"""The port's ``jax.lax.scan`` (``repro_torch.models.common.scan``) and the
dry run's count of a loop body by trip (``repro_torch.parallel.collectives``
``repeat``/``repeat_backward``).

On real tensors ``scan`` is the eager loop, held against ``jax.lax.scan``
on the same numpy inputs (f32 within 1e-6). On ``meta`` tensors it traces
the first, one middle and the last trip; the recurrent blocks (Mamba,
mLSTM, sLSTM at ``reduced()`` widths) give the shapes and dtypes they give
on the CPU, forward and backward. On a fake 4-rank CPU mesh (2 x 2, in a
subprocess: the fake process group is process-global) the collectives a
block's forward and backward issue on ``meta`` DTensors, counted by trip,
equal those the eager loop issues on CPU DTensors, op by op and in wire
bytes; so does a whole train step of xlstm and jamba (remat included).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import run_script

from repro_torch.configs import base
from repro_torch.models import lm, ssm, xlstm
from repro_torch.models.common import scan
from repro_torch.parallel import collectives

TOL = 1e-6


def _step_np(W):
    def step(h, x):
        h = jnp.tanh(h @ W + x)
        return h, 2.0 * h
    return step


def _step_torch(W):
    def step(h, x):
        h = torch.tanh(h @ W + x)
        return h, 2.0 * h
    return step


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_scan_equals_lax_scan(dim):
    """A nonlinear recurrence over the slices of ``xs`` along ``dim``: the
    last carry and the stacked outputs equal ``jax.lax.scan``'s."""
    rng = np.random.default_rng(dim)
    shape = [3, 3, 3]
    shape[dim] = 7
    xs = rng.standard_normal(shape + [5]).astype(np.float32)
    W = (0.5 * rng.standard_normal((5, 5))).astype(np.float32)
    h0 = rng.standard_normal((3, 3, 5)).astype(np.float32)
    jh, jys = jax.lax.scan(_step_np(jnp.asarray(W)), jnp.asarray(h0),
                           jnp.moveaxis(jnp.asarray(xs), dim, 0))
    h, ys = scan(_step_torch(torch.as_tensor(W)), torch.as_tensor(h0),
                 torch.as_tensor(xs), dim=dim)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(ys.numpy(),
                               np.moveaxis(np.asarray(jys), 0, dim),
                               atol=TOL, rtol=TOL)


def test_scan_takes_a_tuple_of_inputs():
    """``xs`` as a tuple: each step gets the tuple of slices."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 1.0, (2, 6, 3)).astype(np.float32)
    b = rng.standard_normal((2, 6, 3)).astype(np.float32)

    def jstep(h, ab):
        return ab[0] * h + ab[1], h

    jh, jys = jax.lax.scan(jstep, jnp.zeros((2, 3)),
                           (jnp.moveaxis(a, 1, 0), jnp.moveaxis(b, 1, 0)))
    h, ys = scan(lambda h, ab: (ab[0] * h + ab[1], h), torch.zeros(2, 3),
                 (torch.as_tensor(a), torch.as_tensor(b)))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(ys.numpy(), np.moveaxis(np.asarray(jys), 0,
                                                       1), atol=TOL,
                               rtol=TOL)


def _block(kind):
    arch = "jamba_1_5_large_398b" if kind == "mamba" else "xlstm_1_3b"
    cfg = base.get_config(arch).reduced()
    fwd = {"mamba": ssm.ssm_forward, "mlstm": xlstm.mlstm_forward,
           "slstm": xlstm.slstm_forward}[kind]
    i = [lm.position_kind(cfg, j) for j in
         range(len(cfg.layer_pattern))].index(kind)
    return cfg, fwd, i


def _run_block(kind, device, S):
    cfg, fwd, i = _block(kind)
    gen = (torch.Generator().manual_seed(0) if device == "cpu" else None)
    params = lm.init_params(gen, cfg, device=device)
    p = {k: v[0].float().requires_grad_() for k, v in
         params[f"pos{i}"]["mixer"].items()}
    x = torch.zeros((2, S, cfg.d_model), device=device, requires_grad=True)
    if device == "cpu":
        x = (torch.randn((2, S, cfg.d_model), generator=torch.Generator()
                         .manual_seed(1)) * 0.5).requires_grad_()
    out, cache = fwd(p, x, cfg)
    grads = torch.autograd.grad(out.float().sum(), [x] + list(p.values()),
                                allow_unused=True, materialize_grads=True)
    return out, cache, grads


def _layout(tensors):
    return [(tuple(t.shape), t.dtype) for t in tensors]


@pytest.mark.parametrize("kind,S", [("mamba", 16), ("mamba", 48),
                                    ("mamba", 64), ("mlstm", 1),
                                    ("mlstm", 2), ("mlstm", 3),
                                    ("mlstm", 7), ("slstm", 1),
                                    ("slstm", 3), ("slstm", 7)])
def test_meta_scan_gives_the_cpu_shapes(kind, S):
    """A block on ``meta`` params and input (the traced trips) gives the
    output, cache and gradient shapes and dtypes of the eager loop on the
    CPU."""
    meta = _run_block(kind, "meta", S)
    cpu = _run_block(kind, "cpu", S)
    assert meta[0].is_meta and not cpu[0].is_meta
    assert _layout([meta[0]]) == _layout([cpu[0]])
    assert type(meta[1]) is type(cpu[1])
    assert _layout(meta[1]) == _layout(cpu[1])
    assert _layout(meta[2]) == _layout(cpu[2])
    for g in cpu[2]:
        assert torch.isfinite(g).all()


def test_records_count_their_multiplier():
    """An entry noted for n trips counts n collectives and n times its
    wire bytes; entries of one trip are the reference's (multiplier 1)."""
    one = collectives.record("all-gather", 1024, 4096, 4)
    many = collectives.record("all-gather", 1024, 4096, 4, 7)
    assert one["multiplier"] == 1 and many["multiplier"] == 7
    assert many["wire_bytes"] == 7 * one["wire_bytes"]
    loop = [one] * 7
    assert collectives.summarize_collectives([many]) == \
        collectives.summarize_collectives(loop)
    assert collectives.counts_by_op([many, one]) == {"all-gather": 8}


def test_repeat_contexts_multiply():
    assert collectives.trips() == 1
    with collectives.repeat(3):
        assert collectives.trips() == 3
        with collectives.repeat(5):
            assert collectives.trips() == 15
        assert collectives.trips() == 3
    assert collectives.trips() == 1


def test_repeat_backward_marks_the_body_alone():
    """Only the nodes created between the marks that the body's outputs
    reach are marked; the input's node before the body and the leaf are
    left alone; a second mark multiplies (nested bodies)."""
    w = torch.ones(3, requires_grad=True)
    pre = w * 2.0
    since = collectives.autograd_mark()
    out = torch.sin(pre) * pre + 1.0
    until = collectives.autograd_mark()
    n = collectives.repeat_backward(4, [out], since, until)
    assert n == 3                          # sin, mul, add
    key = collectives.TRIPS_KEY
    assert pre.grad_fn.metadata.get(key) is None
    assert out.grad_fn.metadata[key] == 4
    collectives.repeat_backward(2, [out], since, until)
    assert out.grad_fn.metadata[key] == 8
    out.sum().backward()                   # the marks change no gradient
    two = torch.full((3,), 2.0)
    expect = 2.0 * torch.sin(two) + 4.0 * torch.cos(two)
    torch.testing.assert_close(w.grad, expect)


MESH_SCRIPT = r"""
import json, logging, torch
logging.getLogger("torch.distributed").setLevel(logging.ERROR)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import train_batch_specs
from repro_torch.launch import train
from repro_torch.launch.mesh import (ambient_mesh, fake_process_group,
                                     make_compat_mesh)
from repro_torch.models import lm, ssm, xlstm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shd

BLOCKS = {"mamba": ("jamba_1_5_large_398b", ssm.ssm_forward, 64),
          "mlstm": ("xlstm_1_3b", xlstm.mlstm_forward, 8),
          "slstm": ("xlstm_1_3b", xlstm.slstm_forward, 8)}


def summary(rec):
    s = coll.summarize_collectives(rec.collectives)
    return {"counts": coll.counts_by_op(rec.collectives),
            "wire": s["total_wire_bytes"], "count": s["count"]}


def block(kind, device, mesh):
    arch, fwd, S = BLOCKS[kind]
    cfg = get_config(arch).reduced()
    i = [lm.position_kind(cfg, j)
         for j in range(len(cfg.layer_pattern))].index(kind)
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = lm.init_params(gen, cfg, device=device)
    placed = shd.to_shardings(mesh, shd.param_specs(params, cfg), params)
    p = {k: v[0].detach().requires_grad_()
         for k, v in placed[f"pos{i}"]["mixer"].items()}
    x = shd.distribute(torch.zeros((4, S, cfg.d_model), device=device,
                                   dtype=torch.bfloat16),
                       mesh, shd.Spec("data", None, None))
    x.requires_grad_()
    with ambient_mesh(mesh), implicit_replication():
        with coll.CollectiveRecorder() as fwd_rec:
            out, _ = fwd(p, x, cfg)
        with coll.CollectiveRecorder() as bwd_rec:
            torch.autograd.grad(out.float().sum(), [x] + list(p.values()),
                                allow_unused=True)
    return {"fwd": summary(fwd_rec), "bwd": summary(bwd_rec)}


def step(arch, device, mesh, S):
    cfg = get_config(arch).reduced()
    if device == "meta":
        state = train.init_state_abstract(cfg)
        batch = train_batch_specs(4, S)
    else:
        state = train.init_state(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in train_batch_specs(4, S).items()}
    state = train.shard_state(state, cfg, mesh)
    bspecs = train.batch_specs(cfg, mesh)
    batch = {k: shd.distribute(v, mesh, bspecs[k]) for k, v in batch.items()}
    fn = train.make_train_step(cfg, train.TrainHParams(), mesh=mesh)
    with coll.CollectiveRecorder() as rec:
        fn(state, batch, 0)
    return summary(rec)


out = {}
with fake_process_group(4):
    mesh = make_compat_mesh((2, 2), ("data", "model"), device_type="cpu")
    for kind in BLOCKS:
        out[kind] = {dev: block(kind, dev, mesh) for dev in ("meta", "cpu")}
    for arch, S in (("xlstm_1_3b", 8), ("jamba_1_5_large_398b", 64)):
        out["train_" + arch] = {dev: step(arch, dev, mesh, S)
                                for dev in ("meta", "cpu")}
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def mesh_counts():
    return run_script(MESH_SCRIPT, timeout=600)


@pytest.mark.parametrize("case", ["mamba", "mlstm", "slstm"])
def test_traced_block_counts_equal_the_loop_on_a_mesh(case):
    """Forward and backward apart: the traced trips on ``meta`` DTensors
    count the eager loop's collectives on CPU DTensors, op by op, and
    their wire bytes (64 Mamba tokens in 4 chunks; 8 xLSTM steps)."""
    got = mesh_counts()[case]
    for part in ("fwd", "bwd"):
        assert got["meta"][part]["counts"] == got["cpu"][part]["counts"], \
            part
        assert got["meta"][part]["wire"] == pytest.approx(
            got["cpu"][part]["wire"], rel=1e-12), part
    assert got["cpu"]["bwd"]["count"] > 0


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "jamba_1_5_large_398b"])
def test_traced_train_step_counts_equal_the_loop_on_a_mesh(arch):
    """A whole ``make_train_step`` step (each period rematerialised in
    the backward) on the 2 x 2 mesh: the same collectives, op by op and
    in wire bytes, on ``meta`` as the eager loop issues on the CPU."""
    got = mesh_counts()["train_" + arch]
    assert got["meta"]["counts"] == got["cpu"]["counts"]
    assert got["meta"]["wire"] == pytest.approx(got["cpu"]["wire"],
                                                rel=1e-12)
    assert got["meta"]["counts"]["all-gather"] > 0
