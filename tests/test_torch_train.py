"""The port's training (``repro_torch.models.lm.train_loss``,
``launch/train.py``, ``convert.train_state_from_tree``) against the JAX
package at ``reduced()`` sizes on the CPU, on the reference's weights
carried by ``convert``.

* ``train_loss`` and every gradient leaf for qwen3, granite-moe (the MoE
  aux term), internvl2 (patch embeddings), whisper (the
  encoder-decoder) and minicpm3 (MLA), and (loss and gradients only)
  qwen2, gemma2 (local/global attention, softcaps), llama4-scout, jamba
  (Mamba with MoE) and xlstm (mLSTM and sLSTM), on f32 copies of the carried
  weights (XLA keeps bf16 chains in f32 between fused ops where torch
  rounds each op, ``tests/test_torch_archs.py``): loss, ce and aux within
  rtol 1e-5; each gradient leaf within 1e-5 + 1e-4 x the leaf's largest
  reference magnitude (measured: loss 7e-8, gradients 1.2e-6 of a
  leaf's largest). One bf16 qwen3 case on the weights as published:
  loss within rtol 2e-3 and each gradient leaf within 5e-2 x its largest
  magnitude (the roundings of a 4-layer bf16 stack; measured 7e-5 and
  1.7e-2).
* ``remat=True`` equals ``remat=False``: hidden states, aux and the
  gradients bit for bit (the recompute runs the same ops).
* Three steps of the reference's ``make_train_step`` against the port's
  from one carried state (f32 weights, bf16 gradient compression on):
  metrics within rtol 1e-4; params within 1e-2 x the lr summed so far,
  moments within 1e-3 of their leaf's largest and residuals within one
  bf16 ulp of the clipped gradient's largest (2^-7: where the f32
  gradients differ in their last bits the bf16 compression may round
  the other way), everywhere except where a step's reference gradient
  lies below 1e-6 of its leaf's largest magnitude (Adam's first steps
  move such an element by ~lr in the direction of a sign that summation
  order decides); those elements are counted.
* The reference's ``test_train.py`` cases on the port, and a run resumed
  across packages both ways.
* On a 1 x 1 CPU mesh (a gloo world of one): the step with the state
  placed as DTensors by ``state_specs`` equals the meshless step bit for
  bit, ``run_training(mesh=)`` writes the meshless checkpoint, and
  ``runtime.elastic_recover`` restores either package's checkpoint.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import gloo_world_of_one

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs import base as jbase
from repro.data.tokens import SyntheticCorpus as JaxCorpus
from repro.launch import train as jtrain
from repro.launch.mesh import make_local_mesh
from repro.models import lm as jlm
from repro_torch import convert, tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base
from repro_torch.data.tokens import SyntheticCorpus
from repro_torch.launch import train
from repro_torch.models import lm

ARCHS = ("qwen3_0_6b", "granite_moe_1b_a400m", "internvl2_1b",
         "whisper_small", "minicpm3_4b")
# the other five configs, held to the loss and gradients alone (Mamba's
# chunk carry and xLSTM's cells step through time on the CPU)
LOSS_ARCHS = ARCHS + ("qwen2_1_5b", "gemma2_27b", "llama4_scout_17b_a16e",
                      "jamba_1_5_large_398b", "xlstm_1_3b")
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_GRAD_REL = 2e-3, 5e-2
METRIC_RTOL = 1e-4
# the compressed gradient's bf16 rounding flips where the two packages'
# f32 gradients differ in their last bits: one bf16 ulp (2^-8 relative)
# moves m/sqrt(v) by up to ~2^-8 (measured 5e-3 x lr on a param, 4.8e-4
# of a moment leaf's largest, ~2^-9 of the clipped gradient's largest in
# a residual)
PARAM_TOL = 1e-2       # x the lr summed over the steps so far
MOMENT_REL = 1e-3      # x the moment leaf's largest magnitude
RESIDUAL_REL = 2.0 ** -7   # x the clipped gradient leaf's largest
NOISE = 1e-6          # a reference grad below this x its leaf max is noise
HP = dict(lr=1e-3, warmup=2, total_steps=20)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(cfg, step=0, seed=0):
    """The reference corpus's batch (numpy) with seeded patches/frames."""
    b = {k: np.asarray(v) for k, v in
         JaxCorpus(cfg.vocab, S, seed=seed).sample(step, 0, B)._asdict()
         .items()}
    rng = np.random.default_rng(100 + step)
    if cfg.num_patches:
        b["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return b


def _tb(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_grad(arch):
    """The reference's jitted value_and_grad of ``train_loss``: one
    compile per config for every test of this file."""
    jcfg = jbase.get_config(arch).reduced()
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, b, jcfg), has_aux=True))


@functools.lru_cache(maxsize=None)
def _carried(arch, dtype):
    """(reference params in ``dtype``, the port's copy), bits carried."""
    jcfg = jbase.get_config(arch).reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, convert.lm_params_from_tree(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _port_loss_and_grads(pp, batch, cfg):
    return train.loss_and_grads(pp, _tb(batch), cfg, train.TrainHParams())


def _assert_grads(pg, jg, rel, atol=0.0):
    keyed = dict(tree.flatten_with_paths(pg))
    for path, want in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = "/".join(str(p) for p in path)
        got = keyed[key]
        assert got.dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                             jnp.dtype(jnp.float32): torch.float32}[want.dtype]
        w = _np(want)
        tol = atol + rel * float(np.abs(w).max())
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_train_loss_and_grads_equal_the_reference(arch):
    cfg = base.get_config(arch).reduced()
    jp, pp = _carried(arch, "f32")
    batch = _batch(cfg)
    (jloss, jm), jg = _reference_grad(arch)(
        jp, jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = _port_loss_and_grads(pp, batch, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if cfg.moe is not None:
        assert float(metrics["aux"]) >= 1.0 - 1e-6
    _assert_grads(grads, jg, GRAD_RTOL, GRAD_ATOL)


def test_an_unused_param_gets_a_zero_gradient():
    """xLSTM as published has no MLP (``d_ff = 0``), so its blocks'
    ``norm2`` takes no part in the loss: ``jax.grad`` gives it zeros, and
    so does the port (every other gradient under the file's bounds)."""
    jcfg = dataclasses.replace(jbase.get_config("xlstm_1_3b").reduced(),
                               d_ff=0)
    cfg = dataclasses.replace(base.get_config("xlstm_1_3b").reduced(),
                              d_ff=0)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jlm.init_params(jax.random.PRNGKey(0), jcfg))
    pp = convert.lm_params_from_tree(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    batch = _batch(cfg)
    (jloss, _), jg = jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, b, jcfg), has_aux=True)(
            jp, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = _port_loss_and_grads(pp, batch, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    unused = [k for k, g in tree.flatten_with_paths(grads)
              if "norm2" in k]
    assert unused
    for k, g in tree.flatten_with_paths(grads):
        if "norm2" in k:
            assert g.dtype == torch.float32 and not g.any(), k
    _assert_grads(grads, jg, GRAD_RTOL, GRAD_ATOL)


def test_train_loss_and_grads_in_bf16():
    """The weights as published (bf16, f32 norms): bf16 grads for bf16
    leaves, f32 for f32 leaves, as the reference's."""
    arch = "qwen3_0_6b"
    cfg = base.get_config(arch).reduced()
    jp, pp = _carried(arch, "bf16")
    batch = _batch(cfg)
    (jloss, _), jg = _reference_grad(arch)(jp,
                                           jax.tree.map(jnp.asarray, batch))
    loss, _, grads = _port_loss_and_grads(pp, batch, cfg)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=BF16_LOSS_RTOL)
    _assert_grads(grads, jg, BF16_GRAD_REL)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "whisper_small"])
def test_remat_equals_no_remat(arch):
    cfg = base.get_config(arch).reduced()
    pp = tree.tree_map(lambda t: t.float(), lm.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    batch = _tb(_batch(cfg))
    outs = []
    for remat in (False, True):
        live, leaves, _ = train.grad_leaves(pp)
        h = lm._embed(live, batch["tokens"], cfg)
        h, caches, aux = lm.backbone_forward(
            live, h, torch.arange(S), cfg, remat=remat)
        assert (caches is None) == remat
        scalar = torch.sum(h.float() ** 2) + aux
        outs.append((h.detach(), aux.detach(),
                     torch.autograd.grad(scalar, leaves, allow_unused=True)))
    (h0, a0, g0), (h1, a1, g1) = outs
    assert torch.equal(h0, h1) and torch.equal(a0, a1)
    for x, y in zip(g0, g1):
        assert (x is None and y is None) or torch.equal(x, y)


# -- the train step --------------------------------------------------------


@pytest.fixture(scope="module")
def three_steps():
    """Three reference steps (``make_train_step`` on the local mesh) and
    three port steps from one carried f32 state, with the reference's
    grads at each step's params; everything as numpy."""
    arch = "qwen3_0_6b"
    jcfg = jbase.get_config(arch).reduced()
    cfg = base.get_config(arch).reduced()
    jp, _ = _carried(arch, "f32")
    from repro.optim.compression import ef_init
    from repro.optim.optimizers import adamw_init
    jstate = jtrain.TrainState(jp, adamw_init(jp), ef_init(jp))
    pstate = convert.train_state_from_tree(
        jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jtrain.make_train_step(jcfg, make_local_mesh(),
                                   jtrain.TrainHParams(**HP))
    pstep = train.make_train_step(cfg, train.TrainHParams(**HP))
    vg = _reference_grad(arch)
    out = []
    for s in range(3):
        batch = _batch(cfg, step=s)
        jb = jax.tree.map(jnp.asarray, batch)
        _, jg = vg(jstate.params, jb)
        jstate, jm = jstep(jstate, jb, jnp.asarray(s, jnp.int32))
        pstate, pm = pstep(pstate, _tb(batch), s)
        out.append(dict(
            jg=jax.tree.map(_np, jg), jm=jax.tree.map(float, jm),
            pm={k: float(v) for k, v in pm.items()},
            jstate=jax.tree.map(np.asarray, jstate),
            pstate=tree.tree_map(lambda t: t.clone(), pstate)))
    return out


def test_train_step_metrics_equal_the_reference(three_steps):
    for s, rec in enumerate(three_steps):
        assert set(rec["pm"]) == set(rec["jm"]) == {"loss", "ce", "aux",
                                                    "gnorm", "lr"}
        for k, v in rec["jm"].items():
            np.testing.assert_allclose(rec["pm"][k], v, rtol=METRIC_RTOL,
                                       atol=1e-9, err_msg=f"step {s} {k}")


def test_train_step_state_equals_the_reference(three_steps):
    """Params, moments and residuals after each step within their bounds,
    but for sign-noise elements (any step's reference grad below NOISE x
    its leaf max so far), which are counted."""
    noise = None
    lr_sum = 0.0
    counted = []
    for s, rec in enumerate(three_steps):
        near = jax.tree.map(lambda g: np.abs(g) < NOISE * np.abs(g).max(),
                            rec["jg"])
        noise = near if noise is None else jax.tree.map(np.logical_or,
                                                        noise, near)
        lr_sum += rec["jm"]["lr"]
        clip = min(1.0, 1.0 / rec["jm"]["gnorm"])
        js, ps = rec["jstate"], rec["pstate"]
        assert int(ps.opt.step) == int(js.opt.step) == s + 1
        keyed = dict(tree.flatten_with_paths(ps))
        n_noise = 0
        for part, want_tree in (("params", js.params), ("opt/.mu", js.opt.mu),
                                ("opt/.nu", js.opt.nu),
                                ("ef/.residual", js.ef.residual)):
            for path, want in jax.tree_util.tree_flatten_with_path(
                    want_tree)[0]:
                sub = "/".join(str(p) for p in path)
                mask, g = noise, rec["jg"]
                for p in path:
                    mask, g = mask[p.key], g[p.key]
                got = keyed[f".{part}/{sub}"].float().numpy()
                want = np.asarray(want, np.float32)
                tol = {"params": PARAM_TOL * lr_sum,
                       "opt/.mu": MOMENT_REL * np.abs(want).max(),
                       "opt/.nu": MOMENT_REL * np.abs(want).max(),
                       "ef/.residual": RESIDUAL_REL * clip * np.abs(g).max()
                       }[part]
                bad = np.abs(got - want) > 1e-6 * np.abs(want) + tol + 1e-12
                assert not (bad & ~mask).any(), (s, part, sub)
                n_noise += int((bad & mask).sum())
        counted.append(n_noise)
    print(f"sign-noise elements outside the bounds, steps 1-3: {counted}")


# -- the reference's test_train.py cases -----------------------------------


def test_loss_decreases_over_steps():
    cfg = base.get_config("qwen3_0_6b").reduced()
    state = train.init_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    step_fn = train.make_train_step(cfg, train.TrainHParams(**HP))
    corpus = SyntheticCorpus(cfg.vocab, 16, device="cpu")
    losses = []
    for s in range(8):
        state, m = step_fn(state, corpus.sample(s, 0, 4)._asdict(), s)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_run_training_checkpoint_resume(tmp_path):
    """Run 4 steps with checkpoints, then resume: the resumed run starts
    at the checkpointed step 4 and runs to 6."""
    cfg = base.get_config("qwen3_0_6b").reduced()
    hp = train.TrainHParams(lr=1e-3, warmup=2, total_steps=10)
    seen, seen2 = [], []
    kw = dict(global_batch=2, seq_len=16, ckpt_dir=str(tmp_path),
              ckpt_every=2, log_every=1, device="cpu")
    train.run_training(cfg, hp, steps=4,
                       on_metrics=lambda s, m: seen.append(s), **kw)
    out = train.run_training(cfg, hp, steps=6,
                             on_metrics=lambda s, m: seen2.append(s), **kw)
    assert seen == [0, 1, 2, 3] and seen2 == [4, 5]
    assert set(out) == {"loss", "ce", "aux", "gnorm", "lr"}
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]


def test_training_needs_a_device_or_the_cpu_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = base.get_config("qwen3_0_6b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_training(cfg, train.TrainHParams(), global_batch=2,
                           seq_len=16, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.init_state(torch.Generator().manual_seed(0), cfg)


def _equal_leaves(port_state, jax_state):
    """Every leaf of the port's state equals the reference's bit for bit,
    keyed by the same tree path."""
    keyed = dict(tree.flatten_with_paths(port_state))
    flat = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    assert len(keyed) == len(flat)
    for path, want in flat:
        got = keyed["/".join(str(p) for p in path)]
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_resume_across_packages(tmp_path):
    """The reference writes step 2; the port resumes there (its restored
    state equals the reference's leaf by leaf) and writes step 4; the
    reference resumes from the port's step 4 (its restored state equals
    the port's) and runs to 6."""
    jcfg = jbase.get_config("qwen3_0_6b").reduced()
    cfg = base.get_config("qwen3_0_6b").reduced()
    hp = dict(lr=1e-3, warmup=2, total_steps=10)
    kw = dict(global_batch=2, seq_len=16, ckpt_dir=str(tmp_path),
              ckpt_every=2, log_every=1)
    mesh = make_local_mesh()
    jtrain.run_training(jcfg, mesh, jtrain.TrainHParams(**hp), steps=2, **kw)
    jtemplate = jtrain.init_state(jax.random.PRNGKey(1), jcfg)
    ptemplate = train.init_state(torch.Generator().manual_seed(1), cfg,
                                 device="cpu")
    _equal_leaves(CheckpointManager(str(tmp_path)).restore(2, ptemplate),
                  JaxManager(str(tmp_path)).restore(2, jtemplate))
    seen = []
    train.run_training(cfg, train.TrainHParams(**hp), steps=4, device="cpu",
                       on_metrics=lambda s, m: seen.append(s), **kw)
    assert seen == [2, 3]
    _equal_leaves(CheckpointManager(str(tmp_path)).restore(4, ptemplate),
                  JaxManager(str(tmp_path)).restore(4, jtemplate))
    jseen = []
    jtrain.run_training(jcfg, mesh, jtrain.TrainHParams(**hp), steps=6,
                        on_metrics=lambda s, m: jseen.append(s), **kw)
    assert jseen == [4, 5]
    assert CheckpointManager(str(tmp_path)).latest_step() == 6


# -- on a mesh ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "granite_moe_1b_a400m"])
def test_train_step_on_a_mesh_equals_the_meshless_step(arch, tmp_path):
    """Reduced Qwen3 and granite-moe (its experts on local shards) on a
    1 x 1 CPU mesh (a gloo world of one): the state placed by
    ``state_specs`` as DTensors, three steps give the meshless step's
    losses and state bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_local_mesh as local_mesh
    cfg = base.get_config(arch).reduced()
    hp = train.TrainHParams(**HP)
    plain = train.init_state(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    corpus = SyntheticCorpus(cfg.vocab, S, seed=1, device="cpu")
    with gloo_world_of_one(tmp_path):
        mesh = local_mesh(device_type="cpu")
        placed = train.shard_state(copy.deepcopy(plain), cfg, mesh)
        assert all(isinstance(x, DTensor) for x in tree.leaves(placed))
        meshless = train.make_train_step(cfg, hp)
        meshed = train.make_train_step(cfg, hp, mesh=mesh)
        for step in range(3):
            batch = dict(corpus.sample(step, 0, B)._asdict())
            plain, want = meshless(plain, dict(batch), step)
            placed, got = meshed(placed, dict(batch), step)
            for k in want:
                assert not isinstance(got[k], DTensor)
                assert torch.equal(got[k], want[k]), (step, k)
        full = dict(tree.flatten_with_paths(train.unshard(placed)))
    for path, leaf in tree.flatten_with_paths(plain):
        assert torch.equal(full[path], leaf), path


def test_run_training_on_a_mesh_writes_the_meshless_checkpoint(tmp_path):
    """``run_training(mesh=)`` on the 1 x 1 mesh writes the gathered state,
    equal bit for bit to the meshless run's checkpoint."""
    from repro_torch.launch.mesh import make_local_mesh as local_mesh
    cfg = base.get_config("qwen3_0_6b").reduced()
    hp = train.TrainHParams(**HP)
    kw = dict(global_batch=2, seq_len=16, ckpt_every=2, device="cpu")
    train.run_training(cfg, hp, steps=2, ckpt_dir=str(tmp_path / "plain"),
                       **kw)
    with gloo_world_of_one(tmp_path):
        train.run_training(cfg, hp, steps=2, ckpt_dir=str(tmp_path / "mesh"),
                           mesh=local_mesh(device_type="cpu"), **kw)
    template = train.init_state(torch.Generator().manual_seed(9), cfg,
                                device="cpu")
    want = CheckpointManager(str(tmp_path / "plain")).restore(2, template)
    got = CheckpointManager(str(tmp_path / "mesh")).restore(2, template)
    for (path, a), (_, b) in zip(tree.flatten_with_paths(got),
                                 tree.flatten_with_paths(want)):
        assert torch.equal(a, b), path


def test_elastic_recover_restores_either_packages_checkpoint(tmp_path):
    """``elastic_recover`` re-meshes the survivors (one 1 x 1 slice of a
    gloo world of one) and restores the latest checkpoint bit for bit,
    whether the reference wrote it or the port did."""
    from repro_torch.launch import runtime
    jcfg = jbase.get_config("qwen3_0_6b").reduced()
    cfg = base.get_config("qwen3_0_6b").reduced()
    jstate = jtrain.init_state(jax.random.PRNGKey(4), jcfg)
    JaxManager(str(tmp_path / "ref")).save(3, jstate)
    pstate = train.init_state(torch.Generator().manual_seed(4), cfg,
                              device="cpu")
    CheckpointManager(str(tmp_path / "port")).save(5, pstate)
    template = train.init_state(torch.Generator().manual_seed(5), cfg,
                                device="cpu")
    with gloo_world_of_one(tmp_path):
        mesh, step, got = runtime.elastic_recover(
            CheckpointManager(str(tmp_path / "ref")), template,
            surviving_slices=1, slice_shape=(1, 1), device_type="cpu")
        assert step == 3
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        _equal_leaves(got, jstate)
        _, step, got = runtime.elastic_recover(
            CheckpointManager(str(tmp_path / "port")), template,
            surviving_slices=1, slice_shape=(1, 1), device_type="cpu")
        assert step == 5
        for (path, a), (_, b) in zip(tree.flatten_with_paths(got),
                                     tree.flatten_with_paths(pstate)):
            assert torch.equal(a, b), path
        with pytest.raises(RuntimeError, match="no checkpoint"):
            runtime.elastic_recover(
                CheckpointManager(str(tmp_path / "empty")), template,
                surviving_slices=1, slice_shape=(1, 1), device_type="cpu")
