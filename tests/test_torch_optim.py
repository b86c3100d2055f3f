"""The port's optimizers, gradient compression, token corpus and runtime
policies against the JAX package (``repro.optim``, ``repro.data.tokens``,
``repro.launch.runtime``) on the same numpy inputs, and the reference's
own ``test_train.py``/``test_runtime.py`` cases on the port.

Tolerances: ``bf16_compress`` and its residual equal the reference bit
for bit (an f32 add, then round to nearest even); ``adamw_update`` on
injected, identical grads within rtol 1e-6 in f32 (the same f32 ops in
the same order; XLA's ``pow`` and torch's may differ by an ulp in the
bias corrections), bf16 params within one bf16 ulp; the global norm and
the schedule within rtol 1e-6 (a sum in another order), and within
1e-6 x base_lr near the end of the decay, where ``1 + cos`` cancels and
an ulp of XLA's ``cos`` against torch's (6e-8 at -1) is all that is left;
``topk_sparsify`` masks equal where the magnitudes are distinct; the
corpus's tokens, labels and mask equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import SyntheticCorpus as JaxCorpus
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.data.tokens import SyntheticCorpus
from repro_torch.launch.runtime import (HeartbeatTracker, StragglerEvent,
                                        StragglerMonitor, WorkerFailure)
from repro_torch.optim import compression, optimizers

RTOL = 1e-6


def _grads(seed, dtype=np.float32):
    """A nested dict of numpy grads: bf16 or f32 weights, f32 norms."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * 0.3).astype(dtype),
            "layer": {"norm": rng.standard_normal(5).astype(np.float32),
                      "b": (rng.standard_normal((3, 4)) * 1e-3
                            ).astype(dtype)}}


def _j(tree_np):
    return jax.tree.map(jnp.asarray, tree_np)


def _t(a):
    """A CPU tensor of numpy (or JAX) array ``a``, bf16 carried bit for
    bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.as_tensor(np.array(a))


def _bits(x):
    """The raw bits of a tensor or array, as numpy integers."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_bf16_compress_equals_the_reference_bit_for_bit(dtype):
    """Three chained steps, each side carrying its own residual: the bf16
    grads and the residuals equal bit for bit."""
    jef = jcomp.ef_init(_j(_grads(0, dtype)))
    pef = compression.ef_init(tree.tree_map(_t, _grads(0, dtype)))
    for step in range(3):
        g = _grads(10 + step, dtype)
        jc, jef = jcomp.bf16_compress(_j(g), jef)
        pc, pef = compression.bf16_compress(tree.tree_map(_t, g), pef)
        for a, b in zip(tree.leaves(pc), jax.tree.leaves(jc)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for a, b in zip(tree.leaves(pef.residual),
                        jax.tree.leaves(jef.residual)):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_bf16_compression_error_feedback_converges():
    """The reference's test: the mean compressed gradient tracks the true
    gradient and the residual stays below one grid step."""
    g = {"w": torch.full((1000,), 0.001)}
    ef = compression.ef_init(g)
    total = torch.zeros(1000)
    for _ in range(50):
        comp, ef = compression.bf16_compress(g, ef)
        total = total + comp["w"].float()
    np.testing.assert_allclose((total / 50).numpy(), 0.001, rtol=1e-2)
    assert float(ef.residual["w"].abs().max()) < 0.001


def test_topk_sparsify_equals_the_reference():
    """Distinct magnitudes, so the threshold picks the same elements:
    masks, kept values and residuals equal."""
    g = _grads(3)
    r = tree.tree_map(lambda a: (0.01 * np.arange(a.size, dtype=np.float32)
                                 .reshape(a.shape)), g)
    jc, jef = jcomp.topk_sparsify(_j(g), jcomp.ErrorFeedback(_j(r)), 0.25)
    pc, pef = compression.topk_sparsify(
        tree.tree_map(_t, g), compression.ErrorFeedback(tree.tree_map(_t, r)),
        0.25)
    for a, b in zip(tree.leaves(pc), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a.numpy() != 0, np.asarray(b) != 0)
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for a, b in zip(tree.leaves(pef.residual),
                    jax.tree.leaves(jef.residual)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    dec = compression.decompress(pc)
    assert all(t.dtype == torch.float32 for t in tree.leaves(dec))


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_adamw_update_equals_the_reference(steps, dtype):
    """``steps`` AdamW steps on the same injected grads and lr: params
    within rtol 1e-6 (f32) or one bf16 ulp, moments within rtol 1e-6,
    the step count equal."""
    params = _grads(1, dtype)
    jp, pp = _j(params), tree.tree_map(_t, params)
    js, ps = jopt.adamw_init(jp), optimizers.adamw_init(pp)
    for s in range(steps):
        g = _grads(100 + s, dtype)
        lr = np.float32(1e-3 * (1 + s))
        jp, js = jopt.adamw_update(_j(g), js, jp, lr=jnp.asarray(lr))
        pp, ps = optimizers.adamw_update(tree.tree_map(_t, g), ps, pp,
                                         lr=torch.tensor(lr))
    assert int(ps.step) == int(js.step) == steps
    assert ps.step.dtype == torch.int32
    for a, b in zip(tree.leaves(pp), jax.tree.leaves(jp)):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                           else torch.float32)
        got, want = a.float().numpy(), np.asarray(b, np.float32)
        if a.dtype == torch.bfloat16:
            ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
            assert (np.abs(got - want) <= ulp).all()
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)
    for pt, jt in ((ps.mu, js.mu), (ps.nu, js.nu)):
        for a, b in zip(tree.leaves(pt), jax.tree.leaves(jt)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=1e-12)


def test_adamw_moves_params_toward_lower_loss():
    """The reference's test, the grads from autograd."""
    params = {"w": torch.tensor([2.0, -3.0])}
    state = optimizers.adamw_init(params)
    for _ in range(60):
        w = params["w"].detach().requires_grad_()
        g, = torch.autograd.grad(torch.sum(torch.square(w)), [w])
        params, state = optimizers.adamw_update({"w": g}, state, params,
                                                lr=0.1, weight_decay=0.0)
    assert float(torch.sum(torch.square(params["w"]))) < 0.05


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_equals_the_reference(max_norm):
    g = _grads(5)
    jc, jn = jopt.clip_by_global_norm(_j(g), max_norm)
    pc, pn = optimizers.clip_by_global_norm(tree.tree_map(_t, g), max_norm)
    np.testing.assert_allclose(float(pn), float(jn), rtol=RTOL)
    for a, b in zip(tree.leaves(pc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)


def test_clip_by_global_norm():
    """The reference's test."""
    clipped, norm = optimizers.clip_by_global_norm(
        {"a": torch.full((4,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-3)


@pytest.mark.parametrize("warmup,total", [(10, 100), (2, 20), (0, 5)])
def test_cosine_schedule_equals_the_reference(warmup, total):
    base = 1e-3
    jlr = jopt.cosine_schedule(base, warmup, total)
    plr = optimizers.cosine_schedule(base, warmup, total)
    for s in range(total + 3):
        want = float(jlr(jnp.asarray(s, jnp.int32)))
        got = plr(s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=RTOL,
                                   atol=RTOL * base)
        assert float(plr(torch.tensor(s))) == float(got)


def test_cosine_schedule_shape():
    """The reference's test."""
    lr = optimizers.cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0, abs=1e-3)
    assert float(lr(100)) == pytest.approx(0.0, abs=1e-3)


def test_sgd_update_equals_the_reference():
    p, g = _grads(7, jnp.bfloat16), _grads(8, jnp.bfloat16)
    want = jopt.sgd_update(_j(g), _j(p), 0.05)
    got = optimizers.sgd_update(tree.tree_map(_t, g), tree.tree_map(_t, p),
                                0.05)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("step,rank,batch", [(0, 0, 4), (7, 0, 2),
                                             (3, 5, 3)])
def test_corpus_equals_the_reference_exactly(step, rank, batch):
    want = JaxCorpus(512, 16, seed=3).sample(step, rank, batch)
    got = SyntheticCorpus(512, 16, seed=3, device="cpu").sample(step, rank,
                                                                batch)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[b.dtype]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    it = SyntheticCorpus(512, 16, seed=3, device="cpu").batches(
        rank, batch, start_step=step)
    assert torch.equal(next(it).tokens, got.tokens)


def test_corpus_needs_a_device_or_the_cpu_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticCorpus(512, 16)


# -- runtime: the reference's test_runtime.py cases ---------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_heartbeat_failure_detection():
    clock = FakeClock()
    hb = HeartbeatTracker(["w0", "w1", "w2"], timeout_s=10.0, clock=clock)
    clock.t = 5.0
    hb.beat("w0")
    hb.beat("w1")
    clock.t = 12.0
    assert hb.failed() == ["w2"]
    with pytest.raises(WorkerFailure) as ei:
        hb.check()
    assert ei.value.workers == ["w2"]
    hb.beat("w2")
    assert hb.failed() == []


def test_straggler_monitor_escalates_after_consecutive():
    clock = FakeClock()
    mon = StragglerMonitor(deadline_s=1.0, max_consecutive=2, clock=clock)

    def slow_step(step):
        with mon.step(step):
            clock.t += 5.0

    slow_step(0)
    assert mon.slow_steps == [0]
    with pytest.raises(StragglerEvent):
        slow_step(1)
    with mon.step(2):          # a fast step resets the consecutive count
        clock.t += 0.1
    slow_step(3)
    assert mon.slow_steps == [0, 1, 3]


def test_straggler_monitor_disabled():
    mon = StragglerMonitor(deadline_s=None)
    with mon.step(0):
        pass
    assert mon.slow_steps == []
