"""The port's recurrent blocks (``repro_torch.models.ssm``: Mamba;
``repro_torch.models.xlstm``: mLSTM and sLSTM) against the JAX package on
the same numpy inputs and carried weights, at ``reduced()`` sizes
(jamba's SSM, d_inner 128, N 16; xlstm's 4 heads, d_qk 16, d_v 32).

The blocks run on f32 copies of the weights, where the point is the
algorithm: states within rtol 1e-5 and atol 1e-6 (f32 products taken in
another order: the port's chunked scan brings the carry into each chunk
after its associative scan where the reference folds it in before, and
the projections are summed in another order), outputs within 1e-5. The
chunked scan's gradients are held against ``jax.grad`` of the
reference's within rtol 1e-5 and atol 1e-5 (f32 sums of up to S terms
in another order; the gradients reach ~25). The bf16 blocks as published are held to
3e-2 on their outputs (bf16 rounds at other places in the two
frameworks). A decode step continues a full-sequence call from its cache,
in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.models import ssm, xlstm

STATE_RTOL, STATE_ATOL = 1e-5, 1e-6
F32_TOL = 1e-5
BF16_TOL = 3e-2
B, S = 2, 16


def _jit(fwd, dec):
    """The reference's forward and decode, compiled once a shape."""
    return (jax.jit(fwd, static_argnums=(2,)),
            jax.jit(dec, static_argnums=(3,)))


BLOCKS = {
    "mamba": ("jamba_1_5_large_398b", jssm.ssm_init,
              *_jit(jssm.ssm_forward, jssm.ssm_decode),
              ssm.ssm_forward, ssm.ssm_decode),
    "mlstm": ("xlstm_1_3b", jxlstm.mlstm_init,
              *_jit(jxlstm.mlstm_forward, jxlstm.mlstm_decode),
              xlstm.mlstm_forward, xlstm.mlstm_decode),
    "slstm": ("xlstm_1_3b", jxlstm.slstm_init,
              *_jit(jxlstm.slstm_forward, jxlstm.slstm_decode),
              xlstm.slstm_forward, xlstm.slstm_decode),
}
INITS = {"mamba": ssm.ssm_init, "mlstm": xlstm.mlstm_init,
         "slstm": xlstm.slstm_init}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.as_tensor(np.array(x))


def _carried(kind, dtype):
    arch, jinit = BLOCKS[kind][:2]
    jcfg = jbase.get_config(arch).reduced()
    cfg = base.get_config(arch).reduced()
    jp = jinit(jax.random.PRNGKey(4), jcfg)
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    pp = convert.lm_params_from_tree(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jcfg, cfg, jp, pp


def _inputs(cfg, dtype, seed, s=S):
    x = np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)
    if dtype == "f32":
        return jnp.asarray(x), _t(x)
    return jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)


def _states(pc, jc, rtol, atol, what):
    assert type(pc).__name__ == type(jc).__name__
    for f, a, b in zip(pc._fields, pc, jc):
        assert tuple(a.shape) == b.shape and \
            str(a.dtype).replace("torch.", "") == str(b.dtype), (what, f)
        np.testing.assert_allclose(a.float().numpy(), _np(b), rtol=rtol,
                                   atol=atol, err_msg=f"{what}.{f}")


@pytest.mark.parametrize("kind", sorted(BLOCKS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_forward_and_decode_match_reference(kind, dtype):
    """The full-sequence block (output and state), then three decode
    steps from that state (outputs and states)."""
    jcfg, cfg, jp, pp = _carried(kind, dtype)
    _, _, jfwd, jdec, pfwd, pdec = BLOCKS[kind]
    jx, px = _inputs(cfg, dtype, 5)
    if dtype == "f32":
        tol, rtol, atol = F32_TOL, STATE_RTOL, STATE_ATOL
    else:
        tol = rtol = atol = BF16_TOL
    jo, jc = jfwd(jp, jx, jcfg)
    po, pc = pfwd(pp, px, cfg)
    assert po.dtype == px.dtype
    np.testing.assert_allclose(po.float().numpy(), _np(jo), atol=tol,
                               rtol=tol)
    _states(pc, jc, rtol, atol, f"{kind} forward")
    jxs, pxs = _inputs(cfg, dtype, 6, 3)
    for t in range(3):
        jo, jc = jdec(jp, jxs[:, t], jc, jcfg)
        po, pc = pdec(pp, pxs[:, t], pc, cfg)
        np.testing.assert_allclose(po.float().numpy(), _np(jo), atol=tol,
                                   rtol=tol)
        _states(pc, jc, rtol, atol, f"{kind} decode {t}")


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_decode_continues_the_forward(kind):
    """A forward over 16 tokens then 3 decode steps gives the outputs and
    final state of one forward over all 19 (Mamba: 16 + 16, its chunk)."""
    jcfg, cfg, jp, pp = _carried(kind, "f32")
    _, _, _, _, pfwd, pdec = BLOCKS[kind]
    n = 16 if kind == "mamba" else 3
    _, px = _inputs(cfg, "f32", 7, S + n)
    full, fstate = pfwd(pp, px, cfg)
    _, state = pfwd(pp, px[:, :S], cfg)
    for t in range(S, S + n):
        out, state = pdec(pp, px[:, t], state, cfg)
        np.testing.assert_allclose(out.numpy(), full[:, t].numpy(),
                                   atol=F32_TOL, rtol=F32_TOL)
    for f, a, b in zip(state._fields, state, fstate):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f)


GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5


def _scan_inputs(S_, chunk):
    rng = np.random.default_rng(S_ + chunk)
    a = rng.uniform(0.5, 1.0, (2, S_, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, S_, 3, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("S_,chunk", [(16, 16), (32, 8), (12, 16), (9, 4),
                                      (48, 16), (256, 16), (64, 64)])
def test_ssm_scan_chunked_matches_reference(S_, chunk):
    """The chunked recurrence on f32 (decay, value) pairs: every state and
    the last within rtol 1e-5, atol 1e-6; S % chunk != 0 raises the
    reference's ValueError (a chunk longer than S is cut to S)."""
    a, b, h0 = _scan_inputs(S_, chunk)
    if S_ % min(chunk, S_):
        with pytest.raises(ValueError, match="multiple of"):
            jssm._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(h0), chunk)
        with pytest.raises(ValueError, match="multiple of"):
            ssm._ssm_scan_chunked(_t(a), _t(b), _t(h0), chunk)
        return
    jhs, jh = jssm._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(h0), chunk)
    phs, ph = ssm._ssm_scan_chunked(_t(a), _t(b), _t(h0), chunk)
    np.testing.assert_allclose(phs.numpy(), np.asarray(jhs),
                               rtol=STATE_RTOL, atol=STATE_ATOL)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=STATE_RTOL,
                               atol=STATE_ATOL)


@pytest.mark.parametrize("S_,chunk", [(16, 16), (32, 8), (48, 16),
                                      (256, 16), (64, 64)])
def test_ssm_scan_chunked_gradients_match_reference(S_, chunk):
    """The gradients of a weighted sum of every state and the last with
    respect to the decays, the values and the initial state, against
    ``jax.grad`` of the reference's scan: within rtol 1e-5, atol 1e-5."""
    a, b, h0 = _scan_inputs(S_, chunk)
    rng = np.random.default_rng(S_ * chunk)
    w = rng.standard_normal(a.shape).astype(np.float32)
    w_last = rng.standard_normal(h0.shape).astype(np.float32)

    def jloss(a, b, h0):
        hs, h = jssm._ssm_scan_chunked(a, b, h0, chunk)
        return jnp.sum(hs * w) + jnp.sum(h * w_last)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    args = [_t(x).requires_grad_() for x in (a, b, h0)]
    hs, h = ssm._ssm_scan_chunked(*args, chunk)
    (torch.sum(hs * _t(w)) + torch.sum(h * _t(w_last))).backward()
    for name, x, g in zip(("a", "b", "h0"), args, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_ssm_forward_needs_whole_chunks():
    jcfg, cfg, jp, pp = _carried("mamba", "f32")
    jx, px = _inputs(cfg, "f32", 8, 20)
    with pytest.raises(ValueError, match="multiple of"):
        jssm.ssm_forward(jp, jx, jcfg)
    with pytest.raises(ValueError, match="multiple of"):
        ssm.ssm_forward(pp, px, cfg)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_init_has_the_reference_tree(kind):
    """Keys, shapes (with a stack axis) and dtypes of the reference's
    init; the deterministic leaves (A_log, D, the gate biases) equal."""
    jcfg, cfg, jp, _ = _carried(kind, "bf16")
    mine = INITS[kind](torch.Generator().manual_seed(0), cfg, (2,))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in mine.items()} == {
        k: ((2,) + v.shape, str(v.dtype)) for k, v in jp.items()}
    for k in ("A_log", "D", "b_if", "b", "conv_b", "gn"):
        if k in jp:
            np.testing.assert_allclose(mine[k][1].float().numpy(),
                                       _np(jp[k]), rtol=1e-6)
    if kind == "mamba":
        dt = torch.nn.functional.softplus(mine["dt_bias"])
        assert float(dt.min()) >= 1e-3 * 0.999
        assert float(dt.max()) <= 1e-1 * 1.001
