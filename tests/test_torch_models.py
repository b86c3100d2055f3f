"""The port's model stack (``repro_torch.configs``, ``models/common.py``,
``models/attention.py``, ``models/lm.py``) against the JAX package on the
same numpy inputs and carried bf16 weights (``convert.lm_params_from_tree``
keeps their bits), at ``reduced()`` sizes.

Tolerances: f32 building blocks (rms_norm, rope, attention on f32 inputs)
within atol 2e-5 (f32 sums in another order); the bf16 stack within atol
and rtol 3e-2 on hidden states (bf16 rounds at other places in the two
frameworks: one bf16 ulp is 2^-8 relative, and a block adds a few), and
logits within atol 5e-2 (unit-norm-scale logits of the reduced models).
Also: the configs equal the reference's, and the kernel plans take every
config's width. The other families (MoE, MLA, Mamba, xLSTM, patches, the
encoder-decoder) are held to the reference in ``test_torch_archs.py``,
``test_torch_moe.py``, ``test_torch_recurrent.py`` and
``test_torch_encdec.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.kernels import ops
from repro_torch.models import attention, common, lm

F32_ATOL = 2e-5
BF16_TOL = 3e-2
LOGIT_ATOL = 5e-2
ARCHS = ("qwen3_0_6b", "gemma2_27b")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(arch, reference cfg, port cfg, reference params, port params)."""
    jcfg = jbase.get_config(request.param).reduced()
    cfg = base.get_config(request.param).reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pp = convert.lm_params_from_tree(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return request.param, jcfg, cfg, jp, pp


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert base.shape_cells(arch) == jbase.shape_cells(arch)


def test_config_registry_equals_the_reference():
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        base.get_config("nope")


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 4, 16)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rms_norm_matches_reference(shape, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale))
    xt = torch.as_tensor(x)
    if dtype is jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    got = common.rms_norm(xt, torch.as_tensor(scale))
    assert got.dtype == (torch.float32 if dtype is np.float32
                         else torch.bfloat16)
    tol = F32_ATOL if dtype is np.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 40
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    np.testing.assert_allclose(
        common.rope_freqs(16, theta).numpy(),
        _np(jcommon.rope_freqs(16, theta)), rtol=1e-6)


def test_swiglu_softcap_and_loss_match_reference():
    rng = np.random.default_rng(3)
    x, wg, wu = (rng.standard_normal(s).astype(np.float32) / 4
                 for s in ((4, 8), (8, 12), (8, 12)))
    wd = rng.standard_normal((12, 8)).astype(np.float32) / 4
    np.testing.assert_allclose(
        common.swiglu(_t(x), _t(wg), _t(wu), _t(wd)).numpy(),
        _np(jcommon.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))),
        atol=F32_ATOL)
    np.testing.assert_allclose(common.softcap(_t(x * 40), 30.0).numpy(),
                               _np(jcommon.softcap(jnp.asarray(x * 40),
                                                   30.0)), atol=F32_ATOL)
    labels = rng.integers(0, 8, (4,))
    mask = np.array([1, 0, 1, 1], np.float32)
    np.testing.assert_allclose(
        float(common.cross_entropy_loss(_t(x), _t(labels), _t(mask))),
        float(jcommon.cross_entropy_loss(jnp.asarray(x), jnp.asarray(labels),
                                         jnp.asarray(mask))), rtol=1e-5)


@pytest.mark.parametrize("kwargs", [
    dict(causal=True), dict(causal=True, window=16),
    dict(causal=True, logit_cap=50.0), dict(causal=False),
])
def test_flash_matches_naive_and_the_reference(kwargs):
    """The chunked online softmax (causal block skipping) against the
    port's naive attention and the reference's flash_attention."""
    rng = np.random.default_rng(4)
    B, S, H, KV, hd = 2, 64, 8, 4, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.arange(S)
    o1 = attention.flash_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                   q_chunk=16, kv_chunk=16, **kwargs)
    o2 = attention.naive_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                   **kwargs)
    want = jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 jnp.asarray(pos), jnp.asarray(pos),
                                 q_chunk=16, kv_chunk=16, **kwargs)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=F32_ATOL)
    np.testing.assert_allclose(o1.numpy(), _np(want), atol=F32_ATOL)


def test_flash_odd_lengths_and_decode_attention_match_reference():
    rng = np.random.default_rng(5)
    B, Sq, Sk, H, hd = 1, 30, 75, 2, 8
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    qp, kp = np.arange(Sq), np.arange(Sk)
    got = attention.flash_attention(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                    causal=False, q_chunk=16, kv_chunk=32)
    want = attention.naive_attention(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                     causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL)
    for window, cap in ((None, None), (8, 50.0)):
        got = attention.decode_attention(_t(q[:, 0]), _t(k), _t(v), 40,
                                         window=window, logit_cap=cap)
        want = jattn.decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(40),
                                      window=window, logit_cap=cap)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_ATOL)


def test_gqa_forward_and_decode_match_reference(carried):
    """One attention layer of the carried stack (its first pattern
    positions: gemma2's local and global layers), full sequence and one
    decode step from its cache, against the reference's."""
    arch, jcfg, cfg, jp, pp = carried
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 12, cfg.d_model)) / 2).astype(np.float32)
    pos = np.arange(12)
    for i in range(lm.combined_period(cfg)):
        jl = jax.tree.map(lambda a: a[0], jp[f"pos{i}"]["mixer"])
        pl = {k: v[0] for k, v in pp[f"pos{i}"]["mixer"].items()}
        local = lm.position_is_local(cfg, i)
        assert local == jlm.position_is_local(jcfg, i)
        jo, jc = jattn.gqa_forward(jl, jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(pos), jcfg,
                                   layer_is_local=local)
        po, pc = attention.gqa_forward(pl, _t(x).to(torch.bfloat16),
                                       _t(pos), cfg, layer_is_local=local)
        np.testing.assert_allclose(po.float().numpy(), _np(jo),
                                   atol=BF16_TOL, rtol=BF16_TOL)
        np.testing.assert_allclose(pc.k.float().numpy(), _np(jc.k),
                                   atol=BF16_TOL, rtol=BF16_TOL)
        # one decode step at slot 12 of a 16-slot cache
        jk = jnp.pad(jc.k, ((0, 0), (0, 4), (0, 0), (0, 0)))
        jv = jnp.pad(jc.v, ((0, 0), (0, 4), (0, 0), (0, 0)))
        pk = torch.nn.functional.pad(pc.k, (0, 0, 0, 0, 0, 4))
        pv = torch.nn.functional.pad(pc.v, (0, 0, 0, 0, 0, 4))
        xd = (rng.standard_normal((2, cfg.d_model)) / 2).astype(np.float32)
        jo, _ = jattn.gqa_decode(jl, jnp.asarray(xd, jnp.bfloat16),
                                 jattn.AttnCache(jk, jv), jnp.asarray(12),
                                 jcfg, layer_is_local=local)
        po, _ = attention.gqa_decode(pl, _t(xd).to(torch.bfloat16),
                                     attention.AttnCache(pk, pv), 12, cfg,
                                     layer_is_local=local)
        np.testing.assert_allclose(po.float().numpy(), _np(jo),
                                   atol=BF16_TOL, rtol=BF16_TOL)


def test_prefill_and_decode_step_match_reference(carried):
    """prefill's last hidden state and caches, then decode steps with full
    logits and with the hidden state only, on carried weights."""
    arch, jcfg, cfg, jp, pp = carried
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, 9))
    jh, jc = jlm.prefill(jp, jnp.asarray(toks), jcfg)
    ph, pc = lm.prefill(pp, _t(toks), cfg)
    np.testing.assert_allclose(ph.float().numpy(), _np(jh), atol=BF16_TOL,
                               rtol=BF16_TOL)
    assert len(pc) == len(jc)
    for a, b in zip(pc, jc):
        assert tuple(a.k.shape) == b.k.shape
        np.testing.assert_allclose(a.v.float().numpy(), _np(b.v),
                                   atol=BF16_TOL, rtol=BF16_TOL)
    jc = jlm.extend_cache(jcfg, jc, 16)
    pc = lm.extend_cache(cfg, pc, 16)
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab, (2,))
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jc,
                                 jnp.asarray(9 + step, jnp.int32), jcfg)
        pl, pc = lm.decode_step(pp, _t(nxt), pc, 9 + step, cfg)
        assert pl.dtype == torch.float32 and tuple(pl.shape) == jl.shape
        np.testing.assert_allclose(pl.numpy(), _np(jl), atol=LOGIT_ATOL)
    jh, _ = jlm.decode_step(jp, jnp.asarray(nxt), jc,
                            jnp.asarray(12, jnp.int32), jcfg,
                            logits_mode="none")
    ph, _ = lm.decode_step(pp, _t(nxt), pc, 12, cfg, logits_mode="none")
    np.testing.assert_allclose(ph.float().numpy(), _np(jh), atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_decode_continues_prefill_as_teacher_forcing(carried):
    """prefill -> extend_cache -> decode gives the hidden state a full
    forward over the extended prefix gives (the reference's own check)."""
    _, _, cfg, _, pp = carried
    rng = np.random.default_rng(8)
    toks = _t(rng.integers(0, cfg.vocab, (2, 6)))
    _, caches = lm.prefill(pp, toks, cfg)
    caches = lm.extend_cache(cfg, caches, 16)
    nxt = _t(rng.integers(0, cfg.vocab, (2,)))
    h_dec, _ = lm.decode_step(pp, nxt, caches, 6, cfg, logits_mode="none")
    toks2 = torch.cat([toks, nxt[:, None]], dim=1)
    h_full, _, _ = lm.backbone_forward(pp, lm._embed(pp, toks2, cfg),
                                       torch.arange(7), cfg)
    np.testing.assert_allclose(h_dec.float().numpy(),
                               h_full[:, -1].float().numpy(), atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_init_params_has_the_reference_tree(carried):
    """The port's own init: the reference's keys, shapes and dtypes
    (layers stacked per pattern position), drawn on the generator's
    device, and init_cache the prefill cache layout."""
    _, jcfg, cfg, jp, _ = carried
    mine = lm.init_params(torch.Generator().manual_seed(3), cfg,
                          device="cpu")
    with pytest.raises(ValueError, match="generator lives on cpu"):
        lm.init_params(torch.Generator(), cfg, device="meta")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_p = {}

    def walk(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat_p[path] = node

    walk(mine)
    want = {tuple(p.key for p in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in flat_j}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flat_p.items()}
    assert got == want
    std = mine["pos0"]["ffn"]["w_up"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5 * 0.88) < 0.02   # trunc-normal ±2σ
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    jcache = jlm.init_cache(jcfg, 2, 16)
    assert [tuple(c.k.shape) for c in cache] == [c.k.shape for c in jcache]


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_kernel_plans_take_every_config_width(arch):
    """hash_encode's and fused_query's launch plans accept each config's
    d_model at every code width up to W = 8 (L = 27, 60, 122, 256) and at
    the vocabulary's size. Before the tiled encode and the sliced fused
    query, hash_encode raised wherever A and one warp's slab of x did not
    fit shared memory (d = 1024 at L = 122) and fused_query from d = 513."""
    d = base.get_config(arch).d_model
    V = base.get_config(arch).padded_vocab
    for L in (27, 60, 122, 256):
        for n in (8, V):
            plan = ops.hash_encode_plan(n, d, L, 132)
            assert plan.smem <= ops._SMEM_LIMIT and plan.blocks >= 1
    plan = ops.fused_query_plan(8, V, d, 32)
    assert plan.nspan == -(-V // ops.FUSED_SPAN)
