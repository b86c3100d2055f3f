"""The port's LM (``repro_torch.models.lm``) against the JAX package for
each family the earlier slices did not run: granite-moe and llama4 (MoE,
top-k and top-1 with a shared expert), jamba (Mamba, attention and MoE
every other layer), minicpm3 (MLA), xlstm (mLSTM and sLSTM, at
``reduced()`` and with ``d_ff = 0`` as published), internvl2 (QKV bias,
patch embeddings) and whisper (the encoder-decoder), at ``reduced()``
sizes on the reference's bf16 weights carried by
``convert.lm_params_from_tree``.

Tolerances: hidden states, attention caches and recurrent states within
atol and rtol 3e-2 (``BF16_TOL`` of ``test_torch_models.py``: bf16 rounds
at other places in the two frameworks, a block adds a few ulps), logits
within atol 5e-2. Every layer is held to that in bf16 on the reference's
own input to it. The whole stack runs on f32 copies of the carried
weights: at ``reduced()`` depth (16 layers for jamba and xlstm) the bf16
roundings compound through the residual stream in both packages (the
reference's bf16 hidden state lies ~0.7 from its own f32 run on xlstm),
so a chained bf16 comparison measures that drift and not the port.
Decode continuing prefill is the reference's own check
(``tests/test_models.py``: atol and rtol 5e-2), for the configs that are
neither MoE (decode capacity is per decode group, so a step is not a
slice of the full forward) nor encoder-decoder (``test_torch_encdec.py``).
Serving: the first greedy token equals the reference server's wherever
the reference's top-1 logit margin exceeds twice the logit tolerance,
and every LSH head at num_probe = V equals the port's exact server.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.models import encdec, lm, lm_head

BF16_TOL = 3e-2
LOGIT_ATOL = 5e-2
CONSISTENCY_TOL = 5e-2
ARCHS = ("granite_moe_1b_a400m", "llama4_scout_17b_a16e",
         "jamba_1_5_large_398b", "minicpm3_4b", "xlstm_1_3b",
         "xlstm_1_3b:d_ff=0", "internvl2_1b", "whisper_small")
DECODER_ONLY = tuple(a for a in ARCHS if a != "whisper_small")
SERVED = ("granite_moe_1b_a400m", "minicpm3_4b", "xlstm_1_3b",
          "jamba_1_5_large_398b")
B, S = 2, 8
# one compile per shape for the reference's scanned stacks
jprefill = jax.jit(jlm.prefill, static_argnums=(2,))
jdecode = jax.jit(jlm.decode_step, static_argnums=(4,),
                  static_argnames=("logits_mode",))


def _cfgs(arch):
    name, _, mod = arch.partition(":")
    jcfg = jbase.get_config(name).reduced()
    cfg = base.get_config(name).reduced()
    if mod == "d_ff=0":       # xLSTM's MLP-free block, as published
        jcfg = dataclasses.replace(jcfg, d_ff=0)
        cfg = dataclasses.replace(cfg, d_ff=0)
    return jcfg, cfg


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=BF16_TOL, what=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol, err_msg=what)


def _close_caches(pc, jc, what):
    assert len(pc) == len(jc)
    for i, (a, b) in enumerate(zip(pc, jc)):
        assert type(a).__name__ == type(b).__name__
        for f, x, y in zip(a._fields, a, b):
            assert tuple(x.shape) == y.shape, (what, i, f)
            _close(x, y, what=f"{what} pos{i}.{f}")


@functools.lru_cache(maxsize=None)
def _carry(arch, dtype=None):
    """The reference's params for ``arch`` (cast to ``dtype`` if given)
    and the port's copy, bits carried; made once a test process."""
    jcfg, cfg = _cfgs(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    pp = convert.lm_params_from_tree(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jp, pp


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(arch, reference cfg, port cfg, reference params, port params), the
    weights as published (bf16, f32 norms and recurrent gates)."""
    jcfg, cfg = _cfgs(request.param)
    return (request.param, jcfg, cfg) + _carry(request.param)


def _flat(tree):
    out = {}

    def walk(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[path] = (tuple(node.shape),
                         str(node.dtype).replace("torch.", ""))
    walk(tree)
    return out


def test_init_params_has_the_reference_tree(carried):
    """The port's own init: the reference's keys, shapes and dtypes
    (layers stacked per pattern position; the encoder-decoder's nested
    encoder and decoder stacks), drawn on the generator's device, and
    init_cache the reference's cache layout."""
    arch, jcfg, cfg, jp, _ = carried
    mine = lm.init_params(torch.Generator().manual_seed(3), cfg,
                          device="cpu")
    want = {tuple(p.key for p in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert _flat(mine) == want
    if cfg.is_encoder_decoder:
        got = encdec.init_cache(cfg, B, 16, device="cpu")
        ref = jencdec.init_cache(jcfg, B, 16)
        got = {"self_k": got["self"].k, "self_v": got["self"].v,
               "cross_k": got["cross_k"], "cross_v": got["cross_v"]}
        ref = {"self_k": ref["self"].k, "self_v": ref["self"].v,
               "cross_k": ref["cross_k"], "cross_v": ref["cross_v"]}
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in ref.items()}
        return
    got = lm.init_cache(cfg, B, 16, device="cpu")
    ref = jlm.init_cache(jcfg, B, 16)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert type(a).__name__ == type(b).__name__
        for x, y in zip(a, b):
            assert tuple(x.shape) == y.shape
            assert str(x.dtype).replace("torch.", "") == str(y.dtype)
            np.testing.assert_array_equal(x.float().numpy(), _np(y))


def _frames(cfg, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_frames, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("arch", [a for a in DECODER_ONLY])
def test_every_layer_matches_reference_in_bf16(arch):
    """Each layer of the stack (every pattern position and repetition:
    attention, MLA, Mamba, mLSTM, sLSTM; dense, MoE or no FFN) on the
    reference's own input to it, bf16 weights as published: its output
    and cache."""
    jcfg, cfg = _cfgs(arch)
    jp, pp = _carry(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, S))
    jx = jlm._embed(jp, jnp.asarray(toks), jcfg)
    pos = np.arange(S)
    P = lm.combined_period(cfg)
    for r, layer in enumerate(lm._layers(pp, cfg)):
        for i in range(P):
            jl = jax.tree.map(lambda a: a[r], jp[f"pos{i}"])
            jo, jc, ja = jlm.layer_forward(jl, jx, jnp.asarray(pos), jcfg, i)
            po, pc, pa = lm.layer_forward(layer[i], _t(_np(jx)).to(
                torch.bfloat16), _t(pos), cfg, i)
            what = f"rep {r} pos {i} ({lm.position_kind(cfg, i)})"
            _close(po, jo, what=what)
            _close_caches((pc,), (jc,), what)
            # the router sees the bf16-normed input, rounded apart
            np.testing.assert_allclose(float(pa), float(ja), rtol=BF16_TOL)
            jx = jo


def test_prefill_and_decode_step_match_reference(carried):
    """prefill's last hidden state and every cache (attention, MLA's
    latent, Mamba, mLSTM and sLSTM states), then three decode steps
    (logits) and one more returning the hidden state, on f32 copies of
    the carried weights. For whisper: the encoder, the cross K/V and the
    decoder's steps."""
    arch, jcfg, cfg, _, _ = carried
    jp, pp = _carry(arch, jnp.float32)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, S))
    if cfg.is_encoder_decoder:
        fr = _frames(cfg, 8)
        jenc = jencdec.encoder_forward(jp["encoder"], jnp.asarray(fr), jcfg)
        penc = encdec.encoder_forward(pp["encoder"], _t(fr), cfg)
        _close(penc, jenc, what="encoder")
        jc = jencdec.init_cache(jcfg, B, 16)
        jc["cross_k"], jc["cross_v"] = jencdec.cross_kv(jp["layers"], jenc,
                                                        jcfg)
        pc = encdec.init_cache(cfg, B, 16, device="cpu")
        pc["cross_k"], pc["cross_v"] = encdec.cross_kv(pp["layers"], penc,
                                                       cfg)
        _close(pc["cross_k"], jc["cross_k"], what="cross_k")
        start = 0
    else:
        jh, jc = jprefill(jp, jnp.asarray(toks), jcfg)
        ph, pc = lm.prefill(pp, _t(toks), cfg)
        _close(ph, jh, what="prefill hidden")
        _close_caches(pc, jc, "prefill cache")
        jc = jlm.extend_cache(jcfg, jc, 16)
        pc = lm.extend_cache(cfg, pc, 16)
        start = S
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab, (B,))
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc,
                                 jnp.asarray(start + step, jnp.int32), jcfg)
        pl, pc = lm.decode_step(pp, _t(nxt), pc, start + step, cfg)
        assert pl.dtype == torch.float32 and tuple(pl.shape) == jl.shape
        np.testing.assert_allclose(pl.numpy(), _np(jl), atol=LOGIT_ATOL)
    if cfg.is_encoder_decoder:
        _close(pc["self"].k, jc["self"].k, what="decode self cache")
    else:
        _close_caches(pc, jc, "decode cache")
    jh, _ = jdecode(jp, jnp.asarray(nxt), jc,
                            jnp.asarray(start + 3, jnp.int32), jcfg,
                            logits_mode="none")
    ph, _ = lm.decode_step(pp, _t(nxt), pc, start + 3, cfg,
                           logits_mode="none")
    _close(ph, jh, what="decode hidden")


@pytest.mark.parametrize("arch", [a for a in DECODER_ONLY
                                  if "moe" not in a and "llama4" not in a
                                  and "jamba" not in a])
def test_decode_continues_prefill_as_teacher_forcing(arch):
    """prefill -> extend_cache -> decode steps give the hidden states a
    full forward over the extended prefix gives (the reference's own
    check; MoE configs are left out, as there: decode capacity is per
    decode group)."""
    jcfg, cfg = _cfgs(arch)
    _, pp = _carry(arch)
    rng = np.random.default_rng(8)
    toks = _t(rng.integers(0, cfg.vocab, (B, S + 3)))
    _, caches = lm.prefill(pp, toks[:, :S], cfg)
    caches = lm.extend_cache(cfg, caches, 16)
    h_full, _, _ = lm.backbone_forward(pp, lm._embed(pp, toks, cfg),
                                       torch.arange(S + 3), cfg)
    for t in range(S, S + 3):
        h_dec, caches = lm.decode_step(pp, toks[:, t], caches, t, cfg,
                                       logits_mode="none")
        np.testing.assert_allclose(h_dec.float().numpy(),
                                   h_full[:, t].float().numpy(),
                                   atol=CONSISTENCY_TOL,
                                   rtol=CONSISTENCY_TOL)


def test_internvl2_prefill_with_patches_matches_reference():
    """Patch embeddings projected and prepended: the last hidden state and
    the caches (positions 0 .. num_patches + S - 1), then a decode step at
    position num_patches + S of the padded cache."""
    jcfg, cfg = _cfgs("internvl2_1b")
    jp, pp = _carry("internvl2_1b")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (B, S))
    patches = rng.standard_normal((B, cfg.num_patches, cfg.d_model)
                                  ).astype(np.float32)
    jh, jc = jprefill(jp, jnp.asarray(toks), jcfg, jnp.asarray(patches))
    ph, pc = lm.prefill(pp, _t(toks), cfg, _t(patches))
    assert pc[0].k.shape[2] == cfg.num_patches + S
    _close(ph, jh, what="prefill hidden")
    _close_caches(pc, jc, "prefill cache")
    jc = jlm.extend_cache(jcfg, jc, 32)
    pc = lm.extend_cache(cfg, pc, 32)
    nxt = rng.integers(0, cfg.vocab, (B,))
    pos = cfg.num_patches + S
    jh, _ = jdecode(jp, jnp.asarray(nxt), jc,
                            jnp.asarray(pos, jnp.int32), jcfg,
                            logits_mode="none")
    ph, _ = lm.decode_step(pp, _t(nxt), pc, pos, cfg, logits_mode="none")
    _close(ph, jh, what="decode hidden")


@pytest.fixture(scope="module", params=SERVED)
def served(request):
    jcfg, cfg = _cfgs(request.param)
    jp, pp = _carry(request.param)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (16, 8))
    exact = serve.BatchedServer(cfg, pp, max_seq=32, device="cpu"
                                ).generate(prompts, 3)
    return jcfg, cfg, jp, pp, prompts, exact


def test_first_token_equals_the_reference_server(served):
    """The exact servers of both packages on carried weights (recurrent
    caches and MoE layers through ``generate``): the first greedy token
    agrees wherever the reference's top-1 margin exceeds twice the logit
    tolerance, on at least a quarter of the rows (random reduced weights
    give small margins)."""
    jcfg, cfg, jp, pp, prompts, exact = served
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    want = np.asarray(jserve.BatchedServer(jcfg, jp, mesh, max_seq=32)
                      .generate(jnp.asarray(prompts), steps=1))[:, 0]
    h, _ = jprefill(jp, jnp.asarray(prompts), jcfg)
    logits = np.asarray(jnp.asarray(h, jnp.float32)
                        @ jlm._unembed_matrix(jp, jcfg).astype(jnp.float32))
    top2 = np.sort(logits[:, :cfg.vocab], axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL
    assert clear.sum() >= len(clear) // 4, clear
    np.testing.assert_array_equal(exact[:, 0].numpy()[clear], want[clear])


@pytest.mark.parametrize("engine", ["dense", "bucket", "fused"])
def test_lsh_heads_at_full_probe_equal_the_exact_server(served, engine):
    _, cfg, _, pp, prompts, exact = served
    vidx = lm_head.build_vocab_index(lm._unembed_matrix(pp, cfg),
                                     torch.Generator().manual_seed(5),
                                     code_len=64, num_ranges=16)
    server = serve.BatchedServer(cfg, pp, max_seq=32, device="cpu",
                                 lsh_decode=True, vocab_index=vidx,
                                 num_probe=cfg.padded_vocab, engine=engine)
    got = server.generate(prompts, 3)
    assert torch.equal(got, exact)
