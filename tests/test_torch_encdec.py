"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper) and
the attention arms it needs (``gqa_forward``'s ``use_rope=False`` and
``kv_override``) against the JAX package, at ``reduced()`` sizes (2
encoder and 2 decoder layers, 8 frames) on the reference's bf16 weights
carried by ``convert.lm_params_from_tree``.

Tolerances: attention on f32 inputs within atol 2e-5 (f32 sums in another
order); the bf16 stack within atol and rtol 3e-2 (``BF16_TOL``), and the
decoder's steps against its full forward within 5e-2, the reference's own
check (``tests/test_models.py``). The serving loop is the reference's:
``encoder_forward`` -> ``cross_kv`` -> ``decode_step(logits_mode="none")``
with the head on the hidden state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models import lm_head as jhead
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.models import attention, encdec, lm, lm_head

F32_ATOL = 2e-5
BF16_TOL = 3e-2
CONSISTENCY_TOL = 5e-2
LOGIT_ATOL = 5e-2
B, S = 2, 8


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def whisper():
    """(reference cfg, port cfg, reference params, port params, frames,
    the reference's encoder output, the port's)."""
    jcfg = jbase.get_config("whisper_small").reduced()
    cfg = base.get_config("whisper_small").reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pp = convert.lm_params_from_tree(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    frames = (0.1 * np.random.default_rng(2).standard_normal(
        (B, cfg.encoder_frames, cfg.d_model))).astype(np.float32)
    jenc = jencdec.encoder_forward(jp["encoder"], jnp.asarray(frames), jcfg)
    penc = encdec.encoder_forward(pp["encoder"], _t(frames), cfg)
    return jcfg, cfg, jp, pp, frames, jenc, penc


@pytest.mark.parametrize("use_rope,override", [
    (False, False), (True, True), (False, True)])
def test_gqa_forward_arms_match_reference(whisper, use_rope, override):
    """Rope-free bidirectional self-attention (the encoder's) and
    cross-attention over external K/V at their own positions (the
    decoder's: the query roped, the keys not), on f32 weights."""
    jcfg, cfg, jp, _, _, _, _ = whisper
    jl = jax.tree.map(lambda a: a[0].astype(jnp.float32),
                      jp["layers"]["cross_attn"])
    pl = {k: _t(_np(v)) for k, v in jl.items()}
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, 5, cfg.d_model)) / 2).astype(np.float32)
    pos = np.arange(5) + 3
    kw, pkw = {}, {}
    if override:
        hd = cfg.resolved_head_dim
        k = rng.standard_normal((B, 11, cfg.n_kv, hd)).astype(np.float32)
        v = rng.standard_normal((B, 11, cfg.n_kv, hd)).astype(np.float32)
        kw = dict(kv_override=(jnp.asarray(k), jnp.asarray(v)),
                  kv_positions=jnp.arange(11))
        pkw = dict(kv_override=(_t(k), _t(v)), kv_positions=torch.arange(11))
    jo, jc = jattn.gqa_forward(jl, jnp.asarray(x), jnp.asarray(pos), jcfg,
                               layer_is_local=False, causal=False,
                               use_rope=use_rope, **kw)
    po, pc = attention.gqa_forward(pl, _t(x), _t(pos), cfg,
                                   layer_is_local=False, causal=False,
                                   use_rope=use_rope, **pkw)
    np.testing.assert_allclose(po.numpy(), _np(jo), atol=F32_ATOL)
    np.testing.assert_allclose(pc.k.numpy(), _np(jc.k), atol=F32_ATOL)


def test_encoder_and_cross_kv_match_reference(whisper):
    jcfg, cfg, jp, pp, _, jenc, penc = whisper
    np.testing.assert_allclose(penc.float().numpy(), _np(jenc),
                               atol=BF16_TOL, rtol=BF16_TOL)
    # cross K/V from the same encoder output: the layers' projections
    ck, cv = encdec.cross_kv(pp["layers"], _t(_np(jenc)).to(torch.bfloat16),
                             cfg)
    jk, jv = jencdec.cross_kv(jp["layers"], jenc, jcfg)
    assert tuple(ck.shape) == jk.shape == (cfg.n_layers, B,
                                           cfg.encoder_frames, cfg.n_kv,
                                           cfg.resolved_head_dim)
    np.testing.assert_allclose(ck.float().numpy(), _np(jk), atol=BF16_TOL,
                               rtol=BF16_TOL)
    np.testing.assert_allclose(cv.float().numpy(), _np(jv), atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_decoder_forward_matches_reference(whisper):
    """The decoder over a token sequence against the reference's encoder
    output: the final-normed hidden states and the self-attention
    caches."""
    jcfg, cfg, jp, pp, _, jenc, _ = whisper
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S))
    jh, jc = jencdec.decoder_forward(jp, jnp.asarray(toks), jenc, jcfg)
    ph, pc = encdec.decoder_forward(pp, _t(toks),
                                    _t(_np(jenc)).to(torch.bfloat16), cfg)
    np.testing.assert_allclose(ph.float().numpy(), _np(jh), atol=BF16_TOL,
                               rtol=BF16_TOL)
    np.testing.assert_allclose(pc.k.float().numpy(), _np(jc.k),
                               atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(pc.v.float().numpy(), _np(jc.v),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_decode_steps_equal_the_decoder_forward(whisper):
    """Step-by-step decode from empty self-attention caches gives the
    full decoder's hidden states (the reference's own check,
    tests/test_models.py), in the port."""
    _, cfg, _, pp, _, _, penc = whisper
    toks = _t(np.random.default_rng(5).integers(0, cfg.vocab, (B, S + 1)))
    h_full, _ = encdec.decoder_forward(pp, toks, penc, cfg)
    caches = encdec.init_cache(cfg, B, S + 4, device="cpu")
    caches["cross_k"], caches["cross_v"] = encdec.cross_kv(pp["layers"],
                                                           penc, cfg)
    for t in range(S + 1):
        h, caches = lm.decode_step(pp, toks[:, t], caches, t, cfg,
                                   logits_mode="none")
        np.testing.assert_allclose(h.float().numpy(),
                                   h_full[:, t].float().numpy(),
                                   atol=CONSISTENCY_TOL,
                                   rtol=CONSISTENCY_TOL)


def test_serving_loop_and_heads_match_reference(whisper):
    """Whisper's serving path in both packages: the encoder, cross K/V,
    then greedy decode steps with the head on the hidden state. The
    reference's greedy tokens are fed to both (teacher forcing), so the
    hidden states compare step by step; the port's exact head gives the
    reference's token wherever the reference's top-1 margin exceeds twice
    the logit tolerance, and the port's LSH dense head at num_probe = V
    gives the port's exact head's tokens."""
    jcfg, cfg, jp, pp, _, jenc, penc = whisper
    junembed, unembed = jp["unembed"], pp["unembed"]
    vidx = lm_head.build_vocab_index(unembed,
                                     torch.Generator().manual_seed(5),
                                     code_len=64, num_ranges=16)
    jc = jencdec.init_cache(jcfg, B, 16)
    jc["cross_k"], jc["cross_v"] = jencdec.cross_kv(jp["layers"], jenc, jcfg)
    pc = encdec.init_cache(cfg, B, 16, device="cpu")
    pc["cross_k"], pc["cross_v"] = encdec.cross_kv(pp["layers"], penc, cfg)
    tok = np.zeros((B,), np.int64)
    clear_rows = 0
    for t in range(6):
        jh, jc = jencdec.decode_step(jp, jnp.asarray(tok), jc,
                                     jnp.asarray(t, jnp.int32), jcfg,
                                     logits_mode="none")
        ph, pc = lm.decode_step(pp, _t(tok), pc, t, cfg, logits_mode="none")
        np.testing.assert_allclose(ph.float().numpy(), _np(jh),
                                   atol=BF16_TOL, rtol=BF16_TOL)
        jv, ji = jhead.exact_topk_tokens(jh, junembed, 2,
                                         true_vocab=jcfg.vocab)
        _, pi = lm_head.exact_topk_tokens(ph, unembed, 1,
                                          true_vocab=cfg.vocab)
        _, li = lm_head.lsh_topk_tokens(vidx, ph, unembed, k=1,
                                        num_probe=cfg.padded_vocab,
                                        true_vocab=cfg.vocab)
        np.testing.assert_array_equal(li.numpy(), pi.numpy())
        jv, ji = np.asarray(jv), np.asarray(ji)
        clear = (jv[:, 0] - jv[:, 1]) > 2 * LOGIT_ATOL
        np.testing.assert_array_equal(pi[:, 0].numpy()[clear], ji[clear, 0])
        clear_rows += int(clear.sum())
        tok = ji[:, 0]
    assert clear_rows >= 3, clear_rows


def test_audio_decoder_only_layer_matches_reference(whisper):
    """``lm``'s audio arms on their own (the reference dispatches them for
    an audio config outside the encoder-decoder): rope-free attention and
    the tanh-GELU MLP: one layer's output and cache."""
    jcfg, cfg, _, _, _, _, _ = whisper
    jl = jlm.layer_init(jax.random.PRNGKey(6), jcfg, 0)
    pl = convert.lm_params_from_tree(jax.tree.map(np.asarray, jl),
                                     device="cpu")
    assert sorted(pl["ffn"]) == ["b_in", "b_out", "w_in", "w_out"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    jo, jc, _ = jlm.layer_forward(jl, jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(pos), jcfg, 0)
    po, pc, _ = lm.layer_forward(pl, _t(x).to(torch.bfloat16), _t(pos), cfg,
                                 0)
    np.testing.assert_allclose(po.float().numpy(), _np(jo), atol=BF16_TOL,
                               rtol=BF16_TOL)
    np.testing.assert_allclose(pc.k.float().numpy(), _np(jc.k),
                               atol=BF16_TOL, rtol=BF16_TOL)
