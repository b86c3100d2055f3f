"""DeepSeek-V2-Lite in the port (``configs/deepseek_v2_lite.py``: MLA
without query compression, YaRN, a leading dense layer, 64 experts top-6
with unrenormalised gates, dropless routing and two shared experts as one
SwiGLU) against the benchmark's plain reference
(``mipsbench/reference/deepseek_v2_lite.py``), at ``reduced()`` size with 8
routed experts and top-3 (so that unrenormalised gates matter), on seeded
random weights.

Tolerances: on float32 copies of the weights the port's prefill and its
decode steps through float32 caches run the reference's products in
another order (chunked online softmax, the absorbed latent form, a
grouped product), so each position's hidden state and logits lie within
1e-4 of the reference's, relative to their norm (float32 rounding is
6e-8 a product, a few hundred products deep). Through the server the
latent cache is bf16, as served: each cached value is rounded to 2^-9
relative, and the hidden state moves by up to a few 1e-3 relative (2e-2
allowed). Each planted fault moves the result by far more than either.
"""

import dataclasses
import math

import pytest
import torch

from mipsbench.reference import deepseek_v2_lite as ref
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.models import attention, common, lm
from repro_torch.parallel import sharding

F32_REL = 1e-4
CACHE_REL = 2e-2
B, S, STEPS = 2, 12, 3


def _small(**moe):
    cfg = base.get_config("deepseek_v2_lite").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8, top_k=3, **moe))


def _source_keys(cfg) -> dict:
    """The configuration in its source's key names, as the reference reads
    it (the published values where the port's config has them)."""
    m, moe, ys = cfg.mla, cfg.moe, cfg.rope_scaling
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "kv_lora_rank": m.kv_rank, "q_lora_rank": m.q_rank,
        "qk_nope_head_dim": m.nope_dim, "qk_rope_head_dim": m.rope_dim,
        "v_head_dim": m.v_dim, "rope_theta": cfg.rope_theta,
        "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32,
                         "beta_slow": 1, "mscale": 0.707,
                         "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096},
        "rms_norm_eps": cfg.norm_eps, "first_k_dense_replace": 1,
        "num_hidden_layers": cfg.n_layers, "vocab_size": cfg.vocab,
        "intermediate_size": cfg.d_ff, "n_routed_experts": 8,
        "num_experts_per_tok": 3, "moe_intermediate_size": 32,
        "n_shared_experts": 2, "norm_topk_prob": False,
        "routed_scaling_factor": 1,
    }


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.to(torch.float32)


def _params(cfg, seed=0):
    return lm.init_params(torch.Generator().manual_seed(seed), cfg,
                          device="cpu")


def _rel(got, want):
    return float((torch.linalg.vector_norm(got - want, dim=-1)
                  / torch.linalg.vector_norm(want, dim=-1)).max())


def _tokens(cfg, seed=1, length=S + STEPS):
    return torch.randint(0, cfg.vocab, (B, length),
                         generator=torch.Generator().manual_seed(seed))


def _port_gaps(cfg, params, tokens):
    """The port's prefill of the first S tokens then decode steps through
    float32 caches, against the reference's full forward of each
    sequence: (largest hidden gap, largest logit gap)."""
    last, caches = lm.prefill(params, tokens[:, :S], cfg)
    caches = lm.extend_cache(cfg, caches, S + STEPS)
    hidden = [last]
    for t in range(S, S + STEPS - 1):
        h, caches = lm.decode_step(params, tokens[:, t], caches, t, cfg,
                                   logits_mode="none")
        hidden.append(h)
    hidden = torch.stack(hidden, 1).float()              # (B, STEPS, d)
    gaps = [0.0, 0.0]
    at = torch.arange(S - 1, S + STEPS - 1)
    for b in range(B):
        h_ref, l_ref = ref.forward(params, tokens[b, :S + STEPS - 1],
                                   _source_keys(cfg), positions=at)
        logits = hidden[b] @ params["unembed"][:, :cfg.vocab].float()
        gaps = [max(gaps[0], _rel(hidden[b], h_ref)),
                max(gaps[1], _rel(logits, l_ref))]
    return gaps


def test_config_keeps_every_published_setting():
    cfg = base.get_config("deepseek_v2_lite")
    assert "deepseek_v2_lite" not in base.ARCH_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab, cfg.d_ff) == \
        (27, 2048, 16, 102400, 10944)
    assert cfg.mla == base.MLAConfig(q_rank=None, kv_rank=512, nope_dim=128,
                                     rope_dim=64, v_dim=128)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff,
            cfg.moe.shared_d_ff, cfg.moe.norm_topk, cfg.moe.dropless) == \
        (64, 6, 1408, 2816, False, True)
    assert cfg.first_dense == 1 and cfg.stacked_layers == 26
    assert cfg.norm_eps == 1e-6 and cfg.rope_scaling.factor == 40
    small = cfg.reduced()
    assert small.mla.q_rank is None and small.first_dense == 1
    assert small.rope_scaling == cfg.rope_scaling
    assert small.moe.dropless and not small.moe.norm_topk
    assert small.moe.shared_d_ff == 2 * small.moe.d_ff


def test_yarn_at_the_published_numbers():
    cfg = base.get_config("deepseek_v2_lite")
    ys = cfg.rope_scaling
    assert common.yarn_mscale(40, 0.707) == pytest.approx(1.26081, abs=1e-5)
    assert common.yarn_softmax_factor(ys) == pytest.approx(1.58963,
                                                           abs=1e-5)
    assert common.yarn_cos_sin_factor(ys) == 1.0
    assert attention.mla_softmax_scale(cfg) == pytest.approx(
        192 ** -0.5 * 1.2608037774 ** 2, rel=1e-9)
    freqs = common.yarn_freqs(64, 1e4, ys)
    base_f = common.rope_freqs(64, 1e4)
    ramp = torch.clamp((torch.arange(32.0) - 10) / 13, 0, 1)
    torch.testing.assert_close(freqs, base_f / 40 * ramp + base_f * (1 - ramp))
    assert torch.equal(freqs[:11], base_f[:11])
    torch.testing.assert_close(freqs[23:], base_f[23:] / 40)
    # the reference's tables at the served positions: its frequencies are
    # 1 / theta^(2i/64), the port's theta^(-i/32), equal to float32
    # rounding (6e-8 relative), which an angle of up to 9,216 radians
    # turns into up to ~1e-3 radians
    pos = torch.arange(0, 9216, 97)
    cos, sin = ref.rope_tables(_source_keys(cfg), pos)
    ang = pos[:, None].float() * freqs
    torch.testing.assert_close(cos, torch.cos(ang), rtol=0, atol=1e-3)
    torch.testing.assert_close(sin, torch.sin(ang), rtol=0, atol=1e-3)


def test_prefill_then_decode_matches_the_reference():
    cfg = _small()
    params = _f32(_params(cfg))
    hidden_gap, logit_gap = _port_gaps(cfg, params, _tokens(cfg))
    assert hidden_gap < F32_REL and logit_gap < F32_REL


def test_one_expert_set_for_every_token_matches_the_reference():
    """A zero router: every probability 1/8, so every token routes to
    experts 0, 1 and 2 (ties to the lower id), with gates of 1/8 each."""
    cfg = _small()
    params = _f32(_params(cfg))
    params["pos0"]["ffn"]["router"].zero_()
    hidden_gap, logit_gap = _port_gaps(cfg, params, _tokens(cfg))
    assert hidden_gap < F32_REL and logit_gap < F32_REL


def test_server_prefills_in_chunks_and_steps_like_the_reference(
        monkeypatch):
    """``BatchedServer.prefill`` a sequence a chunk into bf16 caches, then
    ``step``: the exact head's top-k of each step are the top-k of the
    step's logits, and the step's logits lie within the bf16 cache's
    rounding of the reference's."""
    monkeypatch.setattr(serve, "PREFILL_TOKENS", S)
    cfg = _small()
    params = _f32(_params(cfg))
    tokens = _tokens(cfg)
    server = serve.BatchedServer(cfg, params, max_seq=S + STEPS, batch=B,
                                 device="cpu")
    hidden, caches = server.prefill(tokens[:, :S], tail=2)
    assert hidden.shape == (B, 2, cfg.d_model)
    assert caches[0].k.dtype == torch.bfloat16
    logits = []
    for t in range(S, S + STEPS - 1):
        out = server.step(tokens[:, t], caches, t, k=4)
        assert out.ids.shape == (B, 4) and out.hidden is None
        logits.append(out.vals)
    at = torch.arange(S, S + STEPS - 1)
    for b in range(B):
        _, l_ref = ref.forward(params, tokens[b, :S + STEPS - 1],
                               _source_keys(cfg), positions=at)
        top = torch.topk(l_ref, 4, dim=-1).values
        assert _rel(torch.stack([v[b] for v in logits]), top) < CACHE_REL
        torch.testing.assert_close(hidden[b, -1].float(), ref.forward(
            params, tokens[b, :S], _source_keys(cfg),
            positions=torch.tensor([S - 1]))[0][0], rtol=CACHE_REL,
            atol=CACHE_REL)


def test_exact_step_top1_is_the_first_of_its_top_k():
    """The exact head's one-token step (an argmax) answers the first of
    its k-token step's answers, ties to the lower id as both keep them."""
    cfg = _small()
    params = _params(cfg)
    tokens = _tokens(cfg)
    server = serve.BatchedServer(cfg, params, max_seq=S + 1, batch=B,
                                 device="cpu")
    _, caches = server.prefill(tokens[:, :S])
    one = server.step(tokens[:, S], caches, S, k=1)
    four = server.step(tokens[:, S], caches, S, k=4)
    assert torch.equal(one.ids, four.ids[:, :1])
    assert torch.equal(one.vals, four.vals[:, :1])


def test_a_tracker_set_later_reaches_the_fused_head():
    """``server.tracker`` set after construction is handed to the fused
    head's engine (which carried none of its own), so a step records the
    engine's stage spans beside the model's, and taken away again with
    None; an engine given its own tracker keeps it. On the CPU the step
    runs eagerly (a graph is the card's)."""
    from repro_torch.models import lm_head
    from repro_torch.obs import Tracker
    from repro_torch.obs.sinks import RingBufferSink
    cfg = _small()
    params = _params(cfg)
    tokens = _tokens(cfg)
    unembed = lm._unembed_matrix(params, cfg)
    vidx = lm_head.build_vocab_index(unembed, torch.Generator()
                                     .manual_seed(4), code_len=64,
                                     num_ranges=8)
    server = serve.BatchedServer(
        cfg, params, max_seq=S + 2, batch=B, lsh_decode=True,
        engine="fused", vocab_index=vidx, num_probe=cfg.padded_vocab,
        device="cpu")
    assert lm.decode_capturable(cfg) and not server._capturable
    _, caches = server.prefill(tokens[:, :S])
    sink = RingBufferSink()
    server.tracker = Tracker([sink])
    assert server._fused_eng.tracker is server.tracker
    server.step(tokens[:, S], caches, S, k=4)
    names = {r["name"] for r in sink.query(type="span")}
    assert {"repro.serve.decode_step", "repro.serve.topk_head",
            "repro.engine.query", "repro.engine.fused_query",
            "repro.model.attn", "repro.model.moe"} <= names
    server.tracker = None
    assert server._fused_eng.tracker is None
    own = Tracker()
    server._fused_eng.tracker = own
    server.tracker = Tracker()
    assert server._fused_eng.tracker is own


def test_dropless_dispatch_runs_every_slot_at_decode():
    """At decode a 64-token group with every token on experts 0-2 would
    drop slots under a capacity (8 a group at the published sizes); the
    dropless layer computes them all and counts none dropped."""
    from repro_torch.models import moe
    from repro_torch.obs import Tracker
    cfg = _small()
    p = _f32(_params(cfg))["pos0"]["ffn"]
    p = {k: v[0] for k, v in p.items()}
    p["router"].zero_()
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    tracker = Tracker()
    out, _ = moe.moe_forward(p, x, cfg, tracker)
    h = x[0]
    want = ref.swiglu(h, p["s_gate"], p["s_up"], p["s_down"]) + sum(
        ref.swiglu(h, p["w_gate"][e], p["w_up"][e], p["w_down"][e]) / 8
        for e in range(3))
    torch.testing.assert_close(out[0], want, rtol=1e-5, atol=1e-5)
    assert tracker.counters["repro.model.moe.dropped_tokens"] == 0
    assert tracker.counters["repro.model.moe.routed_tokens"] == 64 * 3
    assert tracker.counters["repro.model.moe.touched_experts"] == 3
    assert tracker.gauges["repro.model.moe.max_expert_tokens"] == 64
    capped = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    tracker = Tracker()
    moe.moe_forward(p, x, capped, tracker)
    assert tracker.counters["repro.model.moe.dropped_tokens"] > 0


def _planted_fault_fails(cfg, params, tokens):
    """True when the reference refuses the tree (a width or a weight the
    published model does not have) or the port's gaps exceed a hundred
    times the float32 tolerance."""
    try:
        gaps = _port_gaps(cfg, params, tokens)
    except ValueError:
        return True
    return max(gaps) > 100 * F32_REL


@pytest.mark.parametrize("fault", ["renormalised_gates",
                                   "one_shared_expert", "no_mscale",
                                   "capacity_drop", "query_compression"])
def test_each_planted_fault_fails(fault, monkeypatch):
    cfg, zero_router = _small(), fault == "capacity_drop"
    if fault == "renormalised_gates":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, norm_topk=True))
    elif fault == "one_shared_expert":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, shared_d_ff=None))
    elif fault == "no_mscale":
        monkeypatch.setattr(attention, "yarn_softmax_factor", lambda y: 1.0)
    elif fault == "capacity_drop":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.25))
    elif fault == "query_compression":
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, q_rank=24))
    params = _f32(_params(cfg))
    if zero_router:
        params["pos0"]["ffn"]["router"].zero_()
    assert _planted_fault_fails(cfg, params, _tokens(cfg))


def test_reference_refuses_a_tree_of_other_widths():
    cfg = _small()
    params = _f32(_params(cfg))
    keys = _source_keys(cfg) | {"n_shared_experts": 1}
    with pytest.raises(ValueError, match="pos0/ffn/s_"):
        ref.forward(params, _tokens(cfg)[0], keys)


def test_mesh_layout_refuses_a_leading_dense_layer():
    cfg = _small()
    with pytest.raises(NotImplementedError, match="leading dense"):
        sharding.param_specs(lm.init_params(None, cfg, device="meta"), cfg)


def test_the_ten_keep_their_trees():
    """No config of the reference's ten grows a ``lead`` stack, and its
    cache tuple has one entry a pattern position."""
    for arch in base.ARCH_IDS:
        cfg = base.get_config(arch).reduced()
        assert cfg.first_dense == 0 and cfg.rope_scaling is None
        if cfg.is_encoder_decoder:
            continue
        tree = lm.init_params(None, cfg, device="meta")
        assert "lead" not in tree
        assert len(lm.cache_kinds(cfg)) == lm.combined_period(cfg)


def test_yarn_moves_the_rope_and_mscale_the_scores():
    """YaRN's frequencies differ from the plain ones past the ramp's
    start, and the decode's scores carry mscale squared."""
    cfg = _small()
    plain = dataclasses.replace(cfg, rope_scaling=None)
    assert attention.mla_softmax_scale(cfg) == pytest.approx(
        attention.mla_softmax_scale(plain) * 1.2608037774 ** 2)
    x = torch.randn(1, 5, 1, 4, generator=torch.Generator().manual_seed(4))
    pos = torch.arange(100, 105)
    assert not torch.allclose(common.apply_rope(x, pos, 1e4, cfg.rope_scaling),
                              common.apply_rope(x, pos, 1e4))
    assert math.isclose(common.yarn_cos_sin_factor(cfg.rope_scaling), 1.0)
