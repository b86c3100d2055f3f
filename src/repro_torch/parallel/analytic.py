"""Analytic FLOP / HBM-byte estimators for the roofline terms (port of
``repro/parallel/analytic.py``, line for line: the same float arithmetic
on the same leaf sizes gives the reference's numbers).

A model that gives the same count whatever implements it: the yardstick a
step's measured time is held against (parallel/roofline.py). The
estimates are **implementation-true**:

  * matmul flops use exact parameter counts from the param tree (meta
    tensors included; active experts only for MoE),
  * attention flops model the flash implementation with its causal block
    skipping (``models/attention.py`` ``CAUSAL_BLOCK_SKIP``, always on in
    the port), so the train factor is 12·B·S·kv·H·hd (4 fwd + 8 bwd) over
    the kv blocks computed; the causal-credited MODEL_FLOPS counts half
    the S² square,
  * recurrent-state flops (mamba / mLSTM / sLSTM cells) are explicit —
    they are NOT proportional to params and dominate for d_state-heavy
    layers.

Byte estimates count HBM traffic per device per step:
  train: FSDP param gathers (fwd+bwd) + grad reduce + AdamW fp32 state RW
         + residual-stream activations (remat: 2 fwd passes + 1 bwd)
         + rematerialized logit chunks;
  decode: one full read of active params + KV/state cache read+write;
  prefill: param read + activation traffic.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.tree import flatten_with_keys

BF16 = 2
F32 = 4


def matmul_param_counts(cfg: ModelConfig, params: Any) -> Dict[str, float]:
    """Params that are matmul operands (>=2D, excluding the embed gather),
    total and MoE-active. Tied embeddings add one d*V logit matmul."""
    total = 0.0
    expert = 0.0
    embed = 0.0
    for keys, leaf in flatten_with_keys(params):
        name = keys[-1]
        if name == "embed":
            embed = float(leaf.numel())
            continue
        if leaf.dim() < 2:
            continue
        if any("ffn" in k for k in keys) and leaf.dim() >= 4:
            expert += leaf.numel()
        total += leaf.numel()
    if cfg.tie_embeddings:
        total += embed          # logit matmul reuses the embed table
    active = total
    if cfg.moe is not None and expert:
        active = total - expert + expert * cfg.moe.top_k / cfg.moe.num_experts
    return {"matmul_total": total, "matmul_active": active,
            "expert": expert, "embed": embed}


def _attn_layers(cfg: ModelConfig) -> Dict[str, float]:
    """Counts of attention layers by kind over the full depth."""
    n_local = n_global = n_mamba = n_mlstm = n_slstm = 0
    pat = cfg.layer_pattern
    for l in range(cfg.n_layers):
        k = pat[l % len(pat)]
        if k == "attn":
            if cfg.local_global_alternate and l % 2 == 0:
                n_local += 1
            else:
                n_global += 1
        elif k == "mamba":
            n_mamba += 1
        elif k == "mlstm":
            n_mlstm += 1
        elif k == "slstm":
            n_slstm += 1
    return {"local": n_local, "global": n_global, "mamba": n_mamba,
            "mlstm": n_mlstm, "slstm": n_slstm}


ATTN_CHUNK = 1024   # flash q/kv chunk (models/attention.py default)


def _attention_flops(cfg: ModelConfig, B: int, S: int, kind: str
                     ) -> Dict[str, float]:
    """Score+value flops: ``impl`` models OUR flash implementation
    (CAUSAL_BLOCK_SKIP-aware), ``ideal`` is the causal-credited
    MODEL_FLOPS reference."""
    from repro_torch.models.attention import CAUSAL_BLOCK_SKIP

    hd = cfg.resolved_head_dim
    H = cfg.n_heads
    if cfg.mla is not None:
        hd = (cfg.mla.nope_dim + cfg.mla.rope_dim + cfg.mla.v_dim) / 2.0
    layers = _attn_layers(cfg)
    win = cfg.local_window
    factor = {"train": 12.0, "prefill": 4.0, "decode": 4.0}[kind]

    def ctx(n_layers, s_q, kv_len):
        # fwd: 2 matmuls (QK^T, PV) x 2 flops/MAC = 4; bwd adds 8.
        return factor * n_layers * B * s_q * kv_len * H * hd

    if kind == "decode":
        kv_l = min(win, S) if win else S
        impl = ctx(layers["global"], 1.0, S) + ctx(layers["local"], 1.0,
                                                   kv_l)
        return {"impl": impl, "ideal": impl}

    nq = max(1, S // ATTN_CHUNK)
    if CAUSAL_BLOCK_SKIP:
        kv_g_impl = S * (nq + 1) / (2.0 * nq)
        kv_l_impl = min(S, (win or S) + ATTN_CHUNK)
    else:
        kv_g_impl = float(S)     # every block computed, mask-only
        kv_l_impl = float(S)
    impl = ctx(layers["global"], S, kv_g_impl) + ctx(layers["local"], S,
                                                     kv_l_impl)
    ideal = ctx(layers["global"], S, S / 2.0) + ctx(
        layers["local"], S, min(win or S, S))
    return {"impl": impl, "ideal": ideal}


def _state_flops(cfg: ModelConfig, B: int, S: int, kind: str) -> float:
    """Recurrent cell flops (not captured by param counts)."""
    layers = _attn_layers(cfg)
    per_token = 0.0
    if layers["mamba"] and cfg.ssm:
        d_inner = cfg.ssm.expand * cfg.d_model
        per_token += layers["mamba"] * 10.0 * d_inner * cfg.ssm.d_state
    if layers["mlstm"] and cfg.xlstm:
        d_inner = int(cfg.xlstm.proj_factor * cfg.d_model)
        d_v = d_inner // cfg.n_heads
        d_qk = int(d_v * cfg.xlstm.qk_dim_factor)
        per_token += layers["mlstm"] * 8.0 * cfg.n_heads * d_qk * d_v
    if layers["slstm"]:
        per_token += layers["slstm"] * 12.0 * cfg.d_model
    tokens = B * (S if kind != "decode" else 1)
    mult = 3.0 if kind == "train" else 1.0
    return per_token * tokens * mult


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    layers = _attn_layers(cfg)
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        per_tok = cfg.mla.kv_rank + cfg.mla.rope_dim
    else:
        per_tok = 2 * cfg.n_kv * hd
    att = (layers["global"] + layers["local"]) * B * S * per_tok * BF16
    if cfg.is_encoder_decoder:
        att += cfg.n_layers * B * cfg.encoder_frames * 2 * cfg.n_kv * hd * BF16
    state = 0.0
    if layers["mamba"] and cfg.ssm:
        d_inner = cfg.ssm.expand * cfg.d_model
        state += layers["mamba"] * B * d_inner * cfg.ssm.d_state * F32
    if layers["mlstm"] and cfg.xlstm:
        d_inner = int(cfg.xlstm.proj_factor * cfg.d_model)
        d_v = d_inner // cfg.n_heads
        d_qk = int(d_v * cfg.xlstm.qk_dim_factor)
        state += layers["mlstm"] * B * cfg.n_heads * d_qk * d_v * F32
    if layers["slstm"]:
        state += layers["slstm"] * B * 4 * cfg.d_model * F32
    return att + state


def estimate(cfg: ModelConfig, shape: ShapeConfig, params: Any,
             chips: int) -> Dict[str, float]:
    """Analytic per-step global flops + per-device HBM bytes."""
    counts = matmul_param_counts(cfg, params)
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    tokens = B * (S if kind != "decode" else 1)
    if cfg.num_patches:
        tokens += B * (cfg.num_patches if kind != "decode" else 0)
    if cfg.is_encoder_decoder and kind != "decode":
        tokens += B * cfg.encoder_frames   # encoder side

    mm_flops_per_tok = 2.0 * counts["matmul_active"]
    mult = 3.0 if kind == "train" else 1.0
    matmul_flops = mult * mm_flops_per_tok * tokens
    attn = _attention_flops(cfg, B, S, kind)
    attn_flops = attn["impl"]
    state_flops = _state_flops(cfg, B, S, kind)
    flops = matmul_flops + attn_flops + state_flops

    # MODEL_FLOPS per the brief: 6 N D (train) / 2 N D (inference), causal
    # attention credited at half (the "ideal" attention term).
    model_flops = mult * mm_flops_per_tok * tokens + attn["ideal"] + \
        state_flops

    # --- HBM bytes per device ---
    N = counts["matmul_total"] + counts["embed"] * (
        0.0 if cfg.tie_embeddings else 1.0)
    act_unit = tokens * cfg.d_model * BF16
    if kind == "train":
        param_traffic = N * (BF16 * 2          # fsdp gather fwd + bwd
                             + BF16            # grad reduce
                             + F32 * 4         # adamw mu/nu read+write
                             + F32 + BF16)     # master read, param write
        act_traffic = act_unit * 6.0 * cfg.n_layers   # remat: ~2 fwd + bwd
        logit_traffic = tokens * cfg.padded_vocab * F32 * 2.0  # fwd + remat
        total = param_traffic + act_traffic + logit_traffic
    elif kind == "prefill":
        param_traffic = N * BF16
        act_traffic = act_unit * 3.0 * cfg.n_layers
        total = param_traffic + act_traffic + _cache_bytes(cfg, B, S)
    else:
        active_bytes = counts["matmul_active"] * BF16 + (
            0 if cfg.tie_embeddings else 0)
        total = active_bytes + _cache_bytes(cfg, B, S) \
            + tokens * cfg.padded_vocab * F32   # logits
    return {
        "flops": flops,
        "model_flops": model_flops,
        "matmul_flops": matmul_flops,
        "attn_flops": attn_flops,
        "state_flops": state_flops,
        "hbm_bytes_per_device": total / chips,
        "tokens": float(tokens),
        **counts,
    }
