"""Encoder-decoder backbone, whisper-small (port of
``repro/models/encdec.py``).

The audio frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (B, frames, d). Encoder = bidirectional
rope-free attention blocks over a learned position table; decoder = causal
self-attention (RoPE) + cross-attention + GELU MLP (the tanh
approximation, ``jax.nn.gelu``'s default).

Cross-attention K/V are computed once from the encoder output and stay
fixed while decoding; the decoder's self-attention caches behave as the
LM's, written in place. Layers are stacked on a leading axis, as the
reference's vmapped init stacks them, and run as a loop over it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (PARAM_DTYPE, dense_init, embed_init,
                                       embed_lookup, rms_norm, unstack)
from repro_torch.parallel.sharding import constrain_batch_leading

PyTree = Any


def _mlp_init(generator: torch.Generator, cfg: ModelConfig,
              stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    dev = generator.device
    return {"w_in": dense_init(generator, stack + (cfg.d_model, cfg.d_ff)),
            "b_in": torch.zeros(stack + (cfg.d_ff,), dtype=PARAM_DTYPE,
                                device=dev),
            "w_out": dense_init(generator, stack + (cfg.d_ff, cfg.d_model)),
            "b_out": torch.zeros(stack + (cfg.d_model,), dtype=PARAM_DTYPE,
                                 device=dev)}


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.gelu(x @ p["w_in"] + p["b_in"],
                                 approximate="tanh")
    return h @ p["w_out"] + p["b_out"]


def _norm(generator: torch.Generator, cfg: ModelConfig,
          stack: Tuple[int, ...]) -> torch.Tensor:
    return torch.zeros(stack + (cfg.d_model,), dtype=torch.float32,
                       device=generator.device)


def encoder_init(generator: torch.Generator, cfg: ModelConfig) -> PyTree:
    L = (cfg.encoder_layers,)
    pos = torch.randn((cfg.encoder_frames, cfg.d_model), generator=generator,
                      dtype=torch.float32, device=generator.device)
    return {
        "pos_table": (0.02 * pos).to(PARAM_DTYPE),
        "layers": {"norm1": _norm(generator, cfg, L),
                   "attn": attn.attn_init(generator, cfg, L),
                   "norm2": _norm(generator, cfg, L),
                   "mlp": _mlp_init(generator, cfg, L)},
        "final_norm": _norm(generator, cfg, ()),
    }


def decoder_layer_init(generator: torch.Generator, cfg: ModelConfig,
                       stack: Tuple[int, ...] = ()) -> PyTree:
    return {"norm1": _norm(generator, cfg, stack),
            "self_attn": attn.attn_init(generator, cfg, stack),
            "norm_x": _norm(generator, cfg, stack),
            "cross_attn": attn.attn_init(generator, cfg, stack),
            "norm2": _norm(generator, cfg, stack),
            "mlp": _mlp_init(generator, cfg, stack)}


def init_params(generator: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Random params drawn from ``generator`` on its device: the
    reference's tree, decoder and encoder layers stacked."""
    return {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model),
        "encoder": encoder_init(generator, cfg),
        "layers": decoder_layer_init(generator, cfg, (cfg.n_layers,)),
        "final_norm": _norm(generator, cfg, ()),
        "unembed": dense_init(generator, (cfg.d_model, cfg.padded_vocab)),
    }


def encoder_forward(p, frames: torch.Tensor, cfg: ModelConfig
                    ) -> torch.Tensor:
    """frames: (B, F, d) precomputed embeddings (stub frontend)."""
    F = frames.shape[1]
    h = frames.to(PARAM_DTYPE) + p["pos_table"][None, :F]
    positions = torch.arange(F, device=frames.device)
    for lp in unstack(p["layers"], cfg.encoder_layers):
        a, _ = attn.gqa_forward(lp["attn"],
                                rms_norm(h, lp["norm1"], cfg.norm_eps),
                                positions, cfg, layer_is_local=False,
                                causal=False, use_rope=False)
        h = h + a
        h = h + _mlp(lp["mlp"], rms_norm(h, lp["norm2"], cfg.norm_eps))
    return rms_norm(h, p["final_norm"], cfg.norm_eps)


def cross_kv(p_layers, enc: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-decoder-layer cross K/V, each (L, B, F, KV, hd)."""
    hd = cfg.resolved_head_dim
    B, F = enc.shape[:2]
    ks, vs = [], []
    for lp in unstack(p_layers, cfg.n_layers):
        ks.append((enc @ lp["cross_attn"]["w_k"]).reshape(B, F, cfg.n_kv,
                                                          hd))
        vs.append((enc @ lp["cross_attn"]["w_v"]).reshape(B, F, cfg.n_kv,
                                                          hd))
    return torch.stack(ks), torch.stack(vs)


def decoder_forward(p, tokens: torch.Tensor, enc: torch.Tensor,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, attn.AttnCache]:
    """The decoder over ``tokens`` (B, S) against the encoder output:
    (final-normed hidden (B, S, d), self-attention caches stacked over
    layers)."""
    S = tokens.shape[1]
    h = embed_lookup(tokens, p["embed"])
    positions = torch.arange(S, device=tokens.device)
    kv_pos = torch.arange(enc.shape[1], device=tokens.device)
    ck, cv = cross_kv(p["layers"], enc, cfg)
    caches = []
    for i, lp in enumerate(unstack(p["layers"], cfg.n_layers)):
        h = constrain_batch_leading(h)      # residual-stream anchor
        a, cache = attn.gqa_forward(
            lp["self_attn"], rms_norm(h, lp["norm1"], cfg.norm_eps),
            positions, cfg, layer_is_local=False, causal=True)
        h = h + a
        c, _ = attn.gqa_forward(
            lp["cross_attn"], rms_norm(h, lp["norm_x"], cfg.norm_eps),
            positions, cfg, layer_is_local=False, causal=False,
            use_rope=True, kv_override=(ck[i], cv[i]), kv_positions=kv_pos)
        h = h + c
        h = h + _mlp(lp["mlp"], rms_norm(h, lp["norm2"], cfg.norm_eps))
        caches.append(cache)
    caches = attn.AttnCache(torch.stack([c.k for c in caches]),
                            torch.stack([c.v for c in caches]))
    return rms_norm(h, p["final_norm"], cfg.norm_eps), caches


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decoder CE over ``batch``'s tokens/labels/mask given its
    ``frames`` (B, F, d), through the LM's chunked loss; aux is 0."""
    from repro_torch.models.lm import chunked_loss
    enc = encoder_forward(params["encoder"], batch["frames"], cfg)
    h, _ = decoder_forward(params, batch["tokens"], enc, cfg)
    loss = chunked_loss(h, params["unembed"], batch["labels"],
                        batch["mask"], cfg)
    return loss, {"ce": loss, "aux": torch.zeros(
        (), dtype=torch.float32, device=loss.device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None) -> Dict:
    """Zero caches on ``device`` (the card unless ``device="cpu"``): the
    decoder's self-attention (L, B, max_seq, KV, hd) and the cross K/V
    slots (L, B, frames, KV, hd), which :func:`cross_kv` fills."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    L = cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=PARAM_DTYPE, device=device)

    return {
        "self": attn.AttnCache(zeros(L, batch, max_seq, cfg.n_kv, hd),
                               zeros(L, batch, max_seq, cfg.n_kv, hd)),
        "cross_k": zeros(L, batch, cfg.encoder_frames, cfg.n_kv, hd),
        "cross_v": zeros(L, batch, cfg.encoder_frames, cfg.n_kv, hd),
    }


def decode_step(params, tokens: torch.Tensor, caches: Dict, cache_pos,
                cfg: ModelConfig, *, seq_axis: Optional[str] = None,
                logits_mode: str = "full") -> Tuple[torch.Tensor, Dict]:
    """One decoder token. ``caches['cross_*']`` are the precomputed
    encoder K/V (fixed); only the self-attention cache is written, in
    place (``seq_axis``: the mesh dimension a DTensor self-attention cache
    shards its sequence on, ``attention.gqa_decode``). "full" returns
    (B, V) f32 logits (padding rows masked), "none" the final hidden
    state (B, d)."""
    from repro_torch.models.lm import mask_padding_logits
    h = embed_lookup(tokens, params["embed"])
    kv_pos = torch.arange(cfg.encoder_frames, device=tokens.device)
    pos = torch.as_tensor(cache_pos, device=tokens.device).reshape(1)
    self_k = torch.unbind(caches["self"].k, 0)
    self_v = torch.unbind(caches["self"].v, 0)
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        h = constrain_batch_leading(h)      # residual-stream anchor
        a, _ = attn.gqa_decode(
            lp["self_attn"], rms_norm(h, lp["norm1"], cfg.norm_eps),
            attn.AttnCache(self_k[i], self_v[i]), cache_pos, cfg,
            layer_is_local=False, seq_axis=seq_axis)
        h = h + a
        # cross attention: one query against the fixed encoder K/V
        hq = rms_norm(h, lp["norm_x"], cfg.norm_eps)
        c, _ = attn.gqa_forward(
            lp["cross_attn"], hq[:, None, :], pos, cfg,
            layer_is_local=False, causal=False, use_rope=True,
            kv_override=(caches["cross_k"][i], caches["cross_v"][i]),
            kv_positions=kv_pos)
        h = h + c[:, 0]
        h = h + _mlp(lp["mlp"], rms_norm(h, lp["norm2"], cfg.norm_eps))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if logits_mode == "none":
        return h, caches
    logits = h.to(torch.float32) @ params["unembed"].to(torch.float32)
    return mask_padding_logits(logits, cfg), caches
