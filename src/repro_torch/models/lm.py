"""Decoder-only LM assembled from a ModelConfig (port of
``repro/models/lm.py`` for attention-only layer patterns: the dense
family, Qwen3, Qwen2 and Gemma-2).

Layer heterogeneity (Gemma-2's local/global alternation) is handled as in
the reference, with a *period-pattern stack*: the layer pattern repeats
with period P, and the params and caches of position ``i`` in the period
are stacked over the ``n_layers / P`` repetitions (leading axis), so the
reference's weights carry across one to one. The forward pass loops over
the repetitions (the reference's ``lax.scan``) and applies positions
0..P-1 in each.

A config whose layers need MoE, Mamba, xLSTM, MLA, patch embeddings or an
encoder raises ``NotImplementedError``: those blocks come with a later
slice of the port. Training (``train_loss``/``chunked_loss``) comes with
the training slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (PARAM_DTYPE, dense_init, embed_init,
                                       rms_norm, softcap, swiglu)

PyTree = Any


# ---------------------------------------------------------------------------
# pattern plumbing
# ---------------------------------------------------------------------------


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def combined_period(cfg: ModelConfig) -> int:
    p = len(cfg.layer_pattern)
    if cfg.moe is not None:
        p = _lcm(p, cfg.moe.every)
    if cfg.local_global_alternate:
        p = _lcm(p, 2)
    if cfg.n_layers % p:
        raise ValueError(f"n_layers={cfg.n_layers} must be a multiple of "
                         f"the combined layer period {p}")
    return p


def position_kind(cfg: ModelConfig, i: int) -> str:
    return cfg.layer_pattern[i % len(cfg.layer_pattern)]


def position_is_local(cfg: ModelConfig, i: int) -> bool:
    return cfg.local_global_alternate and (i % 2 == 0)


def check_supported(cfg: ModelConfig) -> None:
    """``NotImplementedError`` for a config this slice cannot run: every
    layer must be attention (GQA, no MLA) with a dense SwiGLU MLP, and the
    model decoder-only without patch embeddings."""
    later = []
    if cfg.is_encoder_decoder:
        later.append("the encoder-decoder stack")
    if cfg.family == "audio":
        later.append("the audio MLP")
    if cfg.moe is not None:
        later.append("MoE layers")
    if cfg.mla is not None:
        later.append("MLA attention")
    kinds = sorted(set(cfg.layer_pattern) - {"attn"})
    if kinds:
        later.append(f"{'/'.join(kinds)} layers")
    if cfg.num_patches:
        later.append("patch embeddings")
    if cfg.d_ff == 0:
        later.append("MLP-free blocks")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} come with a later slice of the "
            f"port (ROADMAP.md §1); this slice runs attention-only dense "
            f"models")


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------


def layer_init(generator: torch.Generator, cfg: ModelConfig, i: int,
               stack: Tuple[int, ...] = ()) -> Dict:
    """The params of pattern position ``i`` (``stack`` leading axes: the
    repetitions, as the reference's vmapped init stacks them)."""
    check_supported(cfg)
    dev = generator.device
    d = cfg.d_model
    return {
        "norm1": torch.zeros(stack + (d,), dtype=torch.float32, device=dev),
        "mixer": attn.attn_init(generator, cfg, stack),
        "norm2": torch.zeros(stack + (d,), dtype=torch.float32, device=dev),
        "ffn": {"w_gate": dense_init(generator, stack + (d, cfg.d_ff)),
                "w_up": dense_init(generator, stack + (d, cfg.d_ff)),
                "w_down": dense_init(generator, stack + (cfg.d_ff, d))},
    }


def _apply_ffn(p, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense SwiGLU MLP; (out, aux loss 0) as the reference's dense arm."""
    return (swiglu(x, p["w_gate"], p["w_up"], p["w_down"]),
            torch.zeros((), dtype=torch.float32, device=x.device))


def layer_forward(p, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, i: int, *, causal: bool = True):
    """Full-sequence block at pattern position i. Returns (x', cache, aux)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, cache = attn.gqa_forward(
        p["mixer"], h, positions, cfg,
        layer_is_local=position_is_local(cfg, i), causal=causal)
    x = x + out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    out, aux = _apply_ffn(p["ffn"], h, cfg)
    return x + out, cache, aux


def layer_decode(p, x: torch.Tensor, cache: attn.AttnCache, cache_pos,
                 cfg: ModelConfig, i: int):
    """One-token block step. x: (B, d). Returns (x', cache', aux); the
    cache is written in place."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, cache = attn.gqa_decode(p["mixer"], h, cache, cache_pos, cfg,
                                 layer_is_local=position_is_local(cfg, i))
    x = x + out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    out, aux = _apply_ffn(p["ffn"], h, cfg)
    return x + out, cache, aux


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device=None) -> PyTree:
    """Random params drawn from ``generator`` on ``device`` (the card
    unless ``device="cpu"``; the generator must live there): the
    reference's tree, with the layers of each pattern position stacked
    over the repetitions."""
    check_supported(cfg)
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"params were asked for {device}")
    P = combined_period(cfg)
    reps = cfg.n_layers // P
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(generator,
                                       (cfg.d_model, cfg.padded_vocab))
    for i in range(P):
        params[f"pos{i}"] = layer_init(generator, cfg, i, (reps,))
    return params


def _unstack(tree, reps: int) -> List:
    """The ``reps`` per-layer views of a stacked param (or cache) tree."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(reps)]
    return list(torch.unbind(tree, 0))


def _layers(params, cfg: ModelConfig) -> List[List]:
    """layers[r][i]: the params of repetition r at pattern position i."""
    P = combined_period(cfg)
    reps = cfg.n_layers // P
    per_pos = [_unstack(params[f"pos{i}"], reps) for i in range(P)]
    return [[per_pos[i][r] for i in range(P)] for r in range(reps)]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = params["embed"][tokens]
    if cfg.final_softcap is not None:   # gemma2 scales embeddings
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def _unembed_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def mask_padding_logits(logits: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """-1e30 on the vocab-padding rows (configs/base.py padded_vocab)."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    ids = torch.arange(cfg.padded_vocab, device=logits.device)
    return torch.where(ids < cfg.vocab, logits, -1e30)


def backbone_forward(params, h: torch.Tensor, positions: torch.Tensor,
                     cfg: ModelConfig, *, causal: bool = True
                     ) -> Tuple[torch.Tensor, Tuple, torch.Tensor]:
    """Run the pattern stack. h: (B, S, d). Returns (h, caches, aux):
    caches per pattern position, each an ``AttnCache`` of (reps, B, S, KV,
    hd) tensors, the layout of :func:`init_cache`."""
    check_supported(cfg)
    P = combined_period(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    per_pos: List[List] = [[] for _ in range(P)]
    for layer in _layers(params, cfg):
        for i in range(P):
            h, cache, a = layer_forward(layer[i], h, positions, cfg, i,
                                        causal=causal)
            per_pos[i].append(cache)
            aux = aux + a
    caches = tuple(attn.AttnCache(torch.stack([c.k for c in cs]),
                                  torch.stack([c.v for c in cs]))
                   for cs in per_pos)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, caches, aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None) -> Tuple:
    """Zero attention caches per pattern position, stacked over
    repetitions: (reps, B, max_seq, KV, hd) bf16, on ``device`` (the card
    unless ``device="cpu"``). Shapes are those prefill returns."""
    check_supported(cfg)
    device = resolve_device(device)
    P = combined_period(cfg)
    reps = cfg.n_layers // P
    shape = (reps, batch, max_seq, cfg.n_kv, cfg.resolved_head_dim)
    return tuple(attn.AttnCache(
        torch.zeros(shape, dtype=PARAM_DTYPE, device=device),
        torch.zeros(shape, dtype=PARAM_DTYPE, device=device))
        for _ in range(P))


def decode_step(params, tokens: torch.Tensor, caches: Tuple, cache_pos,
                cfg: ModelConfig, *, logits_mode: str = "full"
                ) -> Tuple[torch.Tensor, Tuple]:
    """One decoding step. tokens: (B,) ids; cache_pos: the write index (an
    int or a 0-d tensor).

    ``logits_mode``: "full" returns (B, V) f32 logits (bf16 products summed
    in f32, padding rows masked); "none" returns the final hidden state
    (B, d) (the LSH-decode head consumes hidden states). The new keys and
    values are written into ``caches`` in place, and ``caches`` is
    returned.
    """
    if logits_mode not in ("full", "none"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    check_supported(cfg)
    P = combined_period(cfg)
    h = _embed(params, tokens, cfg)
    cache_layers = [_unstack({"k": c.k, "v": c.v}, c.k.shape[0])
                    for c in caches]
    for r, layer in enumerate(_layers(params, cfg)):
        for i in range(P):
            c = cache_layers[i][r]
            h, _, _ = layer_decode(layer[i], h,
                                   attn.AttnCache(c["k"], c["v"]),
                                   cache_pos, cfg, i)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if logits_mode == "none":
        return h, caches
    logits = h.to(torch.float32) @ _unembed_matrix(params, cfg).to(
        torch.float32)
    if cfg.final_softcap is not None:
        logits = softcap(logits, cfg.final_softcap)
    return mask_padding_logits(logits, cfg), caches


def extend_cache(cfg: ModelConfig, caches: Tuple, max_seq: int) -> Tuple:
    """Pad prefill attention caches (reps, B, S_prompt, ...) out to
    ``max_seq`` slots (zeros) so a decode loop can continue writing into
    them."""
    out = []
    for c in caches:
        pad = max_seq - c.k.shape[2]
        out.append(attn.AttnCache(
            torch.nn.functional.pad(c.k, (0, 0, 0, 0, 0, pad)),
            torch.nn.functional.pad(c.v, (0, 0, 0, 0, 0, pad))))
    return tuple(out)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            patches: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Tuple]:
    """Full-sequence forward returning (last hidden (B, d), caches).

    Attention caches come back (reps, B, S, ...), matching init_cache's
    layout so a decode loop can continue from them.
    """
    if patches is not None:
        raise NotImplementedError("patch embeddings come with a later "
                                  "slice of the port (ROADMAP.md §1)")
    B, S = tokens.shape
    h = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    h, caches, _ = backbone_forward(params, h, positions, cfg)
    return h[:, -1], caches
