"""Generic LM assembled from a ModelConfig (port of
``repro/models/lm.py``): every config of ``configs/``.

Layer heterogeneity (jamba's 1:7 attn:mamba interleave, gemma2's
local/global alternation, xLSTM's 7:1 mLSTM:sLSTM, MoE-every-k) is handled
as in the reference, with a *period-pattern stack*: the layer pattern
repeats with period P, and the params and caches of position ``i`` in the
period are stacked over the ``n_layers / P`` repetitions (leading axis),
so the reference's weights carry across one to one. The forward pass
loops over the repetitions (the reference's ``lax.scan``) and applies
positions 0..P-1 in each. The encoder-decoder (whisper) dispatches to
:mod:`repro_torch.models.encdec`.

Leading dense layers (``cfg.first_dense``, DeepSeek's
``first_k_dense_replace``) sit outside the period stack: attention blocks
of pattern position 0's kind with a dense SwiGLU of ``d_ff``, their params
under ``"lead"`` stacked over those layers, their cache the last entry of
the cache tuple (after the pattern positions'). They run before the
stack. A config without them (the reference's ten) has neither.

With a tracker (``prefill``/``decode_step``'s ``tracker``) each layer's
attention mixer is the span ``repro.model.attn`` and each MoE FFN the span
``repro.model.moe`` (routing counters inside, ``models/moe.py``), both
synchronised at their end; without one the layers record nothing. A
step captured as a CUDA graph (:func:`decode_capturable`) is handed an
``obs.trace.DeviceSpans`` instead, whose spans are timed on the device.

Decode writes every cache in place: attention caches through their
per-layer views, recurrent states (Mamba, mLSTM, sLSTM) by copying each
step's new state into the stacked tensors; ``decode_step`` returns the
caches it was given.

Training (``train_loss``) runs the stack with each repetition of the
pattern period under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` on its scanned period body) and the CE over the
vocabulary in sequence chunks, each recomputed in the backward pass, so
the (B, S, V) logits are never materialised.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (PARAM_DTYPE, MetaGenerator,
                                       dense_init, embed_init, embed_lookup,
                                       rms_norm, softcap, swiglu, unstack)
from repro_torch.obs.trace import span_or_null
from repro_torch.parallel.sharding import constrain_batch_leading, settled

PyTree = Any

#: decode-MoE token groups, the reference's measured optimum: one group
#: (the whole decode batch)
MOE_DECODE_GROUPS = 1


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
    if cfg.stacked_layers % p:
        raise ValueError(f"n_layers={cfg.n_layers} less {cfg.first_dense} "
                         f"leading dense must be a multiple of the "
                         f"combined layer period {p}")
    return p


def position_kind(cfg: ModelConfig, i: int) -> str:
    return cfg.layer_pattern[i % len(cfg.layer_pattern)]


def position_is_local(cfg: ModelConfig, i: int) -> bool:
    return cfg.local_global_alternate and (i % 2 == 0)


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------


def _mixer_init(generator: torch.Generator, cfg: ModelConfig, kind: str,
                stack: Tuple[int, ...]):
    if kind == "attn":
        return attn.attn_init(generator, cfg, stack)
    if kind == "mamba":
        return ssm_mod.ssm_init(generator, cfg, stack)
    if kind == "mlstm":
        return xlstm_mod.mlstm_init(generator, cfg, stack)
    if kind == "slstm":
        return xlstm_mod.slstm_init(generator, cfg, stack)
    raise ValueError(kind)


def _ffn_init(generator: torch.Generator, cfg: ModelConfig, is_moe: bool,
              stack: Tuple[int, ...]):
    if cfg.d_ff == 0:
        return {}
    if is_moe:
        return moe_mod.moe_init(generator, cfg, stack)
    d = cfg.d_model
    if cfg.family == "audio":    # whisper: plain GELU MLP
        return encdec._mlp_init(generator, cfg, stack)
    return {"w_gate": dense_init(generator, stack + (d, cfg.d_ff)),
            "w_up": dense_init(generator, stack + (d, cfg.d_ff)),
            "w_down": dense_init(generator, stack + (cfg.d_ff, d))}


def layer_init(generator: torch.Generator, cfg: ModelConfig, i: int,
               stack: Tuple[int, ...] = (), *, dense: bool = False) -> Dict:
    """The params of pattern position ``i`` (``stack`` leading axes: the
    repetitions, as the reference's vmapped init stacks them); ``dense``:
    a leading dense layer's, whose FFN is the SwiGLU of ``d_ff``."""
    dev = generator.device
    d = cfg.d_model
    return {
        "norm1": torch.zeros(stack + (d,), dtype=torch.float32, device=dev),
        "mixer": _mixer_init(generator, cfg, position_kind(cfg, i), stack),
        "norm2": torch.zeros(stack + (d,), dtype=torch.float32, device=dev),
        "ffn": _ffn_init(generator, cfg, cfg.is_moe_layer(i) and not dense,
                         stack),
    }


def _apply_ffn(p, x: torch.Tensor, cfg: ModelConfig, is_moe: bool,
               tracker=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, aux loss): zero for an MLP-free block (``d_ff == 0``), the
    MoE layer's (the span ``repro.model.moe`` with a tracker), the audio
    GELU MLP's or the SwiGLU MLP's (aux 0)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff == 0:
        return torch.zeros_like(x), zero
    if is_moe:
        with span_or_null(tracker, "repro.model.moe") as sp:
            out, aux = moe_mod.moe_forward(p, x, cfg, tracker)
            sp.sync(out)
        return out, aux
    if cfg.family == "audio":
        return encdec._mlp(p, x), zero
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), zero


def layer_forward(p, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, i: int, *, causal: bool = True,
                  dense: bool = False, tracker=None):
    """Full-sequence block at pattern position i (``dense``: a leading
    dense layer). Returns (x', cache, aux)."""
    kind = position_kind(cfg, i)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "attn":
        with span_or_null(tracker, "repro.model.attn") as sp:
            if cfg.mla is not None:
                out, cache = attn.mla_forward(p["mixer"], h, positions, cfg)
            else:
                out, cache = attn.gqa_forward(
                    p["mixer"], h, positions, cfg,
                    layer_is_local=position_is_local(cfg, i), causal=causal,
                    use_rope=cfg.family != "audio")
            sp.sync(out)
    elif kind == "mamba":
        out, cache = ssm_mod.ssm_forward(p["mixer"], h, cfg)
    elif kind == "mlstm":
        out, cache = xlstm_mod.mlstm_forward(p["mixer"], h, cfg)
    elif kind == "slstm":
        out, cache = xlstm_mod.slstm_forward(p["mixer"], h, cfg)
    else:
        raise ValueError(kind)
    x = x + out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    out, aux = _apply_ffn(p["ffn"], h, cfg,
                          cfg.is_moe_layer(i) and not dense, tracker)
    return x + out, cache, aux


def layer_decode(p, x: torch.Tensor, cache, cache_pos, cfg: ModelConfig,
                 i: int, *, seq_axis: Optional[str] = None,
                 dense: bool = False, tracker=None):
    """One-token block step. x: (B, d). Returns (x', cache', aux): an
    attention cache is written in place and returned; a recurrent mixer
    returns new state tensors. ``seq_axis``: the mesh dimension a DTensor
    attention cache's sequence is sharded on (``attn.gqa_decode``);
    ``dense``: a leading dense layer."""
    kind = position_kind(cfg, i)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "attn":
        with span_or_null(tracker, "repro.model.attn") as sp:
            if cfg.mla is not None:
                out, cache = attn.mla_decode(p["mixer"], h, cache, cache_pos,
                                             cfg, seq_axis=seq_axis)
            else:
                out, cache = attn.gqa_decode(
                    p["mixer"], h, cache, cache_pos, cfg,
                    layer_is_local=position_is_local(cfg, i),
                    seq_axis=seq_axis)
            sp.sync(out)
    elif kind == "mamba":
        out, cache = ssm_mod.ssm_decode(p["mixer"], h, cache, cfg)
    elif kind == "mlstm":
        out, cache = xlstm_mod.mlstm_decode(p["mixer"], h, cache, cfg)
    elif kind == "slstm":
        out, cache = xlstm_mod.slstm_decode(p["mixer"], h, cache, cfg)
    else:
        raise ValueError(kind)
    x = x + out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.is_moe_layer(i) and not dense and cfg.d_ff != 0:
        # decode MoE: the batch as G groups of B / G tokens, capacity per
        # group (the reference's GShard layout)
        B, d = h.shape
        G = math.gcd(B, MOE_DECODE_GROUPS)
        out, aux = _apply_ffn(p["ffn"], h.reshape(G, B // G, d), cfg, True,
                              tracker)
        out = out.reshape(B, d)
    else:
        out, aux = _apply_ffn(p["ffn"], h, cfg, False)
    return x + out, cache, aux


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device=None) -> PyTree:
    """Random params drawn from ``generator`` on ``device`` (the card
    unless ``device="cpu"``; the generator must live there): the
    reference's tree, with the layers of each pattern position stacked
    over the repetitions (the encoder-decoder's: :mod:`encdec`'s tree).
    With ``generator=None`` and ``device="meta"``, the tree's shapes and
    dtypes only: nothing is allocated or drawn."""
    device = resolve_device(device)
    if generator is None and device.type == "meta":
        generator = MetaGenerator()
    where = getattr(generator, "device", None)
    if where is None or where.type != device.type:
        raise ValueError(f"the generator lives on {where}, the params were "
                         f"asked for {device}")
    if cfg.is_encoder_decoder:
        return encdec.init_params(generator, cfg)
    P = combined_period(cfg)
    reps = cfg.stacked_layers // P
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(generator,
                                       (cfg.d_model, cfg.padded_vocab))
    if cfg.first_dense:
        params["lead"] = layer_init(generator, cfg, 0, (cfg.first_dense,),
                                    dense=True)
    for i in range(P):
        params[f"pos{i}"] = layer_init(generator, cfg, i, (reps,))
    if cfg.num_patches:
        params["patch_proj"] = dense_init(generator,
                                          (cfg.d_model, cfg.d_model))
    return params


def _layers(params, cfg: ModelConfig) -> List[List]:
    """layers[r][i]: the params of repetition r at pattern position i."""
    P = combined_period(cfg)
    reps = cfg.stacked_layers // P
    per_pos = [unstack(params[f"pos{i}"], reps) for i in range(P)]
    return [[per_pos[i][r] for i in range(P)] for r in range(reps)]


def _lead_layers(params, cfg: ModelConfig) -> List:
    """The params of each leading dense layer, in order (none for a config
    without them)."""
    if not cfg.first_dense:
        return []
    return unstack(params["lead"], cfg.first_dense)


def cache_kinds(cfg: ModelConfig) -> List[str]:
    """The mixer kind of each entry of the cache tuple: the pattern
    positions', then the leading dense layers' (pattern position 0's
    kind) where the config has them."""
    P = combined_period(cfg)
    kinds = [position_kind(cfg, i) for i in range(P)]
    return kinds + [position_kind(cfg, 0)] * bool(cfg.first_dense)


def decode_capturable(cfg: ModelConfig) -> bool:
    """Whether the meshless :func:`decode_step`, given its position as a
    0-d device tensor, can be captured as a CUDA graph, nothing in it
    waiting for the device: MLA attention in every layer (its cache
    written through the position tensor) with dropless MoE FFNs (segment
    ends from the one-hot), DeepSeek-V2's layout, which the card's tests
    check against the eager step. The other steps are not held to that
    (GQA writes its cache at a host position) and run eagerly."""
    return (not cfg.is_encoder_decoder and cfg.mla is not None
            and cfg.moe is not None and cfg.moe.dropless
            and all(kind == "attn" for kind in cache_kinds(cfg)))


def _cache_layers(cache) -> List:
    """The per-repetition views of one pattern position's stacked cache
    (a NamedTuple of (reps, ...) tensors), each a NamedTuple of its
    type."""
    return [type(cache)(*fields)
            for fields in zip(*(torch.unbind(f, 0) for f in cache))]


def _stack_caches(caches: List):
    """One pattern position's per-repetition caches stacked on a leading
    axis (the reference's scan-stacked layout)."""
    return type(caches[0])(*(torch.stack(list(f)) for f in zip(*caches)))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = embed_lookup(tokens, params["embed"])
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


def _period(layer: List, h: torch.Tensor, aux: torch.Tensor,
            positions: torch.Tensor, cfg: ModelConfig, causal: bool,
            dense: bool = False, tracker=None):
    """One repetition of the pattern: positions 0..P-1 on ``h`` (``dense``:
    the leading dense layers, each at position 0). Returns (h, aux, the
    layers' caches)."""
    caches = []
    for i, p in enumerate(layer):
        h = constrain_batch_leading(h)      # residual-stream anchor
        h, cache, a = layer_forward(p, h, positions, cfg, 0 if dense else i,
                                    causal=causal, dense=dense,
                                    tracker=tracker)
        caches.append(cache)
        aux = aux + a
    return h, aux, caches


def _period_remat(layer, h, aux, positions, cfg, causal, dense=False):
    return _period(layer, h, aux, positions, cfg, causal, dense)[:2]


def backbone_forward(params, h: torch.Tensor, positions: torch.Tensor,
                     cfg: ModelConfig, *, causal: bool = True,
                     remat: bool = False, tracker=None
                     ) -> Tuple[torch.Tensor, Optional[Tuple], torch.Tensor]:
    """Run the leading dense layers, then the pattern stack. h: (B, S, d).
    Returns (h, caches, aux): caches per pattern position, each stacked
    over the repetitions (an ``AttnCache`` of (reps, B, S, ...) tensors or
    a recurrent state), then the leading layers' stacked the same, the
    layout of :func:`init_cache`.

    ``remat=True`` (training) runs each repetition of the period under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward pass, so training keeps O(n_layers / P) boundary states, and
    no caches are kept (``caches`` is None)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    lead = _lead_layers(params, cfg)
    lead_caches: List = []
    if lead and remat:
        h, aux = checkpoint(_period_remat, lead, h, aux, positions, cfg,
                            causal, True, use_reentrant=False)
    elif lead:
        h, aux, lead_caches = _period(lead, h, aux, positions, cfg, causal,
                                      True, tracker)
    per_pos: List[List] = [[] for _ in range(combined_period(cfg))]
    for layer in _layers(params, cfg):
        if remat:
            h, aux = checkpoint(_period_remat, layer, h, aux, positions, cfg,
                                causal, use_reentrant=False)
            continue
        h, aux, caches = _period(layer, h, aux, positions, cfg, causal,
                                 tracker=tracker)
        for i, cache in enumerate(caches):
            per_pos[i].append(cache)
    if lead_caches:
        per_pos.append(lead_caches)
    caches = None if remat else tuple(_stack_caches(cs) for cs in per_pos)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, caches, aux


def _chunk_nll(h: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked NLL sum, mask sum) of one sequence chunk: f32 logits from
    f32 copies of h and the unembedding (exact products of bf16 values),
    soft-capped, the padding rows masked."""
    logits = h.to(torch.float32) @ unembed.to(torch.float32)
    if cfg.final_softcap is not None:
        logits = softcap(logits, cfg.final_softcap)
    logits = settled(mask_padding_logits(logits, cfg))
    logz = torch.logsumexp(logits, dim=-1)
    gold = _label_logits(logits, labels)
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def _label_logits(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """``logits[..., label]``. On a mesh whose logits are sharded along
    the vocabulary (a DTensor), each rank picks the labels that fall in
    its vocabulary slice (0 elsewhere) and the picks sum over those mesh
    dimensions: the gather never moves the logits."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(logits, DTensor) or Shard(logits.dim() - 1) not in \
            logits.placements:
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, vocab = logits.device_mesh, Shard(logits.dim() - 1)
    rows = tuple(pl if isinstance(pl, Shard) and pl != vocab else
                 Replicate() for pl in logits.placements)
    logits = logits.redistribute(mesh, tuple(
        pl if pl == vocab else rows[d]
        for d, pl in enumerate(logits.placements)))
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, rows).to_local().long()
    local = logits.to_local()
    _, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    n = local.shape[-1]
    at = lab - offset[-1]
    inside = (at >= 0) & (at < n)
    picked = torch.gather(local, -1, at.clamp(0, max(n - 1, 0))[..., None])
    picked = torch.where(inside, picked[..., 0], 0.0)
    return DTensor.from_local(
        picked, mesh, tuple(Partial() if pl == vocab else pl
                            for pl in logits.placements),
        run_check=False, shape=labels.shape,
        stride=labels.stride()).redistribute(mesh, rows)


def chunked_loss(h: torch.Tensor, unembed: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor, cfg: ModelConfig,
                 chunk: int = 512) -> torch.Tensor:
    """Mean CE over the vocab without materialising (B, S, V) logits: the
    sequence in chunks (the largest divisor of S up to ``chunk``), each
    under ``torch.utils.checkpoint`` so its logits are recomputed in the
    backward pass."""
    S = h.shape[1]
    chunk = attn._pick_chunk(S, chunk)   # S may include patch positions
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        part, m = checkpoint(_chunk_nll, h[:, c:c + chunk], unembed,
                             labels[:, c:c + chunk], mask[:, c:c + chunk],
                             cfg, use_reentrant=False)
        nll = nll + part
        denom = denom + m
    return nll / torch.clamp_min(denom, 1.0)


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               *, aux_weight: float = 0.01
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ ``aux_weight`` x the MoE aux loss). batch:
    tokens/labels (B, S) int, mask (B, S) f32; ``patches`` (B,
    num_patches, d) for a config with patch embeddings (their positions
    carry no loss), ``frames`` for the encoder-decoder. Returns (total,
    {"ce", "aux"})."""
    if cfg.is_encoder_decoder:
        return encdec.train_loss(params, batch, cfg)
    tokens, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
    B, S = tokens.shape
    h = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    if cfg.num_patches:
        Np = cfg.num_patches
        h = torch.cat([batch["patches"].to(h.dtype) @ params["patch_proj"],
                       h], dim=1)
        positions = torch.arange(Np + S, device=tokens.device)
        mask = torch.cat([mask.new_zeros((B, Np)), mask], dim=1)
        labels = torch.cat([labels.new_zeros((B, Np)), labels], dim=1)
    h, _, aux = backbone_forward(params, h, positions, cfg, remat=True)
    loss = chunked_loss(h, _unembed_matrix(params, cfg), labels, mask, cfg)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None) -> Tuple:
    """Zero caches per pattern position, stacked over repetitions, then
    the leading dense layers' (where the config has them), on ``device``
    (the card unless ``device="cpu"``): attention caches of (reps, B,
    max_seq, ...) bf16 slots (MLA's latent and rope key), recurrent states
    O(1) in the sequence (the stabilisers at -1e30). Shapes are those
    prefill returns."""
    device = resolve_device(device)
    P = combined_period(cfg)
    hd = cfg.resolved_head_dim
    f32 = torch.float32
    kinds = cache_kinds(cfg)
    layers = [cfg.stacked_layers // P] * P + [cfg.first_dense] * (
        len(kinds) - P)

    caches = []
    for kind, reps in zip(kinds, layers):

        def zeros(*shape, dtype=PARAM_DTYPE):
            return torch.zeros((reps, batch) + shape, dtype=dtype,
                               device=device)

        def stabiliser(*shape):
            return torch.full((reps, batch) + shape, xlstm_mod.M_INIT,
                              dtype=f32, device=device)

        if kind == "attn":
            if cfg.mla is not None:
                c = attn.AttnCache(zeros(max_seq, cfg.mla.kv_rank),
                                   zeros(max_seq, cfg.mla.rope_dim))
            else:
                c = attn.AttnCache(zeros(max_seq, cfg.n_kv, hd),
                                   zeros(max_seq, cfg.n_kv, hd))
        elif kind == "mamba":
            d_inner, N, d_conv, _ = ssm_mod._dims(cfg)
            c = ssm_mod.SSMCache(zeros(d_conv - 1, d_inner),
                                 zeros(d_inner, N, dtype=f32))
        elif kind == "mlstm":
            d_inner, H, d_qk, d_v = xlstm_mod._mlstm_dims(cfg)
            c = xlstm_mod.MLSTMCache(
                zeros(H, d_qk, d_v, dtype=f32), zeros(H, d_qk, dtype=f32),
                stabiliser(H), zeros(xlstm_mod.D_CONV - 1, d_inner))
        elif kind == "slstm":
            d = cfg.d_model
            c = xlstm_mod.SLSTMCache(zeros(d, dtype=f32),
                                     zeros(d, dtype=f32), stabiliser(d),
                                     zeros(d, dtype=f32))
        else:
            raise ValueError(kind)
        caches.append(c)
    return tuple(caches)


def decode_step(params, tokens: torch.Tensor, caches, cache_pos,
                cfg: ModelConfig, *, seq_axis: Optional[str] = None,
                logits_mode: str = "full", tracker=None):
    """One decoding step. tokens: (B,) ids; cache_pos: the write index (an
    int or a 0-d tensor; a host int with ``seq_axis``, the mesh dimension
    DTensor attention caches shard their sequence on).

    ``logits_mode``: "full" returns (B, V) f32 logits (bf16 products summed
    in f32, padding rows masked); "none" returns the final hidden state
    (B, d) (the LSH-decode head consumes hidden states). Every cache is
    written in place (recurrent states copied into their stacked tensors)
    and ``caches`` is returned. The encoder-decoder's caches are
    :func:`encdec.init_cache`'s dict. ``tracker``: the layers' spans and
    routing counters (module docstring), or None.
    """
    if logits_mode not in ("full", "none"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    if cfg.is_encoder_decoder:
        return encdec.decode_step(params, tokens, caches, cache_pos, cfg,
                                  seq_axis=seq_axis, logits_mode=logits_mode)
    P = combined_period(cfg)
    h = _embed(params, tokens, cfg)
    cache_layers = [_cache_layers(c) for c in caches]
    steps = [(p, cache_layers[P][j], 0, True)
             for j, p in enumerate(_lead_layers(params, cfg))]
    steps += [(layer[i], cache_layers[i][r], i, False)
              for r, layer in enumerate(_layers(params, cfg))
              for i in range(P)]
    for p, view, i, dense in steps:
        h = constrain_batch_leading(h)      # residual-stream anchor
        h, new, _ = layer_decode(p, h, view, cache_pos, cfg, i,
                                 seq_axis=seq_axis, dense=dense,
                                 tracker=tracker)
        for dst, src in zip(view, new):
            if src is not dst:
                dst.copy_(src)
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
    them; any rank (GQA's K/V are 5-D, MLA's latent and rope key 4-D).
    Recurrent caches are O(1) and pass through unchanged."""
    out = []
    for kind, c in zip(cache_kinds(cfg), caches):
        if kind == "attn":
            pad = max_seq - c.k.shape[2]
            out.append(attn.AttnCache(*(
                torch.nn.functional.pad(t, (0, 0) * (t.ndim - 3) + (0, pad))
                for t in c)))
        else:
            out.append(c)
    return tuple(out)


def prefill_hidden(params, tokens: torch.Tensor, cfg: ModelConfig,
                   patches: Optional[torch.Tensor] = None, *, tracker=None
                   ) -> Tuple[torch.Tensor, Tuple]:
    """Full-sequence forward returning (final hidden (B, S', d), caches):
    every position's final-normed hidden state (S' = S, or num_patches + S
    with ``patches``). :func:`prefill` keeps the last."""
    B, S = tokens.shape
    h = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    if cfg.num_patches and patches is not None:
        h = torch.cat([patches.to(h.dtype) @ params["patch_proj"], h], dim=1)
        positions = torch.arange(cfg.num_patches + S, device=tokens.device)
    h, caches, _ = backbone_forward(params, h, positions, cfg,
                                    tracker=tracker)
    return h, caches


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            patches: Optional[torch.Tensor] = None, *, tracker=None
            ) -> Tuple[torch.Tensor, Tuple]:
    """Full-sequence forward returning (last hidden (B, d), caches).

    ``patches`` (B, num_patches, d), for a config with patch embeddings,
    are projected and prepended to the tokens' embeddings (positions 0 ..
    num_patches + S - 1). Attention caches come back (reps, B, S, ...),
    matching init_cache's layout so a decode loop can continue from them.
    """
    h, caches = prefill_hidden(params, tokens, cfg, patches, tracker=tracker)
    return h[:, -1], caches
