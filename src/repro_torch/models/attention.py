"""Attention: GQA with qk_norm, bias, softcap and local windows, and MLA
(port of ``repro/models/attention.py``).

Two execution modes, plain PyTorch (the reference computes attention
outside any Pallas kernel):

* ``flash_attention`` — prefill: a loop over query chunks, each an online
  softmax over key/value chunks (O(S * chunk) memory, never the full (S, S)
  matrix), with causal block skipping (a chunk sweeps only the kv chunks
  at or below the diagonal and inside the local window), the reference's
  default.
* ``decode_attention`` — one new token against a (B, S_max, KV, hd) cache.

Layouts are the reference's: q (B, S, H, hd), k and v (B, S, KV, hd).

MLA (MiniCPM3/DeepSeek-style latent attention) caches the compressed
``c_kv`` and the shared ``k_rope`` only; decode uses the absorbed form
(scores via ``q W_uk^T c_kv``), so the full K/V are never formed at
decode time. The reference's sequence-sharded decode combine
(``decode_attention_seq_sharded``, a combine across a mesh axis) waits
for the port's parallel slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (PARAM_DTYPE, apply_rope, dense_init,
                                       rms_norm, softcap)

NEG_INF = -1e30
# flash_attention always skips the kv chunks above the diagonal and outside
# the local window (the reference's default, REPRO_CAUSAL_SKIP=1, which the
# port does not read); parallel/analytic.py counts attention FLOPs with it
CAUSAL_BLOCK_SKIP = True


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """One attention layer's params, GQA or MLA per ``cfg`` (``stack``
    leading axes: layers stacked per pattern position, as the reference's
    vmapped init)."""
    hd = cfg.resolved_head_dim
    dev = generator.device
    if cfg.mla is not None:
        m = cfg.mla
        H = cfg.n_heads
        return {
            "w_dq": dense_init(generator, stack + (cfg.d_model, m.q_rank)),
            "q_norm": torch.zeros(stack + (m.q_rank,), dtype=torch.float32,
                                  device=dev),
            "w_uq": dense_init(generator, stack + (
                m.q_rank, H * (m.nope_dim + m.rope_dim))),
            "w_dkv": dense_init(generator, stack + (cfg.d_model, m.kv_rank)),
            "kv_norm": torch.zeros(stack + (m.kv_rank,), dtype=torch.float32,
                                   device=dev),
            "w_kr": dense_init(generator, stack + (cfg.d_model, m.rope_dim)),
            "w_uk": dense_init(generator, stack + (m.kv_rank,
                                                   H * m.nope_dim)),
            "w_uv": dense_init(generator, stack + (m.kv_rank, H * m.v_dim)),
            "w_o": dense_init(generator, stack + (H * m.v_dim, cfg.d_model)),
        }
    p = {
        "w_q": dense_init(generator, stack + (cfg.d_model, cfg.n_heads * hd)),
        "w_k": dense_init(generator, stack + (cfg.d_model, cfg.n_kv * hd)),
        "w_v": dense_init(generator, stack + (cfg.d_model, cfg.n_kv * hd)),
        "w_o": dense_init(generator, stack + (cfg.n_heads * hd, cfg.d_model)),
    }
    if cfg.qkv_bias:
        for name, width in (("b_q", cfg.n_heads), ("b_k", cfg.n_kv),
                            ("b_v", cfg.n_kv)):
            p[name] = torch.zeros(stack + (width * hd,), dtype=PARAM_DTYPE,
                                  device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(stack + (hd,), dtype=torch.float32,
                                  device=dev)
        p["k_norm"] = torch.zeros(stack + (hd,), dtype=torch.float32,
                                  device=dev)
    return p


# ---------------------------------------------------------------------------
# flash core (prefill)
# ---------------------------------------------------------------------------


def _pick_chunk(S: int, want: int) -> int:
    """Largest divisor of S that is <= want (seq lengths like 1500 or
    4096+256 patches aren't powers of two)."""
    want = min(want, S)
    for c in range(want, 0, -1):
        if S % c == 0:
            return c
    return S


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """(Cq, Ck) boolean keep-mask from absolute positions."""
    d = q_pos[:, None] - k_pos[None, :]
    keep = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        keep &= d >= 0
    if window is not None:
        keep &= d < window
    return keep


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked online-softmax attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0.
    q_pos: (Sq,), k_pos: (Sk,) absolute positions for masking.
    Returns (B, Sq, H, hd) in q.dtype.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"n_heads={H} must be a multiple of n_kv={KV}")
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    q_chunk = _pick_chunk(Sq, q_chunk)
    kv_chunk = _pick_chunk(Sk, kv_chunk)
    nq, nk = Sq // q_chunk, Sk // kv_chunk

    qc = q.reshape(B, nq, q_chunk, KV, G, hd).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(B, nk, kv_chunk, KV, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, kv_chunk, KV, hd).permute(1, 0, 3, 2, 4)
    qp = q_pos.reshape(nq, q_chunk)
    kp = k_pos.reshape(nk, kv_chunk)

    def run_q_chunk(i: int, lo: int, hi: int) -> torch.Tensor:
        """Online-softmax sweep of query chunk i over kv chunks [lo, hi)."""
        qi = qc[i].to(torch.float32)           # (B, KV, G, Cq, hd)
        shape = (B, KV, G, q_chunk)
        m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(shape, dtype=torch.float32, device=q.device)
        acc = torch.zeros(shape + (hd,), dtype=torch.float32,
                          device=q.device)
        for j in range(lo, hi):
            s = torch.einsum("bkgqd,bkcd->bkgqc", qi,
                             kc[j].to(torch.float32)) * scale
            if logit_cap is not None:
                s = softcap(s, logit_cap)
            keep = _block_mask(qp[i], kp[j], causal, window)
            s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vc[j].to(torch.float32))
            m = m_new
        return acc / torch.clamp_min(l, 1e-30)[..., None]

    aligned = (causal and Sq == Sk and q_chunk == kv_chunk
               and q_pos.numel() == k_pos.numel())
    outs = []
    for i in range(nq):
        if aligned:
            # causal block skipping: chunk i sweeps only kv chunks
            # [lo_i, i], lo_i trimming blocks fully outside the window
            lo = 0
            if window is not None:
                lo = max(0, (i * q_chunk - window) // kv_chunk)
            outs.append(run_q_chunk(i, lo, i + 1))
        else:
            outs.append(run_q_chunk(i, 0, nk))
    o = torch.stack(outs, dim=0)            # (nq, B, KV, G, Cq, hd)
    o = o.permute(1, 0, 4, 2, 3, 5)
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def naive_attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                    logit_cap=None, scale=None):
    """Reference O(S^2)-memory attention (tests + tiny smoke configs)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    if logit_cap is not None:
        s = softcap(s, logit_cap)
    keep = _block_mask(q_pos, k_pos, causal, window)
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# decode (one token, KV cache)
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos, *,
                     window: Optional[int] = None,
                     logit_cap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, S, KV, hd); cache_pos: current length.

    Attends to positions [max(0, cache_pos-window), cache_pos]."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    if logit_cap is not None:
        s = softcap(s, logit_cap)
    pos = torch.arange(S, device=q.device)
    keep = pos <= cache_pos
    if window is not None:
        keep &= pos > cache_pos - window
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA layer: projections + rope + cache plumbing
# ---------------------------------------------------------------------------


class AttnCache(NamedTuple):
    k: torch.Tensor          # (B, S, KV, hd)  [MLA: (B, S, kv_rank) c_kv]
    v: torch.Tensor          # (B, S, KV, hd)  [MLA: (B, S, rope_dim) k_rope]


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = q.reshape(q.shape[:-1] + (cfg.n_heads, hd))
    k = k.reshape(k.shape[:-1] + (cfg.n_kv, hd))
    v = v.reshape(v.shape[:-1] + (cfg.n_kv, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def gqa_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, layer_is_local: bool,
                causal: bool = True, use_rope: bool = True,
                kv_override: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None,
                kv_positions: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, AttnCache]:
    """Full-sequence attention (prefill). x: (B, S, d).

    Returns (output (B, S, d), cache of the projected K/V for decode reuse).
    ``kv_override`` supplies external K/V at ``kv_positions`` (whisper's
    cross-attention: the query is roped, the encoder's keys are not);
    ``use_rope=False`` is the audio encoder's rope-free self-attention.
    """
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_override is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    if kv_override is not None:
        k, v = kv_override
        k_pos = kv_positions
    else:
        k_pos = positions
    window = cfg.local_window if layer_is_local else None
    o = flash_attention(q, k, v, positions, k_pos, causal=causal,
                        window=window, logit_cap=cfg.attn_softcap)
    out = o.reshape(o.shape[:2] + (-1,)) @ p["w_o"]
    return out, AttnCache(k, v)


def gqa_decode(p, x: torch.Tensor, cache: AttnCache, cache_pos,
               cfg: ModelConfig, *, layer_is_local: bool,
               ) -> Tuple[torch.Tensor, AttnCache]:
    """One-token decode. x: (B, d); cache holds S_max slots; cache_pos is
    the slot being written (an int or a 0-d tensor). The new key and value
    are written into ``cache`` in place (the reference returns an updated
    copy); the returned cache is the same tensors."""
    q, k, v = _project_qkv(p, x[:, None, :], cfg)
    pos = torch.as_tensor(cache_pos, device=x.device).reshape(1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    q = q[:, 0]                                    # (B, H, hd)
    cache.k[:, cache_pos] = k[:, 0].to(cache.k.dtype)
    cache.v[:, cache_pos] = v[:, 0].to(cache.v.dtype)
    window = cfg.local_window if layer_is_local else None
    o = decode_attention(q, cache.k, cache.v, cache_pos, window=window,
                         logit_cap=cfg.attn_softcap)
    out = o.reshape(o.shape[0], -1) @ p["w_o"]
    return out, cache


# ---------------------------------------------------------------------------
# MLA (latent attention)
# ---------------------------------------------------------------------------


def mla_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, AttnCache]:
    """Prefill MLA: K and V expanded from the latent, v padded to the qk
    width for the shared flash core (then sliced), at scale
    ``(nope + rope)^-0.5``. Returns (out, AttnCache(c_kv, k_rope))."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(B, S, H, m.nope_dim + m.rope_dim)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = x @ p["w_kr"]                                # shared head
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]

    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, m.nope_dim)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, m.v_dim)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.rope_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    qk_dim = m.nope_dim + m.rope_dim
    v_pad = torch.nn.functional.pad(v, (0, qk_dim - m.v_dim))
    o = flash_attention(q_full, k_full, v_pad, positions, positions,
                        causal=True, scale=qk_dim ** -0.5)
    o = o[..., :m.v_dim]
    out = o.reshape(B, S, H * m.v_dim) @ p["w_o"]
    return out, AttnCache(c_kv, k_rope)


def mla_decode(p, x: torch.Tensor, cache: AttnCache, cache_pos,
               cfg: ModelConfig) -> Tuple[torch.Tensor, AttnCache]:
    """Absorbed-form MLA decode: never forms per-head K/V. Scores are
    ``q_nope W_uk^T c_kv + q_rope k_rope`` in f32.

    cache.k = c_kv (B, S, kv_rank); cache.v = k_rope (B, S, rope_dim). The
    new latent and rope key are written into ``cache`` in place, as
    :func:`gqa_decode` writes; the returned cache is the same tensors.
    """
    m = cfg.mla
    B, _ = x.shape
    H = cfg.n_heads
    f32 = torch.float32
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(B, H, m.nope_dim + m.rope_dim)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    pos = torch.as_tensor(cache_pos, device=x.device).reshape(1)
    q_rope = apply_rope(q_rope[:, None], pos, cfg.rope_theta)[:, 0]

    c_new = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    kr_new = x @ p["w_kr"]
    kr_new = apply_rope(kr_new[:, None, None], pos, cfg.rope_theta)[:, 0, 0]
    cache.k[:, cache_pos] = c_new.to(cache.k.dtype)
    cache.v[:, cache_pos] = kr_new.to(cache.v.dtype)
    c_kv, k_rope = cache.k, cache.v

    w_uk = p["w_uk"].reshape(m.kv_rank, H, m.nope_dim)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope.to(f32), w_uk.to(f32))
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c_kv.to(f32))
         + torch.einsum("bhn,bsn->bhs", q_rope.to(f32), k_rope.to(f32)))
    s = s * (m.nope_dim + m.rope_dim) ** -0.5
    keep = torch.arange(c_kv.shape[1], device=x.device) <= cache_pos
    s = torch.where(keep, s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pattn, c_kv.to(f32))
    w_uv = p["w_uv"].reshape(m.kv_rank, H, m.v_dim)
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv.to(f32))
    out = o.to(x.dtype).reshape(B, H * m.v_dim) @ p["w_o"]
    return out, cache
