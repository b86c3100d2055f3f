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

* ``decode_attention_seq_sharded`` — the flash-decoding combine across a
  sequence-sharded cache: each shard's partial softmax, one max and two
  sum reductions over a shard group (``core/distributed.py``: in-process,
  or a ``torch.distributed`` group such as one ``DeviceMesh``
  dimension). ``gqa_decode(seq_axis=)`` runs it on a DTensor cache's
  local shards, so a mesh never gathers the cache.

MLA (MiniCPM3/DeepSeek-style latent attention) caches the compressed
``c_kv`` and the shared ``k_rope`` only; decode uses the absorbed form
(scores via ``q W_uk^T c_kv``), so the full K/V are never formed at
decode time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (PARAM_DTYPE, apply_rope, dense_init,
                                       merge_heads, pad, rms_norm,
                                       softcap, split_heads)

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


def decode_attention_seq_sharded(q: torch.Tensor, k_local, v_local,
                                 cache_pos, group, shard=None, *,
                                 window: Optional[int] = None,
                                 logit_cap: Optional[float] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Flash-decoding combine across a sequence-sharded cache.

    ``k_local``/``v_local``: the (B, S_loc, KV, hd) shards this process
    holds, one per member of ``group.members()`` (a tensor for a
    one-member list); ``shard`` (default: those members) is each one's
    position along the sequence, so shard ``s`` holds positions
    ``[s * S_loc, (s + 1) * S_loc)`` and global causal masking stays
    exact. Local masked scores, a max reduction, local exp / sum / p·v,
    two sum reductions, then the divide: O(B*H*hd) bytes cross the group
    instead of O(S). ``window`` and ``logit_cap`` are
    :func:`decode_attention`'s (the reference's combine takes neither).
    A one-member group has nothing to combine: the shard's
    :func:`decode_attention`.
    """
    ks = [k_local] if isinstance(k_local, torch.Tensor) else list(k_local)
    vs = [v_local] if isinstance(v_local, torch.Tensor) else list(v_local)
    if shard is None:
        shards = group.members()
    else:
        shards = [shard] if isinstance(shard, int) else list(shard)
    if not len(ks) == len(vs) == len(shards):
        raise ValueError(f"{len(ks)} key and {len(vs)} value shards for "
                         f"{len(shards)} members")
    if group.size == 1:
        return decode_attention(q, ks[0], vs[0], cache_pos, window=window,
                                logit_cap=logit_cap, scale=scale)
    B, H, hd = q.shape
    S_loc, KV = ks[0].shape[1], ks[0].shape[2]
    G = H // KV
    f32 = torch.float32
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, KV, G, hd).to(f32)
    scores = []
    for k, s_ in zip(ks, shards):
        s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(f32)) * scale
        if logit_cap is not None:
            s = softcap(s, logit_cap)
        pos = s_ * S_loc + torch.arange(S_loc, device=q.device)
        keep = pos <= cache_pos
        if window is not None:
            keep &= pos > cache_pos - window
        scores.append(torch.where(keep, s, NEG_INF))
    o = _combine(group, scores, [v.to(f32) for v in vs], "bkgs,bskd->bkgd")
    return o.reshape(B, H, hd).to(q.dtype)


def _combine(group, scores, values, spec: str) -> torch.Tensor:
    """The flash-decoding combine of masked f32 ``scores`` (..., S_loc)
    and ``values``, one of each per member: a max reduction, local exp /
    sum / ``einsum(spec, p, v)``, two sum reductions, the divide."""
    m = group.all_reduce([torch.amax(s, dim=-1) for s in scores], "max")
    ps = [torch.exp(s - m[..., None]) for s in scores]
    l = group.all_reduce([torch.sum(p, dim=-1) for p in ps], "sum")
    o = group.all_reduce([torch.einsum(spec, p, v)
                          for p, v in zip(ps, values)], "sum")
    return o / torch.clamp_min(l, 1e-30)[..., None]


# ---------------------------------------------------------------------------
# GQA layer: projections + rope + cache plumbing
# ---------------------------------------------------------------------------


class AttnCache(NamedTuple):
    k: torch.Tensor          # (B, S, KV, hd)  [MLA: (B, S, kv_rank) c_kv]
    v: torch.Tensor          # (B, S, KV, hd)  [MLA: (B, S, rope_dim) k_rope]


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = split_heads(q, cfg.n_heads)
    k = split_heads(k, cfg.n_kv)
    v = split_heads(v, cfg.n_kv)
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
    o = _flash(q, k, v, positions, k_pos, causal=causal, window=window,
               logit_cap=cfg.attn_softcap)
    out = merge_heads(o) @ p["w_o"]
    return out, AttnCache(k, v)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`flash_attention`; on a mesh (``q`` a DTensor) it runs on
    each rank's local batch and heads. Attention is independent across
    both, so once k and v are laid out as q the loop needs no
    collective: q keeps its batch and head sharding (anything else is
    replicated first), k and v take q's placements, and where q's head
    sharding cannot split the KV groups (16 query heads on 16 ranks over
    8 KV heads) each query head first gets its own copy of its KV head."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(q, DTensor):
        return flash_attention(q, k, v, q_pos, k_pos, **kw)
    mesh = q.device_mesh
    keep = (Shard(0), Shard(2))
    pl = tuple(p if p in keep else Replicate() for p in q.placements)
    q = q.redistribute(mesh, pl)
    n = 1
    for dim, p in enumerate(pl):
        if p == Shard(2):
            n *= mesh.size(dim)

    def placed(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t

    k, v = placed(k), placed(v)
    B, S, KV, hd = k.shape
    H = q.shape[2]
    if n > 1 and KV % n:
        k, v = (t.unsqueeze(3).expand(B, S, KV, H // KV, t.shape[3])
                .reshape(B, S, H, t.shape[3]) for t in (k, v))
    k, v = (t.redistribute(mesh, pl).to_local() for t in (k, v))

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    o = flash_attention(q.to_local(), k, v, local(q_pos), local(k_pos),
                        **kw).contiguous()
    shape = tuple(q.shape[:3]) + (v.shape[3],)
    return DTensor.from_local(
        o, mesh, pl, run_check=False, shape=shape,
        stride=(shape[1] * shape[2] * shape[3], shape[2] * shape[3],
                shape[3], 1))


def gqa_decode(p, x: torch.Tensor, cache: AttnCache, cache_pos,
               cfg: ModelConfig, *, layer_is_local: bool,
               seq_axis: Optional[str] = None,
               ) -> Tuple[torch.Tensor, AttnCache]:
    """One-token decode. x: (B, d); cache holds S_max slots; cache_pos is
    the slot being written (an int or a 0-d tensor). The new key and value
    are written into ``cache`` in place (the reference returns an updated
    copy); the returned cache is the same tensors.

    ``seq_axis`` names the mesh dimension a DTensor cache's sequence is
    sharded on: the write lands on the owning shard only and the
    attention is :func:`decode_attention_seq_sharded` over that
    dimension's group, on local shards (``cache_pos`` a host int)."""
    q, k, v = _project_qkv(p, x[:, None, :], cfg)
    pos = torch.as_tensor(cache_pos, device=x.device).reshape(1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    q = q[:, 0]                                    # (B, H, hd)
    window = cfg.local_window if layer_is_local else None
    if seq_axis is None:
        cache.k[:, cache_pos] = k[:, 0].to(cache.k.dtype)
        cache.v[:, cache_pos] = v[:, 0].to(cache.v.dtype)
        o = decode_attention(q, cache.k, cache.v, cache_pos, window=window,
                             logit_cap=cfg.attn_softcap)
    else:
        o = _seq_sharded_decode(q, k[:, 0], v[:, 0], cache, int(cache_pos),
                                seq_axis, window, cfg.attn_softcap)
    out = o.reshape(o.shape[0], -1) @ p["w_o"]
    return out, cache


class _SeqShards(NamedTuple):
    """A DTensor cache's sequence shards on this rank: the mesh, the
    cache's batch layout with whole heads, the ``seq_axis`` shard group,
    the local key and value shards and their slot count."""
    mesh: object
    layout: tuple
    group: object
    k: torch.Tensor
    v: torch.Tensor
    S_loc: int

    def local(self, t):
        """``t`` in the batch layout, this rank's part (a plain tensor is
        replicated first)."""
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return t.redistribute(self.mesh, self.layout).to_local()

    def write(self, cache_pos: int, k_new, v_new) -> None:
        """The owning shard writes slot ``cache_pos``; the others keep
        theirs."""
        at = cache_pos - self.group.rank * self.S_loc
        if 0 <= at < self.S_loc:
            self.k[:, at] = self.local(k_new).to(self.k.dtype)
            self.v[:, at] = self.local(v_new).to(self.v.dtype)

    def placed(self, o: torch.Tensor, shape):
        """A local result as a DTensor of the batch layout."""
        from torch.distributed.tensor import DTensor
        stride, n = [], 1
        for d in reversed(shape):
            stride.insert(0, n)
            n *= d
        return DTensor.from_local(o, self.mesh, self.layout, run_check=False,
                                  shape=tuple(shape), stride=tuple(stride))


def _seq_shards(cache: AttnCache, seq_axis: str) -> _SeqShards:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.distributed import mesh_shard_group
    if not isinstance(cache.k, DTensor):
        raise ValueError(f"seq_axis={seq_axis!r} needs a DTensor cache "
                         f"sharded along it")
    mesh = cache.k.device_mesh
    names = tuple(mesh.mesh_dim_names)
    if cache.k.placements[names.index(seq_axis)] != Shard(1):
        raise ValueError(f"the cache is not sharded on {seq_axis!r} along "
                         f"its sequence: {cache.k.placements}")
    layout = tuple(Shard(0) if pl == Shard(0) else Replicate()
                   for pl in cache.k.placements)
    group = mesh_shard_group(mesh, seq_axis)
    S = cache.k.shape[1]
    if S % group.size:
        raise ValueError(f"a cache of {S} slots does not split over "
                         f"{group.size} sequence shards")
    return _SeqShards(mesh, layout, group, cache.k.to_local(),
                      cache.v.to_local(), S // group.size)


def _seq_sharded_decode(q, k_new, v_new, cache: AttnCache, cache_pos: int,
                        seq_axis: str, window, logit_cap) -> torch.Tensor:
    """:func:`gqa_decode`'s sequence-sharded step on a DTensor cache
    (B, S, KV, hd) sharded on ``seq_axis`` along S: the new token's q, k
    and v take the cache's batch layout with whole heads, the owning
    shard writes its slot, and the combine runs on the local shards over
    the ``seq_axis`` group. Returns the (B, H, hd) output as a DTensor of
    that batch layout."""
    sh = _seq_shards(cache, seq_axis)
    sh.write(cache_pos, k_new, v_new)
    o = decode_attention_seq_sharded(sh.local(q), sh.k, sh.v, cache_pos,
                                     sh.group, window=window,
                                     logit_cap=logit_cap)
    return sh.placed(o, q.shape)


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
    q = split_heads(cq @ p["w_uq"], H)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = x @ p["w_kr"]                                # shared head
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]

    k_nope = split_heads(c_kv @ p["w_uk"], H)
    v = split_heads(c_kv @ p["w_uv"], H)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.rope_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    qk_dim = m.nope_dim + m.rope_dim
    v_pad = pad(v, (0, qk_dim - m.v_dim))
    o = _flash(q_full, k_full, v_pad, positions, positions, causal=True,
               scale=qk_dim ** -0.5)
    o = o[..., :m.v_dim]
    out = merge_heads(o) @ p["w_o"]
    return out, AttnCache(c_kv, k_rope)


def mla_decode(p, x: torch.Tensor, cache: AttnCache, cache_pos,
               cfg: ModelConfig, *, seq_axis: Optional[str] = None
               ) -> Tuple[torch.Tensor, AttnCache]:
    """Absorbed-form MLA decode: never forms per-head K/V. Scores are
    ``q_nope W_uk^T c_kv + q_rope k_rope`` in f32.

    cache.k = c_kv (B, S, kv_rank); cache.v = k_rope (B, S, rope_dim). The
    new latent and rope key are written into ``cache`` in place, as
    :func:`gqa_decode` writes; the returned cache is the same tensors.
    ``seq_axis``, as :func:`gqa_decode`'s: the latent and rope-key caches
    are DTensors sharded along their sequence on that mesh dimension, the
    owning shard writes the slot and the softmax over the positions is
    the flash-decoding combine over the shards (``cache_pos`` a host
    int).
    """
    m = cfg.mla
    B, _ = x.shape
    H = cfg.n_heads
    f32 = torch.float32
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = split_heads(cq @ p["w_uq"], H)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    pos = torch.as_tensor(cache_pos, device=x.device).reshape(1)
    q_rope = apply_rope(q_rope[:, None], pos, cfg.rope_theta)[:, 0]

    c_new = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    kr_new = x @ p["w_kr"]
    kr_new = apply_rope(kr_new[:, None, None], pos, cfg.rope_theta)[:, 0, 0]
    w_uk = split_heads(p["w_uk"], H)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope.to(f32), w_uk.to(f32))
    if seq_axis is None:
        cache.k[:, cache_pos] = c_new.to(cache.k.dtype)
        cache.v[:, cache_pos] = kr_new.to(cache.v.dtype)
        o_lat = _mla_attend(q_lat, q_rope, cache.k, cache.v, cache_pos, 0,
                            cfg)
    else:
        sh = _seq_shards(cache, seq_axis)
        cache_pos = int(cache_pos)
        sh.write(cache_pos, c_new, kr_new)
        ql, qr = sh.local(q_lat), sh.local(q_rope)
        if sh.group.size == 1:
            o_lat = _mla_attend(ql, qr, sh.k, sh.v, cache_pos, 0, cfg)
        else:
            s = _mla_scores(ql, qr, sh.k, sh.v, cache_pos,
                            sh.group.rank * sh.S_loc, cfg)
            o_lat = _combine(sh.group, [s], [sh.k.to(f32)], "bhs,bsr->bhr")
        o_lat = sh.placed(o_lat, q_lat.shape)
    w_uv = split_heads(p["w_uv"], H)
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv.to(f32))
    out = merge_heads(o.to(x.dtype)) @ p["w_o"]
    return out, cache


def _mla_scores(q_lat, q_rope, c_kv, k_rope, cache_pos, offset: int,
                cfg: ModelConfig) -> torch.Tensor:
    """MLA's masked absorbed scores (B, H, S) of the cache slots
    ``offset ..``: ``q_lat c_kv + q_rope k_rope`` in f32, scaled."""
    m = cfg.mla
    f32 = torch.float32
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c_kv.to(f32))
         + torch.einsum("bhn,bsn->bhs", q_rope.to(f32), k_rope.to(f32)))
    s = s * (m.nope_dim + m.rope_dim) ** -0.5
    keep = offset + torch.arange(c_kv.shape[1], device=s.device) <= cache_pos
    return torch.where(keep, s, NEG_INF)


def _mla_attend(q_lat, q_rope, c_kv, k_rope, cache_pos, offset: int,
                cfg: ModelConfig) -> torch.Tensor:
    """The attention-weighted latent (B, H, kv_rank) over a whole cache."""
    pattn = torch.softmax(_mla_scores(q_lat, q_rope, c_kv, k_rope,
                                      cache_pos, offset, cfg), dim=-1)
    return torch.einsum("bhs,bsr->bhr", pattn, c_kv.to(torch.float32))
