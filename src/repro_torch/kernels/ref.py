"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, in plain tensor
ops. The CPU path of every wrapper in :mod:`repro_torch.kernels.ops`
runs these, the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. No
main-path call reaches them when the tensors live on a CUDA device, save
one that no kernel stands behind: the sequence-sharded MLA decode
(``models/attention.py`` ``mla_decode`` over several shards) takes
:func:`latent_scores_ref` as the plain math of its shards' scores, which
its cross-shard combine needs whole.

Packed codes are int32 tensors holding the bits of the reference's
uint32 words (``np.asarray(u32).view(np.int32)``): torch has no popcount
and no CPU shifts on uint32, so :func:`popcount32` widens to int64.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.core.hashing import pack_bits

NEG = -3e38       # score of a candidate slot past the query's take total
# score of a masked slot: one past the latent cache's live position here,
# and every attention mask of models/attention.py, which takes it from here
NEG_INF = -1e30


@contextlib.contextmanager
def full_f32():
    """Run f32 matrix products without TF32 (cuBLAS would otherwise be
    free to round inputs to 10 mantissa bits when the flag is on)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set-bit count of every 32-bit word of an int32 tensor (SWAR on an
    int64 widening, so no step can overflow)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def stable_topk(x: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis of a 2-D tensor with ``lax.top_k``'s tie
    rule: equal values come out in ascending column order.

    ``torch.topk`` gives the right values but no tie order, so only its
    k-th value is used, as a threshold: the columns at or above it (k plus
    any ties) are pulled out in column order and ranked by a stable
    descending sort. Returns (values, int64 columns)."""
    rows, m = x.shape
    if not 0 < k <= m:
        raise ValueError(f"stable_topk: k={k} outside (0, {m}]")
    thr = torch.topk(x, k, dim=-1).values[:, -1:]
    r, c = torch.nonzero(x >= thr, as_tuple=True)      # row-major order
    cnt = torch.bincount(r, minlength=rows)
    width = int(cnt.max())
    first = torch.cumsum(cnt, 0) - cnt
    slot = torch.arange(r.shape[0], device=x.device) - first[r]
    cand = torch.zeros((rows, width), dtype=torch.int64, device=x.device)
    cval = torch.full((rows, width), float("-inf"), dtype=x.dtype,
                      device=x.device)
    cand[r, slot] = c
    cval[r, slot] = x[r, c]
    # padding sits after every real entry of its row, so a real -inf
    # still ranks before it under the stable sort
    vals, order = torch.sort(cval, dim=-1, descending=True, stable=True)
    return vals[:, :k], torch.gather(cand, 1, order[:, :k])


def hash_encode_ref(x: torch.Tensor, A: torch.Tensor,
                    tail: Optional[torch.Tensor] = None,
                    a_tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed sign codes of ``x @ A [+ tail * a_tail]``: (N, ceil(L/32))
    int32, bit ``i`` of word ``w`` = code bit ``32 w + i``, pad bits 0.

    The product is summed in k order with every multiply and add rounded
    on its own (no fused multiply-add), exactly as the CUDA kernel does,
    so each sign decision agrees bit for bit on the card. The tail term is
    added after the product, in the reference's op order."""
    x = x.to(torch.float32)
    A = A.to(torch.float32)
    n, d = x.shape
    proj = torch.zeros((n, A.shape[1]), dtype=torch.float32,
                       device=x.device)
    for k in range(d):
        proj.add_(x[:, k:k + 1] * A[k:k + 1, :])
    if tail is not None:
        proj = proj + tail.to(torch.float32)[:, None] * a_tail[None, :]
    return pack_bits(proj >= 0.0)


def hamming_ref(q_codes: torch.Tensor, db_codes: torch.Tensor
                ) -> torch.Tensor:
    """All-pairs Hamming distance: (Q, W) x (N, W) -> (Q, N) int32."""
    x = torch.bitwise_xor(q_codes[:, None, :], db_codes[None, :, :])
    return popcount32(x).sum(dim=-1, dtype=torch.int32)


def bucket_match_ref(q_codes: torch.Tensor, bucket_codes: torch.Tensor,
                     hash_bits: int) -> torch.Tensor:
    """Directory match counts ``hash_bits - hamming``: (Q, B) int32."""
    return hash_bits - hamming_ref(q_codes, bucket_codes)


def delta_scan_ref(q_codes: torch.Tensor, delta_codes: torch.Tensor,
                   live: torch.Tensor, hash_bits: int) -> torch.Tensor:
    """Delta-buffer match counts ``hash_bits - hamming`` for live slots,
    ``-1`` for dead ones: (Q, C) int32."""
    matches = bucket_match_ref(q_codes, delta_codes, hash_bits)
    return torch.where(live[None, :] != 0, matches, -1).to(torch.int32)


def mips_topk_ref(queries: torch.Tensor, items: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner products: the full f32 product (no TF32), then
    :func:`stable_topk` (equal scores go to the lower id). Returns vals
    (Q, k) f32 and ids (Q, k) int32."""
    with full_f32():
        scores = queries.to(torch.float32) @ items.to(torch.float32).T
    vals, ids = stable_topk(scores, k)
    return vals, ids.to(torch.int32)


def bucket_gather_ref(cum: torch.Tensor, starts: torch.Tensor,
                      num_probe: int) -> torch.Tensor:
    """CSR position of the p-th probed item per query.

    ``cum`` (Q, S+1): exclusive prefix of the probe-ordered run sizes;
    ``starts`` (Q, S): CSR start of each run. Slot p lies in run
    ``j = #{i : cum[q, i+1] <= p}``, clamped to S-1. Returns (Q,
    num_probe) int32."""
    q, s = starts.shape
    p = torch.arange(num_probe, dtype=cum.dtype, device=cum.device)
    j = torch.searchsorted(cum[:, 1:].contiguous(),
                           p.expand(q, -1).contiguous(), right=True)
    j = j.clamp_(max=s - 1)
    base = torch.gather(starts, 1, j)
    lo = torch.gather(cum, 1, j)
    return (base + (p[None, :] - lo)).to(torch.int32)


def fused_query_ref(queries: torch.Tensor, cum: torch.Tensor,
                    starts: torch.Tensor, items: torch.Tensor, total: int,
                    k: int, *, kprime: Optional[int] = None,
                    payload: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staged form of the fused query: run expansion -> phase-1 scores
    ``q . (payload_row * scale)`` -> top-k' survivors -> f32 rescore ->
    top-k. Returns vals (Q, k) f32 and CSR positions (Q, k) int32; slots
    past a query's take total score ``NEG`` at position -1."""
    if kprime is None:
        kprime = max(k, min(max(4 * k, 32), total))
    if payload is None:
        payload = items
        scale = torch.ones((items.shape[0], 1), dtype=torch.float32,
                           device=items.device)
    q = queries.to(torch.float32)
    pos = bucket_gather_ref(cum, starts, total)                # (Q, total)
    valid = (torch.arange(total, device=cum.device)[None, :]
             < cum[:, -1:])
    safe = torch.where(valid, pos, 0).long()
    deq = payload[safe].to(torch.float32) * scale[safe][..., 0][..., None]
    s1 = torch.einsum("qd,qpd->qp", q, deq)
    s1 = torch.where(valid, s1, NEG)
    _, si = stable_topk(s1, min(int(kprime), total))
    spos = torch.gather(pos, 1, si)
    ok = torch.gather(valid, 1, si)
    rows = items.to(torch.float32)[torch.where(ok, spos, 0).long()]
    rescored = torch.where(ok, torch.einsum("qd,qpd->qp", q, rows), NEG)
    fv, fi = stable_topk(rescored, k)
    fpos = torch.gather(torch.where(ok, spos, -1), 1, fi)
    return fv, fpos.to(torch.int32)


def range_cum_before(rid_o: torch.Tensor, sizes_o: torch.Tensor,
                     num_ranges: int) -> torch.Tensor:
    """(Q, B) cumulative same-range sizes before each probe-ordered slot;
    with unit sizes, the within-range probe position. One masked int32
    cumsum a range."""
    crb = torch.zeros_like(sizes_o)
    for j in range(num_ranges):
        mask = rid_o == j
        sz_j = torch.where(mask, sizes_o, 0)
        crb += torch.where(
            mask, torch.cumsum(sz_j, dim=-1, dtype=torch.int32) - sz_j, 0)
    return crb


def planned_take(rid_o: torch.Tensor, sizes_o: torch.Tensor,
                 budgets) -> torch.Tensor:
    """(Q, B) take per probe-ordered bucket: what is left of its range's
    budget (``budgets``: R ints or an (R,) int32 tensor) after the
    same-range buckets probed before it."""
    caps = torch.as_tensor(budgets, dtype=torch.int32, device=rid_o.device)
    crb = range_cum_before(rid_o, sizes_o, caps.shape[0])
    return torch.minimum(torch.clamp_min(caps[rid_o] - crb, 0), sizes_o)


def exclusive_cum(sizes: torch.Tensor) -> torch.Tensor:
    """(Q, S+1) int32 ``[0, cumsum(sizes)]`` of each row."""
    zero = torch.zeros((sizes.shape[0], 1), dtype=torch.int32,
                       device=sizes.device)
    return torch.cat([zero, torch.cumsum(sizes, dim=-1,
                                         dtype=torch.int32)], dim=-1)


def planned_runs_ref(order: torch.Tensor, bucket_start: torch.Tensor,
                     bucket_rid: torch.Tensor, caps: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs realizing per-range budgets over a probe order: (cum (Q, B+1),
    starts (Q, B)) int32. Bucket ``order[q, s]`` starts its run at its CSR
    offset and takes what is left of its range's cap (:func:`planned_take`);
    ``cum`` is the exclusive prefix of the takes."""
    sizes_o = (bucket_start[1:] - bucket_start[:-1])[order]
    starts = bucket_start[:-1][order]
    take = planned_take(bucket_rid[order], sizes_o, caps)
    return exclusive_cum(take), starts


def latent_scores_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_kv: torch.Tensor, k_rope: torch.Tensor, pos,
                      scale: float, offset: int = 0) -> torch.Tensor:
    """MLA's masked absorbed scores (B, H, S) of the cache slots ``offset
    ..``: ``q_lat c_kv + q_rope k_rope`` in f32, times ``scale``; slots
    past ``pos`` (an int or a one-element tensor) score
    :data:`NEG_INF`."""
    f32 = torch.float32
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c_kv.to(f32))
         + torch.einsum("bhn,bsn->bhs", q_rope.to(f32), k_rope.to(f32)))
    s = s * scale
    keep = offset + torch.arange(c_kv.shape[1], device=s.device) <= pos
    return torch.where(keep, s, NEG_INF)


def latent_attend_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_kv: torch.Tensor, k_rope: torch.Tensor, pos,
                      scale: float) -> torch.Tensor:
    """The attention-weighted latent (B, H, r) f32 over a whole cache:
    the softmax of :func:`latent_scores_ref` over its slots, times the
    latent cast to f32."""
    pattn = torch.softmax(latent_scores_ref(q_lat, q_rope, c_kv, k_rope,
                                            pos, scale), dim=-1)
    return torch.einsum("bhs,bsr->bhr", pattn, c_kv.to(torch.float32))
