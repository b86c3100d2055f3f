"""Merged candidate generation: base bucket store + delta buffer, exact
(port of ``repro/streaming/engine.py``).

The contract is bit-parity with a from-scratch rebuild: for any interleaving
of inserts and deletes, the merged candidate sequence equals the canonical
``(rank[j, l], CSR position)`` sequence of a bucket store rebuilt over the
mutated dataset (frozen hash functions / current ``U_j``). Three pieces make
one stable sort sufficient:

  * base arm — the bucket traversal (``bucket_match`` over the directory,
    ``bucket_gather`` of the probed runs) or the dense scan
    (``bucket_match`` over the CSR-ordered codes), over-probed to
    ``probe_base = min(N_csr, num_probe + max_tombstones)`` so that after
    masking at most ``max_tombstones`` dead rows at least ``num_probe``
    live base candidates survive in canonical order;
  * delta arm — one ``delta_scan`` over the buffer; dead slots come back as
    ``-1`` and rank as ``RANK_SENTINEL`` (sorted last). Columns are
    pre-arranged by the buffer's canonical ``perm``;
  * merge — two-pass LSD stable sort by ``(rank, ord)`` where ``ord`` is
    the directory-position ordinal (base bucket ``b`` -> ``2b``; delta
    slots carry their host-computed placement). The pre-arranged column
    order — base CSR order first, then delta slots in ``(range_id, code,
    id)`` order — is the canonical tie order, so stability finishes the job.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.topk import RERANK_BYTES
from repro_torch.kernels import ops
from repro_torch.kernels.ref import full_f32, stable_topk

RANK_SENTINEL = torch.iinfo(torch.int32).max


def bucket_runs(arrs: Dict[str, torch.Tensor], q_codes: torch.Tensor,
                probe_base: int, hash_bits: int, impl: str
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bucket arm's directory ranks (Q, B) and its probe-ordered runs,
    the first ``min(B, probe_base)`` buckets by rank: (cum (Q, S+1),
    starts (Q, S)), the inputs of its ``bucket_gather``."""
    matches = ops.bucket_match(q_codes, arrs["bucket_code"], hash_bits,
                               impl=impl)                           # (Q, B)
    brank = arrs["rank"][arrs["bucket_rid"][None, :], matches]
    order = torch.argsort(brank, dim=-1, stable=True)
    B = arrs["bucket_rid"].shape[0]
    sel = order[:, :min(B, probe_base)]
    start = arrs["bucket_start"]
    sizes = (start[1:] - start[:-1])[sel]
    starts = start[:-1][sel]
    cum = torch.cat([torch.zeros((sel.shape[0], 1), dtype=torch.int32,
                                 device=sel.device),
                     torch.cumsum(sizes, dim=-1, dtype=torch.int32)],
                    dim=-1)
    return brank, cum, starts


def _base_arm(arrs: Dict[str, torch.Tensor], q_codes: torch.Tensor,
              probe_base: int, hash_bits: int, engine: str, impl: str
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rank, ord, id) of the first ``probe_base`` base-store candidates in
    canonical order; dead (tombstoned) rows carry RANK_SENTINEL."""
    rank = arrs["rank"]
    if engine == "bucket":
        brank, cum, starts = bucket_runs(arrs, q_codes, probe_base,
                                         hash_bits, impl)
        csr_pos = ops.bucket_gather(cum, starts, probe_base, impl=impl)
        bucket_of = arrs["csr_bucket"][csr_pos]
        base_rank = torch.gather(brank, 1, bucket_of.long())
    else:  # dense scan over the CSR-ordered code table
        m_csr = ops.bucket_match(q_codes, arrs["csr_codes"], hash_bits,
                                 impl=impl)                         # (Q, N)
        rank_csr = rank[arrs["csr_rid"][None, :], m_csr]
        order = torch.argsort(rank_csr, dim=-1, stable=True)
        csr_pos = order[:, :probe_base]
        base_rank = torch.gather(rank_csr, 1, csr_pos)
        bucket_of = arrs["csr_bucket"][csr_pos]
    base_ids = arrs["item_ids"][csr_pos]
    dead = ~arrs["live"][base_ids]
    base_rank = torch.where(dead, RANK_SENTINEL, base_rank)
    return base_rank, 2 * bucket_of, base_ids


def _delta_arm(arrs: Dict[str, torch.Tensor], q_codes: torch.Tensor,
               hash_bits: int, impl: str
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rank, ord, id) of every delta slot, columns in canonical ``perm``
    order; dead slots carry RANK_SENTINEL."""
    dm = ops.delta_scan(q_codes, arrs["d_codes"], arrs["d_live"], hash_bits,
                        impl=impl)                                  # (Q, C)
    d_rank = arrs["rank"][arrs["d_rid"][None, :], torch.clamp_min(dm, 0)]
    d_rank = torch.where(dm < 0, RANK_SENTINEL, d_rank)
    perm = arrs["d_perm"]
    Q, C = dm.shape
    d_rank = d_rank[:, perm]
    d_ord = arrs["d_ord"][perm][None, :].expand(Q, C)
    d_ids = arrs["d_ids"][perm][None, :].expand(Q, C)
    return d_rank, d_ord, d_ids


def merged_candidates(arrs: Dict[str, torch.Tensor], q_codes: torch.Tensor,
                      *, num_probe: int, probe_base: int, hash_bits: int,
                      engine: str, impl: str) -> torch.Tensor:
    """(Q, num_probe) int32 global item ids over base + delta, identical to
    a from-scratch rebuild on the mutated dataset (the caller guarantees
    ``num_probe`` <= live item count)."""
    if probe_base > 0:
        b_rank, b_ord, b_ids = _base_arm(arrs, q_codes, probe_base,
                                         hash_bits, engine, impl)
        d_rank, d_ord, d_ids = _delta_arm(arrs, q_codes, hash_bits, impl)
        rank_all = torch.cat([b_rank, d_rank], dim=1)
        ord_all = torch.cat([b_ord, d_ord], dim=1)
        ids_all = torch.cat([b_ids, d_ids], dim=1)
    else:  # base store empty (everything lives in the delta)
        rank_all, ord_all, ids_all = _delta_arm(arrs, q_codes, hash_bits,
                                                impl)
    # LSD two-pass stable sort: secondary key ord, then primary key rank.
    o1 = torch.argsort(ord_all, dim=-1, stable=True)
    r1 = torch.gather(rank_all, 1, o1)
    o2 = torch.argsort(r1, dim=-1, stable=True)
    morder = torch.gather(o1, 1, o2[:, :num_probe])
    return torch.gather(ids_all, 1, morder)


def merged_rerank(store_items: torch.Tensor, delta_items: torch.Tensor,
                  store_live: torch.Tensor, delta_live: torch.Tensor,
                  queries: torch.Tensor, cand: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank with the two-source gather: global id < N_store reads
    the base store, otherwise delta slot ``id - N_store``. Dead candidates
    score ``-inf`` (a probe budget past the live count pads the tail with
    tombstoned rows); equal scores go to the first occurrence. The rows
    are gathered a chunk of queries at a time, within ``RERANK_BYTES``."""
    n_store = store_items.shape[0]
    q, p = cand.shape
    d = store_items.shape[1]
    chunk = max(1, RERANK_BYTES // max(1, 4 * p * d))
    vals, ids = [], []
    for s in range(0, q, chunk):
        c = cand[s:s + chunk].long()
        in_base = c < n_store
        base_pos = torch.clamp(c, 0, n_store - 1)
        slot = torch.clamp(c - n_store, 0, delta_items.shape[0] - 1)
        vecs = store_items[base_pos]
        vecs[~in_base] = delta_items[slot[~in_base]]
        live = torch.where(in_base, store_live[base_pos], delta_live[slot])
        with full_f32():
            scores = torch.einsum("qd,qpd->qp",
                                  queries[s:s + chunk].to(torch.float32),
                                  vecs)
        scores = torch.where(live, scores, float("-inf"))
        v, pos = stable_topk(scores, k)
        vals.append(v)
        ids.append(torch.gather(cand[s:s + chunk], 1, pos))
    return torch.cat(vals), torch.cat(ids)
