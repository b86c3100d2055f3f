"""Exact MIPS, candidate re-ranking and recall (port of
``repro/core/topk.py``).

Top-k ties go to the first occurrence, as ``lax.top_k`` does
(:func:`repro_torch.kernels.ref.stable_topk`). Products on the card run
in full f32: TF32 is switched off around them (:func:`full_f32`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import full_f32, stable_topk
from repro_torch.obs import cost
from repro_torch.obs.trace import costed_span

EXACT_CHUNK = 64          # queries per (chunk, N) score block in exact_mips
# bytes of gathered (P, d) candidate rows a re-rank holds at once (here and
# in the streaming engine's merged re-rank), and of the (Qc, N, K) equality
# block of L2-ALSH's match count
RERANK_BYTES = 1 << 30
RECALL_CHUNK = 64         # queries per (chunk, N) position block


def exact_mips(queries: torch.Tensor, items: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force top-k MIPS: (Q, d) x (N, d) -> values (Q, k), int64
    ids (Q, k). Scores are formed ``EXACT_CHUNK`` queries at a time so
    the (Q, N) block stays bounded."""
    vals, ids = [], []
    with full_f32():
        for s in range(0, queries.shape[0], EXACT_CHUNK):
            v, i = stable_topk(queries[s:s + EXACT_CHUNK] @ items.T, k)
            vals.append(v)
            ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def _first_occurrence_dups(cand_ids: torch.Tensor) -> torch.Tensor:
    """(Q, P) bool: True where an id repeats one earlier in its row
    (stable-sort the ids, flag equal neighbours, scatter back)."""
    q = cand_ids.shape[0]
    order = torch.argsort(cand_ids, dim=1, stable=True)
    sorted_ids = torch.gather(cand_ids, 1, order)
    dup_sorted = torch.cat(
        [torch.zeros((q, 1), dtype=torch.bool, device=cand_ids.device),
         sorted_ids[:, 1:] == sorted_ids[:, :-1]], dim=1)
    return torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)


def rerank_blocks(q: int, p: int, d: int, k: int) -> Tuple[int, int]:
    """(queries, candidates) of one re-rank block: whole rows of queries
    while their gathered (P, d) f32 rows fit ``RERANK_BYTES``, else one
    query and as many candidates as fit (never fewer than k)."""
    max_bytes = RERANK_BYTES
    row = 4 * d
    if row * p <= max_bytes:
        return max(1, min(q, max_bytes // max(1, row * p))), p
    return 1, min(p, max(k, max_bytes // max(1, row)))


def gathered_scores(queries: torch.Tensor, rows: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """(Q, P) f32 inner products of each query with its rows ``rows[ids]``
    (any float type, scored in f32 without TF32), gathered a block of
    queries at a time so that at most ``RERANK_BYTES`` of f32 rows are
    held."""
    q, p = ids.shape
    per_query = 4 * rows.shape[1] * max(p, 1)
    qb = max(1, min(q, RERANK_BYTES // per_query))
    queries = queries.to(torch.float32)
    out = torch.empty((q, p), dtype=torch.float32, device=ids.device)
    with full_f32():
        for s in range(0, q, qb):
            out[s:s + qb] = torch.einsum(
                "qd,qpd->qp", queries[s:s + qb],
                rows[ids[s:s + qb].long()].to(torch.float32))
    return out


def rerank(queries: torch.Tensor, items: torch.Tensor,
           cand_ids: torch.Tensor, k: int, *, tracker=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of per-query candidates (Q, P) -> (vals, item ids)
    (Q, k). A repeated id is masked to its first occurrence before the
    top-k, so one item never claims two result slots.

    The (Q, P) scores are formed a block at a time
    (:func:`rerank_blocks`), so at most ``RERANK_BYTES`` of gathered
    candidate rows are held; then one :func:`stable_topk` a block of
    queries ranks them, equal scores to the first position. ``tracker``
    adds the ``re_rank`` (scores) and ``top_k`` stage spans, each over
    the whole loop, synchronised at their ends."""
    q, p = cand_ids.shape
    d = items.shape[1]
    qb, pb = rerank_blocks(q, p, d, int(k))
    with costed_span(tracker, "repro.engine.re_rank", cost.re_rank_cost,
                     q, p, d) as sp:
        scores = torch.empty((q, p), dtype=torch.float32,
                             device=cand_ids.device)
        for s in range(0, q, qb):
            for c in range(0, p, pb):
                block = cand_ids[s:s + qb, c:c + pb].long()
                with full_f32():
                    scores[s:s + qb, c:c + pb] = torch.einsum(
                        "qd,qpd->qp", queries[s:s + qb], items[block])
        sp.sync(scores)
    low = torch.finfo(torch.float32).min
    vals, ids = [], []
    with costed_span(tracker, "repro.engine.top_k", cost.top_k_cost,
                     q, p, k) as sp:
        for s in range(0, q, qb):
            cand = cand_ids[s:s + qb]
            masked = torch.where(_first_occurrence_dups(cand), low,
                                 scores[s:s + qb])
            v, pos = stable_topk(masked, k)
            vals.append(v)
            ids.append(torch.gather(cand, 1, pos))
        vals, ids = sp.sync((torch.cat(vals), torch.cat(ids)))
    return vals, ids


def recall_at(retrieved: torch.Tensor, truth: torch.Tensor) -> float:
    """Mean fraction of ``truth`` ids (Q, k) present in ``retrieved``
    (Q, P)."""
    hit = (retrieved[:, :, None] == truth[:, None, :]).any(dim=1)
    return float(hit.to(torch.float32).mean())


def truth_positions(probe_order: torch.Tensor, truth: torch.Tensor
                    ) -> torch.Tensor:
    """(Q, k) int32 position of each truth id in its query's probe order
    (Q, N), found ``RECALL_CHUNK`` queries at a time so that the (chunk,
    N) position block stays bounded."""
    q, n = probe_order.shape
    out = []
    for s in range(0, q, RECALL_CHUNK):
        order = probe_order[s:s + RECALL_CHUNK].long()
        rows = order.shape[0]
        pos = torch.empty((rows, n), dtype=torch.int32, device=order.device)
        pos.scatter_(1, order, torch.arange(
            n, dtype=torch.int32, device=order.device).expand(rows, n))
        out.append(torch.gather(pos, 1, truth[s:s + RECALL_CHUNK].to(
            order.device).long()))
    return torch.cat(out)


def recall_from_positions(positions: torch.Tensor, probe_counts
                          ) -> torch.Tensor:
    """(len(probe_counts),) f32 fraction of truth positions below each
    count: an exact count times the f32 reciprocal of the total, as
    ``jnp.mean`` of the 0/1 floats gives it."""
    flat = positions.reshape(-1)
    inv = float(np.float32(1.0) / np.float32(flat.numel()))
    hits = [int((flat < int(c)).sum()) for c in probe_counts]
    return torch.tensor(hits, dtype=torch.float32) * inv


def probed_recall_curve(probe_order: torch.Tensor, truth: torch.Tensor,
                        probe_counts) -> torch.Tensor:
    """Recall@T of the probing order for each T in ``probe_counts``: the
    fraction of the top-k ``truth`` ids (Q, k) among the first T entries
    of ``probe_order`` (Q, N), the paper's Fig. 2 curves. Returns a
    (len(probe_counts),) f32 tensor on the host."""
    return recall_from_positions(truth_positions(probe_order, truth),
                                 probe_counts)
