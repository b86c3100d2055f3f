"""Exact MIPS, candidate re-ranking and recall (port of
``repro/core/topk.py``).

Top-k ties go to the first occurrence, as ``lax.top_k`` does
(:func:`repro_torch.kernels.ref.stable_topk`). Products on the card run
in full f32: TF32 is switched off around them (:func:`full_f32`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ref import full_f32, stable_topk

EXACT_CHUNK = 64          # queries per (chunk, N) score block in exact_mips


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


def rerank(queries: torch.Tensor, items: torch.Tensor,
           cand_ids: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of per-query candidates (Q, P) -> (vals, item ids)
    (Q, k). A repeated id is masked to its first occurrence before the
    top-k, so one item never claims two result slots."""
    q, p = cand_ids.shape
    with full_f32():
        scores = torch.einsum("qd,qpd->qp", queries, items[cand_ids.long()])
    order = torch.argsort(cand_ids, dim=1, stable=True)
    sorted_ids = torch.gather(cand_ids, 1, order)
    dup_sorted = torch.cat(
        [torch.zeros((q, 1), dtype=torch.bool, device=cand_ids.device),
         sorted_ids[:, 1:] == sorted_ids[:, :-1]], dim=1)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    scores = torch.where(dup, torch.finfo(scores.dtype).min, scores)
    vals, pos = stable_topk(scores, k)
    return vals, torch.gather(cand_ids, 1, pos)


def recall_at(retrieved: torch.Tensor, truth: torch.Tensor) -> float:
    """Mean fraction of ``truth`` ids (Q, k) present in ``retrieved``
    (Q, P)."""
    hit = (retrieved[:, :, None] == truth[:, None, :]).any(dim=1)
    return float(hit.to(torch.float32).mean())
