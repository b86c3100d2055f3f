"""Cross-range probing order, the paper's eq. 12 (port of
``repro/core/probe.py``).

With ``l`` of ``L`` bits matching in range ``j``,
``s_hat = U_j * cos(pi * (1 - eps) * (1 - l/L))``; the ``eps`` slack keeps
a wide range with an unlucky ``l < L/2`` from sinking to the very end of
the probe order (§3.3).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DEFAULT_EPS = 0.06


def similarity_estimate(U_j: torch.Tensor, matches: torch.Tensor,
                        code_len: int, eps: float = DEFAULT_EPS
                        ) -> torch.Tensor:
    """eq. (12): ``s_hat = U_j cos[pi (1-eps) (1 - l/L)]`` (broadcasting)."""
    frac = 1.0 - matches.to(torch.float32) / float(code_len)
    return U_j * torch.cos(math.pi * (1.0 - eps) * frac)


class ProbeTable(NamedTuple):
    """All ``(j, l)`` pairs in descending eq.-12 order.

    Attributes:
      range_idx: (m*(L+1),) int32 — sub-dataset j of each entry.
      match_cnt: (m*(L+1),) int32 — match count l of each entry.
      score:     (m*(L+1),) f32   — eq. 12 value (descending).
    """

    range_idx: torch.Tensor
    match_cnt: torch.Tensor
    score: torch.Tensor


def probe_table(upper: torch.Tensor, code_len: int,
                eps: float = DEFAULT_EPS) -> ProbeTable:
    """The paper's sorted ``(U_j, l)`` structure, stable on ties."""
    m = upper.shape[0]
    ls = torch.arange(code_len + 1, dtype=torch.int32, device=upper.device)
    flat = similarity_estimate(upper[:, None], ls[None, :], code_len,
                               eps).reshape(-1)
    order = torch.argsort(-flat, stable=True)
    j_idx = torch.arange(m, dtype=torch.int32,
                         device=upper.device).repeat_interleave(code_len + 1)
    l_idx = ls.repeat(m)
    return ProbeTable(j_idx[order], l_idx[order], flat[order])


def item_scores(upper: torch.Tensor, range_id: torch.Tensor,
                hamming: torch.Tensor, code_len: int,
                eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Dense eq.-12 score per item (the order of traversing the
    :class:`ProbeTable`): ``hamming`` (..., n) int32 distances,
    ``range_id`` (n,) item ranges; higher = probed earlier."""
    matches = code_len - hamming
    return similarity_estimate(upper[range_id.long()], matches, code_len,
                               eps)


def hamming_scores(hamming: torch.Tensor) -> torch.Tensor:
    """SIMPLE-LSH probe order: plain Hamming ranking (higher = better)."""
    return -hamming.to(torch.float32)


ORDER_BLOCK = 64          # queries a block of a (Q, N) probe order


def blocked_probe_order(scores_fn, queries: torch.Tensor,
                        block: int = ORDER_BLOCK) -> torch.Tensor:
    """(Q, N) int32 columns of ``scores_fn(queries)`` in stable descending
    order (ties by column), computed ``block`` queries at a time, so that
    the (block, N) scores and sort buffers are all a call holds beside
    the result. int32, as the reference's argsort gives it: at N = 2.34 M,
    1,000 queries' int64 order would take 18.7 GB."""
    parts = [torch.argsort(-scores_fn(queries[s:s + block]), dim=-1,
                           stable=True).to(torch.int32)
             for s in range(0, queries.shape[0], block)]
    return torch.cat(parts)
