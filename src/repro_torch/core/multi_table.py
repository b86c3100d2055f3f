"""Multi-table single-probe LSH, the paper's supplementary comparison
(port of ``repro/core/multi_table.py``).

T independent projection draws over the (range-)normalized items give T
packed code arrays; a candidate is any item whose code matches the
query's in at least one table, ranked by the number of matching tables
(scaled by ``U_j`` when ranged) and exactly re-ranked.

A thin shim over :class:`repro_torch.core.index.ComposedMultiTable`:
:func:`build` is ``core.index.build`` of
``IndexSpec(family="simple", num_tables=T)``. A ``torch.Generator`` draws
the T projections in turn (the reference splits a JAX key), or
``params`` hands in T of them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import index as spec_index
from repro_torch.core.index import ComposedMultiTable, IndexSpec


class MultiTableIndex(NamedTuple):
    items: torch.Tensor       # (N, d)
    codes: torch.Tensor       # (T, N, W) int32 packed
    As: torch.Tensor          # (T, d+1, L)
    range_id: torch.Tensor    # (N,) all zeros when ranging disabled
    upper: torch.Tensor       # (m,)
    code_len: int
    ranged: bool


def _composed(index: MultiTableIndex, impl: str) -> ComposedMultiTable:
    """Re-wrap the legacy tuple for the generic single-probe engine.
    ``norms``/``lower`` are placeholders the query surface never reads."""
    spec = IndexSpec(family="simple", code_len=index.code_len,
                     m=index.upper.shape[0] if index.ranged else 1,
                     num_tables=index.codes.shape[0], impl=impl)
    placeholder = torch.zeros_like(index.upper)
    return ComposedMultiTable(spec, index.items, placeholder, index.codes,
                              index.range_id, index.upper, placeholder,
                              tuple(index.As), index.code_len)


def build(items, generator, code_len: int, num_tables: int, *,
          num_ranges: int = 1, impl: str = "auto", params=None,
          device=None) -> MultiTableIndex:
    """T-table SIMPLE-LSH (RANGE-LSH when ``num_ranges > 1``) on
    ``device`` (the card unless ``device="cpu"``)."""
    spec = IndexSpec(family="simple", code_len=code_len, m=num_ranges,
                     num_tables=num_tables, impl=impl)
    cidx = spec_index.build(spec, items, generator, params=params,
                            strict=False, device=device)
    return MultiTableIndex(cidx.items, cidx.codes, torch.stack(cidx.params),
                           cidx.range_id, cidx.upper, code_len,
                           num_ranges > 1)


def candidate_scores(index: MultiTableIndex, queries: torch.Tensor, *,
                     impl: str = "auto") -> torch.Tensor:
    """(Q, N) score = #tables with an exact bucket match, norm-scaled for
    ranged indexes (0 => not a candidate)."""
    return _composed(index, impl).candidate_scores(queries)


def query(index: MultiTableIndex, queries: torch.Tensor, k: int, *,
          max_candidates: int = 512, impl: str = "auto"
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-probe query: exact re-rank restricted to true candidates
    (score > 0). Returns (vals, ids, num_candidates (Q,)); slots beyond
    the candidate count come back as (-inf, -1)."""
    return _composed(index, impl).query(queries, k,
                                        max_candidates=max_candidates)
