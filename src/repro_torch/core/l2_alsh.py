"""L2-ALSH (Shrivastava & Li 2014) and the §5 norm-ranging extension
(port of ``repro/core/l2_alsh.py``).

Items are scaled so the max 2-norm is ``U`` (< 1), transformed with
``P(x) = [Ux; ||Ux||^2; ...; ||Ux||^{2^m}]`` and hashed with the L2 LSH
family (eq. 2); queries are normalized and transformed with
``Q(q) = [q; 1/2; ...; 1/2]``. Probe order ranks items by the number of
matching integer hashes out of K = code_len (single-table multi-probe).
:func:`build_ranged` (§5) partitions by norm and scales each range by
``U / U_j``.

A thin shim over the composable index API: both builds are
``core.index.build`` of ``IndexSpec(family="l2_alsh", m=...)`` and return
the legacy :class:`L2ALSHIndex` tuple with the same arrays. A
``torch.Generator`` draws ``(a, b)`` (the reference takes a JAX key), or
``params`` hands the pair in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import hashing
from repro_torch.core import index as spec_index
from repro_torch.core.family import L2ALSHFamily, L2ALSHParams
from repro_torch.core.index import IndexSpec
from repro_torch.core.probe import blocked_probe_order
from repro_torch.core.topk import rerank


class L2ALSHIndex(NamedTuple):
    """L2-ALSH index (optionally norm-ranged); every tensor on one device.

    Attributes:
      items:     (N, d) original items.
      norms:     (N,)   2-norms.
      hashes:    (N, K) int32 L2-LSH values of the transformed items.
      a, b:      L2 hash parameters ((d+m, K) and (K,)).
      range_id:  (N,)   sub-dataset ids (all zero when un-ranged).
      scale:     (R,)   per-range scaling (U / U_j); R=1 when un-ranged.
      upper:     (R,)   per-range max original 2-norm U_j (effective).
      m, U, r:   ALSH transform order / scaling / quantization width.
    """

    items: torch.Tensor
    norms: torch.Tensor
    hashes: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    range_id: torch.Tensor
    scale: torch.Tensor
    upper: torch.Tensor
    m: int
    U: float
    r: float


def _family(index: L2ALSHIndex) -> L2ALSHFamily:
    return L2ALSHFamily(m=index.m, U=index.U, r=index.r)


def _params(index: L2ALSHIndex) -> L2ALSHParams:
    return L2ALSHParams(index.a, index.b)


def _shim_build(items, generator, code_len, num_ranges, scheme, m, U, r,
                params, device) -> L2ALSHIndex:
    spec = IndexSpec(family="l2_alsh", code_len=code_len, m=num_ranges,
                     scheme=scheme, alsh_m=m, alsh_U=U, alsh_r=r)
    cidx = spec_index.build(spec, items, generator, params=params,
                            strict=False, device=device)
    fam = cidx.family
    # legacy tuples carry the *effective* upper and its scaling U / U_j
    return L2ALSHIndex(cidx.items, cidx.norms, cidx.codes, cidx.params.a,
                       cidx.params.b, cidx.range_id,
                       hashing.scalar_over(fam.U, cidx.upper_eff),
                       cidx.upper_eff, fam.m, fam.U, fam.r)


def build(items, generator, code_len: int, *, m: Optional[int] = None,
          U: Optional[float] = None, r: Optional[float] = None,
          params=None, device=None) -> L2ALSHIndex:
    """Plain L2-ALSH with the recommended (m=3, U=0.83, r=2.5), on
    ``device`` (the card unless ``device="cpu"``)."""
    return _shim_build(items, generator, code_len, 1, "percentile", m, U,
                       r, params, device)


def build_ranged(items, generator, code_len: int, num_ranges: int, *,
                 scheme: str = "percentile", m: Optional[int] = None,
                 U: Optional[float] = None, r: Optional[float] = None,
                 params=None, device=None) -> L2ALSHIndex:
    """§5: norm-ranged L2-ALSH — per-range scaling U / U_j."""
    return _shim_build(items, generator, code_len, num_ranges, scheme, m,
                       U, r, params, device)


def encode_queries(index: L2ALSHIndex, queries: torch.Tensor
                   ) -> torch.Tensor:
    return _family(index).encode_queries(_params(index), queries)


def probe_scores(index: L2ALSHIndex, queries: torch.Tensor
                 ) -> torch.Tensor:
    """(Q, N) probe priority: the inner product estimated from the match
    count, scale-aware across norm ranges (``L2ALSHFamily.score_table``)."""
    fam = _family(index)
    params = _params(index)
    qh = fam.encode_queries(params, queries)                  # (Q, K)
    K = index.hashes.shape[1]
    matches = fam.match_counts(params, qh, index.hashes, K)
    table = fam.score_table(index.upper, K)                   # (R, K+1)
    return table[index.range_id[None, :].long(), matches.long()]


def probe_order(index: L2ALSHIndex, queries: torch.Tensor
                ) -> torch.Tensor:
    """(Q, N) int32 item ids in probe order, a block of queries at a
    time."""
    return blocked_probe_order(lambda q: probe_scores(index, q), queries)


def query(index: L2ALSHIndex, queries: torch.Tensor, k: int,
          num_probe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    order = probe_order(index, queries)
    return rerank(queries, index.items, order[:, :num_probe], k)
