"""NORM-RANGING LSH (RANGE-LSH), the paper's contribution (port of
``repro/core/range_lsh.py``).

Index build (Algorithm 1): rank items by 2-norm, partition into ``m``
sub-datasets by percentile (or uniformly over the norm domain, Fig 3a),
normalize each by its local max norm ``U_j`` and hash with SIMPLE-LSH.
Per the paper's protocol (§4) the code budget ``L`` is split:
``ceil(log2 m)`` bits identify the sub-dataset, the remaining
``hash_bits`` are sign-projection hashes. One projection ``A`` is shared
by all sub-datasets.

Query processing (Algorithm 2 + §3.3) probes every sub-dataset, ordered
by eq. 12, ``s_hat = U_j cos[pi (1-eps) (1 - l / L_hash)]``: densely
(one Hamming scan and a per-item score), or through the query engines.

A thin shim over the composable index API: :func:`build` is
``core.index.build`` of ``IndexSpec(family="simple", m=...)`` and returns
the legacy :class:`RangeLSHIndex` tuple with the same arrays. A
``torch.Generator`` draws the projection (the reference takes a JAX
key), or ``params`` hands one in.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import index as spec_index
from repro_torch.core.family import SimpleLSHFamily
from repro_torch.core.index import IndexSpec
from repro_torch.core.probe import (DEFAULT_EPS, blocked_probe_order,
                                    item_scores, probe_table)
from repro_torch.core.simple_lsh import code_bucket_stats
from repro_torch.core.topk import rerank


class RangeLSHIndex(NamedTuple):
    """Immutable RANGE-LSH index; every tensor on one device.

    Attributes:
      items:     (N, d) original item vectors.
      norms:     (N,)   item 2-norms.
      codes:     (N, W) int32 packed hash codes (hash_bits wide).
      range_id:  (N,)   int32 sub-dataset of each item.
      upper:     (m,)   U_j per sub-dataset (0 for an empty one).
      lower:     (m,)   min norm per sub-dataset.
      A:         (d+1, hash_bits) shared projection matrix.
      code_len:  int    total code budget L (= hash_bits + index bits).
      hash_bits: int    sign-projection bits actually hashed.
      eps:       float  eq.-12 slack.
    """

    items: torch.Tensor
    norms: torch.Tensor
    codes: torch.Tensor
    range_id: torch.Tensor
    upper: torch.Tensor
    lower: torch.Tensor
    A: torch.Tensor
    code_len: int
    hash_bits: int
    eps: float

    @property
    def num_ranges(self) -> int:
        return self.upper.shape[0]


def build(items, generator, code_len: int, m: int, *,
          scheme: str = "percentile", eps: float = DEFAULT_EPS,
          charge_index_bits: bool = True, impl: str = "auto",
          params=None, device=None) -> RangeLSHIndex:
    """Algorithm 1, through ``NormRangePartitioned(SimpleLSH)``, on
    ``device`` (the card unless ``device="cpu"``).
    ``charge_index_bits=False`` gives all L bits to hashing."""
    spec = IndexSpec(family="simple", code_len=code_len, m=m, scheme=scheme,
                     eps=eps, charge_index_bits=charge_index_bits,
                     impl=impl)
    cidx = spec_index.build(spec, items, generator, params=params,
                            strict=False, device=device)
    return RangeLSHIndex(cidx.items, cidx.norms, cidx.codes, cidx.range_id,
                         cidx.upper, cidx.lower, cidx.params, code_len,
                         cidx.hash_bits, eps)


def encode_queries(index: RangeLSHIndex, queries: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    return SimpleLSHFamily().encode_queries(index.A, queries, impl=impl)


def probe_scores(index: RangeLSHIndex, queries: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """(Q, N) eq.-12 probe priority (higher = probed earlier)."""
    q_codes = encode_queries(index, queries, impl=impl)
    matches = SimpleLSHFamily().match_counts(index.A, q_codes, index.codes,
                                             index.hash_bits, impl=impl)
    # items always reference non-empty ranges, so the raw upper is safe
    return item_scores(index.upper, index.range_id,
                       index.hash_bits - matches, index.hash_bits,
                       index.eps)


def probe_order(index: RangeLSHIndex, queries: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """(Q, N) int32 item ids in eq.-12 probe order, a block of queries
    at a time."""
    return blocked_probe_order(
        lambda q: probe_scores(index, q, impl=impl), queries)


def query(index: RangeLSHIndex, queries: torch.Tensor, k: int,
          num_probe: int, *, impl: str = "auto", engine: str = "dense",
          buckets=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2: probe ``num_probe`` items across all sub-datasets in
    eq.-12 order, exact re-rank, global top-k.

    ``engine="dense"`` (default) is the flat scan and sort; any other
    choice, or prebuilt ``buckets``, goes through
    :class:`repro_torch.core.engine.QueryEngine`, whose directory match
    is ``ops.bucket_match``."""
    if engine == "dense" and buckets is None:
        cand = probe_order(index, queries, impl=impl)[:, :num_probe]
        return rerank(queries, index.items, cand, k)
    from repro_torch.core.engine import QueryEngine
    eng = QueryEngine(index, engine=engine, buckets=buckets, impl=impl,
                      device=index.items.device)
    return eng.query(queries, k, num_probe)


def sorted_probe_table(index: RangeLSHIndex):
    """The paper's m*(L+1) sorted ``(U_j, l)`` structure (§3.3)."""
    return probe_table(index.upper, index.hash_bits, index.eps)


def bucket_stats(index: RangeLSHIndex) -> Tuple[int, int]:
    """(#occupied buckets, max bucket size); a bucket is (range_id,
    code) (host numpy)."""
    rid = index.range_id.to(torch.int32)[:, None]
    return code_bucket_stats(torch.cat([rid, index.codes], dim=1)
                             .cpu().numpy())
