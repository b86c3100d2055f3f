"""SIMPLE-LSH (Neyshabur & Srebro 2015), the paper's baseline (port of
``repro/core/simple_lsh.py``).

Index build: normalize the whole dataset by the *global* max 2-norm U,
apply ``P(x) = [x; sqrt(1-||x||^2)]`` (eq. 8) and hash with sign random
projection (eq. 4). Query processing ranks items by Hamming distance
(single-table multi-probe, §3.3) and exactly re-ranks the first
``num_probe`` items.

A thin shim over the composable index API: :func:`build` is
``core.index.build`` of ``IndexSpec(family="simple", m=1)`` and returns
the legacy :class:`SimpleLSHIndex` tuple with the same arrays. A
``torch.Generator`` draws the projection (the reference takes a JAX
key), or ``params`` hands one in.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import index as spec_index
from repro_torch.core.family import SimpleLSHFamily
from repro_torch.core.index import IndexSpec
from repro_torch.core.probe import blocked_probe_order, hamming_scores
from repro_torch.core.topk import rerank


class SimpleLSHIndex(NamedTuple):
    """Immutable SIMPLE-LSH index; every tensor on one device.

    Attributes:
      items:    (N, d) original (un-normalized) item vectors.
      norms:    (N,)   item 2-norms.
      codes:    (N, W) int32 packed hash codes.
      A:        (d+1, L) sign-projection matrix (last row = augmentation).
      U:        ()     global max 2-norm used for normalization.
      code_len: int    L.
    """

    items: torch.Tensor
    norms: torch.Tensor
    codes: torch.Tensor
    A: torch.Tensor
    U: torch.Tensor
    code_len: int


def build(items, generator, code_len: int, *, impl: str = "auto",
          params=None, device=None) -> SimpleLSHIndex:
    """Global normalization + fused encode (the spec API's m = 1 case),
    on ``device`` (the card unless ``device="cpu"``)."""
    spec = IndexSpec(family="simple", code_len=code_len, m=1, impl=impl)
    cidx = spec_index.build(spec, items, generator, params=params,
                            device=device)
    return SimpleLSHIndex(cidx.items, cidx.norms, cidx.codes, cidx.params,
                          cidx.upper[0], code_len)


def encode_queries(index: SimpleLSHIndex, queries: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """Hash queries with ``P(q) = [q; 0]`` (zero tail)."""
    return SimpleLSHFamily().encode_queries(index.A, queries, impl=impl)


def probe_scores(index: SimpleLSHIndex, queries: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """(Q, N) probe priority — plain Hamming ranking (higher = earlier)."""
    q_codes = encode_queries(index, queries, impl=impl)
    matches = SimpleLSHFamily().match_counts(index.A, q_codes, index.codes,
                                             index.code_len, impl=impl)
    return hamming_scores(index.code_len - matches)


def probe_order(index: SimpleLSHIndex, queries: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """(Q, N) int32 item ids in probe order (stable descending priority),
    a block of queries at a time."""
    return blocked_probe_order(
        lambda q: probe_scores(index, q, impl=impl), queries)


def query(index: SimpleLSHIndex, queries: torch.Tensor, k: int,
          num_probe: int, *, impl: str = "auto", engine: str = "dense",
          buckets=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k approximate MIPS: probe ``num_probe`` items, exact re-rank.

    ``engine``/``buckets`` select the candidate engine as in
    :func:`repro_torch.core.range_lsh.query` (SIMPLE-LSH is its m = 1
    case: eq.-12 order is Hamming order)."""
    if engine == "dense" and buckets is None:
        cand = probe_order(index, queries, impl=impl)[:, :num_probe]
        return rerank(queries, index.items, cand, k)
    from repro_torch.core.engine import QueryEngine
    eng = QueryEngine(index, engine=engine, buckets=buckets, impl=impl,
                      device=index.items.device)
    return eng.query(queries, k, num_probe)


def bucket_stats(index: SimpleLSHIndex) -> Tuple[int, int]:
    """(#occupied buckets, max bucket size) — the §3.1 balance
    statistics (host numpy)."""
    return code_bucket_stats(index.codes.cpu().numpy())


def code_bucket_stats(keys: np.ndarray) -> Tuple[int, int]:
    """(#distinct rows, largest multiplicity) of an (N, W) key array."""
    keys = np.ascontiguousarray(keys)
    rows = keys.view([("", keys.dtype)] * keys.shape[1]).ravel()
    _, counts = np.unique(rows, return_counts=True)
    return int(counts.size), int(counts.max())
