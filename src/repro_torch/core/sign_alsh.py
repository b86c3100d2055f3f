"""SIGN-ALSH (Shrivastava & Li, UAI 2015), the third baseline (port of
``repro/core/sign_alsh.py``).

Asymmetric transforms into angular similarity,

    P(x) = [Ux; 1/2 - ||Ux||^2; ...; 1/2 - ||Ux||^{2^m}]
    Q(q) = [q; 0; ...; 0],

hashed with sign random projection; recommended m = 2, U = 0.75. With
``num_ranges > 1`` each norm range is scaled by its own bound (the §5
argument applied to SIGN-ALSH). Probe order: plain Hamming ranking
(un-ranged) or eq. 12 over the per-range bounds (ranged).

A thin shim over the composable index API: :func:`build` is
``core.index.build`` of ``IndexSpec(family="sign_alsh", m=...)`` and
returns the legacy :class:`SignALSHIndex` tuple with the same arrays. A
``torch.Generator`` draws the projection (the reference takes a JAX
key), or ``params`` hands one in.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import index as spec_index
from repro_torch.core.family import (SIGN_ALSH_RECOMMENDED_M,
                                     SIGN_ALSH_RECOMMENDED_U, SignALSHFamily)
from repro_torch.core.index import IndexSpec
from repro_torch.core.probe import (DEFAULT_EPS, blocked_probe_order,
                                    item_scores)
from repro_torch.core.topk import rerank

RECOMMENDED_M = SIGN_ALSH_RECOMMENDED_M
RECOMMENDED_U = SIGN_ALSH_RECOMMENDED_U


class SignALSHIndex(NamedTuple):
    items: torch.Tensor       # (N, d)
    norms: torch.Tensor       # (N,)
    codes: torch.Tensor       # (N, W) int32 packed
    A: torch.Tensor           # (d + m, L)
    range_id: torch.Tensor    # (N,) int32
    upper: torch.Tensor       # (R,) effective max norm per range (R=1 plain)
    m: int
    U: float
    code_len: int
    eps: float


def _family(index: SignALSHIndex) -> SignALSHFamily:
    return SignALSHFamily(m=index.m, U=index.U)


def build(items, generator, code_len: int, *, num_ranges: int = 1,
          scheme: str = "percentile", m: int = RECOMMENDED_M,
          U: float = RECOMMENDED_U, eps: float = DEFAULT_EPS,
          impl: str = "auto", params=None, device=None) -> SignALSHIndex:
    """Plain (num_ranges=1) or norm-ranged SIGN-ALSH on ``device`` (the
    card unless ``device="cpu"``)."""
    spec = IndexSpec(family="sign_alsh", code_len=code_len, m=num_ranges,
                     scheme=scheme, eps=eps, impl=impl, alsh_m=m, alsh_U=U)
    cidx = spec_index.build(spec, items, generator, params=params,
                            strict=False, device=device)
    # legacy tuples carry the *effective* upper (the scale needs U_j > 0)
    return SignALSHIndex(cidx.items, cidx.norms, cidx.codes, cidx.params,
                         cidx.range_id, cidx.upper_eff, m, U, code_len, eps)


def encode_queries(index: SignALSHIndex, queries: torch.Tensor
                   ) -> torch.Tensor:
    return _family(index).encode_queries(index.A, queries)


def probe_scores(index: SignALSHIndex, queries: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    qc = encode_queries(index, queries)
    matches = _family(index).match_counts(index.A, qc, index.codes,
                                          index.code_len, impl=impl)
    ham = index.code_len - matches
    if index.upper.shape[0] == 1:
        return -ham.to(torch.float32)            # plain Hamming ranking
    return item_scores(index.upper, index.range_id, ham, index.code_len,
                       index.eps)


def probe_order(index: SignALSHIndex, queries: torch.Tensor
                ) -> torch.Tensor:
    """(Q, N) int32 item ids in probe order, a block of queries at a
    time."""
    return blocked_probe_order(lambda q: probe_scores(index, q), queries)


def query(index: SignALSHIndex, queries: torch.Tensor, k: int,
          num_probe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    order = probe_order(index, queries)
    return rerank(queries, index.items, order[:, :num_probe], k)
