"""Hash families of the composable index (port of
``repro/core/family.py``).

A :class:`HashFamily` draws its parameters, hashes items given each
item's range bound ``U_j``, hashes queries, counts matches and gives the
(R, n_hashes+1) score table the index turns into the global probe order.
This slice ports SIMPLE-LSH, which the norm-range combinator turns into
the paper's RANGE-LSH; the L2-ALSH and SIGN-ALSH families are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import hashing
from repro_torch.core.probe import DEFAULT_EPS, similarity_estimate
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class HashFamily:
    """Base contract. ``charges_index_bits``: the §4 protocol, where
    ``ceil(log2 m)`` bits of the code budget pay for the range id."""

    name: str = ""
    charges_index_bits: bool = False

    def make_params(self, generator: torch.Generator, dim: int,
                    n_hashes: int, *, device=None):
        raise NotImplementedError

    def encode_items(self, params, items: torch.Tensor,
                     upper_per_item: torch.Tensor, *,
                     impl: str = "auto") -> torch.Tensor:
        raise NotImplementedError

    def encode_queries(self, params, queries: torch.Tensor, *,
                       impl: str = "auto") -> torch.Tensor:
        raise NotImplementedError

    def match_counts(self, params, q_codes: torch.Tensor,
                     db_codes: torch.Tensor, n_hashes: int, *,
                     impl: str = "auto") -> torch.Tensor:
        raise NotImplementedError

    def score_table(self, upper: torch.Tensor, n_hashes: int, *,
                    eps: float = DEFAULT_EPS) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SimpleLSHFamily(HashFamily):
    """SIMPLE-LSH: ``P(x) = [x; sqrt(1-||x||^2)]`` + sign random
    projection; ``params`` is the (d+1, L) projection matrix with the
    augmentation row last."""

    name: str = "simple"
    charges_index_bits: bool = True

    def make_params(self, generator, dim, n_hashes, *, device=None):
        return hashing.srp_projections(generator, dim + 1, n_hashes,
                                       device=device)

    def encode_items(self, params, items, upper_per_item, *, impl="auto"):
        x = items / upper_per_item[:, None]
        tail = torch.sqrt(torch.clamp_min(
            1.0 - torch.sum(x * x, dim=-1), 0.0))
        return ops.hash_encode(x, params[:-1], tail, params[-1], impl=impl)

    def encode_queries(self, params, queries, *, impl="auto"):
        q = hashing.normalize(queries.to(torch.float32))
        zeros = torch.zeros((q.shape[0],), dtype=q.dtype, device=q.device)
        return ops.hash_encode(q, params[:-1], zeros, params[-1], impl=impl)

    def match_counts(self, params, q_codes, db_codes, n_hashes, *,
                     impl="auto"):
        return n_hashes - ops.hamming_scan(q_codes, db_codes, impl=impl)

    def score_table(self, upper, n_hashes, *, eps=DEFAULT_EPS):
        ls = torch.arange(n_hashes + 1, dtype=torch.int32,
                          device=upper.device)
        return similarity_estimate(upper[:, None], ls[None, :], n_hashes,
                                   eps)


FAMILY_NAMES: Tuple[str, ...] = ("simple", "l2_alsh", "sign_alsh")


def get_family(name: str) -> HashFamily:
    """Resolve a family by registry name."""
    if name == "simple":
        return SimpleLSHFamily()
    if name in FAMILY_NAMES:
        raise ValueError(f"hash family {name!r} is not yet ported to "
                         f"repro_torch; only 'simple' is")
    raise ValueError(
        f"unknown hash family {name!r}; expected one of {FAMILY_NAMES}")
