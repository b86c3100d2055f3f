"""Hash families of the composable index (port of
``repro/core/family.py``).

A :class:`HashFamily` draws its parameters, hashes items given each
item's range bound ``U_j``, hashes queries, counts matches and gives the
(R, n_hashes+1) score table the index turns into the global probe order.
Three families: SIMPLE-LSH (which the norm-range combinator turns into
the paper's RANGE-LSH), L2-ALSH and SIGN-ALSH. Sign families encode
through ``ops.hash_encode`` and match through ``ops.hamming_scan``;
L2-ALSH's integer hashes are plain f32 products and equality counts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import hashing
from repro_torch.core.probe import DEFAULT_EPS, similarity_estimate
from repro_torch.core.rho import RECOMMENDED_L2_ALSH
from repro_torch.core.topk import RERANK_BYTES
from repro_torch.kernels import ops

SIGN_ALSH_RECOMMENDED_M = 2
SIGN_ALSH_RECOMMENDED_U = 0.75


@dataclasses.dataclass(frozen=True)
class HashFamily:
    """Base contract. ``packed``: codes are packed sign bits (Hamming
    matching; the bucket and streaming kernels apply), else integer hash
    rows. ``charges_index_bits``: the §4 protocol, where
    ``ceil(log2 m)`` bits of the code budget pay for the range id."""

    name: str = ""
    packed: bool = True
    charges_index_bits: bool = False

    def make_params(self, generator: torch.Generator, dim: int,
                    n_hashes: int, *, device=None):
        raise NotImplementedError

    def params_on(self, params, device):
        """``params`` (tensors or arrays) as the family's f32 tensors on
        ``device``."""
        return torch.as_tensor(params, dtype=torch.float32, device=device)

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
    packed: bool = True
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


class L2ALSHParams(NamedTuple):
    a: torch.Tensor  # (d + m, K)
    b: torch.Tensor  # (K,)


@dataclasses.dataclass(frozen=True)
class L2ALSHFamily(HashFamily):
    """L2-ALSH (Shrivastava & Li 2014): ``P(x)=[Ux; ||Ux||^2; ...]`` +
    the L2 LSH family (integer hashes). ``match_counts`` is an equality
    count in plain torch, so no kernel serves it (``packed=False``);
    ``impl`` is accepted and ignored."""

    name: str = "l2_alsh"
    packed: bool = False
    charges_index_bits: bool = False
    m: int = RECOMMENDED_L2_ALSH.m
    U: float = RECOMMENDED_L2_ALSH.U
    r: float = RECOMMENDED_L2_ALSH.r

    def make_params(self, generator, dim, n_hashes, *, device=None):
        return L2ALSHParams(*hashing.l2_hash_params(
            generator, dim + self.m, n_hashes, self.r, device=device))

    def params_on(self, params, device):
        a, b = params
        return L2ALSHParams(
            torch.as_tensor(a, dtype=torch.float32, device=device),
            torch.as_tensor(b, dtype=torch.float32, device=device))

    def encode_items(self, params, items, upper_per_item, *, impl="auto"):
        x = items * hashing.scalar_over(self.U, upper_per_item)[:, None]
        px = hashing.l2_alsh_item_transform(x, self.m, 1.0)
        return hashing.l2_hash(px, params.a, params.b, self.r)

    def encode_queries(self, params, queries, *, impl="auto"):
        q = hashing.l2_alsh_query_transform(queries, self.m)
        return hashing.l2_hash(q, params.a, params.b, self.r)

    def match_counts(self, params, q_codes, db_codes, n_hashes, *,
                     impl="auto"):
        """(Q, N) int32 equal hashes per pair, ``Qc`` queries at a time so
        that the (Qc, N, K) boolean block stays within ``RERANK_BYTES``."""
        n, k = db_codes.shape
        qc = max(1, RERANK_BYTES // max(1, n * k))
        return torch.cat([
            (q_codes[s:s + qc, None, :] == db_codes[None, :, :]).sum(
                dim=-1, dtype=torch.int32)
            for s in range(0, q_codes.shape[0], qc)])

    def score_table(self, upper, n_hashes, *, eps=DEFAULT_EPS):
        """Invert eq. (3) to a distance estimate and solve eq. (6) for the
        inner product given the range's scaling s_j = U / U_j. ``eps``
        does not apply to integer hashes and is ignored."""
        K = n_hashes
        l_frac = torch.arange(K + 1, dtype=torch.float32,
                              device=upper.device) / K
        p = torch.clamp(l_frac, 1.0 / (4 * K), 1.0 - 1e-4)
        d_hat = _invert_l2_collision(p, self.r)              # (K+1,)
        s = hashing.scalar_over(self.U, upper)[:, None]      # (R, 1)
        tail = s * upper[:, None]
        for _ in range(self.m + 1):                  # ** 2^(m+1)
            tail = tail * tail
        return ((1.0 + self.m / 4.0 + tail - (d_hat * d_hat)[None, :])
                / (2.0 * s))


def _invert_l2_collision(p: torch.Tensor, r: float, iters: int = 50
                         ) -> torch.Tensor:
    """Distance d with F_r(d) = p (F_r decreasing): ``iters`` bisection
    steps in f32."""
    lo = torch.full_like(p, 1e-4)
    hi = torch.full_like(p, 100.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_close = hashing.l2_collision_prob(mid, r) > p
        lo = torch.where(too_close, mid, lo)
        hi = torch.where(too_close, hi, mid)
    return 0.5 * (lo + hi)


@dataclasses.dataclass(frozen=True)
class SignALSHFamily(HashFamily):
    """SIGN-ALSH (Shrivastava & Li, UAI 2015):
    ``P(x) = [Ux; 1/2-||Ux||^2; ...]`` + sign random projection. Its
    packed codes come from ``ops.hash_encode`` with no tail (the
    reference's ``pack_bits(srp_hash(px, A))``, same sign rule), so the
    bucket store and streaming layer apply unchanged."""

    name: str = "sign_alsh"
    packed: bool = True
    charges_index_bits: bool = False
    m: int = SIGN_ALSH_RECOMMENDED_M
    U: float = SIGN_ALSH_RECOMMENDED_U

    def make_params(self, generator, dim, n_hashes, *, device=None):
        return hashing.srp_projections(generator, dim + self.m, n_hashes,
                                       device=device)

    def encode_items(self, params, items, upper_per_item, *, impl="auto"):
        x = items * hashing.scalar_over(self.U, upper_per_item)[:, None]
        px = hashing.sign_alsh_item_transform(x, self.m, 1.0)
        return ops.hash_encode(px, params, impl=impl)

    def encode_queries(self, params, queries, *, impl="auto"):
        q = hashing.sign_alsh_query_transform(
            queries.to(torch.float32), self.m)
        return ops.hash_encode(q, params, impl=impl)

    def match_counts(self, params, q_codes, db_codes, n_hashes, *,
                     impl="auto"):
        return n_hashes - ops.hamming_scan(q_codes, db_codes, impl=impl)

    def score_table(self, upper, n_hashes, *, eps=DEFAULT_EPS):
        ls = torch.arange(n_hashes + 1, dtype=torch.int32,
                          device=upper.device)
        return similarity_estimate(upper[:, None], ls[None, :], n_hashes,
                                   eps)


FAMILY_NAMES: Tuple[str, ...] = ("simple", "l2_alsh", "sign_alsh")


def get_family(name: str, *, alsh_m=None, alsh_U=None, alsh_r=None
               ) -> HashFamily:
    """Resolve a family by registry name; ``alsh_*`` override the ALSH
    transform order / scaling / quantization width (ignored by
    "simple")."""
    if name == "simple":
        return SimpleLSHFamily()
    if name == "l2_alsh":
        return L2ALSHFamily(
            m=RECOMMENDED_L2_ALSH.m if alsh_m is None else int(alsh_m),
            U=RECOMMENDED_L2_ALSH.U if alsh_U is None else float(alsh_U),
            r=RECOMMENDED_L2_ALSH.r if alsh_r is None else float(alsh_r))
    if name == "sign_alsh":
        return SignALSHFamily(
            m=SIGN_ALSH_RECOMMENDED_M if alsh_m is None else int(alsh_m),
            U=SIGN_ALSH_RECOMMENDED_U if alsh_U is None else float(alsh_U))
    raise ValueError(
        f"unknown hash family {name!r}; expected one of {FAMILY_NAMES}")
