"""Query-time exponent (rho) theory for hashing-based MIPS (port of
``repro/core/rho.py``).

The LSH query time is ``O(n^rho log n)`` with ``rho = log p1 / log p2``
(Definition 1). This module gives:

* eq. (9)  — SIMPLE-LSH: ``rho = G(c, S0)``,
* eq. (7)  — L2-ALSH ``rho`` with parameters (m, U, r) and its grid search,
* eq. (13) — norm-ranged L2-ALSH ``rho_j`` for a sub-dataset with norms
             in ``(u_{j-1}, u_j]``,
* Theorem 1 helpers: per-range ``rho_j = G(c, S0/U_j)`` and the
  ``alpha``/``beta`` feasibility conditions.

Everything runs on f32 tensors, as the reference does, so benchmarks can
sweep (c, S0) grids.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch

from repro_torch.core.hashing import l2_collision_prob, srp_collision_prob


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _pow2k(x: torch.Tensor, e: int) -> torch.Tensor:
    """``x ** (2 ** e)`` by repeated squaring (the reference's
    integer power)."""
    for _ in range(e):
        x = x * x
    return x


def rho_simple_lsh(c, S0) -> torch.Tensor:
    """eq. (9): ``G(c, S0) = log(1 - acos(S0)/pi) / log(1 - acos(c S0)/pi)``
    for the post-normalization target inner product ``S0``, ``0 < c < 1``."""
    c, S0 = _f32(c), _f32(S0)
    return (torch.log(srp_collision_prob(S0))
            / torch.log(srp_collision_prob(c * S0)))


def rho_ranged_simple_lsh(c, S0, U_j) -> torch.Tensor:
    """Per-range exponent of RANGE-LSH: ``rho_j = G(c, S0 / U_j)`` (§3.2),
    ``U_j <= 1`` the range's max norm in the global scale."""
    return rho_simple_lsh(c, torch.clamp_max(_f32(S0) / _f32(U_j), 1.0))


def _l2_rho(num2: torch.Tensor, den2: torch.Tensor, r: float
            ) -> torch.Tensor:
    p1 = l2_collision_prob(torch.sqrt(num2), r)
    p2 = l2_collision_prob(torch.sqrt(torch.clamp_min(den2, 1e-12)), r)
    return torch.log(p1) / torch.log(p2)


def rho_l2_alsh(S0, c, m: int, U: float, r: float) -> torch.Tensor:
    """eq. (7): L2-ALSH exponent for parameters (m, U, r)."""
    S0, c = _f32(S0), _f32(c)
    num2 = 1.0 + m / 4.0 - 2.0 * U * S0 + _pow2k(U * S0, m + 1)
    den2 = 1.0 + m / 4.0 - 2.0 * c * U * S0
    return _l2_rho(num2, den2, r)


def rho_ranged_l2_alsh(S0, c, m: int, U_j: float, r: float, u_lo, u_hi
                       ) -> torch.Tensor:
    """eq. (13): ranged L2-ALSH exponent for a sub-dataset with 2-norms
    in ``(u_lo, u_hi]`` and scaling ``U_j`` (``U_j * u_hi < 1``)."""
    S0, c, u_lo, u_hi = _f32(S0), _f32(c), _f32(u_lo), _f32(u_hi)
    num2 = 1.0 + m / 4.0 - 2.0 * U_j * S0 + _pow2k(U_j * u_hi, m + 1)
    den2 = (1.0 + m / 4.0 - 2.0 * c * U_j * S0
            + _pow2k(U_j * u_lo, m + 1))
    return _l2_rho(num2, den2, r)


class L2ALSHParams(NamedTuple):
    m: int
    U: float
    r: float
    rho: float


#: The setting recommended by Shrivastava & Li (2014) and used in the
#: paper's experiments (§4): m=3, U=0.83, r=2.5.
RECOMMENDED_L2_ALSH = L2ALSHParams(m=3, U=0.83, r=2.5, rho=float("nan"))

_GRID_US = tuple(float(u) for u in torch.linspace(0.5, 0.95, 10))
_GRID_RS = tuple(float(r) for r in torch.linspace(1.5, 4.5, 13))


def grid_search_l2_alsh(S0: float, c: float, ms=(1, 2, 3, 4),
                        Us=_GRID_US, rs=_GRID_RS) -> L2ALSHParams:
    """Grid search minimizing eq. (7) over (m, U, r), as the paper
    suggests."""
    best = L2ALSHParams(3, 0.83, 2.5, float("inf"))
    for m, U, r in itertools.product(ms, Us, rs):
        rho = float(rho_l2_alsh(S0, c, m, U, r))
        if math.isfinite(rho) and 0.0 < rho < best.rho:
            best = L2ALSHParams(m, U, r, rho)
    return best


def theorem1_conditions(rho: float, rho_star: float, alpha: float,
                        beta: float) -> bool:
    """Feasibility check of Theorem 1: ``0 < alpha < min(rho,
    (rho - rho*)/(1 - rho*))`` and ``0 < beta < alpha * rho``."""
    lim = min(rho, (rho - rho_star) / (1.0 - rho_star))
    return (0.0 < alpha < lim) and (0.0 < beta < alpha * rho)


def query_complexity_ratio(n: float, alpha: float, beta: float, rho: float,
                           rho_star: float) -> float:
    """Upper bound on ``f(n) / (n^rho log n)`` from eq. (11):

    ``n^{alpha-rho}/log n + n^{alpha+(1-alpha) rho* - rho}
    + n^{beta - alpha rho}`` (the log in f32, as the reference takes it).
    """
    ln = torch.log(_f32(n))
    return float(n ** (alpha - rho) / ln
                 + n ** (alpha + (1 - alpha) * rho_star - rho)
                 + n ** (beta - alpha * rho))
