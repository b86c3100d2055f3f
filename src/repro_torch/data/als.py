"""Alternating least squares matrix factorization (port of
``repro/data/als.py``).

The paper takes its Netflix / Yahoo!Music item and user embeddings from
ALS matrix factorization (Yun et al., 2013) and serves MIPS over them
(user embedding = query, item embedding = database). This module makes
that embedding geometry. Observed entries are weighted 1, unobserved 0
(weighted ALS):

    U_i <- (V^T diag(w_i) V + lam I)^-1  V^T diag(w_i) r_i

The reference forms ``V * w_i`` for every row (an (n, m, r) block when
batched: ~427 GB at 20,000 x 17,770 x 300); the port forms the Gram
matrices as one product instead, ``W @ (V ⊗ V)`` reshaped to (n, r, r),
a block of rows at a time, and solves them with a batched Cholesky (the
reference's ``solve(assume_a="pos")``). Products run in f32 with TF32
off.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ref import full_f32

# bytes of one block of (rows, r, r) f32 Gram matrices
GRAM_BYTES = 1 << 30


class ALSState(NamedTuple):
    users: torch.Tensor   # (n_users, rank)
    items: torch.Tensor   # (n_items, rank)
    loss: torch.Tensor    # () observed-entry MSE after the last sweep


def _solve_side(fixed: torch.Tensor, ratings: torch.Tensor,
                weights: torch.Tensor, lam: float) -> torch.Tensor:
    """Solve for one side. fixed: (m, r); ratings/weights: (n, m) -> (n,
    r): row i is ``(sum_j w_ij f_j f_j^T + lam I)^-1 sum_j w_ij r_ij
    f_j``."""
    m, r = fixed.shape
    n = ratings.shape[0]
    outer = (fixed[:, :, None] * fixed[:, None, :]).reshape(m, r * r)
    eye = lam * torch.eye(r, dtype=fixed.dtype, device=fixed.device)
    rhs = (weights * ratings) @ fixed                          # (n, r)
    out = torch.empty((n, r), dtype=fixed.dtype, device=fixed.device)
    rows = max(1, GRAM_BYTES // (4 * r * r))
    for s in range(0, n, rows):
        gram = (weights[s:s + rows] @ outer).reshape(-1, r, r) + eye
        chol = torch.linalg.cholesky(gram)
        out[s:s + rows] = torch.cholesky_solve(rhs[s:s + rows, :, None],
                                               chol)[..., 0]
    return out


def _sweep(users: torch.Tensor, items: torch.Tensor, ratings: torch.Tensor,
           weights: torch.Tensor, lam: float
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sweep: users given items, then items given the new users;
    returns (users, items, observed-entry MSE)."""
    with full_f32():
        users = _solve_side(items, ratings, weights, lam)
        items = _solve_side(users, ratings.T, weights.T, lam)
        pred = users @ items.T
    se = torch.sum(weights * torch.square(ratings - pred))
    return users, items, se / torch.clamp_min(torch.sum(weights), 1.0)


def als_factorize(ratings: torch.Tensor, weights: torch.Tensor, rank: int,
                  generator: Optional[torch.Generator] = None, *,
                  init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  reg: float = 0.1, iters: int = 10) -> ALSState:
    """Factorize ``ratings`` (n_users, n_items) with observation
    ``weights`` on their device. The start is ``0.1 x`` standard normal
    factors drawn from ``generator`` (on that device), or ``init =
    (users, items)``."""
    n_u, n_i = ratings.shape
    if init is not None:
        users, items = (torch.as_tensor(a, dtype=ratings.dtype,
                                        device=ratings.device) for a in init)
    elif generator is None:
        raise ValueError("pass a generator or init=(users, items)")
    else:
        users = 0.1 * torch.randn((n_u, rank), generator=generator,
                                  dtype=ratings.dtype, device=ratings.device)
        items = 0.1 * torch.randn((n_i, rank), generator=generator,
                                  dtype=ratings.dtype, device=ratings.device)
    loss = torch.tensor(math.inf, dtype=ratings.dtype, device=ratings.device)
    for _ in range(iters):
        users, items, loss = _sweep(users, items, ratings, weights, reg)
    return ALSState(users, items, loss)


def synthetic_ratings(generator: torch.Generator, n_users: int, n_items: int,
                      true_rank: int = 16, density: float = 0.05,
                      noise: float = 0.1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-rank + noise rating matrix with a sparse observation mask,
    drawn on the generator's device: (ratings * mask, mask). Item
    popularity is lognormal, which gives the learned item norms a long-ish
    tail."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    u = normal(n_users, true_rank) / math.sqrt(true_rank)
    v = normal(n_items, true_rank)
    pop = torch.exp(0.5 * normal(n_items))
    with full_f32():
        r = (u @ v.T) * pop[None, :]
    r = r + noise * normal(n_users, n_items)
    w = (torch.rand((n_users, n_items), generator=generator, device=dev)
         < density).to(r.dtype)
    return r * w, w
