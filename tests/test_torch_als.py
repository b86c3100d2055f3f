"""The port's ALS factorization (``repro_torch.data.als``) against the JAX
package's (``repro.data.als``) on the CPU.

``jax.random`` streams cannot be reproduced in torch, so the reference's
ratings, observation weights and starting factors are injected
(``init=``). The port forms each row's Gram matrix as ``W @ (V ⊗ V)``
and solves by Cholesky, the reference per row through ``vmap``: f32 sums
in another order, amplified by the solves. Tolerance: users and items
within 2e-4 of their largest magnitude, the loss within rtol 1e-4, after
one sweep and after eight (measured at most 5.5e-5, 3.8e-5 and 7.6e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import als as jals
from repro_torch.data import als

FACTOR_REL = 2e-4
LOSS_RTOL = 1e-4


@pytest.mark.parametrize("iters", [1, 8])
@pytest.mark.parametrize("n_users,n_items,rank,density", [
    (60, 40, 8, 0.3), (200, 150, 16, 0.1)])
def test_als_equals_the_reference(n_users, n_items, rank, density, iters):
    ratings, weights = jals.synthetic_ratings(
        jax.random.PRNGKey(0), n_users, n_items, true_rank=4,
        density=density)
    key = jax.random.PRNGKey(3)
    ku, ki = jax.random.split(key)      # the reference's own start
    u0 = 0.1 * jax.random.normal(ku, (n_users, rank), ratings.dtype)
    i0 = 0.1 * jax.random.normal(ki, (n_items, rank), ratings.dtype)
    want = jals.als_factorize(ratings, weights, rank, key, iters=iters)
    got = als.als_factorize(torch.as_tensor(np.array(ratings)),
                            torch.as_tensor(np.array(weights)), rank,
                            init=(np.array(u0), np.array(i0)), iters=iters)
    for a, b in ((got.users, want.users), (got.items, want.items)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=FACTOR_REL * np.abs(b).max())
    np.testing.assert_allclose(float(got.loss), float(want.loss),
                               rtol=LOSS_RTOL)


def test_als_from_a_generator_lowers_the_loss():
    r, w = als.synthetic_ratings(torch.Generator().manual_seed(0), 80, 60,
                                 density=0.2)
    losses = [float(als.als_factorize(
        r, w, 8, torch.Generator().manual_seed(1), iters=it).loss)
        for it in (1, 4)]
    assert losses[1] < losses[0]
    with pytest.raises(ValueError, match="generator or init"):
        als.als_factorize(r, w, 8)


def test_synthetic_ratings_shape_and_density():
    gen = torch.Generator().manual_seed(5)
    r, w = als.synthetic_ratings(gen, 300, 200, true_rank=16, density=0.05)
    assert r.shape == w.shape == (300, 200)
    assert r.dtype == w.dtype == torch.float32
    assert set(torch.unique(w).tolist()) <= {0.0, 1.0}
    assert torch.equal(r[w == 0], torch.zeros_like(r[w == 0]))
    # 60,000 Bernoulli(0.05) draws: 5 sigma is 0.0045
    assert abs(float(w.mean()) - 0.05) < 0.0045
    assert bool(torch.isfinite(r).all())
