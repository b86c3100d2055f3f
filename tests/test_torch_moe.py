"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package on the same numpy inputs and carried weights, at ``reduced()``
sizes: granite-moe (4 experts, top-2) and llama4 (top-1 with the shared
expert), with ample capacity and with capacity cut so that tokens are
dropped.

The reference's router decisions (expert ids and capacity ranks) are not
among its outputs, so the test recomputes them from the reference's own
expressions (``repro/models/moe.py:63-78``); they must be equal exactly.
Gates and the aux loss are f32 and within rtol 1e-6 (f32 router products
summed in another order); the layer's output within atol and rtol 1e-5
in f32 and 3e-2 in bf16 (bf16 rounds at other places in the two
frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.models import moe

F32_TOL = 1e-5
BF16_TOL = 3e-2
GATE_RTOL = 1e-6


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(arch, capacity_factor):
    jcfg = jbase.get_config(arch).reduced()
    cfg = base.get_config(arch).reduced()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


def _reference_route(p, x, cfg):
    """The reference's routing expressions (moe.py:63-78): gate values,
    expert ids and capacity ranks."""
    m = cfg.moe
    B, S, _ = x.shape
    E, K = m.num_experts, m.top_k
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    flat = onehot.reshape(B, S * K, E)
    rank = jnp.cumsum(flat, axis=1) - flat
    rank = jnp.sum(rank * flat, axis=-1).reshape(B, S, K).astype(jnp.int32)
    C = jmoe.group_capacity(S, E, K, m.capacity_factor)
    gate_vals = gate_vals * (rank < C).astype(gate_vals.dtype)
    return probs, gate_vals, gate_idx, rank, C


@pytest.fixture(scope="module", params=["granite_moe_1b_a400m",
                                        "llama4_scout_17b_a16e"])
def experts(request):
    """(arch, reference cfg, port cfg, reference params, port params)."""
    jcfg, cfg = _cfgs(request.param, None)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    pp = convert.lm_params_from_tree(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return request.param, jcfg, cfg, jp, pp


@pytest.mark.parametrize("capacity_factor,shape", [
    (None, (2, 16)), (0.5, (2, 16)), (None, (1, 8))])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_forward_matches_reference(experts, capacity_factor, shape,
                                       dtype):
    """Routing, capacity ranks, gates, aux loss and the layer's output.
    ``capacity_factor`` 0.5 cuts the capacity below demand (C = 4 for 32
    top-2 slots over 4 experts), so tokens are dropped; (1, 8) is one
    decode group of 8 tokens."""
    arch, _, _, jp, pp = experts
    jcfg, cfg = _cfgs(arch, capacity_factor)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        pp = {k: v.float() for k, v in pp.items()}
        jx, px, tol = jnp.asarray(x), torch.as_tensor(x), F32_TOL
    else:
        jx = jnp.asarray(x, jnp.bfloat16)
        px = torch.as_tensor(x).to(torch.bfloat16)
        tol = BF16_TOL
    jprobs, jgates, jidx, jrank, jC = _reference_route(jp, jx, jcfg)
    probs, gates, idx, onehot, rank, C = moe.route(pp, px, cfg)
    assert C == jC
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               rtol=GATE_RTOL, atol=1e-7)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates),
                               rtol=GATE_RTOL, atol=1e-7)
    dropped = int((rank >= C).sum())
    if capacity_factor == 0.5:
        assert dropped > 0
    jo, jaux = jmoe.moe_forward(jp, jx, jcfg)
    po, paux = moe.moe_forward(pp, px, cfg)
    assert po.dtype == px.dtype and tuple(po.shape) == jo.shape
    np.testing.assert_allclose(po.float().numpy(), _np(jo), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=GATE_RTOL)


def test_router_ties_go_to_the_lower_expert(experts):
    """Equal router probabilities (a zero input: every expert 1/E) pick
    experts 0..K-1, as ``lax.top_k``, and rank the tokens in order."""
    _, jcfg, cfg, jp, pp = experts
    x = np.zeros((1, 6, cfg.d_model), np.float32)
    _, _, jidx, jrank, _ = _reference_route(jp, jnp.asarray(x), jcfg)
    _, _, idx, _, rank, _ = moe.route(pp, torch.as_tensor(x), cfg)
    K = cfg.moe.top_k
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, 0].tolist() == list(range(K))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    assert rank[0, :, 0].tolist() == list(range(6))


@pytest.mark.parametrize("group,E,K,cf", [
    (16, 4, 2, 1.25), (8, 32, 8, 1.25), (64, 16, 1, 1.25), (8, 16, 2, 1.25),
    (1, 4, 2, 1.25), (5, 4, 2, 0.5), (4096, 16, 2, 1.0)])
def test_group_capacity_matches_reference(group, E, K, cf):
    assert moe.group_capacity(group, E, K, cf) == jmoe.group_capacity(
        group, E, K, cf)


def test_moe_init_has_the_reference_tree(experts):
    _, jcfg, cfg, jp, _ = experts
    mine = moe.moe_init(torch.Generator().manual_seed(0), cfg, (3,))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in mine.items()} == {
        k: ((3,) + v.shape, str(v.dtype)) for k, v in jp.items()}
