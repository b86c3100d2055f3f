"""The sequence-sharded decode combine
(``repro_torch.models.attention.decode_attention_seq_sharded``) against
the JAX package's ``decode_attention`` on the same numpy inputs, over
in-process shard groups of 1, 2 and 4 with the write position in the
first, a middle and the last shard; at one shard also against the
reference's own combine under ``shard_map`` on a one-device mesh. Then
``gqa_decode(seq_axis=)`` on a DTensor cache over a gloo group of one
rank against the meshless step. The four-rank gloo run (each rank one
sequence shard, the write on its owner only) is in
``test_torch_distributed.py``.

Tolerances: f32 softmaxes over 64 positions of 16-term scores, the
combine dividing once at the end where ``softmax`` normalises first:
atol 2e-6, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import gloo_world_of_one
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.models import attention as jattn
from repro_torch.configs.base import get_config
from repro_torch.core.distributed import InProcessShardGroup
from repro_torch.models import attention as attn

ATOL, RTOL = 2e-6, 1e-5
B, H, KV, HD, S = 2, 8, 4, 16, 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    return q, k, v


def _position(where, shards):
    """A write position in the first, a middle or the last shard."""
    s_loc = S // shards
    return {"first": s_loc // 2 - 1,
            "middle": (shards // 2) * s_loc + 3,
            "last": S - 1}[where]


def _port(q, k, v, pos, shards, **kw):
    ks = torch.chunk(torch.as_tensor(k), shards, dim=1)
    vs = torch.chunk(torch.as_tensor(v), shards, dim=1)
    return attn.decode_attention_seq_sharded(
        torch.as_tensor(q), list(ks), list(vs), pos,
        InProcessShardGroup(shards), **kw).numpy()


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_seq_sharded_equals_the_references_decode_attention(shards, where):
    q, k, v = _inputs(shards)
    pos = _position(where, shards)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos)))
    got = _port(q, k, v, pos, shards)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the positions past the write never count
    k2 = k.copy()
    k2[:, pos + 1:] = 100.0
    np.testing.assert_allclose(_port(q, k2, v, pos, shards), got,
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_seq_sharded_window_and_cap_equal_decode_attention(shards):
    q, k, v = _inputs(7)
    pos = _position("middle", shards)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
        window=20, logit_cap=5.0))
    got = _port(q, k, v, pos, shards, window=20, logit_cap=5.0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_one_shard_equals_the_references_combine_under_shard_map():
    q, k, v = _inputs(3)
    pos = 41
    mesh = jax.make_mesh((1,), ("model",))
    f = compat.shard_map(
        lambda q_, k_, v_: jattn.decode_attention_seq_sharded(
            q_, k_, v_, jnp.int32(pos), "model"),
        mesh=mesh, in_specs=(P(), P(None, "model"), P(None, "model")),
        out_specs=P())
    want = np.asarray(f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(_port(q, k, v, pos, 1), want, atol=ATOL,
                               rtol=RTOL)


def test_shard_positions_can_be_named():
    q, k, v = _inputs(5)
    ks = list(torch.chunk(torch.as_tensor(k), 4, dim=1))
    vs = list(torch.chunk(torch.as_tensor(v), 4, dim=1))
    order = [2, 0, 3, 1]
    got = attn.decode_attention_seq_sharded(
        torch.as_tensor(q), [ks[i] for i in order], [vs[i] for i in order],
        50, InProcessShardGroup(4), shard=order)
    want = attn.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), 50)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="members"):
        attn.decode_attention_seq_sharded(
            torch.as_tensor(q), ks[:3], vs, 50, InProcessShardGroup(4))


def test_in_process_group_reduces():
    g = InProcessShardGroup(3)
    xs = [torch.tensor([1.0, 5.0]), torch.tensor([4.0, 2.0]),
          torch.tensor([3.0, 3.0])]
    assert torch.equal(g.all_reduce(xs, "sum"), torch.tensor([8.0, 10.0]))
    assert torch.equal(g.all_reduce(xs, "max"), torch.tensor([4.0, 5.0]))
    with pytest.raises(ValueError, match="unknown reduction"):
        g.all_reduce(xs, "min")


def test_gqa_decode_seq_axis_needs_a_dtensor_cache():
    cfg = get_config("qwen3_0_6b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = attn.attn_init(gen, cfg)
    hd = cfg.resolved_head_dim
    cache = attn.AttnCache(torch.zeros(2, 8, cfg.n_kv, hd),
                           torch.zeros(2, 8, cfg.n_kv, hd))
    x = torch.randn(2, cfg.d_model, generator=gen).to(torch.bfloat16)
    with pytest.raises(ValueError, match="DTensor cache"):
        attn.gqa_decode(p, x, cache, 3, cfg, layer_is_local=False,
                        seq_axis="model")


def test_gqa_decode_on_a_mesh_equals_the_meshless_step(tmp_path):
    """A 1 x 1 CPU mesh: the cache a DTensor sharded sequence on model,
    the step on its local shard equals the meshless step bit for bit
    (one shard: nothing to combine)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import ambient_mesh, make_local_mesh
    from repro_torch.parallel import sharding as shd

    cfg = get_config("qwen3_0_6b").reduced()
    gen = torch.Generator().manual_seed(1)
    p = attn.attn_init(gen, cfg)
    hd = cfg.resolved_head_dim
    k0 = torch.randn(2, 16, cfg.n_kv, hd, generator=gen).to(torch.bfloat16)
    v0 = torch.randn(2, 16, cfg.n_kv, hd, generator=gen).to(torch.bfloat16)
    x = torch.randn(2, cfg.d_model, generator=gen).to(torch.bfloat16)
    want, wc = attn.gqa_decode(p, x, attn.AttnCache(k0.clone(), v0.clone()),
                               9, cfg, layer_is_local=False)
    with gloo_world_of_one(tmp_path):
        mesh = make_local_mesh(device_type="cpu")
        spec = shd.Spec("data", "model", None, None)
        cache = attn.AttnCache(shd.distribute(k0.clone(), mesh, spec),
                               shd.distribute(v0.clone(), mesh, spec))
        with ambient_mesh(mesh), implicit_replication():
            got, gc = attn.gqa_decode(p, x, cache, 9, cfg,
                                      layer_is_local=False, seq_axis="model")
        assert isinstance(got, DTensor)
        assert torch.equal(got.full_tensor(), want)
        assert torch.equal(gc.k.full_tensor(), wc.k)
        assert torch.equal(gc.v.full_tensor(), wc.v)
