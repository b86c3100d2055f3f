"""One rank of the gloo test in ``test_torch_distributed.py``: joins a
file-rendezvous process group, builds the same sharded index as every
other rank (same seed), keeps its own shard and answers the queries in
both arms through a ``ProcessShardGroup``. Rank 0 writes the merged ids
and values beside the rendezvous file. Then the sequence-sharded decode:
each rank holds one sequence shard of the same seeded cache, runs
``decode_attention_seq_sharded`` over the group and ``gqa_decode`` with
``seq_axis`` on a DTensor cache over a (1, world) mesh, and writes its
shard and outputs. Imports neither JAX nor the reference package, so
each spawned process starts quickly."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed
from repro_torch.core.index import IndexSpec

SHARDS = 4
K, NUM_PROBE = 10, 200
BUDGETS = (40, 30, 30, 20, 20, 20, 20, 20)


def dataset():
    """(items, queries) of the gloo case, from a seed."""
    rng = np.random.default_rng(11)
    items = (rng.standard_normal((1500, 16))
             * np.exp(0.8 * rng.standard_normal((1500, 1)))
             ).astype(np.float32)
    return items, rng.standard_normal((6, 16)).astype(np.float32)


def build():
    items, queries = dataset()
    spec = IndexSpec(family="simple", code_len=16, m=8)
    sidx = distributed.build_sharded(spec, items,
                                     torch.Generator().manual_seed(3),
                                     SHARDS, device="cpu")
    return sidx, torch.as_tensor(queries)


def run(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        sidx, queries = build()
        group = distributed.ProcessShardGroup()
        placed = distributed.shard_index(sidx, group)
        assert placed.items.shape[0] == sidx.rows_per_shard
        got = {}
        for engine in ("bucket", "dense"):
            eng = distributed.DistributedEngine(placed, group, engine=engine)
            got[f"{engine}_scalar"] = eng.query(queries, K, NUM_PROBE)
            got[f"{engine}_planned"] = eng.query(queries, K,
                                                 budgets=BUDGETS)
        if rank == 0:
            np.savez(f"{out_dir}/rank0.npz",
                     **{f"{n}_ids": v[1].numpy() for n, v in got.items()},
                     **{f"{n}_vals": v[0].numpy() for n, v in got.items()})
        seq_sharded(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


SEQ, SEQ_POS = 32, 21          # cache slots; the write, in shard 2 of 4


def seq_inputs():
    """(attention params, x, k, v, q) of the sequence-sharded case, f32,
    from a seed: reduced Qwen3's attention layer, a (2, SEQ, KV, hd)
    cache and a (2, H, hd) query."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as attn
    cfg = get_config("qwen3_0_6b").reduced()
    gen = torch.Generator().manual_seed(5)
    p = {k: v.float() for k, v in attn.attn_init(gen, cfg).items()}
    hd = cfg.resolved_head_dim
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((2, cfg.d_model)),
                        dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((2, SEQ, cfg.n_kv, hd)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((2, SEQ, cfg.n_kv, hd)),
                        dtype=torch.float32)
    q = torch.as_tensor(rng.standard_normal((2, cfg.n_heads, hd)),
                        dtype=torch.float32)
    return cfg, p, x, k, v, q


def seq_sharded(rank: int, world: int, out_dir: str) -> None:
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import ambient_mesh, make_compat_mesh
    from repro_torch.models import attention as attn

    cfg, p, x, k, v, q = seq_inputs()
    s_loc = SEQ // world
    mine = slice(rank * s_loc, (rank + 1) * s_loc)
    o = attn.decode_attention_seq_sharded(
        q, k[:, mine], v[:, mine], SEQ_POS, distributed.ProcessShardGroup())
    mesh = make_compat_mesh((1, world), ("data", "model"),
                            device_type="cpu")
    cache = attn.AttnCache(
        DTensor.from_local(k[:, mine].clone(), mesh, [Shard(0), Shard(1)]),
        DTensor.from_local(v[:, mine].clone(), mesh, [Shard(0), Shard(1)]))
    with ambient_mesh(mesh), implicit_replication():
        out, cache = attn.gqa_decode(p, x, cache, SEQ_POS, cfg,
                                     layer_is_local=False, seq_axis="model")
        out = out.full_tensor()
    np.savez(f"{out_dir}/seq{rank}.npz", combine=o.numpy(),
             out=out.numpy(), k=cache.k.to_local().numpy(),
             v=cache.v.to_local().numpy())
    latent(mesh, out_dir, rank, world)
    experts(mesh, out_dir, rank)
    label_logits(mesh, out_dir, rank)


def vocab_inputs():
    """(logits (2, 3, 22), labels (2, 3)) from a seed: 22 vocabulary
    entries split 6/6/6/4 over 4 ranks."""
    rng = np.random.default_rng(12)
    return (torch.as_tensor(rng.standard_normal((2, 3, 22)),
                            dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 22, (2, 3))))


def label_logits(mesh, out_dir: str, rank: int) -> None:
    """The loss's label logits picked from logits sharded along the
    vocabulary over ``model``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import lm

    logits, labels = vocab_inputs()
    with implicit_replication():
        got = lm._label_logits(distribute_tensor(
            logits, mesh, [Replicate(), Shard(2)]), labels)
    np.savez(f"{out_dir}/vocab{rank}.npz", got=got.full_tensor().numpy())


def mla_inputs():
    """(cfg, f32 MLA params, x, latent cache, rope-key cache) of reduced
    minicpm3, from a seed."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as attn
    cfg = get_config("minicpm3_4b").reduced()
    p = {k: v.float() for k, v in attn.attn_init(
        torch.Generator().manual_seed(9), cfg).items()}
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.standard_normal((2, cfg.d_model)),
                        dtype=torch.float32)
    c = torch.as_tensor(rng.standard_normal((2, SEQ, cfg.mla.kv_rank)),
                        dtype=torch.float32)
    r = torch.as_tensor(rng.standard_normal((2, SEQ, cfg.mla.rope_dim)),
                        dtype=torch.float32)
    return cfg, p, x, c, r


def latent(mesh, out_dir: str, rank: int, world: int) -> None:
    """MLA's decode with its latent caches sharded along the sequence."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import ambient_mesh
    from repro_torch.models import attention as attn

    cfg, p, x, c, r = mla_inputs()
    s_loc = SEQ // world
    mine = slice(rank * s_loc, (rank + 1) * s_loc)
    cache = attn.AttnCache(
        DTensor.from_local(c[:, mine].clone(), mesh, [Shard(0), Shard(1)]),
        DTensor.from_local(r[:, mine].clone(), mesh, [Shard(0), Shard(1)]))
    with ambient_mesh(mesh), implicit_replication():
        out, cache = attn.mla_decode(p, x, cache, SEQ_POS, cfg,
                                     seq_axis="model")
        out = out.full_tensor()
    np.savez(f"{out_dir}/mla{rank}.npz", out=out.numpy(),
             c=cache.k.to_local().numpy(), r=cache.v.to_local().numpy())


def moe_inputs():
    """(cfg, f32 MoE params, x (2, 8, d)) of reduced granite-moe, from a
    seed."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    cfg = get_config("granite_moe_1b_a400m").reduced()
    p = {k: v.float() for k, v in moe.moe_init(
        torch.Generator().manual_seed(7), cfg).items()}
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (2, 8, cfg.d_model)), dtype=torch.float32)
    return cfg, p, x


def experts(mesh, out_dir: str, rank: int) -> None:
    """The MoE layer on the (1, world) mesh: the expert stacks sharded
    over ``model`` (each rank its own experts), the tokens replicated."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import moe

    cfg, p, x = moe_inputs()
    placed = {k: distribute_tensor(v, mesh, [Replicate(), Shard(0)]
                                   if k in ("w_gate", "w_up", "w_down")
                                   else [Replicate(), Replicate()])
              for k, v in p.items()}
    with implicit_replication():
        out, aux = moe.moe_forward(placed, distribute_tensor(
            x, mesh, [Replicate(), Replicate()]), cfg)
    np.savez(f"{out_dir}/moe{rank}.npz", out=out.full_tensor().numpy(),
             aux=aux.full_tensor().numpy(),
             experts=placed["w_gate"].to_local().shape[0])

