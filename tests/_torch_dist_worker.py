"""One rank of the gloo test in ``test_torch_distributed.py``: joins a
file-rendezvous process group, builds the same sharded index as every
other rank (same seed), keeps its own shard and answers the queries in
both arms through a ``ProcessShardGroup``. Rank 0 writes the merged ids
and values beside the rendezvous file. Imports neither JAX nor the
reference package, so each spawned process starts quickly."""

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
    finally:
        dist.destroy_process_group()
