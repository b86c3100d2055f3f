"""The dry run's abstract state and inputs (``repro_torch.launch.dryrun``,
``launch/train.init_state_abstract``, ``data/tokens.*_batch_specs``)
against the JAX package's, on every config at full width.

Nothing is allocated: every leaf lives on the ``meta`` device (the two
largest configs would take ~214 GB and ~796 GB of bf16 weights). The
abstract ``TrainState`` has the reference's leaf keys, shapes and dtypes
on all ten configs, so a checkpoint of any config crosses packages; so
do the inputs of every cell.

Then the cells on the production meshes: one cell through the CLI in a
subprocess (its fake 256-rank process group never reaches this
process), the collectives' wire bytes and summary against
``repro.parallel.hlo_analysis``'s on the same entries, the profiler and
shard-group sources, and the MIPS cell's machinery at a small size on
the CPU.
"""

import functools
import json
import os
import subprocess
import sys
import types

import jax
import pytest
import torch
from _torch_parity import reference_dryrun, run_script

from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.launch import train as jtrain
from repro.parallel import hlo_analysis as jhlo
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.data import tokens
from repro_torch.launch import dryrun, train
from repro_torch.parallel import collectives

CELLS = [(a, s) for a in jbase.ARCH_IDS for s in jbase.shape_cells(a)]


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _layout(port_tree):
    """(keys, shape, dtype) of every leaf, each leaf checked to be meta."""
    out = []
    for keys, leaf in tree.flatten_with_keys(port_tree):
        assert leaf.is_meta, keys
        out.append((keys, tuple(leaf.shape), _dtype(leaf)))
    return out


def _reference_layout(ref_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    return [(tuple(str(getattr(p, "key", p)) for p in path),
             tuple(leaf.shape), str(leaf.dtype)) for path, leaf in flat]


@functools.lru_cache(maxsize=None)
def reference_state(arch):
    return _reference_layout(jtrain.init_state_abstract(
        jbase.get_config(arch)))


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_init_state_abstract_equals_the_reference(arch):
    state = train.init_state_abstract(base.get_config(arch))
    assert isinstance(state, train.TrainState)
    got = _layout(state)
    assert got == reference_state(arch)
    assert len(got) >= 3 * len(tree.leaves(state.params))


def test_init_state_abstract_allocates_nothing():
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
        else 0
    state = train.init_state_abstract(base.get_config(
        "jamba_1_5_large_398b"))
    n = sum(x.numel() for x in tree.leaves(state.params))
    assert n > 3.9e11
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    got = dryrun.input_specs(arch, shape)
    want = reference_dryrun().input_specs(arch, shape)
    assert sorted(got) == sorted(want)
    assert _layout(got) == _reference_layout(want)


def test_batch_specs_equal_the_reference():
    assert _layout(tokens.train_batch_specs(8, 512)) == _reference_layout(
        jtokens.train_batch_specs(8, 512))
    assert _layout(tokens.decode_batch_specs(8)) == _reference_layout(
        jtokens.decode_batch_specs(8))


def test_abstract_caches_allocate_nothing():
    """The longest cells' caches (jamba and xlstm at 524,288 positions)
    are meta tensors of the reference's layout."""
    for arch in ("jamba_1_5_large_398b", "xlstm_1_3b"):
        caches = dryrun._abstract_cache(base.get_config(arch), 1, 524288)
        want = reference_dryrun()._abstract_cache(jbase.get_config(arch), 1,
                                                  524288)
        assert _layout(caches) == _reference_layout(want)


# -- cells on the production meshes ------------------------------------------

# the cheapest production cell: one decode step of Qwen3-0.6B, ~3 s
CELL = ("qwen3_0_6b", "decode_32k")


def test_one_production_cell_runs_in_a_subprocess(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one cell of the 16 x 16
    pod mesh, its fake process group in the subprocess only."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         CELL[0], "--shape", CELL[1], "--mesh", "pod", "--out",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    rec = json.load(open(tmp_path / f"{CELL[0]}__{CELL[1]}__pod.json"))
    assert rec["ok"] and rec["chips"] == 256
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["roofline"]["compute_s"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["collective_counts"]["all-reduce"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_bytes"] > 0 and mem["peak_bytes"] is None
    # the caches shard 128 requests over data and 32,768 slots over model
    cfg = base.get_config(CELL[0])
    per_layer = (128 // 16) * (32768 // 16) * cfg.n_kv \
        * cfg.resolved_head_dim * 2
    assert mem["argument_bytes"] > 2 * cfg.n_layers * per_layer
    assert rec["layout"]["stationary"]
    assert rec["layout"]["card"] == "NVIDIA H100 80GB HBM3"


def test_cli_needs_a_cell():
    with pytest.raises(SystemExit, match="required"):
        dryrun.main(["--mesh", "pod"])


@pytest.mark.parametrize("op", jhlo._COLLECTIVES)
@pytest.mark.parametrize("g", [1, 2, 16, 256])
def test_wire_bytes_equal_the_reference(op, g):
    assert collectives.wire_bytes(op, 4096, 65536, g) == \
        jhlo._wire_bytes(op, 4096, 65536, g)


def test_summary_equals_the_reference():
    colls = [collectives.record(op, 1 << (10 + i), 1 << (12 + i), g)
             for i, (op, g) in enumerate(
                 [("all-gather", 16), ("all-reduce", 16),
                  ("reduce-scatter", 256), ("all-reduce", 2),
                  ("all-to-all", 16), ("collective-permute", 4)])]
    assert collectives.summarize_collectives(colls) == \
        jhlo.summarize_collectives(colls)
    assert collectives.counts_by_op(colls)["all-reduce"] == 2


def test_profiler_events_give_collectives():
    """``nccl:``/``gloo:`` events of a profiled run (their input shapes
    and dtypes): op, bytes and the ring factors."""
    ev = [types.SimpleNamespace(name="nccl:all_reduce",
                                input_shapes=[[4, 8]], input_dtypes=["float"]),
          types.SimpleNamespace(name="gloo:all_gather",
                                input_shapes=[[2, 8]],
                                input_dtypes=["c10::BFloat16"]),
          types.SimpleNamespace(name="aten::mm", input_shapes=[[2, 2]],
                                input_dtypes=["float"])]
    colls = collectives.from_profiler(ev, 4)
    assert [c["op"] for c in colls] == ["all-reduce", "all-gather"]
    assert colls[0]["in_bytes"] == 128
    assert colls[0]["wire_bytes"] == 2 * 0.75 * 128
    assert colls[1]["out_bytes"] == 4 * 32


def test_recording_group_counts_one_members_gathers():
    from repro_torch.core.distributed import InProcessShardGroup
    g = collectives.RecordingShardGroup(InProcessShardGroup(4))
    out = g.all_gather([torch.ones(3, 2)] * 4)
    assert out.shape == (4, 3, 2) and g.size == 4
    g.all_reduce([torch.ones(5)] * 4, "max")
    assert [c["op"] for c in g.collectives] == ["all-gather", "all-reduce"]
    assert g.collectives[0]["wire_bytes"] == 0.75 * 4 * 24
    assert g.collectives[1]["wire_bytes"] == 2 * 0.75 * 20


def test_mips_cell_runs_the_sharded_engine_on_the_cpu(tmp_path):
    """The MIPS cell's machinery at a small size on the CPU: the index
    built and sharded over the pod mesh's 16 data shards x 16 query
    shards, the measured bucket count, the kernels' cost counters and the
    gathers' wire bytes."""
    rec = dryrun.run_mips_cell("pod", str(tmp_path), device="cpu", n=3000,
                               d=16, L=32, m=8, k=5, probe=64, nq=32)
    assert rec["ok"], rec.get("error")
    assert rec["chips"] == 256 and rec["shards"] == 16
    assert rec["query_shards"] == 16
    assert 0 < rec["num_buckets"] <= 3000
    assert rec["collective_counts"] == {"all-gather": 2}
    assert rec["collectives"]["total_wire_bytes"] > 0
    for op in ("hash_encode", "hamming_scan", "bucket_gather"):
        assert rec["cost_counters"][f"{op}.flops"] > 0
    assert rec["roofline"]["compute_s"] > 0
    assert json.load(open(tmp_path / "range_lsh_mips__pod.json"))["ok"]


def test_all_records_a_cell_past_its_timeout(tmp_path):
    """``--all``'s runner kills a cell's process past its time and
    records the cell as failed (Qwen3's prefill of 32 x 32,768 tokens
    takes ~55 s of host time on meta, far longer than 3 s)."""
    ok = dryrun.run_cells([("qwen3_0_6b", "prefill_32k", "pod")],
                          str(tmp_path), jobs=1, timeout=3)
    rec = json.load(open(tmp_path / "qwen3_0_6b__prefill_32k__pod.json"))
    assert not ok and not rec["ok"]
    assert rec["error"] == "timed out after 3 s"


RECURRENT_CELLS = r"""
import json, logging, time
logging.getLogger("torch.distributed").setLevel(logging.ERROR)
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shd

out = {}
with fake_process_group(256):
    mesh = make_production_mesh()
    for arch in ("xlstm_1_3b", "jamba_1_5_large_398b"):
        cfg = get_config(arch).reduced()
        for shape in ("train_4k", "prefill_32k"):
            fn, args, _ = dryrun.build_cell(cfg, shape, mesh)
            t = time.time()
            with coll.CollectiveRecorder() as rec:
                res = fn(*args)
            out[f"{arch}:{shape}"] = {
                "run_s": time.time() - t,
                "argument_bytes": shd.local_bytes(args),
                "output_bytes": shd.local_bytes(res),
                "counts": coll.counts_by_op(rec.collectives),
                "summary": coll.summarize_collectives(rec.collectives)}
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def recurrent_cells():
    return run_script(RECURRENT_CELLS, timeout=600)


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "jamba_1_5_large_398b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_recurrent_cells_finish_and_record_collectives(arch, shape):
    """xlstm's and jamba's train and prefill cells, their time loops
    traced by trip (4,096 and 32,768 steps; Mamba's 256 and 2,048 chunk
    carries), at ``reduced()`` widths on the 16 x 16 pod mesh's 256 fake
    ranks: each finishes and records its bytes and collectives, every
    wire byte counted with its trips."""
    got = recurrent_cells()[f"{arch}:{shape}"]
    assert got["argument_bytes"] > 0 and got["output_bytes"] > 0
    assert sum(got["counts"].values()) == got["summary"]["count"] > 0
    assert got["summary"]["total_wire_bytes"] > 0
    if shape == "train_4k":
        assert got["counts"]["all-gather"] > 0
        assert got["counts"]["reduce-scatter"] > 0
