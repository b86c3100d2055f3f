"""Multi-pod dry run: every (arch x shape x mesh) cell run once on the
production meshes, with no device (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's jitted step for 512
placeholder host devices. Here a cell runs eagerly on ``meta`` DTensors
over a fake process group of the mesh's world
(``launch/mesh.fake_process_group``: 256 ranks for ``pod``'s 16 x 16,
512 for ``multipod``'s 2 x 16 x 16), this process one rank of it. Per
cell it:

  1. builds the abstract state (``meta`` params, caches and inputs,
     nothing allocated) and places it by the production specs
     (``parallel/sharding.py``): the train step's state FSDP x TP (pure
     ZeRO when the batch divides the mesh and every layer is attention),
     prefill's params FSDP x TP, decode's stationary serve specs where
     they fit the card's memory (else FSDP) with the caches sequence on
     ``model``;
  2. runs the real ``train.make_train_step`` step, ``lm.prefill`` (the
     encoder-decoder's encoder and decoder) or ``lm.decode_step`` under
     ``implicit_replication``: success means DTensor's sharding
     propagation went through every op;
  3. records the exact per-device argument and output bytes from the
     local shard shapes (XLA's temp and peak bytes have no counterpart:
     null), every collective the step issued
     (``parallel/collectives.CollectiveRecorder``) and the roofline of
     the analytic FLOPs and bytes (``parallel/analytic.py``) and the wire
     bytes at the card's peaks (``parallel/roofline.py``);
  4. writes ``experiments/dryrun/<arch>__<shape>__<mesh>.json``.

The MIPS cell cannot run on ``meta``: the planner reads data (range
counts, bucket runs). ``run_mips_cell`` builds its index for real on the
card and shards it over an in-process group of the mesh's data-parallel
count, queries over ``model``. ``--all`` runs each model cell in its own
process, ``--jobs`` at a time, and records a cell still running after
``--cell-timeout`` seconds as failed.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape decode_32k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both] [--jobs N] [--cell-timeout S]
  python -m repro_torch.launch.dryrun --mips          # the MIPS cell, on the card
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      get_config, shape_cells)
from repro_torch.data.tokens import train_batch_specs
from repro_torch.models import lm
from repro_torch.tree import flatten_with_keys, leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")
#: the share of a card's memory the stationary serve layout may take (the
#: reference's 12e9 bytes of a 16 GB TPU chip)
STATIONARY_SHARE = 0.75


def _abstract_params(cfg: ModelConfig):
    return lm.init_params(None, cfg, device="meta")


def _abstract_cache(cfg: ModelConfig, batch: int, seq: int):
    if cfg.is_encoder_decoder:
        from repro_torch.models import encdec
        return encdec.init_cache(cfg, batch, seq, device="meta")
    return lm.init_cache(cfg, batch, seq, device="meta")


def param_counts(cfg: ModelConfig, params) -> Dict[str, float]:
    """Total, MoE-active and expert parameter counts of a param tree (the
    reference's: a leaf under an ``ffn`` key with 4 or more axes is a
    stack of experts)."""
    total = sum(x.numel() for x in leaves(params))
    expert = 0
    for keys, leaf in flatten_with_keys(params):
        if any("ffn" in k for k in keys) and leaf.dim() >= 4:
            expert += leaf.numel()
    active = total - expert
    if cfg.moe is not None and expert:
        active += expert * cfg.moe.top_k / cfg.moe.num_experts
    return {"total": float(total), "active": float(active),
            "expert": float(expert)}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str):
    """Stand-ins on ``meta`` for every input of a cell, with the
    reference's shapes and dtypes: train cells give the batch dict;
    prefill cells ``tokens`` (and ``patches``/``frames``); decode cells
    ``tokens``, ``caches`` and ``cache_pos``."""
    return _inputs(get_config(arch), shape_name)


def _inputs(cfg: ModelConfig, shape_name: str):
    shape = SHAPES[shape_name]
    B = shape.global_batch
    extra = {}
    if cfg.num_patches:
        extra["patches"] = _meta((B, cfg.num_patches, cfg.d_model),
                                 torch.float32)
    if cfg.is_encoder_decoder:
        extra["frames"] = _meta((B, cfg.encoder_frames, cfg.d_model),
                                torch.float32)
    if shape.kind == "train":
        return {**train_batch_specs(B, shape.seq_len), **extra}
    if shape.kind == "prefill":
        return {"tokens": _meta((B, shape.seq_len), torch.int32), **extra}
    return {"tokens": _meta((B,), torch.int32),
            "caches": _abstract_cache(cfg, B, shape.seq_len),
            "cache_pos": _meta((), torch.int32)}


# -- cells on the production meshes ------------------------------------------


def card_name() -> str:
    """The card whose peaks and memory a cell is held to: CUDA device 0,
    or off the card the one the port targets."""
    from repro_torch.parallel.roofline import TARGET_CARD
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return TARGET_CARD


def serve_budget(card: str) -> float:
    """Bytes a chip may give the stationary serve layout's weights."""
    from repro_torch.parallel.roofline import card_peaks
    return STATIONARY_SHARE * card_peaks(card).memory_bytes


def _zero_dp(cfg: ModelConfig, shape, mesh) -> bool:
    """Pure ZeRO data parallelism: the global batch divides the whole
    mesh and every layer is attention (recurrent archs keep 2D FSDP x TP,
    as the reference measured)."""
    return (shape.global_batch % mesh.size() == 0
            and all(k == "attn" for k in cfg.layer_pattern)
            and not cfg.is_encoder_decoder)


def build_cell(cfg: ModelConfig, shape_name: str, mesh,
               card: Optional[str] = None):
    """Returns (fn, args, info): ``fn(*args)`` runs the cell's step once
    on ``args``, ``meta`` DTensors placed on ``mesh``; ``info`` holds the
    layout choices (``zero_dp``, the serve budget)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import train
    from repro_torch.launch.mesh import ambient_mesh
    from repro_torch.parallel import analytic
    from repro_torch.parallel import sharding as shd

    shape = SHAPES[shape_name]
    B = shape.global_batch
    dp = shd.dp_axes(mesh)
    inputs = _inputs(cfg, shape_name)
    info: Dict[str, Any] = {}

    if shape.kind == "train":
        zero_dp = _zero_dp(cfg, shape, mesh)
        info["zero_dp"] = zero_dp
        step = train.make_train_step(cfg, train.TrainHParams(), mesh=mesh,
                                     zero_dp=zero_dp)
        state = train.shard_state(train.init_state_abstract(cfg), cfg, mesh,
                                  zero_dp=zero_dp)
        bspecs = train.batch_specs(cfg, mesh, zero_dp)
        batch = {k: shd.distribute(v, mesh, bspecs[k])
                 for k, v in inputs.items()}
        return step, (state, batch, 0), info

    params = _abstract_params(cfg)

    def run(fn):
        def go(*args):
            with ambient_mesh(mesh), implicit_replication():
                return fn(*args)
        return go

    if shape.kind == "prefill":
        params = shd.to_shardings(
            mesh, shd.param_specs(params, cfg, fsdp_axis="data"), params)
        tokens = shd.distribute(inputs["tokens"], mesh, shd.Spec(dp, None))
        extra = shd.Spec(dp, None, None)
        if cfg.is_encoder_decoder:
            from repro_torch.models import encdec
            frames = shd.distribute(inputs["frames"], mesh, extra)

            def prefill_ed(params, tokens, frames):
                enc = encdec.encoder_forward(params["encoder"], frames, cfg)
                h, caches = encdec.decoder_forward(params, tokens, enc, cfg)
                return h[:, -1], caches
            return run(prefill_ed), (params, tokens, frames), info
        args = (params, tokens)
        if cfg.num_patches:
            args += (shd.distribute(inputs["patches"], mesh, extra),)
        return run(lambda *a: lm.prefill(*a[:2], cfg, *a[2:])), args, info

    # decode: weights stationary (pure TP, experts 2D) where they fit the
    # card's memory, else FSDP + TP; caches sequence on model
    card = card or card_name()
    counts = analytic.matmul_param_counts(cfg, params)
    embed_n, expert_n = counts["embed"], counts["expert"]
    dense_n = sum(x.numel() for x in leaves(params)) - expert_n - embed_n
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    tp = sizes["model"]
    per_chip = 2.0 * (dense_n / tp + embed_n / tp + expert_n / mesh.size())
    budget = serve_budget(card)
    stationary = per_chip <= budget
    info.update(stationary=stationary, stationary_bytes_per_chip=per_chip,
                serve_budget_bytes=budget, card=card)
    params = shd.to_shardings(mesh, shd.param_specs(
        params, cfg, fsdp_axis=None if stationary else "data",
        serve_stationary=stationary), params)
    caches = shd.to_shardings(mesh, shd.cache_specs(cfg, mesh, batch=B),
                              inputs["caches"])
    tokens = shd.distribute(inputs["tokens"], mesh,
                            shd.Spec(shd.dp_axes_for_batch(mesh, B)))

    def decode(params, tokens, caches, cache_pos):
        return lm.decode_step(params, tokens, caches, cache_pos, cfg,
                              seq_axis=shd.MODEL)
    return run(decode), (params, tokens, caches, shape.seq_len - 1), info


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[str] = OUT_DIR,
             card: Optional[str] = None) -> Dict[str, Any]:
    """One cell on the production mesh of ``mesh_kind`` ("pod" or
    "multipod") under its fake process group; returns its record (and
    writes it under ``out_dir`` unless None)."""
    from repro_torch.launch.mesh import (fake_process_group,
                                         make_production_mesh, mesh_shape)
    from repro_torch.parallel import analytic
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.roofline import roofline

    # DTensor warns at each redistribution it does in two collectives
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    cfg = get_config(arch)
    multi = mesh_kind == "multipod"
    card = card or card_name()
    record: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_kind, "card": card}
    t0 = time.time()
    try:
        with fake_process_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            chips = mesh.size()
            record.update(mesh_shape=mesh_shape(mesh), chips=chips)
            fn, args, info = build_cell(cfg, shape_name, mesh, card)
            arg_bytes = shd.local_bytes(args)
            t1 = time.time()
            with coll.CollectiveRecorder() as rec:
                out = fn(*args)
            t2 = time.time()
            out_bytes = shd.local_bytes(out)
        csum = coll.summarize_collectives(rec.collectives)
        params = _abstract_params(cfg)
        shape = SHAPES[shape_name]
        est = analytic.estimate(cfg, shape, params, chips)
        terms = roofline(est["flops"], est["hbm_bytes_per_device"] * chips,
                         csum.get("total_wire_bytes", 0.0), chips,
                         model_flops=est["model_flops"], card=card)
        record.update({
            "ok": True,
            "build_s": round(t1 - t0, 2),
            "run_s": round(t2 - t1, 2),
            "layout": info,
            # exact local shard bytes; XLA's temp and peak bytes have no
            # counterpart in an eager run
            "memory_analysis": {"argument_bytes": arg_bytes,
                                "output_bytes": out_bytes,
                                "bytes_per_device": None,
                                "peak_bytes": None},
            "collectives": csum,
            "collective_counts": coll.counts_by_op(rec.collectives),
            "analytic": est,
            "roofline": terms,
            "param_counts": param_counts(cfg, params),
            "model_flops": est["model_flops"],
            "useful_flops_ratio": (est["model_flops"] / est["flops"]
                                   if est["flops"] else None),
        })
    except Exception as e:
        record.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]})
    _write(record, out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    status = "OK" if record.get("ok") else "FAIL"
    print(f"[{status}] {arch} x {shape_name} x {mesh_kind} "
          f"(run {record.get('run_s', '-')}s)", flush=True)
    if not record.get("ok"):
        print(record["error"], flush=True)
    return record


def _write(record, out_dir: Optional[str], name: str) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1, default=str)


def run_mips_cell(mesh_kind: str, out_dir: Optional[str] = OUT_DIR, *,
                  device=None, n: int = 2_000_000, d: int = 128,
                  L: int = 128, m: int = 256, k: int = 10,
                  probe: int = 512, nq: int = 1024, seed: int = 0,
                  card: Optional[str] = None,
                  check_plain: bool = False) -> Dict[str, Any]:
    """The paper's own workload: sharded MIPS serving on the spec API,
    bucket-traversal engine, on ``device`` (the card unless
    ``device="cpu"``). The index is built for real (``n`` items of
    ``d``, code length ``L``, ``m`` ranges, from ``seed``) and sharded
    over an in-process group of the mesh's data-parallel count (16 on
    ``pod``, 32 on ``multipod``) x its ``model`` width of query shards;
    ``nq`` queries take the top ``k`` at ``probe`` probes. Recorded: the
    measured bucket count, the wire bytes of the group's gathers (one
    member's), the kernels' cost counters (the ops' analytic models) and
    their roofline over the mesh's chips. ``check_plain`` answers the
    queries again through the kernels' plain versions (``impl="ref"``):
    the ids must be equal and the values within 1e-4 (``plain_*``)."""
    from repro_torch import resolve_device
    from repro_torch.core import distributed as dist
    from repro_torch.core.index import IndexSpec
    from repro_torch.kernels import ops
    from repro_torch.obs.sinks import RingBufferSink
    from repro_torch.obs.tracker import Tracker
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.roofline import roofline

    device = resolve_device(device)
    multi = mesh_kind == "multipod"
    shape = {"pod": 2, "data": 16, "model": 16} if multi else \
        {"data": 16, "model": 16}
    if not multi:
        shape.pop("pod", None)
    chips = 1
    for v in shape.values():
        chips *= v
    shards = shape["data"] * shape.get("pod", 1)
    qshards = shape["model"]
    card = card or card_name()
    record: Dict[str, Any] = {"arch": "range_lsh_mips",
                              "shape": f"n{n}_d{d}_q{nq}",
                              "mesh": mesh_kind, "mesh_shape": shape,
                              "chips": chips, "card": card,
                              "device": str(device)}
    t0 = time.time()
    try:
        gen = torch.Generator(device=device).manual_seed(seed)
        items = torch.randn((n, d), generator=gen, device=device)
        items = items * torch.exp(0.8 * torch.randn(
            (n, 1), generator=gen, device=device))
        queries = torch.randn((nq, d), generator=gen, device=device)
        spec = IndexSpec(family="simple", code_len=L, m=m, engine="bucket")
        sidx = dist.build_sharded(spec, items, gen, shards, device=device)
        del items
        group = coll.RecordingShardGroup(
            dist.InProcessShardGroup(shards * qshards))
        eng = dist.DistributedEngine(sidx, group, engine="bucket",
                                     query_axis=qshards)
        t1 = time.time()
        tracker = Tracker([RingBufferSink()])
        ops.set_dispatch_tracker(tracker)
        try:
            vals, ids = eng.query(queries, k, probe)
            if device.type == "cuda":
                # repro-lint: allow[R6] the cell's query time ends on the card
                torch.cuda.synchronize(device)
        finally:
            ops.set_dispatch_tracker(None)
        t2 = time.time()
        snap = tracker.snapshot()["counters"]
        cost = {key[len("repro.kernels.cost."):]: float(v)
                for key, v in snap.items()
                if key.startswith("repro.kernels.cost.")}
        flops = sum(v for key, v in cost.items() if key.endswith(".flops"))
        hbm = sum(v for key, v in cost.items()
                  if key.endswith(".hbm_bytes"))
        # one member's gathers: the wire bytes a device sends or receives
        per_member = [dict(c, wire_bytes=c["wire_bytes"] / group.size)
                      for c in group.collectives]
        csum = coll.summarize_collectives(per_member)
        terms = roofline(flops, hbm, csum["total_wire_bytes"], chips,
                         card=card)
        ok = (tuple(vals.shape) == (nq, k)
              and bool(torch.isfinite(vals).all())
              and bool((ids >= 0).all()))
        if check_plain:
            plain = dist.DistributedEngine(
                sidx, dist.InProcessShardGroup(shards * qshards),
                engine="bucket", query_axis=qshards, impl="ref")
            pv, pi = plain.query(queries, k, probe)
            record["plain_ids_equal"] = bool(torch.equal(pi, ids))
            record["plain_max_abs_err"] = float((pv - vals).abs().max())
            ok = (ok and record["plain_ids_equal"]
                  and record["plain_max_abs_err"] <= 1e-4)
        record.update({"ok": ok, "build_s": round(t1 - t0, 2),
                       "run_s": round(t2 - t1, 2),
                       "num_buckets": int(sidx.num_buckets),
                       "rows_per_shard": int(sidx.rows_per_shard),
                       "shards": shards, "query_shards": qshards,
                       "cost_counters": cost,
                       "collectives": csum,
                       "collective_counts": coll.counts_by_op(per_member),
                       "roofline": terms})
        if not ok:
            record["error"] = "the merged top-k is not finite and whole"
    except Exception as e:
        record.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]})
    _write(record, out_dir, f"range_lsh_mips__{mesh_kind}.json")
    print(f"[{'OK' if record.get('ok') else 'FAIL'}] MIPS x {mesh_kind} "
          f"(run {record.get('run_s', '-')}s)", flush=True)
    if not record.get("ok"):
        print(record["error"], flush=True)
    return record


def run_cells(cells, out_dir: str, jobs: int, timeout: float) -> bool:
    """Each (arch, shape, mesh) cell in a fresh process of this CLI,
    ``jobs`` at a time, each with ``timeout`` seconds (a cell past it is
    killed and recorded as failed). True if every cell was ok."""
    import subprocess
    import sys
    pending = list(cells)
    running = []
    ok = True

    def finish(cell, proc, t0, timed_out):
        arch, shape, mk = cell
        name = f"{arch}__{shape}__{mk}.json"
        path = os.path.join(out_dir, name)
        if timed_out and os.path.exists(path) and \
                os.path.getmtime(path) >= t0:
            timed_out = False         # its record came in as it was killed
        if timed_out or not os.path.exists(path):
            why = (f"timed out after {timeout:.0f} s" if timed_out else
                   f"the process exited {proc.returncode} with no record")
            _write({"arch": arch, "shape": shape, "mesh": mk, "ok": False,
                    "error": why, "run_s": round(time.time() - t0, 2)},
                   out_dir, name)
            print(f"[FAIL] {arch} x {shape} x {mk} ({why})", flush=True)
            return False
        with open(path) as f:
            return bool(json.load(f).get("ok"))

    while pending or running:
        while pending and len(running) < jobs:
            cell = pending.pop(0)
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", cell[0], "--shape", cell[1], "--mesh", cell[2],
                 "--out", out_dir])
            running.append((cell, proc, time.time()))
        time.sleep(0.5)
        still = []
        for cell, proc, t0 in running:
            if proc.poll() is not None:
                ok &= finish(cell, proc, t0, False)
            elif time.time() - t0 > timeout:
                proc.kill()
                proc.wait()
                ok &= finish(cell, proc, t0, True)
            else:
                still.append((cell, proc, t0))
        running = still
    return ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mips", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1,
                    help="processes running --all's model cells, each "
                         "cell in a fresh one")
    ap.add_argument("--cell-timeout", type=float, default=600.0,
                    help="seconds an --all cell may run before it is "
                         "killed and recorded as failed")
    args = ap.parse_args(argv)

    meshes = (["pod", "multipod"] if args.mesh == "both" else [args.mesh])
    ok = True
    if args.mips:
        for mk in meshes:
            ok &= run_mips_cell(mk, args.out).get("ok", False)
    elif args.all:
        t0 = time.time()
        cells = [(arch, shape, mk) for arch in ARCH_IDS
                 for shape in shape_cells(arch) for mk in meshes]
        ok = run_cells(cells, args.out, args.jobs, args.cell_timeout)
        print(f"dryrun: {len(cells)} model cells in "
              f"{time.time() - t0:.1f} s", flush=True)
        for mk in meshes:
            ok &= run_mips_cell(mk, args.out).get("ok", False)
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all required")
        for mk in meshes:
            ok &= run_cell(args.arch, args.shape, mk, args.out).get(
                "ok", False)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
