#!/usr/bin/env python3
"""Time bucket_gather.cu and hash_encode.cu beside another build of them,
on one GPU.

    python3 tools/gather_encode_ab.py --baseline DIR [--rounds 3]

DIR holds another ``bucket_gather.cu`` and ``hash_encode.cu`` with the
same C entry points (an earlier tree's ``src/repro_torch/kernels/csrc``;
its ``repro_hash_encode`` is called without this tree's ``rows``,
``warps`` and ``blocks`` arguments). Both are built with ``nvcc`` into
``build/tools/ab/``. The inputs are the path's, made as ``chip_smoke.py``
makes them: the synthetic ``imagenet`` set at N = 2,340,373, d = 150, its
RANGE-LSH index and calibration; hash_encode at the build's shape and at
one 64-query batch; bucket_gather at the planned runs of that batch
(recall target 0.9) and at the streaming bucket arm's runs of a
``MutableIndex`` mounted on the index and calibrated (about one slot a
run, P odd). Every build must equal the plain version (kernels/ref.py)
at every shape first. Then, in ``--rounds`` rounds of baseline, this
tree, this tree, baseline, each shape's bare C call is timed as the
median of 10 CUDA-event windows after warm-up, and its device time as
the median of 20 profiled calls. Prints the card's name and power limit,
then one line per shape and build: the median over rounds and each
round's value. Exits non-zero without a CUDA device, when a build fails
or disagrees.
"""

import argparse
import ctypes
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build/tools/ab"
KERNELS = ("bucket_gather", "hash_encode")


def build_baseline(src_dir: Path):
    """ctypes handles of DIR's two libraries, built in parallel."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
             str(lib), str(src_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"gather_encode_ab: {name} failed to build:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def entries(libs):
    """(baseline, this tree) launchers of both kernels: f(inputs) -> out,
    each one bare C launch on the current stream."""
    import torch
    from repro_torch.kernels import _build, ops
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = ops._current_stream
    b_gather = libs["bucket_gather"].repro_bucket_gather
    b_gather.argtypes = [P, P, P, I, I, I, P]
    b_encode = libs["hash_encode"].repro_hash_encode
    b_encode.argtypes = [P, P, P, P, P, LL, I, I, I, P]
    b_encode.restype = b_gather.restype = ctypes.c_int
    n_gather = _build.function("bucket_gather")
    n_encode = _build.function("hash_encode")

    def gather(fn):
        def run(cum, starts, num_probe):
            Q, S = starts.shape
            out = torch.empty((Q, num_probe), dtype=torch.int32,
                              device=cum.device)
            if fn(cum.data_ptr(), starts.data_ptr(), out.data_ptr(), Q, S,
                  num_probe, stream()):
                sys.exit("gather_encode_ab: bucket_gather launch failed")
            return out
        return run

    def encode(fn, planned=True):
        def run(x, A, tail, a_tail):
            N, d = x.shape
            L = A.shape[1]
            W = (L + 31) // 32
            out = torch.empty((N, W), dtype=torch.int32, device=x.device)
            extra = ()
            if planned:
                plan = ops.hash_encode_plan(
                    N, d, L, torch.cuda.get_device_properties(x.device)
                    .multi_processor_count)
                extra = (plan.rows, plan.warps, plan.blocks)
            err = fn(x.data_ptr(), A.data_ptr(), tail.data_ptr(),
                     a_tail.data_ptr(), out.data_ptr(), N, d, L, W, *extra,
                     stream())
            if err:
                sys.exit(f"gather_encode_ab: hash_encode launch failed "
                         f"({err})")
            return out
        return run

    return ({"bucket_gather": gather(b_gather),
             "hash_encode": encode(b_encode, planned=False)},
            {"bucket_gather": gather(n_gather),
             "hash_encode": encode(n_encode)})


def path_inputs(dev):
    """{shape name: (kernel, args)} at the path's shapes."""
    import torch
    from chip_smoke import (BATCH, DIM, K, N_ITEMS, NUM_QUERIES,
                            RECALL_TARGET, SEED)
    from repro_torch import streaming
    from repro_torch.core import hashing, planner
    from repro_torch.core.engine import (_directory_order, _planned_runs,
                                         engine_for)
    from repro_torch.core.index import IndexSpec, build
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.streaming.engine import bucket_runs

    ds = make_dataset("imagenet", SEED, n=N_ITEMS, d=DIM,
                      num_queries=NUM_QUERIES)
    spec = IndexSpec(family="simple", code_len=32, m=32, scheme="percentile",
                     engine="fused", recall_target=RECALL_TARGET)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    idx = build(dataclasses.replace(spec, recall_target=None), ds.items, gen)
    idx = idx._replace(spec=spec, calib=planner.calibrate(idx,
                                                          generator=gen))
    fused = engine_for(idx, engine="fused")
    plan = planner.resolve_budgets(idx.calib, RECALL_TARGET, k=K)
    qb = ds.queries[:BATCH]
    q_codes = idx.family.encode_queries(idx.params, qb)
    order = _directory_order(fused.buckets, q_codes, fused._match_fn)
    cum, starts = _planned_runs(fused.buckets, order, plan.budgets)

    mi = streaming.MutableIndex.from_composed(idx)
    cal_gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    cal_q = torch.randn((planner.DEFAULT_CAL_QUERIES, DIM),
                        generator=cal_gen, device=dev)
    mi.set_calibration(planner.calibrate_streaming(mi, cal_q, k=K))
    width = planner.plan_global(mi.calib, RECALL_TARGET).num_probe
    n_csr = mi.num_csr_items
    probe_base = min(n_csr, min(width, n_csr + mi.delta.capacity)
                     + mi.max_tombstones)
    _, g_cum, g_starts = bucket_runs(mi._arrs(), mi.encode_queries(qb),
                                     probe_base, mi.hash_bits, "auto")

    x = idx.items / idx.upper_eff[idx.range_id][:, None]
    tail = torch.sqrt(torch.clamp_min(1.0 - torch.sum(x * x, -1), 0.0))
    A, a_tail = idx.params[:-1], idx.params[-1]
    qn = hashing.normalize(qb)
    zeros = torch.zeros((BATCH,), device=dev)
    return {
        "hash_encode build": ("hash_encode", (x, A, tail, a_tail)),
        "hash_encode query": ("hash_encode", (qn, A, zeros, a_tail)),
        "bucket_gather main": ("bucket_gather",
                               (cum, starts, plan.num_probe)),
        "bucket_gather stream": ("bucket_gather",
                                 (g_cum, g_starts, probe_base)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="directory with the other bucket_gather.cu and "
                         "hash_encode.cu")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gather_encode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import device_ms, timed
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    base, new = entries(build_baseline(args.baseline.resolve()))
    shapes = path_inputs(dev)
    builds = {"baseline": base, "this tree": new}
    plain = {"hash_encode": lambda *a: ops.hash_encode(*a, impl="ref"),
             "bucket_gather": lambda *a: ops.bucket_gather(*a, impl="ref")}
    for shape, (kernel, a) in shapes.items():
        want = plain[kernel](*a)
        for name, fns in builds.items():
            if not torch.equal(fns[kernel](*a), want):
                print(f"gather_encode_ab: {name} != plain at {shape}",
                      file=sys.stderr)
                return 1
        print(f"{shape}: every build equals the plain version, shape "
              f"{tuple(want.shape)}")
        del want
    order = ["baseline", "this tree", "this tree", "baseline"]
    ms = {}
    for _ in range(args.rounds):
        for name in order:
            for shape, (kernel, a) in shapes.items():
                fn = builds[name][kernel]
                win = timed(lambda: fn(*a))
                dev_t = device_ms(lambda: fn(*a), names=(f"{kernel}_kernel",))
                ms.setdefault((shape, name), []).append((win, dev_t))
    for shape in shapes:
        for name in builds:
            got = ms[(shape, name)]
            wins = [w for w, _ in got]
            devs = [t for _, t in got if t is not None]
            dv = (f"{statistics.median(devs):.4f}" if devs
                  else "not measured")
            win = statistics.median(wins)
            print(f"{shape:22s} {name:20s} window {win:.4f}"
                  f" ms, device {dv} ms; rounds "
                  f"{[round(w, 4) for w in wins]} / "
                  f"{[None if t is None else round(t, 4) for _, t in got]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
