#!/usr/bin/env python3
"""Time build variants of hamming.cu's scans side by side, on one GPU.

    python3 tools/hamming_variants.py [--baseline OTHER.cu] [--rounds 3]

Builds ``src/repro_torch/kernels/csrc/hamming.cu`` as it is and once per
variant, each with one of the wide kernel's design macros set by ``-D``
(queries a block walks, threads a block, items a thread, tiles launched
first to last, a launch bound of 8 blocks an SM, plain in place of
evict-first stores), all ``nvcc`` runs at once, into ``build/tools/``;
with ``--baseline`` also another source with the same C entry points (an
earlier hamming.cu). Prints the registers of each build's W = 1 distance
kernel and delta-scan kernel. Then, in ``--rounds`` interleaved rounds,
times each build's ``repro_hamming`` at Q = 64 and W = 1 against the item
counts of the path (N = 2,340,373, the same rounded down to a multiple of
8, the streaming CSR's 2,341,141 and directory's 2,249,784) and its
``repro_delta_scan`` at (64, 1,024), each as the median of 20
CUDA-event-timed launches after warm-up, beside the event-timed
``fill_`` of an int32 tensor of the output's shape. Every build's output
must equal the plain version (kernels/ref.py) at every shape first.
Prints one line per build and shape: the median over rounds, and each
round's. Exits non-zero without a CUDA device, when a build fails, or
when a build disagrees.
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/hamming.cu"
OUT = ROOT / "build/tools"
# name -> the -D flags of hamming.cu's design macros that the variant sets
VARIANTS = {
    "default": [],
    "forward": ["-DHAMMING_LAST_TILE_FIRST=0"],
    "no_stcs": ["-DHAMMING_EVICT_FIRST=0"],
    "qb32": ["-DHAMMING_QB=32"],
    "qb16": ["-DHAMMING_QB=16"],
    "t128": ["-DHAMMING_THREADS=128"],
    "t512": ["-DHAMMING_THREADS=512"],
    "ipt8": ["-DHAMMING_IPT=8"],
    "minb8": ["-DHAMMING_MIN_BLOCKS=8"],
}
WIDE_N = (2340373, 2340368, 2341141, 2249784)
Q, DELTA_C, HASH_BITS = 64, 1024, 27


def host_us(fn, reps: int = 2000) -> float:
    """Host microseconds per ``fn()`` over ``reps`` calls (launches queue
    up; one synchronise at the end)."""
    import time

    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def host_breakdown(q, d_codes, live, out) -> None:
    """Where ops.delta_scan's host time goes at (64, 1,024): the whole
    wrapper, the bare C call, a bare fill_, and the wrapper's pieces."""
    import torch
    from repro_torch.kernels import _build, ops
    fn = _build.function("delta_scan")
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), d_codes.data_ptr(), live.data_ptr(),
            out.data_ptr(), Q, DELTA_C, 1, HASH_BITS)
    pieces = {
        "ops.delta_scan (wrapper, launch included)": lambda: ops.delta_scan(
            q, d_codes, live, HASH_BITS),
        "bare C call (launch included)": lambda: fn(*args, stream),
        "out.fill_ (one PyTorch op)": lambda: out.fill_(7),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "ops._current_stream (the raw stream handle)":
            ops._current_stream,
        "torch.empty((64, 1024), int32)": lambda: torch.empty(
            (Q, DELTA_C), dtype=torch.int32, device=q.device),
        "q.new_empty((64, 1024))": lambda: q.new_empty((Q, DELTA_C)),
        "_check_packed": lambda: ops._check_packed(
            "delta_scan", q, d_codes, "C", "delta codes"),
        "_resolve": lambda: ops._resolve("auto", "delta_scan", q, d_codes,
                                         live),
        "two _require + live.contiguous": lambda: (
            ops._require("d", q, "q", torch.int32),
            ops._require("d", d_codes, "c", torch.int32),
            live.contiguous()),
        "four data_ptr": lambda: (q.data_ptr(), d_codes.data_ptr(),
                                  live.data_ptr(), out.data_ptr()),
    }
    for name, fn_ in pieces.items():
        print(f"host: {host_us(fn_):8.2f} us  {name}")


def build(builds, nvcc, flags):
    """Compile every name -> (source, extra flags) at once; name -> CDLL."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, extra) in builds.items():
        lib = OUT / f"libhamming_{name}.so"
        cmd = [nvcc, *flags, *extra, "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        func = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif ("registers" in line and func and
                  ("EpilogueE0ELi1E" in func or "EpilogueE2E" in func
                   or name == "baseline")):
                print(f"build {name}: {func}: "
                      f"{line.split('info    :')[-1].strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--host", action="store_true",
                    help="only the host-time breakdown of ops.delta_scan")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hamming_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import timed
    from repro_torch.kernels import _build, ref

    if args.host:
        dev = torch.device("cuda")
        q = torch.zeros((Q, 1), dtype=torch.int32, device=dev)
        d_codes = torch.zeros((DELTA_C, 1), dtype=torch.int32, device=dev)
        live = torch.ones((DELTA_C,), dtype=torch.bool, device=dev)
        host_breakdown(q, d_codes, live, torch.empty(
            (Q, DELTA_C), dtype=torch.int32, device=dev))
        return 0
    builds = {name: (SRC, flags) for name, flags in VARIANTS.items()}
    if args.baseline:
        builds["baseline"] = (args.baseline.resolve(), [])
    libs = build(builds, _build._nvcc(), _build.NVCC_FLAGS)
    fns = {}
    for name, lib in libs.items():
        for entry in ("hamming", "delta_scan"):
            _, symbol, argtypes = _build.SIGNATURES[entry]
            f = getattr(lib, symbol)
            f.argtypes, f.restype = argtypes, ctypes.c_int
            fns[name, entry] = f

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def words(n):
        return torch.randint(-2 ** 31, 2 ** 31, (n, 1), generator=gen,
                             dtype=torch.int64, device=dev).to(torch.int32)

    q = words(Q)
    dbs = {n: words(n) for n in WIDE_N}
    d_codes = words(DELTA_C)
    live = torch.rand((DELTA_C,), generator=gen, device=dev) < 0.6
    stream = torch.cuda.current_stream().cuda_stream
    outs = {n: torch.empty((Q, n), dtype=torch.int32, device=dev)
            for n in (*WIDE_N, DELTA_C)}

    def call(name, n):
        if n == DELTA_C:
            err = fns[name, "delta_scan"](
                q.data_ptr(), d_codes.data_ptr(), live.data_ptr(),
                outs[n].data_ptr(), Q, n, 1, HASH_BITS, stream)
        else:
            err = fns[name, "hamming"](q.data_ptr(), dbs[n].data_ptr(),
                                       outs[n].data_ptr(), Q, n, 1, stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")

    for name in libs:
        for n in (*WIDE_N, DELTA_C):
            call(name, n)
            torch.cuda.synchronize()
            want = (ref.delta_scan_ref(q, d_codes, live, HASH_BITS)
                    if n == DELTA_C else ref.hamming_ref(q, dbs[n]))
            if not torch.equal(outs[n], want):
                print(f"hamming_variants: {name} at N={n} != plain",
                      file=sys.stderr)
                return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    times = {}
    for _ in range(args.rounds):
        for n in (*WIDE_N, DELTA_C):
            times.setdefault(("fill_", n), []).append(
                timed(lambda: outs[n].fill_(7), 20, 3))
            for name in libs:
                times.setdefault((name, n), []).append(
                    timed(lambda: call(name, n), 20, 3))
    for (name, n), ts in times.items():
        ms = statistics.median(ts)
        gbs = 4 * Q * n / ms / 1e6
        print(f"{name:18s} N={n:8d} {ms:.4f} ms ({gbs:.0f} GB/s of output)"
              f"  rounds {[round(t, 4) for t in ts]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
