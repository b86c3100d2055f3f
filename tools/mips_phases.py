#!/usr/bin/env python3
"""Where mips_topk.cu's first launch spends its cycles, on one GPU.

    python3 tools/mips_phases.py

Builds a copy of ``src/repro_torch/kernels/csrc/mips_topk.cu`` with
``clock64()`` probes added around the end-of-tile candidate phase (the
filter, the barrier, and the sorted-list insertions), runs it once at the
exact-baseline shape (Q = 64, N = 2,341,909, d = 150, k = 10, seeded
normal data) and prints, per block on average: all cycles, the filter's,
the barrier's and the insertions' (thread 0, which inserts for query 0
and waits for the other inserting lanes of its warp), the number of tiles
that inserted, and the candidates. The probes are added to a build under
``build/``; the repository's kernel is not changed. Exits non-zero
without a CUDA device or when the source no longer has the probe points.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/mips_topk.cu"
OUT = ROOT / "build/tools"
N_SLOTS = 8

# (anchor in the source, text that replaces it)
PROBES = [
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long g_phase[65536 * 8];\n"),
    ("  const float* qsrc = queries + (size_t)q0 * d;\n",
     "  const float* qsrc = queries + (size_t)q0 * d;\n"
     "  const long long t_start = clock64();\n"
     "  long long t_cand = 0, t_filter = 0, t_bar = 0;\n"
     "  int n_flush = 0;\n"),
    ("    if (it % nks != nks - 1) continue;\n",
     "    if (it % nks != nks - 1) continue;\n"
     "    const long long tc0 = clock64();\n"),
    ("          cval[slot * kQT + q] = acc[i][j];\n",
     "          cval[slot * kQT + q] = acc[i][j];\n"
     "          atomicAdd(&g_phase[blockIdx.x * 8 + 3], 1ull);\n"),
    ("    if (__syncthreads_or(any) && (tid & 31) < 16 && fq < nq) {\n",
     "    const long long tf0 = clock64();\n"
     "    const bool flush = __syncthreads_or(any);\n"
     "    const long long tf1 = clock64();\n"
     "    t_filter += tf0 - tc0;\n"
     "    t_bar += tf1 - tf0;\n"
     "    n_flush += flush;\n"
     "    if (flush && (tid & 31) < 16 && fq < nq) {\n"),
    ("      }\n    }\n  }\n  __syncthreads();\n\n  for (int e = tid; e < nq * k;",
     "      }\n    }\n    t_cand += clock64() - tc0;\n  }\n  __syncthreads();\n"
     "  if (tid == 0) {\n"
     "    unsigned long long* g = g_phase + blockIdx.x * 8;\n"
     "    g[0] = clock64() - t_start;\n    g[1] = t_cand;\n"
     "    g[2] = n_flush;\n    g[4] = t_filter;\n    g[5] = t_bar;\n"
     "  }\n\n  for (int e = tid; e < nq * k;"),
]
READER = """
extern "C" int phase_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
"""


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mips_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    text = SRC.read_text()
    for anchor, repl in PROBES:
        if text.count(anchor) != 1:
            print(f"mips_phases: probe point not found once: {anchor!r}",
                  file=sys.stderr)
            return 1
        text = text.replace(anchor, repl)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "mips_phases.cu").write_text(text + READER)
    lib_path = OUT / "libmips_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(OUT / "mips_phases.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    run_fn = lib.repro_mips_topk
    run_fn.argtypes = _build.SIGNATURES["mips_topk"][2]
    run_fn.restype = ctypes.c_int
    blocks_fn = lib.repro_mips_topk_blocks_per_sm
    blocks_fn.argtypes, blocks_fn.restype = [ctypes.c_int], ctypes.c_int

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Q, N, d, k = 64, 2341909, 150, 10
    queries = torch.randn((Q, d), generator=gen, device=dev)
    items = torch.randn((N, d), generator=gen, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block, nblk = ops.mips_topk_plan(Q, N, blocks_fn(k), sms)
    part_val = torch.empty((nblk, Q, k), device=dev)
    part_id = torch.empty((nblk, Q, k), dtype=torch.int32, device=dev)
    vals = torch.empty((Q, k), device=dev)
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    err = run_fn(queries.data_ptr(), items.data_ptr(), part_val.data_ptr(),
                 part_id.data_ptr(), vals.data_ptr(), ids.data_ptr(), Q, N,
                 d, k, per_block, nblk, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        print(f"mips_phases: launch failed ({err})", file=sys.stderr)
        return 1
    if not torch.equal(ids, ops.mips_topk(queries, items, k)[1]):
        print("mips_phases: probed build disagrees with the kernel",
              file=sys.stderr)
        return 1
    buf = (ctypes.c_ulonglong * (65536 * N_SLOTS))()
    lib.phase_read(buf)
    a = np.frombuffer(buf, dtype=np.uint64).reshape(-1, N_SLOTS)[:nblk]
    a = a.astype(np.float64).mean(axis=0)
    total, cand, filt, bar = a[0], a[1], a[4], a[5]
    insert = cand - filt - bar
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"mips_phases: {nblk} blocks of {per_block} items "
          f"({per_block // 128} tiles); cycles per block {total:.0f}: "
          f"filter {filt:.0f} ({100 * filt / total:.1f}%), barrier "
          f"{bar:.0f} ({100 * bar / total:.1f}%), insertions {insert:.0f} "
          f"({100 * insert / total:.1f}%), the rest (staging and FMAs) "
          f"{total - cand:.0f} ({100 * (total - cand) / total:.1f}%); "
          f"tiles that inserted {a[2]:.1f}, candidates {a[3]:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
