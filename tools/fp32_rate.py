#!/usr/bin/env python3
"""Measure the f32 instruction rate the card reaches on hash_encode's
arithmetic: a multiply and a separate add per term (no FMA), on one GPU.

    python3 tools/fp32_rate.py

Builds a register-only kernel with ``nvcc`` into ``build/tools/fp32/``:
each thread holds 8 x 4 accumulators and per loop step adds the products
of 8 row values with 4 A values (``__fmul_rn`` then ``__fadd_rn``, 64 f32
instructions) and scales its 4 A values (4 more), as hash_encode.cu's
inner loop does without the shared-memory loads; a second build fuses each
term into one ``__fmaf_rn``. Each runs at 1, 2, 4 and 8 warps per SM
scheduler (blocks of 128 threads, 1 to 8 blocks per SM over every SM),
timed with CUDA events (median of 5 after warm-up). Prints, for each, the
f32 instructions per second and that rate as a share of 132 SMs x 128
lanes x the SM clock that ``nvidia-smi`` reads during the run, and the
card's name and power limit first.
"""

import ctypes
import statistics
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build/tools/fp32"
STEPS = 20000

SOURCE = r"""
#include <cuda_runtime.h>
template <bool FMA>
__global__ void __launch_bounds__(128) chain(float* out, int steps, float s) {
  float acc[8][4], x[8], a[4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    x[r] = 1.0f + 1e-3f * (threadIdx.x + r);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = 0.5f + 1e-3f * i;
  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[r][i] = FMA ? __fmaf_rn(x[r], a[i], acc[r][i])
                        : __fadd_rn(acc[r][i], __fmul_rn(x[r], a[i]));
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = __fmul_rn(a[i], s);
  }
  float sum = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += acc[r][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
extern "C" int run(void* out, int blocks, int steps, int fma, void* stream) {
  if (fma)
    chain<true><<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (float*)out, steps, 0.999999f);
  else
    chain<false><<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (float*)out, steps, 0.999999f);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fp32_rate: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import timed
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "fp32_rate.cu", OUT / "libfp32_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for fma in (0, 1):
        per_thread = STEPS * (32 + 4) if fma else STEPS * (64 + 4)
        for per_sm in (1, 2, 4, 8):      # blocks of 4 warps: warps/scheduler
            blocks = per_sm * sms
            out = torch.empty(blocks * 128, device="cuda")
            clocks, stop = [], threading.Event()

            def sample():
                while not stop.is_set():
                    r = subprocess.run(
                        ["nvidia-smi", "--query-gpu=clocks.sm",
                         "--format=csv,noheader,nounits"],
                        capture_output=True, text=True).stdout.strip()
                    if r.isdigit():
                        clocks.append(int(r))
            th = threading.Thread(target=sample)
            th.start()
            ms = statistics.median(
                timed(lambda: fn(out.data_ptr(), blocks, STEPS, fma, stream),
                      reps=1, warmup=1) for _ in range(5))
            stop.set()
            th.join()
            rate = blocks * 128 * per_thread / (ms * 1e-3)
            mhz = max(clocks) if clocks else None
            peak = sms * 128 * mhz * 1e6 if mhz else None
            share = f"{100 * rate / peak:.1f}%" if peak else "not measured"
            print(f"{'fma' if fma else 'mul+add'} {per_sm} warps/scheduler:"
                  f" {ms:.3f} ms, {rate / 1e12:.2f} T f32 instructions/s, "
                  f"SM clock {mhz} MHz, {share} of 128 lanes x clock")
    return 0


if __name__ == "__main__":
    sys.exit(main())
