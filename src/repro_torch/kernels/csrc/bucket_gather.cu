// Segmented CSR gather: out[q, p] = starts[q, j] + p - cum[q, j], where run
// j = #{i : cum[q, i+1] <= p} (clamped to S-1) holds probe slot p.
//
// Replaces the Pallas kernel bucket_gather_pallas (src/repro/kernels/
// bucket_probe.py, body _gather_kernel).
//
// What bounds it on an H100: moving bytes. The (Q, P) int32 output is
// written once; of cum and starts only the runs that hold probe slots are
// needed. Two shapes matter: the planned path's (64 x 73,136 slots over a
// 2.25 M-run cum row whose taken runs are several hundred, most runs empty)
// and the streaming bucket arm's (64 x 2.34 M slots over 2.25 M runs, about
// one slot a run), where the output and the cum/starts stream are ~1.75 GB.
//
// Design: the run expansion of fused_query.cu's span kernel, written out.
// Grid (spans of kSpan = 2,048 slots, Q), 256 threads, kPer = 8 consecutive
// slots a thread. Two warps find the runs of the span's first and last
// live slot (below cum[q, S]) by a 32-way warp search (run_search.cuh).
// Each thread finds the run of its first slot by one binary search inside
// that bracket, then walks forward; past a run's end it gallops from the
// next run (steps 1, 2, 4, ...), so a run that directly follows costs one
// load and a stretch of empty runs a few. Slots at or past cum[q, S] take
// run S-1, as the reference's clamp does. The span's positions are staged
// in shared memory (padded, so each thread's 8 writes hit distinct banks)
// and written out coalesced: 16-byte stores when every row offset q*P is a
// multiple of 4 (P % 4 == 0, a 16-byte aligned output), else 4-byte
// stores. Positions are computed in 32-bit wrapping arithmetic, as the
// plain version's int32 tensors do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "run_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                     // consecutive slots a thread
constexpr int kSpan = kThreads * kPer;      // slots a block

// padded shared index: thread-contiguous runs of kPer ints hit distinct banks
__device__ __forceinline__ int pad(int x) { return x + (x >> 5); }

// starts[j] - cum[j], the position of slot 0 if run j went back that far
__device__ __forceinline__ unsigned run_base(const int32_t* c,
                                             const int32_t* st, int j) {
  return (unsigned)__ldg(st + j) - (unsigned)__ldg(c + j);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
bucket_gather_kernel(const int32_t* __restrict__ cum,
                     const int32_t* __restrict__ starts,
                     int32_t* __restrict__ out, int Q, int S, int P) {
  __shared__ int stage[kSpan + kSpan / 32];
  __shared__ int bracket[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kSpan;
  const int n = min(kSpan, P - p0);         // this span's slots
  const int x0 = tid * kPer;
  for (int qi = blockIdx.y; qi < Q; qi += gridDim.y) {
    const size_t q = qi;
    const int32_t* c = cum + q * (S + 1);
    const int32_t* st = starts + q * S;
    // live slots (below the take total) of this span
    const int nl = max(0, min(n, __ldg(c + S) - p0));
    if (nl > 0 && warp < 2) {
      const int j = runs::find_run(c, S, warp ? p0 + nl - 1 : p0, lane);
      if (lane == 0) bracket[warp] = j;
    }
    __syncthreads();
    if (x0 < nl) {
      const int j1 = bracket[1] + 1;        // bracket: runs [j0, j1)
      int j = runs::run_in(c, p0 + x0, bracket[0], j1);
      int hi = __ldg(c + j + 1);
      unsigned base = run_base(c, st, j);
      const int xe = min(x0 + kPer, nl);
      for (int x = x0; x < xe; ++x) {
        const int p = p0 + x;
        if (p >= hi) {
          j = runs::gallop(c, p, j + 1, j1);
          hi = __ldg(c + j + 1);
          base = run_base(c, st, j);
        }
        stage[pad(x)] = (int)(base + (unsigned)p);
      }
    }
    if (x0 < n && x0 + kPer > nl) {         // past the total: run S-1
      const unsigned tb = run_base(c, st, S - 1);
      for (int x = max(x0, nl); x < min(x0 + kPer, n); ++x)
        stage[pad(x)] = (int)(tb + (unsigned)(p0 + x));
    }
    __syncthreads();
    int32_t* row = out + q * P + p0;
    if (VEC) {                              // n % 4 == 0, row 16-byte aligned
      for (int x = 4 * tid; x < n; x += 4 * kThreads)
        *reinterpret_cast<int4*>(row + x) =
            make_int4(stage[pad(x)], stage[pad(x + 1)], stage[pad(x + 2)],
                      stage[pad(x + 3)]);
    } else {
      for (int x = tid; x < n; x += kThreads) row[x] = stage[pad(x)];
    }
    __syncthreads();                        // stage and bracket are reused
  }
}

}  // namespace

extern "C" int repro_bucket_gather(const void* cum, const void* starts,
                                   void* out, int Q, int S, int P,
                                   void* stream) {
  const dim3 grid((unsigned)((P + kSpan - 1) / kSpan),
                  (unsigned)(Q < 65535 ? Q : 65535));
  const bool vec = P % 4 == 0 && (uintptr_t)out % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    bucket_gather_kernel<true><<<grid, kThreads, 0, s>>>(
        (const int32_t*)cum, (const int32_t*)starts, (int32_t*)out, Q, S, P);
  else
    bucket_gather_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int32_t*)cum, (const int32_t*)starts, (int32_t*)out, Q, S, P);
  return (int)cudaGetLastError();
}
