// Segmented CSR gather: out[q, p] = starts[q, j] + p - cum[q, j], where run
// j = #{i : cum[q, i+1] <= p} (clamped to S-1) holds probe slot p.
//
// Replaces the Pallas kernel bucket_gather_pallas (src/repro/kernels/
// bucket_probe.py, body _gather_kernel).
//
// What bounds it on an H100: moving bytes. The (Q, P) int32 output is
// written once; of cum and starts only the runs that hold probe slots are
// needed. On the planned path cum is (Q, B+1) with B close to N, so the
// Pallas form, a pass over all S runs per slot block, would cost O(S * P)
// per query.
//
// Design: one thread per (q, p) binary-searches cum[q, 1:] (upper bound,
// the searchsorted(side="right") of bucket_gather_ref), so a slot costs
// log2(S) loads that neighbouring slots share through L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void bucket_gather_kernel(const int32_t* __restrict__ cum,
                                     const int32_t* __restrict__ starts,
                                     int32_t* __restrict__ out, int Q,
                                     int S, int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const int32_t* c = cum + (size_t)q * (S + 1);
    int lo = 0, hi = S;                  // count of c[1..S] <= p
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (c[mid + 1] <= p) lo = mid + 1; else hi = mid;
    }
    const int j = min(lo, S - 1);
    out[(size_t)q * P + p] = starts[(size_t)q * S + j] + (p - c[j]);
  }
}

}  // namespace

extern "C" int repro_bucket_gather(const void* cum, const void* starts,
                                   void* out, int Q, int S, int P,
                                   void* stream) {
  const dim3 grid((unsigned)((P + kThreads - 1) / kThreads),
                  (unsigned)(Q < 65535 ? Q : 65535));
  bucket_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cum, (const int32_t*)starts, (int32_t*)out, Q, S, P);
  return (int)cudaGetLastError();
}
