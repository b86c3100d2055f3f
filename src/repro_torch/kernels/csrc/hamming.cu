// All-pairs packed Hamming distance: out[q, n] = sum_w popc(q[q,w] ^ db[n,w]).
//
// Replaces the Pallas kernel hamming_pallas (src/repro/kernels/hamming.py).
//
// What bounds it on an H100: writing the (Q, N) int32 output. At the
// dense-scan shape (Q = 64, N = 2,340,373, W = 1) that is 0.60 GB, 0.18 ms
// at 3.35 TB/s; the item codes are 9.4 MB and the XOR/popcount work is
// 3e8 integer operations.
//
// Design: a block stages up to 64 query codes in shared memory; thread n
// of the grid owns item n, keeps its code words hot in L1 and walks the
// staged queries, so each item code is read from device memory once per
// 64 queries and the output row of every query is written by neighbouring
// lanes at neighbouring addresses (coalesced stores, the only stream that
// matters).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 64;

__global__ void hamming_kernel(const int32_t* __restrict__ q,
                               const int32_t* __restrict__ db,
                               int32_t* __restrict__ out, int Q,
                               long long N, int W) {
  extern __shared__ uint32_t qs[];
  const int q0 = blockIdx.y * kQueries;
  const int nq = min(kQueries, Q - q0);
  for (int t = threadIdx.x; t < nq * W; t += blockDim.x)
    qs[t] = (uint32_t)q[(size_t)q0 * W + t];
  __syncthreads();
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int32_t* dn = db + n * W;
  for (int qi = 0; qi < nq; ++qi) {
    int acc = 0;
    for (int w = 0; w < W; ++w)
      acc += __popc(qs[qi * W + w] ^ (uint32_t)__ldg(dn + w));
    out[(size_t)(q0 + qi) * N + n] = acc;
  }
}

}  // namespace

extern "C" int repro_hamming(const void* q, const void* db, void* out,
                             int Q, long long N, int W, void* stream) {
  const size_t smem = (size_t)kQueries * W * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hamming_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads),
                  (unsigned)((Q + kQueries - 1) / kQueries));
  hamming_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)q, (const int32_t*)db, (int32_t*)out, Q, N, W);
  return (int)cudaGetLastError();
}
