// Packed code scans: all-pairs popcount of q[q, :] ^ db[n, :] with one of
// three epilogues, each its own C entry point:
//
//   repro_hamming       out[q, n] = hamming distance
//   repro_bucket_match  out[q, n] = hash_bits - hamming (the eq.-12 input)
//   repro_delta_scan    out[q, n] = live[n] ? hash_bits - hamming : -1
//
// Replaces the Pallas kernels hamming_pallas (src/repro/kernels/
// hamming.py), bucket_match_pallas (src/repro/kernels/bucket_probe.py,
// body _match_kernel) and delta_scan_pallas (src/repro/kernels/
// delta_scan.py, body _delta_scan_kernel).
//
// What bounds them on an H100: writing the (Q, N) int32 output. At the
// dense-scan shape (Q = 64, N = 2,340,373, W = 1) that is 0.60 GB, 0.18 ms
// at 3.35 TB/s; the item codes are 9.4 MB and the XOR/popcount work is
// 3e8 integer operations. The delta scan's (64, 1024) output is 0.26 MB:
// its time is launch latency.
//
// Design: a block stages up to 64 query codes in shared memory; thread n
// of the grid owns item n, keeps its code words hot in L1 and walks the
// staged queries, so each item code is read from device memory once per
// 64 queries and the output row of every query is written by neighbouring
// lanes at neighbouring addresses (coalesced stores, the only stream that
// matters). The epilogue is a template argument: the three scans share
// the body and differ only in the value stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 64;

enum Epilogue { kDistance, kMatch, kLiveMatch };

template <Epilogue E>
__global__ void packed_scan_kernel(const int32_t* __restrict__ q,
                                   const int32_t* __restrict__ db,
                                   const uint8_t* __restrict__ live,
                                   int32_t* __restrict__ out, int Q,
                                   long long N, int W, int hash_bits) {
  extern __shared__ uint32_t qs[];
  const int q0 = blockIdx.y * kQueries;
  const int nq = min(kQueries, Q - q0);
  for (int t = threadIdx.x; t < nq * W; t += blockDim.x)
    qs[t] = (uint32_t)q[(size_t)q0 * W + t];
  __syncthreads();
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int32_t* dn = db + n * W;
  const bool dead = E == kLiveMatch && !live[n];
  for (int qi = 0; qi < nq; ++qi) {
    int acc = 0;
    for (int w = 0; w < W; ++w)
      acc += __popc(qs[qi * W + w] ^ (uint32_t)__ldg(dn + w));
    int v = E == kDistance ? acc : hash_bits - acc;
    if (dead) v = -1;
    out[(size_t)(q0 + qi) * N + n] = v;
  }
}

template <Epilogue E>
int launch(const void* q, const void* db, const void* live, void* out,
           int Q, long long N, int W, int hash_bits, void* stream) {
  const size_t smem = (size_t)kQueries * W * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_scan_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads),
                  (unsigned)((Q + kQueries - 1) / kQueries));
  packed_scan_kernel<E><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)q, (const int32_t*)db, (const uint8_t*)live,
      (int32_t*)out, Q, N, W, hash_bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_hamming(const void* q, const void* db, void* out,
                             int Q, long long N, int W, void* stream) {
  return launch<kDistance>(q, db, nullptr, out, Q, N, W, 0, stream);
}

extern "C" int repro_bucket_match(const void* q, const void* db, void* out,
                                  int Q, long long N, int W, int hash_bits,
                                  void* stream) {
  return launch<kMatch>(q, db, nullptr, out, Q, N, W, hash_bits, stream);
}

extern "C" int repro_delta_scan(const void* q, const void* db,
                                const void* live, void* out, int Q,
                                long long N, int W, int hash_bits,
                                void* stream) {
  return launch<kLiveMatch>(q, db, live, out, Q, N, W, hash_bits, stream);
}
