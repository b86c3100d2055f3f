// Exact top-k inner products: vals[q, :k] and ids[q, :k] of the k items
// with the largest queries[q] . items[i], ordered by (score descending,
// item id ascending): on equal scores the lower id wins, as lax.top_k and
// the plain PyTorch version (stable_topk) do.
//
// Replaces the Pallas kernel mips_topk_pallas (src/repro/kernels/
// mips_topk.py, body _topk_kernel).
//
// What bounds it on an H100: the f32 dot products. At the exact-baseline
// shape (Q = 64 queries, N = 2,340,373 items, d = 150) they are 4.5e10
// operations, 0.67 ms at the 67 TFLOP/s CUDA-core rate, against 1.40 GB of
// items, 0.42 ms at 3.35 TB/s. No TF32 and no tensor cores: every product
// is an f32 fmaf on the CUDA cores.
//
// Design, two launches:
//  1. mips_partial_kernel. The items are split into contiguous chunks, one
//     per block (about two blocks per SM), and each block takes a tile of
//     up to 64 queries. The block walks its chunk 128 items at a time and
//     forms the 64 x 128 score tile from depth slices of 32 staged in
//     shared memory; each thread accumulates 8 queries x 4 items in
//     registers. Each item row is read from device memory once per query
//     tile. A score enters a query's running top-k (kept sorted in shared
//     memory) only if the list is not yet full or the score beats its
//     last entry; items of a tile have higher ids than everything already
//     in the list, so an equal score never displaces an entry. The few
//     scores that pass are appended to a per-query pending buffer and one
//     thread per query inserts them. Each block writes its k best per query
//     (unfilled entries as id -1) to scratch.
//  2. mips_merge_kernel: one block per query selects the k best of the
//     (blocks x k) candidates in k rounds, each round the best candidate
//     strictly below the previous winner in (score desc, id asc) order.
// Padded or out-of-range items are never scored, so no id >= N and no
// padded slot can surface, and negative scores rank as they are (no
// sentinel column is needed).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;            // queries per block tile
constexpr int kIT = 128;           // items per tile
constexpr int kDK = 32;            // depth slice staged in shared memory
constexpr int kTX = 32;            // thread columns (items)
constexpr int kTY = kThreads / kTX;  // thread rows (queries)
constexpr int kQR = kQT / kTY;     // queries per thread
constexpr int kIR = kIT / kTX;     // items per thread
constexpr int kMergeThreads = 256;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
mips_partial_kernel(const float* __restrict__ queries,
                    const float* __restrict__ items,
                    float* __restrict__ part_val,
                    int32_t* __restrict__ part_id, int Q, long long N,
                    int d, int k, long long per_block) {
  extern __shared__ float smem[];
  float* as = smem;                               // kQT x (kDK + 1)
  float* bs = as + kQT * (kDK + 1);               // kIT x (kDK + 1)
  float* pval = bs + kIT * (kDK + 1);             // kQT x kIT pending
  int* pid = (int*)(pval + kQT * kIT);            // kQT x kIT
  float* lval = (float*)(pid + kQT * kIT);        // kQT x k running top-k
  int* lid = (int*)(lval + kQT * k);              // kQT x k
  int* pcount = lid + kQT * k;                    // kQT
  int* lcount = pcount + kQT;                     // kQT
  float* thr = (float*)(lcount + kQT);            // kQT: last entry's score

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int q0 = blockIdx.y * kQT;
  const int nq = min(kQT, Q - q0);
  const long long i_begin = (long long)blockIdx.x * per_block;
  const long long i_end = min(N, i_begin + per_block);
  if (tid < kQT) {
    pcount[tid] = 0;
    lcount[tid] = 0;
    thr[tid] = -INFINITY;
  }

  for (long long t0 = i_begin; t0 < i_end; t0 += kIT) {
    float acc[kQR][kIR];
#pragma unroll
    for (int i = 0; i < kQR; ++i)
#pragma unroll
      for (int j = 0; j < kIR; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kDK) {
      __syncthreads();
      for (int e = tid; e < kQT * kDK; e += kThreads) {
        const int r = e / kDK, c = e % kDK;
        as[r * (kDK + 1) + c] = (r < nq && k0 + c < d)
            ? __ldg(queries + (size_t)(q0 + r) * d + k0 + c) : 0.0f;
      }
      for (int e = tid; e < kIT * kDK; e += kThreads) {
        const int r = e / kDK, c = e % kDK;
        const long long it = t0 + r;
        bs[r * (kDK + 1) + c] = (it < i_end && k0 + c < d)
            ? __ldg(items + it * d + k0 + c) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kDK; ++c) {
        float a[kQR], b[kIR];
#pragma unroll
        for (int i = 0; i < kQR; ++i) a[i] = as[(ty + kTY * i) * (kDK + 1) + c];
#pragma unroll
        for (int j = 0; j < kIR; ++j) b[j] = bs[(tx + kTX * j) * (kDK + 1) + c];
#pragma unroll
        for (int i = 0; i < kQR; ++i)
#pragma unroll
          for (int j = 0; j < kIR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // candidates: scores that may enter their query's running top-k
#pragma unroll
    for (int i = 0; i < kQR; ++i) {
      const int q = ty + kTY * i;
      if (q >= nq) continue;
      const bool full = lcount[q] == k;
      const float th = thr[q];
#pragma unroll
      for (int j = 0; j < kIR; ++j) {
        const long long it = t0 + tx + kTX * j;
        if (it >= i_end) continue;
        const float s = acc[i][j];
        if (!full || s > th) {
          const int slot = atomicAdd(&pcount[q], 1);
          pval[q * kIT + slot] = s;
          pid[q * kIT + slot] = (int)it;
        }
      }
    }
    __syncthreads();

    // one thread per query inserts its pending scores into the sorted list
    if (tid < nq) {
      const int q = tid;
      const int cnt = pcount[q];
      pcount[q] = 0;
      int n = lcount[q];
      float* lv = lval + q * k;
      int* li = lid + q * k;
      for (int p = 0; p < cnt; ++p) {
        const float v = pval[q * kIT + p];
        const int id = pid[q * kIT + p];
        if (n == k && !better(v, id, lv[k - 1], li[k - 1])) continue;
        int pos = n < k ? n : k - 1;
        while (pos > 0 && better(v, id, lv[pos - 1], li[pos - 1])) {
          lv[pos] = lv[pos - 1];
          li[pos] = li[pos - 1];
          --pos;
        }
        lv[pos] = v;
        li[pos] = id;
        if (n < k) ++n;
      }
      lcount[q] = n;
      thr[q] = n == k ? lv[k - 1] : -INFINITY;
    }
    // the next tile's first __syncthreads orders this merge before its reads
  }
  __syncthreads();

  for (int e = tid; e < nq * k; e += kThreads) {
    const int q = e / k, r = e % k;
    const size_t o = ((size_t)blockIdx.x * Q + q0 + q) * k + r;
    const bool ok = r < lcount[q];
    part_val[o] = ok ? lval[q * k + r] : -INFINITY;
    part_id[o] = ok ? lid[q * k + r] : -1;
  }
}

// (v, i) reduction step: keep the better of two candidates; id -1 is none
__device__ __forceinline__ void keep_best(float& bv, int& bi, float ov,
                                          int oi) {
  if (oi >= 0 && (bi < 0 || better(ov, oi, bv, bi))) {
    bv = ov;
    bi = oi;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
mips_merge_kernel(const float* __restrict__ part_val,
                  const int32_t* __restrict__ part_id,
                  float* __restrict__ out_val, int32_t* __restrict__ out_id,
                  int Q, int nblk, int k) {
  __shared__ float wv[kMergeThreads / 32];
  __shared__ int wi[kMergeThreads / 32];
  __shared__ float prev_v;
  __shared__ int prev_i;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int M = nblk * k;
  for (int r = 0; r < k; ++r) {
    const float pv = r ? prev_v : 0.0f;
    const int pi = r ? prev_i : -1;
    float bv = -INFINITY;
    int bi = -1;
    for (int c = tid; c < M; c += kMergeThreads) {
      const size_t o = ((size_t)(c / k) * Q + q) * k + (c % k);
      const int id = part_id[o];
      if (id < 0) continue;
      const float v = part_val[o];
      if (r && !better(pv, pi, v, id)) continue;  // taken in an earlier round
      keep_best(bv, bi, v, id);
    }
    for (int off = 16; off > 0; off >>= 1)
      keep_best(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                __shfl_down_sync(0xffffffffu, bi, off));
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kMergeThreads / 32; ++w) keep_best(bv, bi, wv[w], wi[w]);
      out_val[(size_t)q * k + r] = bi >= 0 ? bv : -INFINITY;
      out_id[(size_t)q * k + r] = bi;
      prev_v = bv;
      prev_i = bi;
    }
    __syncthreads();
  }
}

size_t partial_smem(int k) {
  return sizeof(float) * ((size_t)(kQT + kIT) * (kDK + 1) +
                          (size_t)2 * kQT * kIT + (size_t)2 * kQT * k +
                          3 * kQT);
}

}  // namespace

extern "C" int repro_mips_topk(const void* queries, const void* items,
                               void* part_val, void* part_id, void* out_val,
                               void* out_id, int Q, long long N, int d, int k,
                               long long per_block, int nblk, void* stream) {
  const size_t smem = partial_smem(k);
  cudaError_t e = cudaFuncSetAttribute(
      mips_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)nblk, (unsigned)((Q + kQT - 1) / kQT));
  mips_partial_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)queries, (const float*)items, (float*)part_val,
      (int32_t*)part_id, Q, N, d, k, per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mips_merge_kernel<<<Q, kMergeThreads, 0, (cudaStream_t)stream>>>(
      (const float*)part_val, (const int32_t*)part_id, (float*)out_val,
      (int32_t*)out_id, Q, nblk, k);
  return (int)cudaGetLastError();
}
