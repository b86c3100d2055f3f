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
// is an f32 fmaf on the CUDA cores, so the design is about keeping the FMA
// pipes fed: few shared-memory loads per FMA, loads overlapped with math,
// and enough warps per SM.
//
// Design, two launches:
//  1. mips_partial_kernel, 128 threads. The items are split into
//     contiguous chunks, one per block, sized from the kernel's measured
//     occupancy so that the grid is one wave; each block takes a tile of up
//     to 64 queries and walks its chunk 128 items at a time. Each thread
//     accumulates an 8 x 8 register tile (8 queries x 8 items; up to 255
//     registers, two blocks an SM). Depth slices of 16 are staged in shared
//     memory in a pair-interleaved k-major layout ([k / 2][row][2], rows
//     XOR-swizzled), so that each of the thread's operands is one float4
//     holding two rows at two depths: 8 128-bit loads per 128 FMAs, reads
//     conflict-free (a warp reads 256 contiguous bytes of items and
//     broadcasts its two query pairs). Staging is a four-slice cp.async
//     ring: three slices are in flight while one is multiplied, with one
//     barrier a slice. Each copy moves two consecutive depths of one row,
//     8 bytes, which f32 rows of even d are aligned to (the item matrix is
//     never copied or padded; out-of-range rows and depths are zero-filled
//     by the copy itself); eight threads copy one row's 64 contiguous
//     bytes; odd d or a misaligned view takes 4-byte copies. At the end of
//     each tile a score is a candidate only if its query's running top-k
//     (sorted, in shared memory) is not full or the score beats the list's
//     last entry in (score desc, id asc) order; candidates go to a
//     per-query buffer that holds a whole tile (so it never overflows), and
//     one thread per query (16 a warp) inserts them into its sorted list.
//     After the first tile almost no score passes. Each block writes its k
//     best per query (unfilled entries as id -1) to scratch.
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

constexpr int kThreads = 128;
constexpr int kQT = 64;            // queries per block tile
constexpr int kIT = 128;           // items per tile
constexpr int kDK = 16;            // depth slice staged in shared memory
constexpr int kKP = kDK / 2;       // depth pairs per slice
constexpr int kStage = (kQT + kIT) * kDK;  // floats per stage
constexpr int kStages = 4;         // slices in the cp.async ring
constexpr int kMinBlocks = 2;      // blocks per SM the registers must allow
constexpr int kMergeThreads = 256;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// an asynchronous global -> shared copy of B bytes (4 or 8); a row or depth
// outside the matrix copies zero bytes, which fills the destination with 0
template <int B>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? B : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(B), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row of the staged [kKP][R][2] tile that holds row r at depth pair p. A
// copy instruction covers kRowsPer rows (32 threads, kKP pairs a row); an
// XOR of the row by kRowsPer * (p mod 16 / kRowsPer) spreads its pairs over
// all 16 bank pairs (two wavefronts, the least for 256 bytes) and keeps row
// pairs adjacent, so compute reads stay 256 contiguous bytes a warp.
constexpr int kRowsPer = 32 / kKP;
static_assert(kRowsPer >= 2 && kRowsPer <= 16, "row pairs must stay adjacent");
__device__ __forceinline__ int swz(int r, int p) {
  return r ^ (kRowsPer * (p & (16 / kRowsPer - 1)));
}

// Stage rows [r0, r0 + R) of a row-major (rows, d) matrix, depths
// [k0, k0 + kDK), into dst as [kKP][R][2] (rows swizzled). Eight
// consecutive threads copy one row's 64 contiguous bytes, so a warp's
// copies touch four rows; a thread always copies the same depth pair, of
// R * kKP / kThreads rows (a fixed count, so the loop unrolls and each
// copy costs a few integer instructions). V = 2: one 8-byte copy per
// depth pair (d even, rows 8-byte aligned), V = 1: two 4-byte copies.
template <int R, int V>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long r0, long long r_end,
                                           int k0, int d) {
  static_assert(R * kKP % kThreads == 0, "whole rows a thread");
  const int p = threadIdx.x % kKP;
  const int k = k0 + 2 * p;
#pragma unroll
  for (int u = 0; u < R * kKP / kThreads; ++u) {
    const int r = threadIdx.x / kKP + u * (kThreads / kKP);
    const long long row = r0 + r;
    float* to = dst + (p * R + swz(r, p)) * 2;
    const float* from = src + (row < r_end ? row : 0) * (long long)d;
    if (V == 2) {
      cp_async<8>(to, from + (k < d ? k : 0), row < r_end && k < d);
    } else {
      cp_async<4>(to, from + (k < d ? k : 0), row < r_end && k < d);
      cp_async<4>(to + 1, from + (k + 1 < d ? k + 1 : 0),
                  row < r_end && k + 1 < d);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mips_partial_kernel(const float* __restrict__ queries,
                    const float* __restrict__ items,
                    float* __restrict__ part_val,
                    int32_t* __restrict__ part_id, int Q, long long N,
                    int d, int k, long long per_block) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                            // kStages x kStage
  // per-query arrays are slot-major ([slot][query]), so the one thread per
  // query that walks them hits 32 distinct banks a warp
  float* cval = stage + kStages * kStage;         // kIT x kQT candidates
  float* lval = cval + kQT * kIT;                 // k x kQT running top-k
  int* lid = (int*)(lval + kQT * k);              // k x kQT
  int* ccnt = lid + kQT * k;                      // kQT
  int* lcnt = ccnt + kQT;                         // kQT
  float* lastv = (float*)(lcnt + kQT);            // kQT: the list's last
  int* lasti = (int*)(lastv + kQT);               // kQT
  uint8_t* coff = (uint8_t*)(lasti + kQT);        // kIT x kQT: item in tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;          // items 2 tx + 32 j + {0, 1}
  const int ty = tid >> 4;          // queries 2 ty + 16 j + {0, 1}
  const int q0 = blockIdx.y * kQT;
  const int nq = min(kQT, Q - q0);
  const long long i_begin = (long long)blockIdx.x * per_block;
  const long long i_end = min(N, i_begin + per_block);
  if (tid < kQT) {
    ccnt[tid] = 0;
    lcnt[tid] = 0;
  }
  const int nks = (d + kDK - 1) / kDK;
  const int ntile = (int)((i_end - i_begin + kIT - 1) / kIT);
  const int steps = ntile * nks;
  const float* qsrc = queries + (size_t)q0 * d;

  auto load = [&](int it) {
    float* buf = stage + (it % kStages) * kStage;
    const long long t0 = i_begin + (long long)(it / nks) * kIT;
    const int k0 = (it % nks) * kDK;
    stage_rows<kQT, V>(buf, qsrc, 0, nq, k0, d);
    stage_rows<kIT, V>(buf + kQT * kDK, items, t0, i_end, k0, d);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // kStages - 1 slices in flight ahead of the one being multiplied; the
  // buffer a copy refills was read one step earlier, before the barrier
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < steps) load(it + kStages - 1);
    cp_commit();
    const float4* A4 = (const float4*)(stage + (it % kStages) * kStage);
    const float4* B4 = A4 + kQT * kDK / 4;
#pragma unroll
    for (int kp = 0; kp < kKP; ++kp) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = A4[(kp * kQT + swz(2 * ty + 16 * i, kp)) / 2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = B4[(kp * kIT + swz(2 * tx + 32 * j, kp)) / 2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& c00 = acc[2 * i][2 * j];
          float& c01 = acc[2 * i][2 * j + 1];
          float& c10 = acc[2 * i + 1][2 * j];
          float& c11 = acc[2 * i + 1][2 * j + 1];
          c00 = fmaf(a[i].y, b.y, fmaf(a[i].x, b.x, c00));
          c01 = fmaf(a[i].y, b.w, fmaf(a[i].x, b.z, c01));
          c10 = fmaf(a[i].w, b.y, fmaf(a[i].z, b.x, c10));
          c11 = fmaf(a[i].w, b.w, fmaf(a[i].z, b.z, c11));
        }
      }
    }
    if (it % nks != nks - 1) continue;

    // the tile's candidates: scores that may enter their query's top-k.
    // A query has at most kIT of them per tile, so the buffer never fills.
    const int t0 = (int)(i_begin + (long long)(it / nks) * kIT);
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = 2 * ty + 16 * (i >> 1) + (i & 1);
      const bool full = q < nq && lcnt[q] == k;
      const float lv = lastv[q];
      const int li = lasti[q];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int id = t0 + 2 * tx + 32 * (j >> 1) + (j & 1);
        if (q < nq && id < i_end &&
            (!full || better(acc[i][j], id, lv, li))) {
          const int slot = atomicAdd(&ccnt[q], 1);
          cval[slot * kQT + q] = acc[i][j];
          coff[slot * kQT + q] = (uint8_t)(id - t0);
          any = true;
        }
        acc[i][j] = 0.0f;
      }
    }
    // the first 16 lanes of each warp insert one query's candidates each
    // into its sorted list (16 queries a warp spread the serial insertions
    // over all four schedulers); the next slice's barrier orders this
    // before the next tile's reads
    const int fq = 16 * (tid >> 5) + (tid & 31);
    if (__syncthreads_or(any) && (tid & 31) < 16 && fq < nq) {
      const int q = fq;
      const int cnt = ccnt[q];
      ccnt[q] = 0;
      int n = lcnt[q];
      float* lv = lval + q;               // entry r at lv[r * kQT]
      int* li = lid + q;
      for (int p = 0; p < cnt; ++p) {
        const float v = cval[p * kQT + q];
        const int id = (int)(t0 + coff[p * kQT + q]);
        if (n == k && !better(v, id, lv[(k - 1) * kQT], li[(k - 1) * kQT]))
          continue;
        int pos = n < k ? n : k - 1;
        while (pos > 0 &&
               better(v, id, lv[(pos - 1) * kQT], li[(pos - 1) * kQT])) {
          lv[pos * kQT] = lv[(pos - 1) * kQT];
          li[pos * kQT] = li[(pos - 1) * kQT];
          --pos;
        }
        lv[pos * kQT] = v;
        li[pos * kQT] = id;
        if (n < k) ++n;
      }
      lcnt[q] = n;
      if (n > 0) {
        lastv[q] = lv[(n - 1) * kQT];
        lasti[q] = li[(n - 1) * kQT];
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < nq * k; e += kThreads) {
    const int q = e / k, r = e % k;
    const size_t o = ((size_t)blockIdx.x * Q + q0 + q) * k + r;
    const bool ok = r < lcnt[q];
    part_val[o] = ok ? lval[r * kQT + q] : -INFINITY;
    part_id[o] = ok ? lid[r * kQT + q] : -1;
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
  return sizeof(float) * (kStages * (size_t)kStage + (size_t)kQT * kIT +
                          2 * (size_t)kQT * k + 4 * (size_t)kQT) +
         (size_t)kQT * kIT;
}

template <int V>
int launch(const void* queries, const void* items, void* part_val,
           void* part_id, void* out_val, void* out_id, int Q, long long N,
           int d, int k, long long per_block, int nblk,
           cudaStream_t stream) {
  const size_t smem = partial_smem(k);
  cudaError_t e = cudaFuncSetAttribute(
      mips_partial_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)nblk, (unsigned)((Q + kQT - 1) / kQT));
  mips_partial_kernel<V><<<grid, kThreads, smem, stream>>>(
      (const float*)queries, (const float*)items, (float*)part_val,
      (int32_t*)part_id, Q, N, d, k, per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mips_merge_kernel<<<Q, kMergeThreads, 0, stream>>>(
      (const float*)part_val, (const int32_t*)part_id, (float*)out_val,
      (int32_t*)out_id, Q, nblk, k);
  return (int)cudaGetLastError();
}

}  // namespace

// blocks of mips_partial_kernel that fit one SM at this k (its registers
// and shared memory), or minus a CUDA error code
extern "C" int repro_mips_topk_blocks_per_sm(int k) {
  const size_t smem = partial_smem(k);
  cudaError_t e = cudaFuncSetAttribute(
      mips_partial_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mips_partial_kernel<2>, kThreads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int repro_mips_topk(const void* queries, const void* items,
                               void* part_val, void* part_id, void* out_val,
                               void* out_id, int Q, long long N, int d, int k,
                               long long per_block, int nblk, void* stream) {
  if (per_block % kIT) return (int)cudaErrorInvalidValue;
  const bool pairs = d % 2 == 0 && (uintptr_t)queries % 8 == 0 &&
                     (uintptr_t)items % 8 == 0;
  if (pairs)
    return launch<2>(queries, items, part_val, part_id, out_val, out_id, Q,
                     N, d, k, per_block, nblk, (cudaStream_t)stream);
  return launch<1>(queries, items, part_val, part_id, out_val, out_id, Q, N,
                   d, k, per_block, nblk, (cudaStream_t)stream);
}
