// Fused planned query: CSR run expansion -> phase-1 score
// q . (payload_row * scale) -> running top-k' -> f32 rescore of the k'
// survivors, emitted in rescored order (the wrapper keeps the first k).
//
// Replaces the Pallas kernel fused_query_pallas (src/repro/kernels/
// fused_query.py, body _fused_kernel).
//
// What bounds it on an H100: the candidate rows. Every probed slot reads
// one payload row (d bytes int8 or 4d bytes f32) and its scale from
// wherever the CSR run puts it, so the traffic is Q * total * row bytes
// of scattered reads plus Q * k' f32 rows for the rescore; the dots are
// 2 * Q * total * d f32 operations, far below the card's rate.
//
// Design: one block per query; no residency limit, rows stream from device
// memory and L2. The block walks its probe slots in chunks of 512: each
// thread binary-searches cum[q, 1:] for its slot's run (the bucket_gather
// search), then each warp scores four gathered rows at a time (lanes over
// d, FMA, butterfly reduction) so four row loads are in flight. A slot
// enters the running top-k' only if it beats the current k'-th survivor;
// the few that do are merged by rank counting in shared memory. The order
// is (score descending, slot ascending): on equal phase-1 scores the lower
// candidate slot wins, the canonical CSR order, as the Pallas _iter_topk
// does. The rescore sorts the k' survivors by (rescored value descending,
// survivor index ascending): equal scores keep the earlier survivor. Slots
// past the query's take total (cum[q, S]) or past `total` are never
// candidates; the buffer's unfilled entries carry NEG = -3e38 at
// position -1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;
constexpr int kRows = 4;
constexpr float kNeg = -3e38f;

__device__ __forceinline__ bool better(float va, int sa, float vb, int sb) {
  return va > vb || (va == vb && sa < sb);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void fused_query_kernel(const float* __restrict__ queries,
                                   const int32_t* __restrict__ cum,
                                   const int32_t* __restrict__ starts,
                                   const T* __restrict__ payload,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ items,
                                   float* __restrict__ out_vals,
                                   int32_t* __restrict__ out_pos, int S,
                                   int d, int total, int KP) {
  extern __shared__ float smem[];
  float* qv = smem;                          // d
  int* cpos = (int*)(qv + d);                // kChunk
  float* cval = (float*)(cpos + kChunk);     // kChunk
  float* pval = cval + kChunk;               // kChunk pending scores
  int* pslot = (int*)(pval + kChunk);        // kChunk pending slots
  int* ppos = pslot + kChunk;                // kChunk pending positions
  float* bval = (float*)(ppos + kChunk);     // KP survivors, sorted
  int* bslot = (int*)(bval + KP);
  int* bpos = bslot + KP;
  float* nval = (float*)(bpos + KP);         // KP merge output / rescore
  int* nslot = (int*)(nval + KP);
  int* npos = nslot + KP;
  __shared__ int npend;

  const size_t q = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int32_t* c = cum + q * (S + 1);
  const int32_t* st = starts + q * S;
  const int tot = min(c[S], total);

  for (int k = tid; k < d; k += kThreads) qv[k] = queries[q * d + k];
  for (int i = tid; i < KP; i += kThreads) {
    bval[i] = kNeg;
    bslot[i] = 0x7fffffff - KP + i;          // distinct, after every slot
    bpos[i] = -1;
  }
  if (tid == 0) npend = 0;
  __syncthreads();

  for (int base = 0; base < tot; base += kChunk) {
    // run expansion: the CSR position of this thread's probe slot
    const int p = base + tid;
    int pos = -1;
    if (p < tot) {
      int lo = 0, hi = S;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (c[mid + 1] <= p) lo = mid + 1; else hi = mid;
      }
      const int j = min(lo, S - 1);
      pos = st[j] + (p - c[j]);
    }
    cpos[tid] = pos;
    __syncthreads();

    // phase-1 scores, four rows per warp in flight
    for (int c0 = warp * kRows; c0 < kChunk; c0 += kWarps * kRows) {
      long long pr[kRows];
      float sc[kRows], acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pr[r] = cpos[c0 + r];
        sc[r] = pr[r] >= 0 ? scale[pr[r]] : 0.0f;
        acc[r] = 0.0f;
      }
      for (int k = lane; k < d; k += 32) {
        const float qk = qv[k];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (pr[r] >= 0)
            acc[r] = __fmaf_rn(
                qk, __fmul_rn((float)payload[pr[r] * d + k], sc[r]), acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float s = warp_sum(acc[r]);
        if (lane == 0) cval[c0 + r] = s;
      }
    }
    __syncthreads();

    // keep only the slots that beat the current k'-th survivor
    if (pos >= 0 && better(cval[tid], p, bval[KP - 1], bslot[KP - 1])) {
      const int e = atomicAdd(&npend, 1);
      pval[e] = cval[tid];
      pslot[e] = p;
      ppos[e] = pos;
    }
    __syncthreads();
    const int np = npend;
    if (np > 0) {
      // merge by rank: an entry's new place is the count of entries
      // before it in (score desc, slot asc) order; ranks >= KP drop out
      for (int e = tid; e < KP + np; e += kThreads) {
        float v;
        int s, ps, rank = 0;
        if (e < KP) {
          v = bval[e]; s = bslot[e]; ps = bpos[e];
          rank = e;
        } else {
          v = pval[e - KP]; s = pslot[e - KP]; ps = ppos[e - KP];
          for (int j = 0; j < KP; ++j) rank += better(bval[j], bslot[j], v, s);
        }
        for (int j = 0; j < np; ++j) rank += better(pval[j], pslot[j], v, s);
        if (rank < KP) {
          nval[rank] = v;
          nslot[rank] = s;
          npos[rank] = ps;
        }
      }
      __syncthreads();
      for (int i = tid; i < KP; i += kThreads) {
        bval[i] = nval[i];
        bslot[i] = nslot[i];
        bpos[i] = npos[i];
      }
      if (tid == 0) npend = 0;
    }
    __syncthreads();
  }

  // rescore the survivors against the f32 rows
  for (int i0 = warp * kRows; i0 < KP; i0 += kWarps * kRows) {
    long long pr[kRows];
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pr[r] = i0 + r < KP ? bpos[i0 + r] : -1;
      acc[r] = 0.0f;
    }
    for (int k = lane; k < d; k += 32) {
      const float qk = qv[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (pr[r] >= 0) acc[r] = __fmaf_rn(qk, items[pr[r] * d + k], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0 && i0 + r < KP) nval[i0 + r] = pr[r] >= 0 ? s : kNeg;
    }
  }
  __syncthreads();
  for (int e = tid; e < KP; e += kThreads) {
    const float v = nval[e];
    int rank = 0;
    for (int j = 0; j < KP; ++j)
      rank += (nval[j] > v) || (nval[j] == v && j < e);
    out_vals[q * KP + rank] = v;
    out_pos[q * KP + rank] = bpos[e];
  }
}

template <typename T>
int launch(const void* queries, const void* cum, const void* starts,
           const void* payload, const void* scale, const void* items,
           void* out_vals, void* out_pos, int Q, int S, int d, int total,
           int kprime, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)d + 5 * kChunk + 6 * kprime);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_query_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_query_kernel<T><<<(unsigned)Q, kThreads, smem, stream>>>(
      (const float*)queries, (const int32_t*)cum, (const int32_t*)starts,
      (const T*)payload, (const float*)scale, (const float*)items,
      (float*)out_vals, (int32_t*)out_pos, S, d, total, kprime);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_fused_query(const void* queries, const void* cum,
                                 const void* starts, const void* payload,
                                 int payload_int8, const void* scale,
                                 const void* items, void* out_vals,
                                 void* out_pos, int Q, int S, int d,
                                 int total, int kprime, void* stream) {
  if (payload_int8)
    return launch<int8_t>(queries, cum, starts, payload, scale, items,
                          out_vals, out_pos, Q, S, d, total, kprime,
                          (cudaStream_t)stream);
  return launch<float>(queries, cum, starts, payload, scale, items,
                       out_vals, out_pos, Q, S, d, total, kprime,
                       (cudaStream_t)stream);
}
