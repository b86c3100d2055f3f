// Fused planned query: CSR run expansion -> phase-1 score
// q . (payload_row * scale) -> top-k' -> f32 rescore of the k' survivors,
// emitted in rescored order (the wrapper keeps the first k).
//
// Replaces the Pallas kernel fused_query_pallas (src/repro/kernels/
// fused_query.py, body _fused_kernel).
//
// What bounds it on an H100: the candidate rows. Every probed slot reads
// one payload row (d bytes int8 or 4d bytes f32) and its scale from
// wherever its CSR run puts it; the batch's queries probe largely the same
// rows, so from L2 the traffic is Q * total row reads, from device memory
// about one read of each distinct row. The dots are 2 * Q * total * d f32
// operations, far below the card's rate.
//
// Design, two launches:
//  1. fq_span_kernel, grid (spans, Q), 256 threads, four blocks an SM. Each
//     block owns kSpan consecutive probe slots of one query, so the main-path
//     batch (64 x 73,136 slots) runs as 2,304 blocks. Two warps find the runs
//     of the span's first and last slot by a 32-way warp search of cum[q]
//     (about five dependent loads; run_search.cuh). Each thread then maps
//     its kPer consecutive slots to runs with two binary searches inside
//     that bracket (whose top levels the block's threads share in L1) and
//     walks forward, searching again only past a run's end, so a block reads
//     only the cum entries its searches visit, never all of cum. Each warp
//     scores 8 rows at a time with
//     the query in registers, 512 columns at a time (a wider query, an LM's
//     hidden state, is reloaded a 512-column slice at a time from the
//     L1-resident query row, and each lane's sum carries across the
//     slices; that loop is a separate WIDE build, so that queries of up to
//     512 columns, loaded once per block, keep their registers and run as
//     before): float2 loads for f32 rows (4d bytes apart,
//     8-byte aligned for even d) and char2 for int8 rows (2-byte aligned for
//     even d), 8 rows x ceil(min(d, 512) / 64) loads in flight per lane, and a
//     transposing butterfly that sums the 8 dots in 9 shuffles. The span's
//     top-KB (KB = min(k', kSpan)) is found by an exact radix select of the
//     order-preserving score keys in shared memory (warp-aggregated histogram
//     atomics); the entries equal to the cut take the lowest slots; the KB
//     survivors are sorted by rank counting and written to scratch as (score,
//     slot, position) lists.
//  2. fq_merge_kernel, one block per query, stages G span lists at a time
//     (G from the caller's plan, ops.fused_query_plan) and merges them
//     into the running top-k' two sorted lists at a time (each entry's
//     new place is its own index plus a binary search in the other list).
//     The order is (score descending, slot ascending): on equal phase-1
//     scores the lower candidate slot wins, the canonical CSR order, as
//     the Pallas _iter_topk does; slots are unique, so every merge is
//     exact. It then rescores the k' survivors on the f32 rows and sorts
//     them by (rescored value descending, survivor index ascending): equal
//     scores keep the earlier survivor.
// Slots past the query's take total (cum[q, S]) or past `total` are never
// candidates; unfilled survivor entries carry NEG = -3e38 at position -1.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "run_search.cuh"

namespace {

using runs::find_run;
using runs::run_in;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 2048;                 // probe slots per block
constexpr int kPer = kSpan / kThreads;      // slots per thread in scans
constexpr int kRows = 8;                    // rows in flight per warp
constexpr int kLanes = 32 / kRows;          // lanes that end with one row
constexpr int kSpanBlocks = 4;              // span blocks an SM must hold
constexpr int kMaxD = 512;                  // query columns in registers
constexpr int kMergeThreads = 256;
constexpr float kNeg = -3e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float va, int sa, float vb, int sb) {
  return va > vb || (va == vb && sa < sb);
}

// order-preserving key of a float: a larger float gets a larger key, and
// -0 the key of +0 (they compare equal)
__device__ __forceinline__ unsigned fkey(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// block-wide exclusive scan of one int per thread
__device__ int block_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = x - v;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  __syncthreads();
  return before;
}

// Loader of V consecutive row values as floats: float2 / char2 for V = 2
// (even d), scalar for V = 1.
template <typename T, int V> struct Row;
template <> struct Row<float, 2> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
};
template <> struct Row<int8_t, 2> {
  static __device__ __forceinline__ float2 load(const int8_t* p) {
    const char2 c = __ldg(reinterpret_cast<const char2*>(p));
    return make_float2((float)c.x, (float)c.y);
  }
};
template <typename T> struct Row<T, 1> {
  static __device__ __forceinline__ float2 load(const T* p) {
    return make_float2((float)__ldg(p), 0.0f);
  }
};

// the query's values at this lane's columns of one kMaxD-wide slice:
// V * (lane + 32 m) + {0, V-1}
template <int V> struct QReg {
  static constexpr int kChunks = kMaxD / (32 * V);
  float2 q[kChunks];
  __device__ void load(const float* qrow, int d, int lane) {
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      const int k = V * (lane + 32 * m);
      q[m].x = k < d ? qrow[k] : 0.0f;
      q[m].y = (V == 2 && k < d) ? qrow[k + 1] : 0.0f;
    }
  }
};

// sums a[0..kRows-1] over the warp in kRows - 1 + log2(32 / kRows)
// shuffles: lanes are halved log2(kRows) times, each half keeping half the
// rows, then the kLanes lanes of a row are summed; lane kLanes * r ends with
// the sum of row r
__device__ __forceinline__ float reduce_rows(float (&a)[kRows], int lane) {
#pragma unroll
  for (int h = kRows / 2, o = 16; h >= 1; h >>= 1, o >>= 1) {
    const bool hi = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = hi ? a[i] : a[i + h];
      const float keep = hi ? a[i + h] : a[i];
      a[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o >= 1; o >>= 1)
    a[0] += __shfl_xor_sync(kFull, a[0], o);
  return a[0];
}

// adds this lane's terms of the query slice [base, base + dw) (held in qr)
// with up to kRows rows (pos < 0: no row) to acc, phase-1 form
// q . (row * scale) when SCALED, else q . row
template <typename T, int V, bool SCALED>
__device__ __forceinline__ void add_slice(
    float (&acc)[kRows], const QReg<V>& qr, const T* __restrict__ rows,
    const float (&sc)[kRows], const int (&pos)[kRows], int d, int base,
    int dw, int lane) {
#pragma unroll
  for (int m = 0; m < QReg<V>::kChunks; ++m) {
    if (V * 32 * m >= dw) break;
    const int k = V * (lane + 32 * m);
    float2 v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v[r] = (pos[r] >= 0 && k < dw)
          ? Row<T, V>::load(rows + (long long)pos[r] * d + base + k)
          : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (SCALED) {
        acc[r] = __fmaf_rn(qr.q[m].x, __fmul_rn(v[r].x, sc[r]), acc[r]);
        if (V == 2)
          acc[r] = __fmaf_rn(qr.q[m].y, __fmul_rn(v[r].y, sc[r]), acc[r]);
      } else {
        acc[r] = __fmaf_rn(qr.q[m].x, v[r].x, acc[r]);
        if (V == 2) acc[r] = __fmaf_rn(qr.q[m].y, v[r].y, acc[r]);
      }
    }
  }
}

// dots of the query with up to kRows rows; lane kLanes * r returns row r's
// dot. Up to kMaxD columns (WIDE false) qr holds the whole query, loaded
// once by the caller; a WIDE query is reloaded from qrow a kMaxD-column
// slice at a time, each lane summing its columns in increasing order
// across the slices (a separate build, so that narrow widths keep the
// registers they had)
template <typename T, int V, bool SCALED, bool WIDE>
__device__ float dot_rows(QReg<V>& qr, const float* __restrict__ qrow,
                          const T* __restrict__ rows,
                          const float* __restrict__ scale,
                          const int (&pos)[kRows], int d, int lane) {
  float acc[kRows], sc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r] = 0.0f;
    sc[r] = (SCALED && pos[r] >= 0) ? __ldg(scale + pos[r]) : 1.0f;
  }
  if constexpr (WIDE) {
    for (int base = 0; base < d; base += kMaxD) {
      const int dw = min(d - base, kMaxD);
      qr.load(qrow + base, dw, lane);
      add_slice<T, V, SCALED>(acc, qr, rows, sc, pos, d, base, dw, lane);
    }
  } else {
    add_slice<T, V, SCALED>(acc, qr, rows, sc, pos, d, 0, d, lane);
  }
  return reduce_rows(acc, lane);
}

// padded shared index: thread-contiguous runs of kPer ints hit distinct banks
__device__ __forceinline__ int pad(int x) { return x + (x >> 5); }
constexpr int kSpanP = kSpan + kSpan / 32;

template <typename T, int V, bool SCALED, bool WIDE>
__global__ void __launch_bounds__(kThreads, kSpanBlocks)
fq_span_kernel(const float* __restrict__ queries,
               const int32_t* __restrict__ cum,
               const int32_t* __restrict__ starts,
               const T* __restrict__ payload, const float* __restrict__ scale,
               float* __restrict__ part_val, int32_t* __restrict__ part_slot,
               int32_t* __restrict__ part_pos, int32_t* __restrict__ part_cnt,
               int S, int d, int total, int KB, int nspan) {
  extern __shared__ int sm[];
  int* spos = sm;                           // kSpanP: each slot's CSR position
  float* score = (float*)(sm + kSpanP);     // kSpanP: its phase-1 score
  float* lv = (float*)(sm + 2 * kSpanP);    // KB survivors, in slot order
  int* ls = (int*)(lv + KB);
  int* lp = ls + KB;
  __shared__ int hist[256];
  __shared__ int wtot[kWarps];
  __shared__ int bracket[2];
  __shared__ unsigned sel_prefix;
  __shared__ int sel_remain;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = blockIdx.x;
  const size_t q = blockIdx.y;
  const int32_t* c = cum + q * (S + 1);
  const int32_t* st = starts + q * S;
  const int tot = min(c[S], total);
  const int p0 = span * kSpan;
  const int n = min(kSpan, tot - p0);       // this span's live slots
  const size_t cell = q * nspan + span;
  if (n <= 0) {
    if (tid == 0) part_cnt[cell] = 0;
    return;
  }
  if (warp < 2) {
    const int j = find_run(c, S, warp ? p0 + n - 1 : p0, lane);
    if (lane == 0) bracket[warp] = j;
  }
  __syncthreads();

  // run expansion: each thread's kPer consecutive slots. Two searches
  // inside the span's bracket give the runs of its first and last slot;
  // the slots between walk forward and search again only past a run's end
  {
    const int j1 = bracket[1] + 1;          // bracket: runs [j0, j1)
    const int x0 = tid * kPer;
    const int xl = min(x0 + kPer, n) - 1;
    if (x0 <= xl) {
      int j = run_in(c, p0 + x0, bracket[0], j1);
      const int jb = run_in(c, p0 + xl, j, j1);
      int lo = __ldg(c + j), hi = __ldg(c + j + 1);
      int base = __ldg(st + j) - lo;
      for (int x = x0; x <= xl; ++x) {
        const int p = p0 + x;
        if (p >= hi) {
          j = run_in(c, p, j + 1, jb + 1);
          lo = __ldg(c + j);
          hi = __ldg(c + j + 1);
          base = __ldg(st + j) - lo;
        }
        spos[pad(x)] = base + p;
      }
    }
  }
  __syncthreads();

  // phase-1 scores, 8 rows per warp in flight
  const float* qrow = queries + q * d;
  QReg<V> qr;
  if (!WIDE) qr.load(qrow, d, lane);
  for (int g = warp * kRows; g < n; g += kWarps * kRows) {
    int pos[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      pos[r] = g + r < n ? spos[pad(g + r)] : -1;
    const float s = dot_rows<T, V, SCALED, WIDE>(qr, qrow, payload, scale,
                                                 pos, d, lane);
    const int x = g + lane / kLanes;
    if (lane % kLanes == 0 && x < n) score[pad(x)] = s;
  }
  __syncthreads();

  // exact radix select of the kb-th largest score key
  const int kb = min(KB, n);
  unsigned prefix = 0;
  int remain = kb;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;                          // kThreads == 256 bins
    __syncthreads();
    const unsigned hmask = shift == 24 ? 0u : ~0u << (shift + 8);
    // lanes with equal digits add once (the top digits are shared by
    // most scores, so plain atomics would serialize on one bin)
    for (int x = tid; x < kSpan; x += kThreads) {
      const unsigned key = x < n ? fkey(score[pad(x)]) : 0u;
      const bool in = x < n && (key & hmask) == prefix;
      const int bin = in ? (int)((key >> shift) & 255) : 256;
      const unsigned same = __match_any_sync(kFull, bin);
      if (in && lane == __ffs(same) - 1) atomicAdd(&hist[bin], __popc(same));
    }
    __syncthreads();
    if (warp == 0) {
      int s = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) s += hist[8 * lane + b];
      int v = s;                            // inclusive suffix over lanes
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_down_sync(kFull, v, o);
        if (lane + o < 32) v += y;
      }
      int above = v - s;
      if (above < remain && remain <= above + s) {
        for (int b = 8 * lane + 7;; --b) {
          if (above + hist[b] >= remain) {
            sel_prefix = prefix | ((unsigned)b << shift);
            sel_remain = remain - above;
            break;
          }
          above += hist[b];
        }
      }
    }
    __syncthreads();
    prefix = sel_prefix;
    remain = sel_remain;
  }
  // the survivors in slot order: every key above the cut, and the first
  // `remain` slots whose key equals it
  {
    int gt = 0, eq = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int x = tid * kPer + e;
      if (x < n) {
        const unsigned key = fkey(score[pad(x)]);
        gt += key > prefix;
        eq += key == prefix;
      }
    }
    const int excl = block_scan((gt << 16) | eq, wtot);
    int eqi = excl & 0xffff;
    int o = (excl >> 16) + min(eqi, remain);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int x = tid * kPer + e;
      if (x >= n) continue;
      const float v = score[pad(x)];
      const unsigned key = fkey(v);
      bool take = key > prefix;
      if (key == prefix) take = eqi++ < remain;
      if (take) {
        lv[o] = v;
        ls[o] = p0 + x;
        lp[o] = spos[pad(x)];
        ++o;
      }
    }
  }
  __syncthreads();
  // sorted by (score desc, slot asc) into this span's scratch list
  for (int e = tid; e < kb; e += kThreads) {
    const float v = lv[e];
    const int s = ls[e];
    int rank = 0;
    for (int j = 0; j < kb; ++j) rank += better(lv[j], ls[j], v, s);
    const size_t o = cell * KB + rank;
    part_val[o] = v;
    part_slot[o] = s;
    part_pos[o] = lp[e];
  }
  if (tid == 0) part_cnt[cell] = kb;
}

// entries of the sorted list (v, s)[0, n) that beat (va, sa): a prefix
__device__ __forceinline__ int count_better(const float* v, const int* s,
                                            int n, float va, int sa) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(v[mid], s[mid], va, sa)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int V, bool WIDE>
__global__ void __launch_bounds__(kMergeThreads)
fq_merge_kernel(const float* __restrict__ queries,
                const float* __restrict__ items,
                const float* __restrict__ part_val,
                const int32_t* __restrict__ part_slot,
                const int32_t* __restrict__ part_pos,
                const int32_t* __restrict__ part_cnt,
                float* __restrict__ out_vals, int32_t* __restrict__ out_pos,
                int d, int nspan, int KB, int KP, int G) {
  extern __shared__ float fm[];
  float* rv = fm;                           // running top-k': KP entries
  int* rs = (int*)(rv + KP);
  int* rp = rs + KP;
  float* nv = (float*)(rp + KP);            // merge output: KP entries
  int* ns = (int*)(nv + KP);
  int* np = ns + KP;
  float* iv = (float*)(np + KP);            // G incoming span lists of KB
  int* is = (int*)(iv + G * KB);
  int* ip = is + G * KB;
  int* icnt = ip + G * KB;                  // their lengths

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q = blockIdx.x;
  int nrun = 0;
  for (int b0 = 0; b0 < nspan; b0 += G) {
    // G lists at a time: one round trip to scratch, then merges in place
    const int gb = min(G, nspan - b0);
    const size_t cell0 = q * nspan + b0;
    for (int g = tid; g < gb; g += kMergeThreads)
      icnt[g] = part_cnt[cell0 + g];
    __syncthreads();
    for (int e = tid; e < gb * KB; e += kMergeThreads) {
      if (e % KB >= icnt[e / KB]) continue;
      iv[e] = part_val[cell0 * KB + e];
      is[e] = part_slot[cell0 * KB + e];
      ip[e] = part_pos[cell0 * KB + e];
    }
    __syncthreads();
    for (int g = 0; g < gb; ++g) {
      const int nb = icnt[g];
      const float* gv = iv + g * KB;
      const int* gs = is + g * KB;
      const int* gp = ip + g * KB;
      for (int i = tid; i < nrun; i += kMergeThreads) {
        const int rank = i + count_better(gv, gs, nb, rv[i], rs[i]);
        if (rank < KP) {
          nv[rank] = rv[i];
          ns[rank] = rs[i];
          np[rank] = rp[i];
        }
      }
      for (int i = tid; i < nb; i += kMergeThreads) {
        const int rank = i + count_better(rv, rs, nrun, gv[i], gs[i]);
        if (rank < KP) {
          nv[rank] = gv[i];
          ns[rank] = gs[i];
          np[rank] = gp[i];
        }
      }
      __syncthreads();
      nrun = min(KP, nrun + nb);
      float* tv = rv; rv = nv; nv = tv;
      int* ts = rs; rs = ns; ns = ts;
      int* tp = rp; rp = np; np = tp;
    }
  }

  // rescore the survivors against the f32 rows (into nv)
  const float* qrow = queries + q * d;
  QReg<V> qr;
  if (!WIDE) qr.load(qrow, d, lane);
  for (int g = warp * kRows; g < KP; g += (kMergeThreads / 32) * kRows) {
    int pos[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) pos[r] = g + r < nrun ? rp[g + r] : -1;
    const float s = dot_rows<float, V, false, WIDE>(qr, qrow, items, nullptr,
                                                    pos, d, lane);
    const int i = g + lane / kLanes;
    if (lane % kLanes == 0 && i < KP) nv[i] = i < nrun ? s : kNeg;
  }
  __syncthreads();
  for (int e = tid; e < KP; e += kMergeThreads) {
    const float v = nv[e];
    int rank = 0;
    for (int j = 0; j < KP; ++j) rank += (nv[j] > v) || (nv[j] == v && j < e);
    out_vals[q * KP + rank] = v;
    out_pos[q * KP + rank] = e < nrun ? rp[e] : -1;
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int V, bool SCALED, bool WIDE>
int launch(const void* queries, const void* cum, const void* starts,
           const void* payload, const void* scale, const void* items,
           void* part_val, void* part_slot, void* part_pos, void* part_cnt,
           void* out_vals, void* out_pos, int Q, int S, int d, int total,
           int kprime, int KB, int nspan, int G, size_t smem1, size_t smem2,
           cudaStream_t stream) {
  int e = set_smem(fq_span_kernel<T, V, SCALED, WIDE>, smem1);
  if (!e) e = set_smem(fq_merge_kernel<V, WIDE>, smem2);
  if (e) return e;
  fq_span_kernel<T, V, SCALED, WIDE><<<dim3((unsigned)nspan, (unsigned)Q),
                                       kThreads, smem1, stream>>>(
      (const float*)queries, (const int32_t*)cum, (const int32_t*)starts,
      (const T*)payload, (const float*)scale, (float*)part_val,
      (int32_t*)part_slot, (int32_t*)part_pos, (int32_t*)part_cnt, S, d,
      total, KB, nspan);
  e = (int)cudaGetLastError();
  if (e) return e;
  fq_merge_kernel<V, WIDE><<<(unsigned)Q, kMergeThreads, smem2, stream>>>(
      (const float*)queries, (const float*)items, (const float*)part_val,
      (const int32_t*)part_slot, (const int32_t*)part_pos,
      (const int32_t*)part_cnt, (float*)out_vals, (int32_t*)out_pos, d,
      nspan, KB, kprime, G);
  return (int)cudaGetLastError();
}

template <typename T, bool SCALED>
int dispatch(bool pairs, const void* queries, const void* cum,
             const void* starts, const void* payload, const void* scale,
             const void* items, void* part_val, void* part_slot,
             void* part_pos, void* part_cnt, void* out_vals, void* out_pos,
             int Q, int S, int d, int total, int kprime, int KB, int nspan,
             int G, size_t smem1, size_t smem2, cudaStream_t s) {
#define FQ_LAUNCH(V, WIDE)                                                   \
  launch<T, V, SCALED, WIDE>(queries, cum, starts, payload, scale, items,  \
                             part_val, part_slot, part_pos, part_cnt,      \
                             out_vals, out_pos, Q, S, d, total, kprime, KB, \
                             nspan, G, smem1, smem2, s)
  if (d > kMaxD) return pairs ? FQ_LAUNCH(2, true) : FQ_LAUNCH(1, true);
  return pairs ? FQ_LAUNCH(2, false) : FQ_LAUNCH(1, false);
#undef FQ_LAUNCH
}

}  // namespace

// span: the slots per block the caller planned for (must equal kSpan);
// the scratch lists are (Q, nspan, KB) and the counts (Q, nspan); the
// caller's plan (ops.fused_query_plan) also gives G, the span lists the
// merge stages at once, and each kernel's dynamic shared memory, smem1
// and smem2 bytes; a null scale means unit scales (the f32 phase 1 over
// the rescore rows)
extern "C" int repro_fused_query(
    const void* queries, const void* cum, const void* starts,
    const void* payload, int payload_int8, const void* scale,
    const void* items, void* part_val, void* part_slot, void* part_pos,
    void* part_cnt, void* out_vals, void* out_pos, int Q, int S, int d,
    int total, int kprime, int span, int KB, int nspan, int G, int smem1,
    int smem2, void* stream) {
  if (span != kSpan || KB > kSpan || KB > kprime || G < 1)
    return (int)cudaErrorInvalidValue;
  // two values a load when every row starts on a pair
  const uintptr_t row_align = payload_int8 ? 2 : 8;
  const bool pairs = d % 2 == 0 && (uintptr_t)items % 8 == 0 &&
                     (uintptr_t)payload % row_align == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (payload_int8)
    return dispatch<int8_t, true>(pairs, queries, cum, starts, payload,
                                  scale, items, part_val, part_slot,
                                  part_pos, part_cnt, out_vals, out_pos, Q,
                                  S, d, total, kprime, KB, nspan, G, smem1,
                                  smem2, s);
  if (scale)
    return dispatch<float, true>(pairs, queries, cum, starts, payload, scale,
                                 items, part_val, part_slot, part_pos,
                                 part_cnt, out_vals, out_pos, Q, S, d, total,
                                 kprime, KB, nspan, G, smem1, smem2, s);
  return dispatch<float, false>(pairs, queries, cum, starts, payload, scale,
                                items, part_val, part_slot, part_pos,
                                part_cnt, out_vals, out_pos, Q, S, d, total,
                                kprime, KB, nspan, G, smem1, smem2, s);
}
