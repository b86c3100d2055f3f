// Segmented CSR gather: out[q, p] = starts[q, j] + p - cum[q, j], where run
// j = #{i : cum[q, i+1] <= p} (clamped to S-1) holds probe slot p. Below it,
// planned_runs_kernel writes the planned (cum, starts) runs it expands.
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

// ---------------------------------------------------------------------------
// Planned runs: the per-range take of each probe-ordered row, written as the
// (cum, starts) runs that bucket_gather_kernel above and fused_query.cu
// expand. For row q and slot s, with b = order[q, s]:
//   starts[q, s] = bucket_start[b], size = bucket_start[b+1] - starts[q, s],
//   crb  = the sizes of the row's earlier slots whose bucket has b's range,
//   take = min(max(caps[bucket_rid[b]] - crb, 0), size),
//   cum[q] = [0, cumsum(take)],
// in 32-bit arithmetic, as the plain version's int32 tensors compute it.
//
// Replaces no Pallas kernel: the reference computes this step in plain jnp
// (range_cum_before's loop of masked cumsums, src/repro/core/engine.py),
// which XLA fuses. Eager PyTorch ran it as six (Q, B) passes a range, ~14 GB
// of traffic for a 64 x 136,736 batch at R 32, nine tenths of a served
// batch; this kernel is one launch.
//
// What bounds it on an H100: moving bytes. The (Q, B) int64 order is read
// once (70 MB at 64 x 136,736) and starts and cum are written once (35 MB
// each): ~140 MB, 0.042 ms at 3.35 TB/s. The B-long bucket_start and
// bucket_rid tables (1.1 MB there) are gathered from L2. No (Q, B)
// intermediate touches device memory.
//
// Design: a row is a chain of dependent prefixes (R per-range sums and the
// take sum), so one block of 1,024 threads walks one row in tiles of 4,096
// slots and carries the R + 1 sums in shared memory; the grid is a block a
// row. Each warp takes 4 consecutive 32-slot chunks of a tile, its lanes on
// neighbouring slots, so order, starts and cum move coalesced; the order of
// the tile after next and the table entries of the next tile are loaded
// while a tile is scanned. Within a chunk the warp scans each range that
// occurs in it once: a ballot picks the range's lanes and a 5-step shuffle
// scan sums their sizes (probe order keeps a range's buckets together, so a
// chunk holds one or two ranges; at most 32 scans in the worst case). The
// warp's per-range sums go to its row of a (32 warps x R) table in shared
// memory; then, per range, one warp scans that range's column across the
// warps and adds the range's carry from the tiles before. The takes are
// scanned in slot order the same way (within a chunk, across the warp's
// chunks, across warps, plus the take carry). Shared memory is about
// 4·33·R bytes, sized by R at launch (any R up to 1,759 fits an H100
// block).

constexpr int kRunWarps = 32;                       // one lane per warp
constexpr int kRunThreads = 32 * kRunWarps;
constexpr int kRunChunks = 4;                       // 32-slot chunks a warp
constexpr int kRunTile = kRunThreads * kRunChunks;  // slots a tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_scan(int v, int lane) {   // inclusive
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// one slot's table entries; rid -1 past the row's end
struct Slot {
  int start, size, rid;
};

__device__ __forceinline__ Slot load_slot(const int32_t* __restrict__ bstart,
                                          const int32_t* __restrict__ brid,
                                          int64_t b, bool live) {
  Slot x{0, 0, -1};
  if (live) {
    x.start = __ldg(bstart + b);
    x.size = __ldg(bstart + b + 1) - x.start;
    x.rid = __ldg(brid + b);
  }
  return x;
}

__global__ void __launch_bounds__(kRunThreads)
planned_runs_kernel(const int64_t* __restrict__ order,
                    const int32_t* __restrict__ bstart,
                    const int32_t* __restrict__ brid,
                    const int32_t* __restrict__ caps,
                    int32_t* __restrict__ starts, int32_t* __restrict__ cum,
                    long long B, int R) {
  // [kRunWarps][Rp] sums, then carry[R]; an odd row stride Rp spreads a
  // column over the banks
  extern __shared__ int table[];
  const int Rp = R | 1;
  int* carry = table + kRunWarps * Rp;
  __shared__ int wtake[kRunWarps];
  __shared__ int take_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q = blockIdx.x;
  const int64_t* ord = order + q * (size_t)B;
  int32_t* st = starts + q * (size_t)B;
  int32_t* cm = cum + q * (size_t)(B + 1);
  int* mine = table + warp * Rp;
  for (int r = tid; r < R; r += kRunThreads) carry[r] = 0;
  if (tid == 0) {
    take_carry = 0;
    cm[0] = 0;
  }
  // this thread's slot of chunk c is t0 + off + 32 c
  const long long off = (long long)warp * (32 * kRunChunks) + lane;
  Slot nxt[kRunChunks];                 // the next tile's entries
  int64_t ob[kRunChunks];               // the order of the tile after
#pragma unroll
  for (int c = 0; c < kRunChunks; ++c) {
    const long long s = off + 32 * c;
    nxt[c] = load_slot(bstart, brid, s < B ? ord[s] : 0, s < B);
    ob[c] = s + kRunTile < B ? ord[s + kRunTile] : 0;
  }
  __syncthreads();
  for (long long t0 = 0; t0 < B; t0 += kRunTile) {
    Slot cur[kRunChunks];
    int pre[kRunChunks];
#pragma unroll
    for (int c = 0; c < kRunChunks; ++c) {
      const long long s = t0 + off + 32 * c;
      cur[c] = nxt[c];
      nxt[c] = load_slot(bstart, brid, ob[c], s + kRunTile < B);
      ob[c] = s + 2 * kRunTile < B ? ord[s + 2 * kRunTile] : 0;
    }
    // only this warp reads or writes its row until the column scans
    for (int r = lane; r < R; r += 32) mine[r] = 0;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kRunChunks; ++c) {
      const int rid = cur[c].rid;
      const int base = rid >= 0 ? mine[rid] : 0;
      pre[c] = base;
      __syncwarp();
      unsigned pending = __ballot_sync(kFull, rid >= 0);
      while (pending) {
        const int key = __shfl_sync(kFull, rid, __ffs(pending) - 1);
        const bool in = rid == key;
        const int v = in ? cur[c].size : 0;
        const int inc = warp_scan(v, lane);
        if (in) pre[c] = base + inc - v;
        if (lane == 31) mine[key] += inc;
        pending &= ~__ballot_sync(kFull, in);
      }
      __syncwarp();
    }
    __syncthreads();
    // per range: the warps' sums scanned across warps, after the carry
    for (int r = warp; r < R; r += kRunWarps) {
      const int v = table[lane * Rp + r];
      const int inc = warp_scan(v, lane);
      const int c0 = carry[r];
      table[lane * Rp + r] = c0 + inc - v;
      __syncwarp();
      if (lane == 31) carry[r] = c0 + inc;
    }
    __syncthreads();
    int run = 0, tk_inc[kRunChunks];
#pragma unroll
    for (int c = 0; c < kRunChunks; ++c) {
      const int rid = cur[c].rid;
      int tk = 0;
      if (rid >= 0)
        tk = min(max(__ldg(caps + rid) - (mine[rid] + pre[c]), 0),
                 cur[c].size);
      tk_inc[c] = run + warp_scan(tk, lane);
      run = __shfl_sync(kFull, tk_inc[c], 31);
    }
    if (lane == 31) wtake[warp] = run;
    __syncthreads();
    if (warp == 0) {
      const int v = wtake[lane];
      const int inc = warp_scan(v, lane);
      const int c0 = take_carry;
      __syncwarp();
      wtake[lane] = c0 + inc - v;
      if (lane == 31) take_carry = c0 + inc;
    }
    __syncthreads();
    const int tb = wtake[warp];
#pragma unroll
    for (int c = 0; c < kRunChunks; ++c) {
      const long long s = t0 + off + 32 * c;
      if (s < B) {
        st[s] = cur[c].start;
        cm[s + 1] = tb + tk_inc[c];
      }
    }
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

extern "C" int repro_planned_runs(const void* order, const void* bucket_start,
                                  const void* bucket_rid, const void* caps,
                                  void* starts, void* cum, int Q, long long B,
                                  int R, void* stream) {
  const int smem = 4 * (kRunWarps * (R | 1) + R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        planned_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  planned_runs_kernel<<<(unsigned)Q, kRunThreads, smem,
                        (cudaStream_t)stream>>>(
      (const int64_t*)order, (const int32_t*)bucket_start,
      (const int32_t*)bucket_rid, (const int32_t*)caps, (int32_t*)starts,
      (int32_t*)cum, B, R);
  return (int)cudaGetLastError();
}
