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
// What bounds them on an H100. The wide scans (hamming, bucket_match:
// Q = 64 against N or B of 2.2-2.3M items, W = 1) write a (Q, N) int32
// output of 0.60 GB, 0.18 ms at 3.35 TB/s; the item codes are 9.4 MB and
// the XOR/popcount work 3e8 integer operations. So the only stream that
// matters is the store stream, and it must reach DRAM as whole 32-byte
// sectors. Row q starts at element q*N: when N is not a multiple of 8 the
// rows start inside a sector, and a kernel that gives each thread one item
// of every row splits every row's first and last sector between blocks
// and every warp's 128-byte store over five sectors, two of them partly.
// The delta scan's (64, 1024) output is 0.26 MB: its time is the launch
// and the first loads' latency, so it wants many small blocks at once.
//
// Wide design (wide_scan_kernel, W = 1..8, a template argument so the
// item codes live in registers): work is assigned in output space. Block
// (x, y) takes the item tile [n0, n1) = [x*kTile, ...) and the queries
// y*kQB + [0, kQB). In the flat output it owns, for each of its rows q,
// the elements [align8(q*N + n0), align8(q*N + n1)) (the last row clipped
// at Q*N): both ends are sector boundaries, so every sector is written in
// full by one block, and consecutive (row, tile) spans tile the output.
// The span of row q is the tile shifted right by s_q = align8(q*N + n0) -
// (q*N + n0) in 0..7, so a thread keeps the codes of its kIPT items plus
// a halo of 7 in registers, picks the window of row q by a switch on s_q
// and writes kIPT consecutive outputs with 16-byte stores. The few
// outputs past the row's end (at most 7 a row, in the last tiles) belong
// to the next row: its query code and the codes of items 0..6 are staged
// in shared memory, so the block that owns a row's last tile does not
// wait on device memory once a row. Rows of 7 items or fewer, whose
// spans would reach past the next row, go to the narrow kernel. The
// output's partial last sector is written a value at a time. The block's
// query codes sit in shared memory and are read as broadcasts; the stores
// are evict-first (the output never fits L2). The grid runs the item
// tiles last to first: with the last (partial) tile launched last, odd row
// lengths ran ~5% slower than aligned ones on an H100; launched first,
// they run level (PERF.md).
//
// Narrow design (narrow_scan_kernel: the delta scan, W > 8, N <= 7):
// thread t owns the four flat outputs [4t, 4t + 4) of the whole (Q, N)
// output, a 16-byte store, so a (64, 1024) scan spreads over 128 blocks of
// 128 threads; codes and liveness bytes are read through the read-only path
// (4 KB of codes, hot after the first touch), and `live` is read as the
// bytes of a torch.bool or uint8 tensor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The wide kernel's design choices, each defaulting to the value that ran
// fastest on an H100 (PERF.md); tools/hamming_variants.py builds it with
// -D to time the others.
#ifndef HAMMING_THREADS
#define HAMMING_THREADS 256                // threads a wide block
#endif
#ifndef HAMMING_IPT
#define HAMMING_IPT 4                      // items a thread owns in a row
#endif
#ifndef HAMMING_QB
#define HAMMING_QB 64                      // queries a wide block walks
#endif
#ifndef HAMMING_MIN_BLOCKS
#define HAMMING_MIN_BLOCKS 1               // launch bound: blocks an SM
#endif
#ifndef HAMMING_LAST_TILE_FIRST
#define HAMMING_LAST_TILE_FIRST 1          // grid order of the item tiles
#endif
#ifndef HAMMING_EVICT_FIRST
#define HAMMING_EVICT_FIRST 1              // __stcs stores, not plain ones
#endif

constexpr int kThreads = HAMMING_THREADS;
constexpr int kIPT = HAMMING_IPT;
constexpr int kTile = kThreads * kIPT;     // items a wide block owns
constexpr int kQB = HAMMING_QB;
constexpr int kHalo = 7;                   // the largest row shift
constexpr int kNarrowThreads = 128;

static_assert(kIPT % 4 == 0 && kTile % 8 == 0,
              "16-byte stores and sector-aligned tiles");

enum Epilogue { kDistance, kMatch, kLiveMatch };

__device__ __forceinline__ long long align8(long long x) {
  return (x + 7) & ~7LL;
}

template <Epilogue E>
__device__ __forceinline__ int finish(int acc, int hash_bits) {
  return E == kDistance ? acc : hash_bits - acc;
}

__device__ __forceinline__ void store4(int32_t* p, int a, int b, int c,
                                       int d) {
  if (HAMMING_EVICT_FIRST)
    __stcs(reinterpret_cast<int4*>(p), make_int4(a, b, c, d));
  else
    *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}

// out[row, n] from device memory (the narrow kernel)
template <Epilogue E>
__device__ int scan_one(const int32_t* __restrict__ q,
                        const int32_t* __restrict__ db,
                        const uint8_t* __restrict__ live, long long row,
                        long long n, int W, int hash_bits) {
  if (E == kLiveMatch && !__ldg(live + n)) return -1;
  int acc = 0;
  for (int w = 0; w < W; ++w)
    acc += __popc((uint32_t)__ldg(q + row * W + w) ^
                  (uint32_t)__ldg(db + n * W + w));
  return finish<E>(acc, hash_bits);
}

// the kIPT outputs of a row shifted by S items: codes c[S .. S + kIPT)
template <Epilogue E, int W, int S>
__device__ __forceinline__ void row_values(uint32_t (&c)[kIPT + kHalo][W],
                                           uint32_t (&qw)[W], int hash_bits,
                                           int (&v)[kIPT]) {
#pragma unroll
  for (int j = 0; j < kIPT; ++j) {
    int acc = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) acc += __popc(qw[w] ^ c[S + j][w]);
    v[j] = finish<E>(acc, hash_bits);
  }
}

template <Epilogue E, int W>
__global__ void __launch_bounds__(kThreads, HAMMING_MIN_BLOCKS)
wide_scan_kernel(const int32_t* __restrict__ q,
                 const int32_t* __restrict__ db, int32_t* __restrict__ out,
                 int Q, long long N, int hash_bits) {
  // the block's query codes, plus the next row's (outputs past a row's
  // end belong to it), and the codes of items 0..6 (those outputs' items)
  __shared__ uint32_t qs[(kQB + 1) * W];
  __shared__ uint32_t head[kHalo * W];
  const long long n0 =
      (long long)(HAMMING_LAST_TILE_FIRST ? gridDim.x - 1 - blockIdx.x
                                          : blockIdx.x) * kTile;
  const long long n1 = min(N, n0 + kTile);
  const int q0 = blockIdx.y * kQB;
  const int nq = min(kQB, Q - q0);
  for (int t = threadIdx.x; t < min(nq + 1, Q - q0) * W; t += kThreads)
    qs[t] = (uint32_t)q[(size_t)q0 * W + t];
  for (int t = threadIdx.x; t < kHalo * W; t += kThreads)
    head[t] = (uint32_t)__ldg(db + t);            // N > kHalo (launch)

  // items n0 + p + i; zero past N (those outputs belong to later rows)
  const int p = threadIdx.x * kIPT;
  uint32_t c[kIPT + kHalo][W];
#pragma unroll
  for (int i = 0; i < kIPT + kHalo; ++i) {
    const long long n = n0 + p + i;
#pragma unroll
    for (int w = 0; w < W; ++w)
      c[i][w] = n < N ? (uint32_t)__ldg(db + n * W + w) : 0u;
  }
  __syncthreads();

  const long long total = (long long)Q * N;
  for (int qi = 0; qi < nq; ++qi) {
    const long long row = (long long)(q0 + qi) * N;
    const long long lo = align8(row + n0);
    const long long hi = min(align8(row + n1), total);
    const long long f = lo + p;                  // first owned output
    if (f >= hi) continue;
    uint32_t qw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) qw[w] = qs[qi * W + w];
    int v[kIPT];
    switch ((int)(lo - row - n0)) {
      case 0: row_values<E, W, 0>(c, qw, hash_bits, v); break;
      case 1: row_values<E, W, 1>(c, qw, hash_bits, v); break;
      case 2: row_values<E, W, 2>(c, qw, hash_bits, v); break;
      case 3: row_values<E, W, 3>(c, qw, hash_bits, v); break;
      case 4: row_values<E, W, 4>(c, qw, hash_bits, v); break;
      case 5: row_values<E, W, 5>(c, qw, hash_bits, v); break;
      case 6: row_values<E, W, 6>(c, qw, hash_bits, v); break;
      default: row_values<E, W, 7>(c, qw, hash_bits, v); break;
    }
    const long long n = f - row;                 // item of output f
    if (f + kIPT <= hi && n + kIPT <= N) {
#pragma unroll
      for (int j = 0; j < kIPT; j += 4)
        store4(out + f + j, v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < kIPT; ++j) {
        if (f + j >= hi) break;
        const long long m = n + j - N;           // item of the next row
        if (m < 0) {
          out[f + j] = v[j];
        } else {                                  // m < kHalo < N
          int acc = 0;
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc += __popc(qs[(qi + 1) * W + w] ^ head[m * W + w]);
          out[f + j] = finish<E>(acc, hash_bits);
        }
      }
    }
  }
}

template <Epilogue E>
__global__ void __launch_bounds__(kNarrowThreads)
narrow_scan_kernel(const int32_t* __restrict__ q,
                   const int32_t* __restrict__ db,
                   const uint8_t* __restrict__ live,
                   int32_t* __restrict__ out, int Q, long long N, int W,
                   int hash_bits) {
  const long long total = (long long)Q * N;
  const long long f = ((long long)blockIdx.x * kNarrowThreads +
                       threadIdx.x) * 4;
  if (f >= total) return;
  long long row = f / N, n = f - row * N;
  int v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (f + j < total) v[j] = scan_one<E>(q, db, live, row, n, W, hash_bits);
    if (++n == N) {
      n = 0;
      ++row;
    }
  }
  if (f + 4 <= total) {
    store4(out + f, v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (f + j < total) out[f + j] = v[j];
  }
}

template <Epilogue E, int W>
int launch_wide(const void* q, const void* db, void* out, int Q, long long N,
                int hash_bits, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + kTile - 1) / kTile),
                  (unsigned)((Q + kQB - 1) / kQB));
  wide_scan_kernel<E, W><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)q, (const int32_t*)db, (int32_t*)out, Q, N,
      hash_bits);
  return (int)cudaGetLastError();
}

template <Epilogue E>
int launch(const void* q, const void* db, const void* live, void* out,
           int Q, long long N, int W, int hash_bits, void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  if constexpr (E != kLiveMatch) {
    // a row longer than the halo: its outputs past its end lie in the next
    // row's items 0..6, which the wide block stages
    if (N > kHalo) switch (W) {
      case 1: return launch_wide<E, 1>(q, db, out, Q, N, hash_bits, stream);
      case 2: return launch_wide<E, 2>(q, db, out, Q, N, hash_bits, stream);
      case 3: return launch_wide<E, 3>(q, db, out, Q, N, hash_bits, stream);
      case 4: return launch_wide<E, 4>(q, db, out, Q, N, hash_bits, stream);
      case 5: return launch_wide<E, 5>(q, db, out, Q, N, hash_bits, stream);
      case 6: return launch_wide<E, 6>(q, db, out, Q, N, hash_bits, stream);
      case 7: return launch_wide<E, 7>(q, db, out, Q, N, hash_bits, stream);
      case 8: return launch_wide<E, 8>(q, db, out, Q, N, hash_bits, stream);
      default: break;
    }
  }
  const long long threads = ((long long)Q * N + 3) / 4;
  const unsigned blocks =
      (unsigned)((threads + kNarrowThreads - 1) / kNarrowThreads);
  narrow_scan_kernel<E><<<blocks, kNarrowThreads, 0, stream>>>(
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
