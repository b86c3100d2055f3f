// Packed sign-projection encode: codes = pack(x @ A + tail * a_tail >= 0).
//
// Replaces the Pallas kernel hash_encode_pallas (src/repro/kernels/
// hash_encode.py, body _encode_kernel).
//
// What bounds it on an H100: the multiplies and adds. Each code bit is a
// dot over k in k order with every multiply and add rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction, no TF32, no tensor cores), so
// that a sign near zero comes out as in the plain PyTorch version and no
// item moves to another bucket. That is two f32 instructions a term: at the
// build shape (N = 2,340,373 rows, d = 150, L = 27 bits) 19.1 G
// instructions, 0.57 ms at 33.5 T f32 instructions/s (128 lanes an SM at
// 1.98 GHz), above the 0.42 ms of reading x (1.40 GB) once. Separate
// multiplies and adds issue at ~85% of that rate, and only from two or
// more warps per scheduler (tools/fp32_rate.py).
//
// Design: a persistent grid, one block an SM, of warps that each walk slabs
// of S = 8 R consecutive rows (R = 1, 2 or 4 rows a thread) on their own;
// the caller picks R from N and the warps a block from the shared memory
// (ops.hash_encode_plan: R = 4 and 11 warps at the build shape).
//  * Register tiles: a warp's lanes are 4 bit groups x 8 row groups. Lane
//    (g, h) = 4 h + g holds R rows of group h x KB bits (g + 4 i, i < KB,
//    of word v; KB = 7 when L <= 28, so 27 bits take 28 slots, else 8):
//    per V k (V = 2, a float2, for even d) it reads its R rows' values (4
//    lanes share each address) and KB A values from shared memory and
//    does 2 V R KB multiplies and adds, so every value loaded serves KB or
//    R terms. One value a term, as a first design read, left the
//    shared-memory crossbar (128 bytes a clock an SM) the limit.
//  * Staging: A (d x L, bits padded with zeros to 32 W columns; pairs over
//    k for even d) and a_tail are copied to shared memory once per block by
//    cp.async. A warp's slab of x is one contiguous block of S d floats;
//    with x's base 16-byte aligned and S a multiple of 4 it is 16-byte
//    aligned for any d and is copied by the warp with 16-byte cp.async
//    (the last words of a partial slab, and a view that is not 16-byte
//    aligned, with 4-byte ones). Each warp has one slab buffer and syncs
//    only with itself: while one warp waits for its next slab the others
//    compute. (Tiles shared by a block stalled the whole block on every
//    copy, and double buffers held an SM to 4 warps.)
//  * Sums run in k order; the tail term is added after the sum, as the
//    reference does. For each row r and bit slot i, __ballot_sync gathers
//    the sign bits of all row groups; lane l (< 8 R) packs row l's word
//    LSB-first from the 4 lanes of its group in each of the KB ballots,
//    the layout of pack_bits. Bits >= L vote 0, so the pad bits of the last
//    word are zero. NaN projections give 0 and -0.0 gives 1, as
//    `proj >= 0` does.
//
// The resident design needs A whole and one slab of x a warp in shared
// memory: at an LM's width (d = 1024, L = 122: A alone is 525 KB) it does
// not fit. Those shapes go to a second, tiled design
// (hash_encode_tiled_kernel), chosen by the caller (ops.hash_encode_plan):
// a block owns BM rows x BN bits of the output and walks d in tiles of
// BK = 16 (64 for a few rows), staging the x tile (BM x BK) and the A tile (BK x BN) by
// cp.async into a double buffer, so the next tile's copy overlaps this
// tile's sums; each thread keeps TM rows x TN bits of partial sums in
// registers from one tile to the next, as the Pallas kernel's bd grid axis
// carries its sums. Padding past d, N and L is copied as zeros (a zero term
// leaves a sum unchanged: an f32 sum that starts at +0 is never -0). The
// sums run in k order, each multiply and add rounded on its own, so codes
// equal the plain version's bit for bit as in the resident design. Signs are
// gathered by shared-memory atomicOr into each row's words and stored
// coalesced. Two thread layouts: 8 rows x TN bits a thread for many rows
// (TN = 8, 4 or 2 for word groups of 4, 2 or 1 words a block; the build of
// a vocabulary), and one row x one bit a thread for a few rows (a decode
// batch), where each block holds 8 rows x 32 bits and the grid spreads
// rows and words over the SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBitGroups = 4;
constexpr int kRowGroups = 32 / kBitGroups;
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
}

// V consecutive k of a row (float2 for even d) and the sum of their terms
// into acc in k order, each multiply and add rounded on its own
template <int V> struct Pack;
template <> struct Pack<2> {
  using T = float2;
  static __device__ __forceinline__ T row(const float* r, int step) {
    return *reinterpret_cast<const float2*>(r + 2 * step);
  }
  static __device__ __forceinline__ float dot(float acc, T x, T a) {
    acc = __fadd_rn(acc, __fmul_rn(x.x, a.x));
    return __fadd_rn(acc, __fmul_rn(x.y, a.y));
  }
};
template <> struct Pack<1> {
  using T = float;
  static __device__ __forceinline__ T row(const float* r, int step) {
    return r[step];
  }
  static __device__ __forceinline__ float dot(float acc, T x, T a) {
    return __fadd_rn(acc, __fmul_rn(x, a));
  }
};

// KB: bits of a word a lane holds (the word's bits g + 4 i, i < KB)
template <int V, int R, int KB>
__global__ void __launch_bounds__(kMaxWarps * 32)
hash_encode_kernel(const float* __restrict__ x, const float* __restrict__ A,
                   const float* __restrict__ tail,
                   const float* __restrict__ a_tail, int32_t* __restrict__ out,
                   long long n, int d, int L, int W, long long slabs,
                   bool aligned) {
  constexpr int S = kRowGroups * R;         // rows a slab
  extern __shared__ __align__(16) float sm[];
  const int Lp = 32 * W;
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane % kBitGroups, h = lane / kBitGroups;
  float* buf = sm + (size_t)warp * S * d;   // this warp's slab
  float* As = sm + (size_t)warps * S * d;   // d x Lp, pairs over k if V = 2
  float* ats = As + (size_t)d * Lp;         // Lp

  // A and a_tail by 4-byte cp.async, pad columns zeroed by plain stores
  for (int i = tid; i < d * Lp; i += blockDim.x) {
    const int k = i / Lp, b = i % Lp;
    float* to = As + (V == 2 ? (k >> 1) * 2 * Lp + 2 * b + (k & 1) : i);
    if (b < L) cp_async<4>(to, A + (size_t)k * L + b);
    else *to = 0.0f;
  }
  for (int b = tid; b < Lp; b += blockDim.x) {
    if (b < L) cp_async<4>(ats + b, a_tail + b);
    else ats[b] = 0.0f;
  }
  // slab sl of x into this warp's buffer (the caller commits)
  auto copy = [&](long long sl) {
    const long long w0 = sl * S;
    const int words = (int)min((long long)S, n - w0) * d;
    const float* src = x + w0 * d;
    int done = 0;
    if (aligned) {
      for (int i = lane; i < words >> 2; i += 32)
        cp_async<16>(buf + 4 * i, src + 4 * i);
      done = words & ~3;
    }
    for (int i = done + lane; i < words; i += 32)
      cp_async<4>(buf + i, src + i);
  };
  const long long first = (long long)blockIdx.x * warps + warp;
  if (first < slabs) copy(first);           // with A, in one group
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  using Vec = typename Pack<V>::T;
  const int hp = min(lane / R, kRowGroups - 1);
  const long long stride = (long long)gridDim.x * warps;
  for (long long sl = first; sl < slabs; sl += stride) {
    if (sl != first) {
      __syncwarp();                         // the slab is refilled
      copy(sl);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncwarp();
    }
    const long long w0 = sl * S;            // the slab's first row
    const float* xr = buf + (size_t)h * R * d;  // this lane's rows
    const long long r0 = w0 + h * R;            // its first row
    for (int v = 0; v < W; ++v) {
      const int b0 = 32 * v + g;            // bits b0 + 4 i
      float acc[R][KB];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < KB; ++i) acc[r][i] = 0.0f;
      const Vec* av = reinterpret_cast<const Vec*>(As) + b0;
#pragma unroll 2
      for (int st = 0; st < d / V; ++st) {
        Vec a[KB];
#pragma unroll
        for (int i = 0; i < KB; ++i)
          a[i] = av[(size_t)st * Lp + kBitGroups * i];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const Vec xv = Pack<V>::row(xr + r * d, st);
#pragma unroll
          for (int i = 0; i < KB; ++i)
            acc[r][i] = Pack<V>::dot(acc[r][i], xv, a[i]);
        }
      }
      // signs: ballot i of row r holds, at lane 4 h + g, bit b0 + 4 i of
      // row r of group h; lane l (< 8 R) packs row l = (l / R, l % R)
      unsigned mine = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool live = r0 + r < n;
        const float tr = live ? __ldg(tail + r0 + r) : 0.0f;
        unsigned word = 0;
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          const int b = b0 + kBitGroups * i;
          const float proj = __fadd_rn(acc[r][i], __fmul_rn(tr, ats[b]));
          const unsigned vote =
              __ballot_sync(kFull, live && b < L && proj >= 0.0f);
          word |= ((vote >> (kBitGroups * hp)) & 0xfu) << (kBitGroups * i);
        }
        if (lane % R == r) mine = word;
      }
      if (lane < S && w0 + lane < n) out[(w0 + lane) * W + v] = (int32_t)mine;
    }
  }
}

template <int V, int R, int KB>
int launch(const float* x, const float* A, const float* tail,
           const float* a_tail, int32_t* out, long long n, int d, int L, int W,
           int warps, int blocks, cudaStream_t stream) {
  constexpr int S = kRowGroups * R;
  const size_t smem = sizeof(float) * ((size_t)warps * S * d +
                                       (size_t)(d + 1) * 32 * W);
  auto kernel = hash_encode_kernel<V, R, KB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long slabs = (n + S - 1) / S;
  const bool aligned = (uintptr_t)x % 16 == 0;
  kernel<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      x, A, tail, a_tail, out, n, d, L, W, slabs, aligned);
  return (int)cudaGetLastError();
}

template <int V, int KB>
int dispatch(int rows, const float* x, const float* A, const float* tail,
             const float* a_tail, int32_t* out, long long n, int d, int L,
             int W, int warps, int blocks, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch<V, 1, KB>(x, A, tail, a_tail, out, n, d, L, W, warps,
                              blocks, s);
    case 2:
      return launch<V, 2, KB>(x, A, tail, a_tail, out, n, d, L, W, warps,
                              blocks, s);
    case 4:
      return launch<V, 4, KB>(x, A, tail, a_tail, out, n, d, L, W, warps,
                              blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int V>
int dispatch_bits(int rows, const float* x, const float* A,
                  const float* tail, const float* a_tail, int32_t* out,
                  long long n, int d, int L, int W, int warps, int blocks,
                  cudaStream_t s) {
  if (L <= 4 * 7)
    return dispatch<V, 7>(rows, x, A, tail, a_tail, out, n, d, L, W, warps,
                          blocks, s);
  return dispatch<V, 8>(rows, x, A, tail, a_tail, out, n, d, L, W, warps,
                        blocks, s);
}

// -- tiled design: any d, a block owns BM rows x BN bits -------------------

constexpr int kTileThreads = 256;

template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src,
                                               bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0));
}

// TN consecutive floats of a shared-memory row into registers
template <int TN>
__device__ __forceinline__ void load_bits(float (&a)[TN], const float* p) {
  if constexpr (TN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      a[j] = v.x; a[j + 1] = v.y; a[j + 2] = v.z; a[j + 3] = v.w;
    }
  } else if constexpr (TN == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  } else {
    a[0] = *p;
  }
}

// TM rows x TN bits a thread; BN bits (BN / 32 words) a block; BK k a tile
template <int TM, int TN, int BN, int BK>
__global__ void __launch_bounds__(kTileThreads)
hash_encode_tiled_kernel(const float* __restrict__ x,
                         const float* __restrict__ A,
                         const float* __restrict__ tail,
                         const float* __restrict__ a_tail,
                         int32_t* __restrict__ out, long long n, int d,
                         int L, int W) {
  constexpr int GB = BN / TN;               // bit groups
  constexpr int GR = kTileThreads / GB;     // row groups
  constexpr int BM = GR * TM;               // rows a block
  constexpr int WB = BN / 32;               // words a block
  constexpr int XS = BK + 1;                // x tile row stride (banks)
  static_assert(32 % TN == 0 && GB * TN == BN && GR * GB == kTileThreads,
                "tile layout");
  __shared__ __align__(16) float xs[2][BM * XS];
  __shared__ __align__(16) float as[2][BK * BN];
  __shared__ unsigned ws[BM * WB];

  const int tid = threadIdx.x;
  const int tx = tid % GB, ty = tid / GB;
  const long long m0 = (long long)blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;           // the block's first bit
  for (int e = tid; e < BM * WB; e += kTileThreads) ws[e] = 0u;

  // tile t of x (BM x BK) and of A (BK x BN) into buffer b, zeros past
  // N, d and L
  auto stage = [&](int t, int b) {
    const int k0 = t * BK;
    for (int e = tid; e < BM * BK; e += kTileThreads) {
      const int r = e / BK, kk = e % BK;
      const long long row = m0 + r;
      const bool ok = row < n && k0 + kk < d;
      cp_async_zfill<4>(&xs[b][r * XS + kk],
                        ok ? x + row * d + k0 + kk : x, ok);
    }
    for (int e = tid; e < BK * BN; e += kTileThreads) {
      const int kk = e / BN, c = e % BN;
      const bool ok = k0 + kk < d && c0 + c < L;
      cp_async_zfill<4>(&as[b][e],
                        ok ? A + (size_t)(k0 + kk) * L + c0 + c : A, ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int tiles = (d + BK - 1) / BK;
  stage(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) stage(t + 1, (t + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);   // tile t has landed
    __syncthreads();
    const float* X = xs[t & 1] + ty * TM * XS;
    const float* Ab = as[t & 1] + tx * TN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TN], xv[TM];
      load_bits<TN>(a, Ab + kk * BN);
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = X[i * XS + kk];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv[i], a[j]));
    }
    __syncthreads();                        // buffer t & 1 is refilled next
  }

  // tail term after the sum, signs into each row's words
  const int cb = tx * TN;                   // the thread's first bit
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const long long row = m0 + r;
    const bool live = row < n;
    const float tr = live ? __ldg(tail + row) : 0.0f;
    unsigned seg = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int b = c0 + cb + j;
      const float at = b < L ? __ldg(a_tail + b) : 0.0f;
      const float proj = __fadd_rn(acc[i][j], __fmul_rn(tr, at));
      if (live && b < L && proj >= 0.0f) seg |= 1u << ((cb + j) % 32);
    }
    if (seg) atomicOr(&ws[r * WB + cb / 32], seg);
  }
  __syncthreads();
  for (int e = tid; e < BM * WB; e += kTileThreads) {
    const long long row = m0 + e / WB;
    const int word = blockIdx.y * WB + e % WB;
    if (row < n && word < W) out[row * W + word] = (int32_t)ws[e];
  }
}

template <int TM, int TN, int BN, int BK>
int launch_tiled(const float* x, const float* A, const float* tail,
                 const float* a_tail, int32_t* out, long long n, int d,
                 int L, int W, cudaStream_t stream) {
  constexpr int BM = (kTileThreads / (BN / TN)) * TM;
  const long long bx = (n + BM - 1) / BM;
  const int by = (W + BN / 32 - 1) / (BN / 32);
  if (bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hash_encode_tiled_kernel<TM, TN, BN, BK>
      <<<dim3((unsigned)bx, (unsigned)by), kTileThreads, 0, stream>>>(
          x, A, tail, a_tail, out, n, d, L, W);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: code rows a thread computes (1, 2 or 4; a warp's slab is 8 times
// that); warps: warps a block (1 to 16); blocks: the grid. The caller
// checks that A and the warps' slabs fit shared memory.
extern "C" int repro_hash_encode(const void* x, const void* A,
                                 const void* tail, const void* a_tail,
                                 void* out, long long n, int d, int L,
                                 int W, int rows, int warps, int blocks,
                                 void* stream) {
  if (warps < 1 || warps > kMaxWarps || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d % 2 == 0)
    return dispatch_bits<2>(rows, (const float*)x, (const float*)A,
                            (const float*)tail, (const float*)a_tail,
                            (int32_t*)out, n, d, L, W, warps, blocks, s);
  return dispatch_bits<1>(rows, (const float*)x, (const float*)A,
                          (const float*)tail, (const float*)a_tail,
                          (int32_t*)out, n, d, L, W, warps, blocks, s);
}


// The tiled design (any d): layout 0 holds one row x one bit a thread
// (8 rows x 32 bits a block, k tiles of 64), layouts 1, 2 and 3 hold 8
// rows x 2, 4 or 8 bits a thread (128 rows x 32, 64 or 128 bits a block,
// k tiles of 16). The grid covers N
// and the W words; nothing is staged before the launch.
extern "C" int repro_hash_encode_tiled(const void* x, const void* A,
                                       const void* tail, const void* a_tail,
                                       void* out, long long n, int d, int L,
                                       int W, int layout, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* Af = (const float*)A;
  const float* tf = (const float*)tail;
  const float* af = (const float*)a_tail;
  int32_t* o = (int32_t*)out;
  switch (layout) {
    case 0: return launch_tiled<1, 1, 32, 64>(xf, Af, tf, af, o, n, d, L, W, s);
    case 1: return launch_tiled<8, 2, 32, 16>(xf, Af, tf, af, o, n, d, L, W, s);
    case 2: return launch_tiled<8, 4, 64, 16>(xf, Af, tf, af, o, n, d, L, W, s);
    case 3: return launch_tiled<8, 8, 128, 16>(xf, Af, tf, af, o, n, d, L,
                                               W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
