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
