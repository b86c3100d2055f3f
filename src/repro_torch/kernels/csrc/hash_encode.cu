// Packed sign-projection encode: codes = pack(x @ A + tail * a_tail >= 0).
//
// Replaces the Pallas kernel hash_encode_pallas (src/repro/kernels/
// hash_encode.py, body _encode_kernel).
//
// What bounds it on an H100: reading x. At the build shape (N = 2,340,373
// rows, d = 150, L = 27 bits) x is 1.40 GB, 0.42 ms at 3.35 TB/s, against
// 19 GFLOP of f32 work, 0.28 ms at the 67 TFLOP/s CUDA-core rate; the
// output is one 32-bit word per row and 32 bits.
//
// Design: one warp per row. The warp copies its row of x into shared
// memory with coalesced loads, then lane b of word w computes projection
// bit 32 w + b as a dot over k in k order, every multiply and add rounded
// on its own (__fmul_rn/__fadd_rn: no FMA contraction, no TF32, no tensor
// cores), so a sign near zero comes out as in the plain PyTorch version
// and no item moves to another bucket. The tail term is added after the
// product, as the reference does. __ballot_sync packs the 32 sign bits
// LSB-first (lane b -> bit b), the layout of pack_bits; lanes >= L vote 0,
// so the pad bits of the last word are zero. NaN projections give 0 and
// -0.0 gives 1, as `proj >= 0` does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__global__ void hash_encode_kernel(const float* __restrict__ x,
                                   const float* __restrict__ A,
                                   const float* __restrict__ tail,
                                   const float* __restrict__ a_tail,
                                   int32_t* __restrict__ out,
                                   long long n, int d, int L, int W) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = rows + (size_t)warp * d;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long i = (long long)blockIdx.x * kWarps + warp; i < n;
       i += stride) {
    const float* xi = x + i * d;
    for (int k = lane; k < d; k += 32) row[k] = xi[k];
    __syncwarp();
    const float t = tail[i];
    for (int w = 0; w < W; ++w) {
      const int b = w * 32 + lane;
      bool bit = false;
      if (b < L) {
        float acc = 0.0f;
        for (int k = 0; k < d; ++k)
          acc = __fadd_rn(acc, __fmul_rn(row[k], A[(size_t)k * L + b]));
        const float proj = __fadd_rn(acc, __fmul_rn(t, a_tail[b]));
        bit = proj >= 0.0f;
      }
      const unsigned word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) out[i * W + w] = (int32_t)word;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int repro_hash_encode(const void* x, const void* A,
                                 const void* tail, const void* a_tail,
                                 void* out, long long n, int d, int L,
                                 int W, void* stream) {
  const size_t smem = (size_t)kWarps * d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hash_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  hash_encode_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                       (cudaStream_t)stream>>>(
      (const float*)x, (const float*)A, (const float*)tail,
      (const float*)a_tail, (int32_t*)out, n, d, L, W);
  return (int)cudaGetLastError();
}
