// Absorbed MLA decode attention over the bf16 latent cache: for each
// sequence b and head h,
//   s[t] = scale * (q_lat[b,h,:] . c_kv[b,t,:] + q_rope[b,h,:] . k_rope[b,t,:])
//   o_lat[b,h,:] = sum_t softmax(s)[t] * c_kv[b,t,:]     over t = 0 .. pos
// f32 scores, softmax and sums; the cache is read as stored (bf16).
//
// Replaces no Pallas kernel: the JAX package computes the absorbed decode
// in plain jnp (src/repro/models/attention.py, mla_decode). The port's
// plain version (kernels/ref.py latent_attend_ref) casts the whole cache to
// f32 twice a layer and runs f32 products on CUDA cores over every slot,
// the masked ones too; this kernel reads each live slot once.
//
// What bounds it on an H100: moving bytes. A layer must read the live
// cache once, B x (pos + 1) x (r + rho) bf16: at DeepSeek-V2-Lite's widths
// (r 512, rho 64: 1,152 B a slot) and 64 sequences at pos ~8,700, ~0.64 GB,
// ~0.19 ms at 3.35 TB/s. Its products are ~60 FLOP a byte with the f32
// operands split in two (below), far under the tensor cores' ~300.
//
// Design. Grid (splits, B): block (j, b) takes the j-th share of sequence
// b's live tiles of kT = 64 slots; the live length pos + 1 is read from
// device memory, so a captured CUDA graph replays at any position and no
// block reads a slot past pos. `splits` is chosen on the host from B and
// the SM count so that B x splits blocks fill the card in one wave (one
// ~190 KB block an SM). A ring of two cache tiles in shared memory, each
// slot's latent and rope key side by side (rows padded by 16 bytes, so
// ldmatrix's eight row addresses hit distinct banks), is filled by
// cp.async one tile ahead of use; slots past pos are zero-filled without a
// read. Each tile is used twice from shared memory and never read again:
//   * scores, on tensor cores (mma.sync m16n8k16, bf16 in, f32 sums): the
//     heads are one m16 tile (MT tiles for up to 16 MT heads, padded rows
//     zero); the 8 warps split the latent columns (64 each at r 512) and
//     the rope columns' k steps, each warp scoring all 64 slots of the tile
//     with the tile as B (ldmatrix), and the 8 partial score tiles are
//     summed through shared memory, each warp summing 8 slots;
//   * the online softmax in f32 (running max and sum per head row; the
//     tile's maxima and sums exchanged through shared memory);
//   * the weighted sum P . C on tensor cores, the same tile transposed as
//     B (ldmatrix .trans), each warp owning its 64 latent columns of o.
// The f32 operands (q_lat, q_rope and P) enter the products as a hi + lo
// pair of bf16 (two MMAs summed in f32), which keeps ~16 bits of their
// mantissa; the cache operand is bf16 as stored and loses nothing. A split
// writes its unnormalised o with its (max, sum); a second launch merges the
// splits by the log-sum-exp rule (with one split the first writes o/sum).
//
// Instantiations: (r, rho, MT) = (512, 64, 1) for up to 16 heads
// (DeepSeek-V2-Lite) and (256, 32, 3) for up to 48 (MiniCPM3's 40); the
// wrapper (kernels/ops.py latent_attend, its LATENT_WIDTHS) raises on any
// other shape before a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 64;                      // slots a tile
constexpr int kStages = 2;
constexpr unsigned kFull = 0xffffffffu;

template <int R, int RHO, int MT>
struct Layout {
  static constexpr int kRow = R + RHO;      // bf16 of a cached slot
  static constexpr int kStride = kRow + 8;  // bf16 of a staged slot
  static constexpr int kChunks = kRow / 8;  // 16-byte chunks of a slot
  static constexpr int kLatChunks = R / 8;
  static constexpr int kLoads = kT * kChunks / kThreads;  // cp.async a thread
  static constexpr int kCols = R / kWarps;  // latent columns a warp owns
  static constexpr int kKs = kCols / 16;    // their k steps in the scores
  static constexpr int kNo = kCols / 8;     // their n8 tiles of o
  static constexpr int kRs = RHO / 16;      // rope k steps, warp w < kRs one
  static constexpr int kNt = kT / 8;        // n8 tiles of a tile's scores
  static constexpr int kPk = kT / 16;       // k steps of P . C
  static constexpr int kPs = kT + 8;        // f32 of a partial-score row
  static constexpr int kPp = kT + 8;        // bf16 of a P row
  static constexpr int kTileBytes = kT * kStride * 2;
  static constexpr int kPartOff = kStages * kTileBytes;
  static constexpr int kPOff = kPartOff + MT * kWarps * 16 * kPs * 4;
  static constexpr int kStatOff = kPOff + MT * 2 * 16 * kPp * 2;
  static constexpr int kSmem = kStatOff + 2 * MT * kWarps * 16 * 4;
  static_assert(R % (16 * kWarps) == 0, "latent columns split over 8 warps");
  static_assert(RHO % 16 == 0 && RHO / 16 <= kWarps, "rope k steps");
  static_assert(kCols % 16 == 0, "a warp's o columns pair into n16");
  static_assert(kT * kChunks % kThreads == 0, "a tile's copies split evenly");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; with on false nothing is read, zeros written
__device__ __forceinline__ void cp16(unsigned dst, const void* src, bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a . b: a 16 x 16 row-major, b 16 x 8 column-major, bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as a hi + lo pair of bf16x2: hi rounds each, lo rounds the rest
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// A fragments (hi and lo) of the 16 x 16 block of rows h0 .. h0 + 15 and
// columns k0 .. k0 + 15 of an (H, ld) f32 matrix; rows past H are zero
__device__ __forceinline__ void load_a(const float* m, int ld, int H, int h0,
                                       int k0, int lane, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = h0 + g + 8 * (i & 1);
    const int k = k0 + c + 8 * (i >> 1);
    float2 v = make_float2(0.f, 0.f);
    if (h < H) v = *reinterpret_cast<const float2*>(m + (size_t)h * ld + k);
    split2(v.x, v.y, hi[i], lo[i]);
  }
}

// acc (16 x 64 scores) += A . tile[:, kc .. kc + 15]^T for the 64 slots
template <int STRIDE>
__device__ __forceinline__ void score_step(float (&acc)[kT / 8][4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           unsigned tile, int kc, int lane) {
  const int row = (lane & 7) + ((lane >> 4) << 3);
  const int col = kc + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int np = 0; np < kT / 16; ++np) {
    unsigned b[4];
    ldsm_x4(b, tile + ((np * 16 + row) * STRIDE + col) * 2);
    mma(acc[2 * np], ah, b[0], b[1]);
    mma(acc[2 * np + 1], ah, b[2], b[3]);
    mma(acc[2 * np], al, b[0], b[1]);
    mma(acc[2 * np + 1], al, b[2], b[3]);
  }
}

template <int R, int RHO, int MT>
__global__ void __launch_bounds__(kThreads, 1)
latent_attn_kernel(const float* __restrict__ q_lat,
                   const float* __restrict__ q_rope,
                   const __nv_bfloat16* __restrict__ c_kv,
                   const __nv_bfloat16* __restrict__ k_rope,
                   const int64_t* __restrict__ pos, float* __restrict__ out,
                   float* __restrict__ o_part, float* __restrict__ ml_part,
                   int H, int S, long long c_b, long long c_s, long long r_b,
                   long long r_s, float scale, int splits) {
  using L = Layout<R, RHO, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, c = (lane & 3) * 2;
  const int split = blockIdx.x, b = blockIdx.y;

  // this block's live tiles: the split-th share of the pos + 1 slots
  const long long p = *pos;
  const int n = (int)(p < 0 ? 0 : (p + 1 < S ? p + 1 : S));
  const int tiles = (n + kT - 1) / kT;
  const int per = (tiles + splits - 1) / splits;
  const int t_begin = split * per;
  const int t_end = min(tiles, t_begin + per);
  float* ml = ml_part + ((size_t)b * splits + split) * H * 2;
  if (t_begin >= t_end) {                   // nothing live in this share
    for (int h = tid; h < H; h += kThreads) {
      ml[2 * h] = -INFINITY;
      ml[2 * h + 1] = 0.f;
    }
    return;
  }

  const __nv_bfloat16* cb = c_kv + (size_t)b * c_b;
  const __nv_bfloat16* rb = k_rope + (size_t)b * r_b;
  auto load = [&](int t, int stage) {
    const unsigned base = smem_u32(smem + stage * L::kTileBytes);
    const int s0 = t * kT;
#pragma unroll
    for (int k = 0; k < L::kLoads; ++k) {
      const int i = tid + k * kThreads;
      const int row = i / L::kChunks, ch = i - row * L::kChunks;
      const int s = s0 + row;
      const bool on = s < n;
      const long long sc = on ? s : s0;     // a live slot's address
      const __nv_bfloat16* src =
          ch < L::kLatChunks ? cb + sc * c_s + ch * 8
                             : rb + sc * r_s + (ch - L::kLatChunks) * 8;
      cp16(base + (row * L::kStride + ch * 8) * 2, src, on);
    }
    cp_commit();
  };
  load(t_begin, 0);

  // the query's A fragments, hi and lo: this warp's latent k steps and,
  // for warp w < kRs, the rope k step w
  const float* qb = q_lat + (size_t)b * H * R;
  const float* rqb = q_rope + (size_t)b * H * RHO;
  unsigned qh[MT][L::kKs][4], ql[MT][L::kKs][4], rh[MT][4], rl[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int ks = 0; ks < L::kKs; ++ks)
      load_a(qb, R, H, 16 * mt, w * L::kCols + 16 * ks, lane, qh[mt][ks],
             ql[mt][ks]);
    load_a(rqb, RHO, H, 16 * mt, 16 * (w < L::kRs ? w : 0), lane, rh[mt],
           rl[mt]);
  }

  float* part = reinterpret_cast<float*>(smem + L::kPartOff);
  const unsigned pbuf = smem_u32(smem + L::kPOff);
  __nv_bfloat16* pst = reinterpret_cast<__nv_bfloat16*>(smem + L::kPOff);
  float* smax = reinterpret_cast<float*>(smem + L::kStatOff);
  float* ssum = smax + MT * kWarps * 16;

  float o[MT][L::kNo][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < L::kNo; ++j)
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    cp_wait_all();
    __syncthreads();                        // tile t in; tile t - 1 done
    if (t + 1 < t_end) load(t + 1, st ^ 1);
    const unsigned tile = smem_u32(smem + st * L::kTileBytes);
    const int valid = min(kT, n - t * kT);

    // 1. this warp's columns' share of the 16 MT x 64 scores
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float acc[L::kNt][4];
#pragma unroll
      for (int j = 0; j < L::kNt; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < L::kKs; ++ks)
        score_step<L::kStride>(acc, qh[mt][ks], ql[mt][ks], tile,
                               w * L::kCols + 16 * ks, lane);
      if (w < L::kRs)
        score_step<L::kStride>(acc, rh[mt], rl[mt], tile, R + 16 * w, lane);
      float* dst = part + (mt * kWarps + w) * 16 * L::kPs;
#pragma unroll
      for (int j = 0; j < L::kNt; ++j) {
        *reinterpret_cast<float2*>(dst + g * L::kPs + 8 * j + c) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(dst + (g + 8) * L::kPs + 8 * j + c) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();

    // 2. slots 8w .. 8w + 7: the partials summed, scaled and masked
    float s[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float2 a = make_float2(0.f, 0.f), d = make_float2(0.f, 0.f);
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const float* src = part + (mt * kWarps + v) * 16 * L::kPs + 8 * w + c;
        const float2 x = *reinterpret_cast<const float2*>(src + g * L::kPs);
        const float2 y =
            *reinterpret_cast<const float2*>(src + (g + 8) * L::kPs);
        a.x += x.x;
        a.y += x.y;
        d.x += y.x;
        d.y += y.y;
      }
      const int slot = 8 * w + c;
      s[mt][0] = slot < valid ? a.x * scale : -INFINITY;
      s[mt][1] = slot + 1 < valid ? a.y * scale : -INFINITY;
      s[mt][2] = slot < valid ? d.x * scale : -INFINITY;
      s[mt][3] = slot + 1 < valid ? d.y * scale : -INFINITY;
      float m0 = fmaxf(s[mt][0], s[mt][1]), m1 = fmaxf(s[mt][2], s[mt][3]);
      m0 = fmaxf(m0, __shfl_xor_sync(kFull, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(kFull, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(kFull, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(kFull, m1, 2));
      if ((lane & 3) == 0) {
        smax[(mt * kWarps + w) * 16 + g] = m0;
        smax[(mt * kWarps + w) * 16 + g + 8] = m1;
      }
    }
    __syncthreads();

    // 3. the new running max (finite: every tile's slot 0 is live),
    // p = exp(s - max) as hi + lo bf16, and the slice's row sums
    float m_new[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float t0 = m_run[mt][0], t1 = m_run[mt][1];
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        t0 = fmaxf(t0, smax[(mt * kWarps + v) * 16 + g]);
        t1 = fmaxf(t1, smax[(mt * kWarps + v) * 16 + g + 8]);
      }
      m_new[mt][0] = t0;
      m_new[mt][1] = t1;
      const float p0 = expf(s[mt][0] - t0), p1 = expf(s[mt][1] - t0);
      const float p2 = expf(s[mt][2] - t1), p3 = expf(s[mt][3] - t1);
      unsigned h01, l01, h23, l23;
      split2(p0, p1, h01, l01);
      split2(p2, p3, h23, l23);
      __nv_bfloat16* hi = pst + (mt * 2) * 16 * L::kPp + 8 * w + c;
      __nv_bfloat16* lo = hi + 16 * L::kPp;
      *reinterpret_cast<unsigned*>(hi + g * L::kPp) = h01;
      *reinterpret_cast<unsigned*>(hi + (g + 8) * L::kPp) = h23;
      *reinterpret_cast<unsigned*>(lo + g * L::kPp) = l01;
      *reinterpret_cast<unsigned*>(lo + (g + 8) * L::kPp) = l23;
      float r0 = p0 + p1, r1 = p2 + p3;
      r0 += __shfl_xor_sync(kFull, r0, 1);
      r0 += __shfl_xor_sync(kFull, r0, 2);
      r1 += __shfl_xor_sync(kFull, r1, 1);
      r1 += __shfl_xor_sync(kFull, r1, 2);
      if ((lane & 3) == 0) {
        ssum[(mt * kWarps + w) * 16 + g] = r0;
        ssum[(mt * kWarps + w) * 16 + g + 8] = r1;
      }
    }
    __syncthreads();

    // 4. rescale o and the sums to the new max, then o += P . C
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float a0 = expf(m_run[mt][0] - m_new[mt][0]);
      const float a1 = expf(m_run[mt][1] - m_new[mt][1]);
      float u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        u0 += ssum[(mt * kWarps + v) * 16 + g];
        u1 += ssum[(mt * kWarps + v) * 16 + g + 8];
      }
      l_run[mt][0] = l_run[mt][0] * a0 + u0;
      l_run[mt][1] = l_run[mt][1] * a1 + u1;
      m_run[mt][0] = m_new[mt][0];
      m_run[mt][1] = m_new[mt][1];
#pragma unroll
      for (int j = 0; j < L::kNo; ++j) {
        o[mt][j][0] *= a0;
        o[mt][j][1] *= a0;
        o[mt][j][2] *= a1;
        o[mt][j][3] *= a1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < L::kPk; ++kk) {
      unsigned ph[MT][4], pl[MT][4];
      const int prow = lane & 15, pcol = 16 * kk + ((lane >> 4) << 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned at = pbuf + ((mt * 2 * 16 + prow) * L::kPp + pcol) * 2;
        ldsm_x4(ph[mt], at);
        ldsm_x4(pl[mt], at + 16 * L::kPp * 2);
      }
      const int srow = 16 * kk + (lane & 15);
#pragma unroll
      for (int np = 0; np < L::kNo / 2; ++np) {
        const int col = w * L::kCols + 16 * np + ((lane >> 4) << 3);
        unsigned bt[4];
        ldsm_x4_t(bt, tile + (srow * L::kStride + col) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * np], ph[mt], bt[0], bt[1]);
          mma(o[mt][2 * np + 1], ph[mt], bt[2], bt[3]);
          mma(o[mt][2 * np], pl[mt], bt[0], bt[1]);
          mma(o[mt][2 * np + 1], pl[mt], bt[2], bt[3]);
        }
      }
    }
  }

  // one split: o / sum is the answer; else o, max and sum for the merge
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int h = 16 * mt + g + 8 * half;
      if (h >= H) continue;
      const float inv = splits == 1 ? 1.f / l_run[mt][half] : 1.f;
      float* dst = splits == 1
          ? out + ((size_t)b * H + h) * R
          : o_part + (((size_t)b * splits + split) * H + h) * R;
#pragma unroll
      for (int j = 0; j < L::kNo; ++j)
        *reinterpret_cast<float2*>(dst + w * L::kCols + 8 * j + c) =
            make_float2(o[mt][j][2 * half] * inv,
                        o[mt][j][2 * half + 1] * inv);
      if (splits > 1 && w == 0 && (lane & 3) == 0) {
        ml[2 * h] = m_run[mt][half];
        ml[2 * h + 1] = l_run[mt][half];
      }
    }
  }
}

// o_lat[b, h] from the splits' (o, max, sum): grid (H, B), R / 4 threads
__global__ void __launch_bounds__(128)
latent_merge_kernel(const float* __restrict__ o_part,
                    const float* __restrict__ ml_part,
                    float* __restrict__ out, int H, int R, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const float* ml = ml_part + (size_t)b * splits * H * 2;
  float m = -INFINITY;
  for (int j = 0; j < splits; ++j) m = fmaxf(m, ml[(j * H + h) * 2]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int j = 0; j < splits; ++j) {
    const float mj = ml[(j * H + h) * 2];
    if (mj == -INFINITY) continue;          // a share with no live slot
    const float wt = expf(mj - m);
    l += wt * ml[(j * H + h) * 2 + 1];
    const float4 x = reinterpret_cast<const float4*>(
        o_part + (((size_t)b * splits + j) * H + h) * R)[i];
    acc.x += wt * x.x;
    acc.y += wt * x.y;
    acc.z += wt * x.z;
    acc.w += wt * x.w;
  }
  const float inv = 1.f / l;
  reinterpret_cast<float4*>(out + ((size_t)b * H + h) * R)[i] =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

template <int R, int RHO, int MT>
int launch(const void* q_lat, const void* q_rope, const void* c_kv,
           const void* k_rope, const void* pos, void* out, void* o_part,
           void* ml_part, int B, int H, int S, long long c_b, long long c_s,
           long long r_b, long long r_s, float scale, int splits,
           cudaStream_t stream) {
  using L = Layout<R, RHO, MT>;
  // the opt-in above 48 KB, on the current device (no stream work: it may
  // be called while a graph is captured)
  cudaError_t e = cudaFuncSetAttribute(
      latent_attn_kernel<R, RHO, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return (int)e;
  latent_attn_kernel<R, RHO, MT><<<dim3(splits, B), kThreads, L::kSmem,
                                   stream>>>(
      (const float*)q_lat, (const float*)q_rope, (const __nv_bfloat16*)c_kv,
      (const __nv_bfloat16*)k_rope, (const int64_t*)pos, (float*)out,
      (float*)o_part, (float*)ml_part, H, S, c_b, c_s, r_b, r_s, scale,
      splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  latent_merge_kernel<<<dim3(H, B), R / 4, 0, stream>>>(
      (const float*)o_part, (const float*)ml_part, (float*)out, H, R, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_latent_attend(const void* q_lat, const void* q_rope,
                                   const void* c_kv, const void* k_rope,
                                   const void* pos, void* out, void* o_part,
                                   void* ml_part, int B, int H, int S, int R,
                                   int RHO, long long c_b, long long c_s,
                                   long long r_b, long long r_s, float scale,
                                   int splits, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (R == 512 && RHO == 64 && H <= 16)
    return launch<512, 64, 1>(q_lat, q_rope, c_kv, k_rope, pos, out, o_part,
                              ml_part, B, H, S, c_b, c_s, r_b, r_s, scale,
                              splits, s);
  if (R == 256 && RHO == 32 && H <= 48)
    return launch<256, 32, 3>(q_lat, q_rope, c_kv, k_rope, pos, out, o_part,
                              ml_part, B, H, S, c_b, c_s, r_b, r_s, scale,
                              splits, s);
  return (int)cudaErrorInvalidValue;
}
