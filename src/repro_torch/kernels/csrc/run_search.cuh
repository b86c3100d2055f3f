// Run search over a probe-ordered CSR prefix: which run holds probe slot p.
//
// c points at one query's exclusive prefix of run sizes, c[0..S] (c[i] the
// first slot of run i, c[S] the query's take total), non-decreasing. The
// run holding a slot p < c[S] is the first i in [0, S) with c[i + 1] > p.
// Shared by fused_query.cu (its run expansion) and bucket_gather.cu (the
// same expansion, written out).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace runs {

// the run of slot p (p < c[S]) by a 32-way warp search, every lane probing
// one point a round; warp-collective, every lane gets the answer
__device__ inline int find_run(const int32_t* c, int S, int p, int lane) {
  int lo = 0, hi = S;                       // answer in [lo, hi)
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int i = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned b = __ballot_sync(0xffffffffu, c[i + 1] > p);
    const int L = __ffs(b) - 1;             // lane 31 probes hi - 1: true
    const int iL = min(lo + (L + 1) * step - 1, hi - 1);
    lo = L ? lo + L * step : lo;
    hi = iL + 1;
  }
  const int i = lo + lane;
  const unsigned b = __ballot_sync(0xffffffffu, i < hi && c[i + 1] > p);
  return lo + __ffs(b) - 1;
}

// the run holding slot p among runs [lo, hi), for a p it is known to hold:
// the first i there with c[i + 1] > p, by binary search
__device__ __forceinline__ int run_in(const int32_t* c, int p, int lo,
                                      int hi) {
  while (hi - lo > 1) {
    const int mid = (lo + hi - 1) >> 1;
    if (__ldg(c + mid + 1) > p) hi = mid + 1; else lo = mid + 1;
  }
  return lo;
}

// the same answer by galloping from lo: probes lo, lo + 1, lo + 3, lo + 7,
// ... (steps 1, 2, 4, ...) until c[i + 1] > p, then a binary search inside
// the last step. A walk that has just left run lo - 1 finds the next
// non-empty run with one load when it is lo, and crosses a stretch of e
// empty runs in about 2 log2(e) loads.
__device__ __forceinline__ int gallop(const int32_t* c, int p, int lo,
                                      int hi) {
  int step = 1;
  while (lo + step < hi && __ldg(c + lo + step) <= p) {
    lo += step;
    step <<= 1;
  }
  return run_in(c, p, lo, min(lo + step, hi));
}

}  // namespace runs
