// dda.cuh: the DDA arithmetic that the march kernels share (fused_march.cu,
// brick_march.cu): the reference's axis tie-break and the closed-form
// crossing of an all-air box (render/fast.py:_aabb_advance_bounds).
//
// Built with -fmad=false and IEEE division, every operation rounds once, in
// the order of the PyTorch version, so DDA near-ties resolve identically.
// The code is plain C++ behind RT_DEV so that a host build (without
// __CUDACC__) can exercise the same logic.

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RT_DEV __device__ __forceinline__
#define RT_LDG(p) __ldg(p)
#else
#define RT_DEV inline
#define RT_LDG(p) (*(p))
#endif

namespace rt {

constexpr int kBig = 1 << 20;    // "infinite" AABB bound (cells)
constexpr int kMaxJump = 512;    // max crossings consumed per bulk advance

RT_DEV int argmin_axis(float tx, float ty, float tz) {
  // x iff strictly smallest, else y iff y < z, else z (renderer._argmin_axis)
  return (tx < ty && tx < tz) ? 0 : (ty < tz ? 1 : 2);
}

RT_DEV float sel3(const float v[3], int k) { return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]); }

// One DDA state: cell, per-axis crossing parameter tmax, step sign and
// |1/dir|, and the last crossing's axis and parameter.
struct Dda {
  int c[3];
  float t[3], s[3], a[3];
  int la;
  float lt;
  int steps;
};

// fast._aabb_advance_bounds for one ray: cross the all-air box [lo, hi].
RT_DEV void aabb_advance(Dda& r, const int lo[3], const int hi[3]) {
  int n[3];
  float te[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int is = r.s[k] > 0.0f ? 1 : -1;
    int nk = is > 0 ? hi[k] + 1 - r.c[k] : r.c[k] - lo[k] + 1;
    nk = nk < 1 ? 1 : (nk > kMaxJump ? kMaxJump : nk);
    n[k] = nk;
    te[k] = r.t[k] + (float)(nk - 1) * r.a[k];
  }
  const int m = argmin_axis(te[0], te[1], te[2]);
  const float tm = sel3(te, m);
  int total = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int ck;
    if (k == m) {
      ck = n[k];
    } else {
      ck = tm >= r.t[k] ? (int)floorf((tm - r.t[k]) / r.a[k]) + 1 : 0;
      ck = ck < n[k] - 1 ? ck : n[k] - 1;  // stay inside the box on non-exit axes
    }
    ck = ck > 0 ? ck : 0;
    r.c[k] += ck * (r.s[k] > 0.0f ? 1 : -1);
    r.t[k] = r.t[k] + (float)ck * r.a[k];
    total += ck;
  }
  r.la = m;
  r.lt = tm;
  r.steps += total;
}

}  // namespace rt
