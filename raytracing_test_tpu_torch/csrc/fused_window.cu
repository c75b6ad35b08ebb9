// fused_window.cu: the guided 24-step window render of the differentiable
// renderer, forward and backward, one ray per thread (two in the forward
// below one wave of rays), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pair of raytracing_test_tpu/kernels/fused_window.py:
// _fwd_kernel (:324) and _bwd_kernel (:417). The plain PyTorch version of both
// is window_plain in raytracing_test_tpu_torch/kernels/fused_window.py (its
// backward is autograd's), which the wrapper there runs for CPU tensors.
//
// Forward (window_fwd): from the seed cell, enumerate S DDA crossings with the
// reference tie-break (x iff strictly smallest, else y if y < z, else z);
// dt = max(t_n - t_cur, 0); the cell wraps & 1023 and a cell outside the grid
// is air. Each sample reads its (sigma, r, g, b) row with one 16-byte load and
// composites e = exp(-sigma dt), w = T (1 - e), T *= e; with shading, w is
// scaled by the face intensity of the sample's entry axis (step 0 takes it
// from argmin(tmax - abs_delta), later steps from the previous exit axis).
// Outputs: surface rgb, T_end, w_sum and t_exp (the expected-hit-point sums
// that drive the soft shadow outside the kernel).
//
// Backward (window_bwd): re-march the same window and re-gather sigma and the
// albedo from the field. With Total = surf . g_surf (a forward output), the
// suffix sum of the reverse sweep is Total - prefix, so one forward pass
// gives g_od = T e A - (Total - prefix) - T_end g_T per sample. The field
// gradient (g_od dt, w g_rgb I) goes into a zeroed [V, 4] field: each run
// of neighbouring lanes of a warp that hit the same row sums with a
// segmented tree of shuffles, then its first lane adds the row with one
// float4 atomicAdd (out-of-grid rows skipped). A surface cell near the bench
// camera takes thousands of contributions; one chain of float atomics per
// row drifts further from the exact sum than the plain version's
// accumulation does; the trees stay close to it and need fewer atomics. The
// tmax and
// abs_delta cotangents follow the crossing recurrence t = tmax_a + k abs_a
// with the one-step-delayed exit-axis subtraction of the TPU kernel. The
// clamp in dt passes its gradient whole, as the TPU kernel does.
//
// What the TPU kernel did only because of the TPU is dropped: the 32x32x64
// field boxes and their bit-packed SMEM origins, hi+lo bf16 one-hot matmul
// fetches and scatters, the 8x32 strip permutation, the escape fallback, the
// four [S*N] residual planes (a re-gather from L2/HBM is cheaper than 400 MB
// of residuals at 1024^2 x 24), and the lossy 1e-6 transmittance early-out:
// every ray runs all S steps, so the result is exact.
//
// What bounds it on this card: the field rows a window touches (16 bytes per
// sample, neighbouring rays share most cells, so L2 serves most of them), the
// per-ray planes, and in the backward the zero-filled 134 MB gradient field
// of the default world. The arithmetic per sample is a few dozen flops and
// one exp; the backward adds its warp reduction, which issues about as many
// instructions again: the kernels are bound by instructions issued, not by
// bytes. Rays in natural (row-major) order so a warp marches neighbouring
// pixels through neighbouring cells and its lanes on one row sit side by
// side. A training batch's forward (less than one wave) waits instead on
// its chain of row loads, longer inside a train step than back to back
// (PERF.md).
//
// The backward's design for this card (each step timed against the
// one-thread-per-ray original on the card, PERF.md): the peers of a row
// are found as runs of neighbouring lanes (one shuffle and one ballot)
// rather than with __match_any_sync, and each run's row goes to memory as
// one float4 atomicAdd (sm_90) rather than four scalar ones. Loading the
// rows of the next samples ahead of their use (their cells follow from the
// DDA alone) was slower: its registers cost occupancy at 1024^2, and a
// training batch of less than a wave gained nothing from it.
//
// The forward's design for this card (each step timed against the kernel
// it replaced on the card, PERF.md): a sample's cell follows from the DDA
// alone, and no row load feeds the next cell, so the rows of a ray's
// samples can all be in flight at once. With the window's length a
// compile-time constant (kFixedS, the training path's 24 steps; other
// lengths run the generic loop) the loop unrolls and the loads issue ahead
// of their use. A launch of less than one wave of rays (a training batch:
// 64 or 128 blocks on 132 SMs) splits each ray over kSplit neighbouring
// lanes: lane k walks the DDA to its share of the samples, loads those rows
// and takes their exponentials at once, and the lanes then composite in
// sample order, each passing its running sums to the next with shuffles, so
// every sum rounds as in the one-lane loop. Two lanes a ray (12 loads in
// flight each) beat one (all 24), four and eight at both batch sizes.
//
// Arithmetic: built with -fmad=false; every expression keeps the plain
// version's operation order, so forward values agree to the last bits of
// expf.
//
// The per-ray code is plain C++ behind RT_DEV so that a host build of this
// file (without __CUDACC__) can exercise the same logic.

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
struct float4 {
  float x, y, z, w;
};
#endif

namespace rtw {

struct Params {
  const float4* field;  // [sx * sy * sz] rows (sigma, r, g, b)
  int sx, sy, sz;
  int n, S, shading;
  float sun[3];          // unit sun vector
  const int32_t* cell;   // [n, 3] seed cell
  const float* tmax;     // [n, 3] first crossing per axis
  const int32_t* istep;  // [n, 3] +-1
  const float* absd;     // [n, 3] |1 / dir|
};

RT_DEV float sel3(const float v[3], int k) { return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]); }

RT_DEV int argmin_axis(float tx, float ty, float tz) {
  return (tx < ty && tx < tz) ? 0 : (ty < tz ? 1 : 2);
}

// DDA state of one ray's window.
struct Ray {
  int c[3], is[3];
  float t[3], a[3];
  float I[3];  // face intensity per entry axis
  int entry;   // entry axis of the current sample
  float t_cur;
};

RT_DEV void load_ray(const Params& P, int i, Ray& r) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.c[k] = P.cell[3 * i + k];
    r.t[k] = P.tmax[3 * i + k];
    r.is[k] = P.istep[3 * i + k];
    r.a[k] = P.absd[3 * i + k];
    // calcLightIntensity + back-face rule: the entry face normal is -step
    const float lam = P.sun[k] * -(float)r.is[k];
    r.I[k] = lam > 0.0f ? fminf(lam + 0.55f, 1.0f) : 0.3f;
  }
  r.entry = argmin_axis(r.t[0] - r.a[0], r.t[1] - r.a[1], r.t[2] - r.a[2]);
  r.t_cur = 0.0f;
}

// The advance of one crossing, without its sample. Returns the exit axis.
RT_DEV int advance(Ray& r) {
  const int ax = argmin_axis(r.t[0], r.t[1], r.t[2]);
  const float tn = sel3(r.t, ax);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k == ax) {
      r.c[k] += r.is[k];
      r.t[k] = r.t[k] + r.a[k];
    }
  }
  r.t_cur = tn;
  return ax;
}

// One crossing: the sample's segment length, its field row (zero outside the
// grid), then the advance. Returns the exit axis.
RT_DEV int step(const Params& P, Ray& r, float& dt, float4& f, size_t& lin, bool& inside) {
  const int ax = argmin_axis(r.t[0], r.t[1], r.t[2]);
  const float tn = sel3(r.t, ax);
  const float d = tn - r.t_cur;
  dt = d > 0.0f ? d : 0.0f;
  const int wx = r.c[0] & 1023, wy = r.c[1] & 1023, wz = r.c[2] & 1023;
  inside = wx < P.sx && wy < P.sy && wz < P.sz;
  lin = ((size_t)wx * P.sy + wy) * P.sz + wz;
  if (inside) {
    f = RT_LDG(P.field + lin);
  } else {
    f.x = 0.0f; f.y = 0.0f; f.z = 0.0f; f.w = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k == ax) {
      r.c[k] += r.is[k];
      r.t[k] = r.t[k] + r.a[k];
    }
  }
  r.t_cur = tn;
  return ax;
}

// The forward's running sums, in sample order.
struct Acc {
  float T, acc0, acc1, acc2, ws, te, tc;
};

RT_DEV Acc acc_start() { return Acc{1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}; }

// One sample into the running sums: e = exp(-sigma dt), the sample's row f
// and the face intensity of its entry axis.
RT_DEV void composite(const Params& P, float e, float dt, const float4& f, float inten, Acc& a) {
  const float w = a.T * (1.0f - e);
  const float wi = P.shading ? w * inten : w;
  a.acc0 = a.acc0 + wi * f.y;
  a.acc1 = a.acc1 + wi * f.z;
  a.acc2 = a.acc2 + wi * f.w;
  a.ws = a.ws + w;
  a.te = a.te + w * (a.tc + 0.5f * dt);
  a.tc = a.tc + dt;
  a.T = a.T * e;
}

RT_DEV void write_out(const Acc& a, int i, float* surf, float* t_end, float* w_sum,
                      float* t_exp) {
  surf[3 * i + 0] = a.acc0;
  surf[3 * i + 1] = a.acc1;
  surf[3 * i + 2] = a.acc2;
  t_end[i] = a.T;
  w_sum[i] = a.ws;
  t_exp[i] = a.te;
}

// One ray's window on one lane: kS > 0 samples (unrolled, the loads issue
// ahead of their use), or kS = 0 for P.S samples.
template <int kS = 0>
RT_DEV void forward_ray(const Params& P, int i, float* surf, float* t_end, float* w_sum,
                        float* t_exp) {
  Ray r;
  load_ray(P, i, r);
  Acc a = acc_start();
  const int S = kS > 0 ? kS : P.S;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int entry = r.entry;
    float dt;
    float4 f;
    size_t lin;
    bool inside;
    r.entry = step(P, r, dt, f, lin, inside);
    composite(P, expf(-f.x * dt), dt, f, sel3(r.I, entry), a);
  }
  write_out(a, i, surf, t_end, w_sum, t_exp);
}

// One lane's share of a ray's window in the split forward: the kC samples
// from sample ``first`` on, each with its row, exponential, segment length
// and entry-face intensity.
template <int kC>
struct Share {
  float4 f[kC];
  float e[kC], dt[kC], inten[kC];
};

// Walk the DDA to sample ``first``, then take the share's samples: every
// row is loaded before the first exponential needs one.
template <int kC>
RT_DEV void load_share(const Params& P, int i, int first, Share<kC>& sh) {
  Ray r;
  load_ray(P, i, r);
  for (int s = 0; s < first; ++s) r.entry = advance(r);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    sh.inten[c] = sel3(r.I, r.entry);
    size_t lin;
    bool inside;
    r.entry = step(P, r, sh.dt[c], sh.f[c], lin, inside);
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) sh.e[c] = expf(-sh.f[c].x * sh.dt[c]);
}

template <int kC>
RT_DEV void composite_share(const Params& P, const Share<kC>& sh, Acc& a) {
#pragma unroll
  for (int c = 0; c < kC; ++c) composite(P, sh.e[c], sh.dt[c], sh.f[c], sh.inten[c], a);
}

#ifdef __CUDACC__
// Sum a, b, c, d over each run of neighbouring lanes with the same ``key``
// (field row) as a segmented tree of shuffles; the first lane of a run ends
// with the run's sums and gets true. Every lane of the warp must call it.
__device__ __forceinline__ bool reduce_runs(unsigned key, float& a, float& b, float& c,
                                            float& d) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned prev = __shfl_up_sync(0xFFFFFFFFu, key, 1);  // every lane takes part
  const bool head = lane == 0 || key != prev;
  const unsigned long long heads = __ballot_sync(0xFFFFFFFFu, head);
  for (unsigned dd = 1; dd < 32; dd <<= 1) {
    // lane + dd is in this lane's run when no run starts in (lane, lane + dd]
    const bool add = lane + dd < 32 &&
                     (heads & ((1ull << (lane + dd + 1)) - (1ull << (lane + 1)))) == 0;
    if (!__any_sync(0xFFFFFFFFu, add)) break;
    const float ta = __shfl_down_sync(0xFFFFFFFFu, a, dd);
    const float tb = __shfl_down_sync(0xFFFFFFFFu, b, dd);
    const float tc = __shfl_down_sync(0xFFFFFFFFu, c, dd);
    const float td = __shfl_down_sync(0xFFFFFFFFu, d, dd);
    if (add) {
      a += ta;
      b += tb;
      c += tc;
      d += td;
    }
  }
  return head;
}
#endif

// Add a gradient row: on the card one float4 atomicAdd (sm_90; adding +0.0
// leaves a component as it is), on the host a plain sum.
RT_DEV void add_row(float* row, float v0, float v1, float v2, float v3) {
#ifdef __CUDA_ARCH__
  atomicAdd(reinterpret_cast<float4*>(row), make_float4(v0, v1, v2, v3));
#else
  row[0] += v0;
  row[1] += v1;
  row[2] += v2;
  row[3] += v3;
#endif
}

// ``valid`` is false for the padding lanes of the last warp: they march ray
// i with zero cotangents (so they add nothing) and write nothing, but stay in
// the warp for the shuffles.
RT_DEV void backward_ray(const Params& P, int i, bool valid, const float* g_surf,
                         const float* g_tend, const float* surf, const float* t_end,
                         float* grad, float* g_tmax, float* g_abs) {
  Ray r;
  load_ray(P, i, r);
  const float gr = valid ? g_surf[3 * i + 0] : 0.0f;
  const float gg = valid ? g_surf[3 * i + 1] : 0.0f;
  const float gb = valid ? g_surf[3 * i + 2] : 0.0f;
  const float total = surf[3 * i + 0] * gr + surf[3 * i + 1] * gg + surf[3 * i + 2] * gb;
  const float tg = valid ? t_end[i] * g_tend[i] : 0.0f;
  float T = 1.0f, prefix = 0.0f;
  float pfm[3] = {0.0f, 0.0f, 0.0f}, pq[3] = {0.0f, 0.0f, 0.0f};
  float pt[3] = {0.0f, 0.0f, 0.0f}, pa[3] = {0.0f, 0.0f, 0.0f};
  int cc[3] = {0, 0, 0};
  for (int s = 0; s < P.S; ++s) {
    const int entry = r.entry;
    float dt;
    float4 f;
    size_t lin;
    bool inside;
    const int ax = step(P, r, dt, f, lin, inside);
    r.entry = ax;
    const float e = expf(-f.x * dt);
    const float w = T * (1.0f - e);
    const float inten = P.shading ? sel3(r.I, entry) : 1.0f;
    const float A = (f.y * gr + f.z * gg + f.w * gb) * inten;
    prefix = prefix + w * A;
    // g_od = T e A - suffix - T_end g_T, with suffix = Total - prefix (incl. s)
    const float g_od = T * e * A - (total - prefix) - tg;
    float v0 = g_od * dt;
    float v1 = w * gr * inten, v2 = w * gg * inten, v3 = w * gb * inten;
    bool lead = inside;
#ifdef __CUDACC__
    // neighbouring lanes on the same row sum first: one atomic per run, and
    // a tree instead of a long chain of float additions
    lead = reduce_runs(inside ? (unsigned)lin : 0xFFFFFFFFu, v0, v1, v2, v3) && inside;
#endif
    if (lead) add_row(grad + 4 * lin, v0, v1, v2, v3);
    // dL/d dt_s = g_od sigma_s; step s's crossing value is tmax_a + c_a abs_a
    // on its exit axis a, and dt_{s+1} subtracts it again
    const float h = g_od * f.x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float fm = k == ax ? 1.0f : 0.0f;
      const float q = fm * (float)cc[k];
      pt[k] = pt[k] + h * (fm - pfm[k]);
      pa[k] = pa[k] + h * (q - pq[k]);
      pfm[k] = fm;
      pq[k] = q;
      cc[k] += k == ax ? 1 : 0;
    }
    T = T * e;
  }
  if (!valid) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_tmax[3 * i + k] = pt[k];
    g_abs[3 * i + k] = pa[k];
  }
}

}  // namespace rtw

#ifdef __CUDACC__

// window_bwd's block: 128 threads for a launch of at most one wave of them
// (the training batches), 64 above (the 1024^2 frame): measured faster each
// at its size than the other
constexpr int kThreads = 128;
constexpr int kBwdSmall = 128, kBwdLarge = 64;
constexpr int kMaxDevices = 64;
// window_fwd: the window length with an unrolled kernel (NUM_STEPS of the
// training path), and the lanes per ray below one wave of rays
constexpr int kFixedS = 24;
constexpr int kSplit = 2;
static_assert(kFixedS % kSplit == 0 && 32 % kSplit == 0, "a ray's lanes share its samples evenly");

template <int kS>
__global__ void __launch_bounds__(kThreads)
window_fwd_kernel(rtw::Params P, float* surf, float* t_end, float* w_sum, float* t_exp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P.n) rtw::forward_ray<kS>(P, i, surf, t_end, w_sum, t_exp);
}

// kK lanes per ray (below one wave of rays): lane k of a ray loads and
// exponentiates samples [k kS / kK, (k + 1) kS / kK), then the lanes
// composite in turn, lane k taking lane k - 1's running sums by a shuffle.
// Padding lanes of the last warp march the last ray and write nothing.
template <int kS, int kK>
__global__ void __launch_bounds__(kThreads)
window_fwd_split_kernel(rtw::Params P, float* surf, float* t_end, float* w_sum, float* t_exp) {
  constexpr int kC = kS / kK;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int ray = t / kK, sub = t % kK;
  const int i = ray < P.n ? ray : P.n - 1;
  rtw::Share<kC> sh;
  rtw::load_share<kC>(P, i, sub * kC, sh);
  rtw::Acc a = rtw::acc_start();
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (sub == k) rtw::composite_share<kC>(P, sh, a);
    if (k + 1 < kK) {  // every lane takes part; lane k + 1 keeps what it gets
      a.T = __shfl_up_sync(0xFFFFFFFFu, a.T, 1, kK);
      a.acc0 = __shfl_up_sync(0xFFFFFFFFu, a.acc0, 1, kK);
      a.acc1 = __shfl_up_sync(0xFFFFFFFFu, a.acc1, 1, kK);
      a.acc2 = __shfl_up_sync(0xFFFFFFFFu, a.acc2, 1, kK);
      a.ws = __shfl_up_sync(0xFFFFFFFFu, a.ws, 1, kK);
      a.te = __shfl_up_sync(0xFFFFFFFFu, a.te, 1, kK);
      a.tc = __shfl_up_sync(0xFFFFFFFFu, a.tc, 1, kK);
    }
  }
  if (ray < P.n && sub == kK - 1) rtw::write_out(a, i, surf, t_end, w_sum, t_exp);
}

template <int kBwdThreads>
__global__ void __launch_bounds__(kBwdThreads)
window_bwd_kernel(rtw::Params P, const float* g_surf, const float* g_tend, const float* surf,
                  const float* t_end, float* grad, float* g_tmax, float* g_abs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  rtw::backward_ray(P, i < P.n ? i : P.n - 1, i < P.n, g_surf, g_tend, surf, t_end, grad,
                    g_tmax, g_abs);
}

static rtw::Params make_params(const void* field, int sx, int sy, int sz, const void* cell,
                               const void* tmax, const void* istep, const void* absd, int n,
                               int S, int shading, float sun_x, float sun_y, float sun_z) {
  rtw::Params P;
  P.field = static_cast<const float4*>(field);
  P.sx = sx; P.sy = sy; P.sz = sz;
  P.n = n; P.S = S; P.shading = shading;
  P.sun[0] = sun_x; P.sun[1] = sun_y; P.sun[2] = sun_z;
  P.cell = static_cast<const int32_t*>(cell);
  P.tmax = static_cast<const float*>(tmax);
  P.istep = static_cast<const int32_t*>(istep);
  P.absd = static_cast<const float*>(absd);
  return P;
}

// Rays in one wave of window_bwd's small blocks on the current device (its
// SMs x resident blocks x threads). It depends on the card alone, so each
// device's value is computed at its first launch and kept.
static int small_wave_rays() {
  static int wave[kMaxDevices] = {};  // 0: not computed yet
  int dev = 0;
  cudaGetDevice(&dev);
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && wave[dev] > 0) return wave[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_bwd_kernel<kBwdSmall>,
                                                kBwdSmall, 0);
  const int rays = per_sm * sms * kBwdSmall;
  if (kept) wave[dev] = rays;
  return rays;
}

// Rays in one wave of window_fwd's unrolled one-lane kernel on the current
// device; kept per device like small_wave_rays.
static int fwd_wave_rays() {
  static int wave[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && wave[dev] > 0) return wave[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_fwd_kernel<kFixedS>, kThreads, 0);
  const int rays = per_sm * sms * kThreads;
  if (kept) wave[dev] = rays;
  return rays;
}

// window_fwd: S == kFixedS runs unrolled, split over kSplit lanes a ray when
// the rays fill less than one wave of the one-lane kernel; other S the
// generic loop.
extern "C" int window_fwd_launch(
    const void* field, int sx, int sy, int sz,
    const void* cell, const void* tmax, const void* istep, const void* absd,
    int n, int S, int shading, float sun_x, float sun_y, float sun_z,
    void* surf, void* t_end, void* w_sum, void* t_exp, void* stream) {
  if (n <= 0) return 0;
  const rtw::Params P = make_params(field, sx, sy, sz, cell, tmax, istep, absd, n, S, shading,
                                    sun_x, sun_y, sun_z);
  auto* o_surf = static_cast<float*>(surf);
  auto* o_tend = static_cast<float*>(t_end);
  auto* o_wsum = static_cast<float*>(w_sum);
  auto* o_texp = static_cast<float*>(t_exp);
  auto st = static_cast<cudaStream_t>(stream);
  if (S == kFixedS && n <= fwd_wave_rays()) {
    const long long threads = static_cast<long long>(n) * kSplit;
    window_fwd_split_kernel<kFixedS, kSplit>
        <<<static_cast<int>((threads + kThreads - 1) / kThreads), kThreads, 0, st>>>(
            P, o_surf, o_tend, o_wsum, o_texp);
  } else if (S == kFixedS) {
    window_fwd_kernel<kFixedS><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        P, o_surf, o_tend, o_wsum, o_texp);
  } else {
    window_fwd_kernel<0><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        P, o_surf, o_tend, o_wsum, o_texp);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_bwd_launch(
    const void* field, int sx, int sy, int sz,
    const void* cell, const void* tmax, const void* istep, const void* absd,
    int n, int S, int shading, float sun_x, float sun_y, float sun_z,
    const void* g_surf, const void* g_tend, const void* surf, const void* t_end,
    void* grad, void* g_tmax, void* g_abs, void* stream) {
  if (n <= 0) return 0;
  const rtw::Params P = make_params(field, sx, sy, sz, cell, tmax, istep, absd, n, S, shading,
                                    sun_x, sun_y, sun_z);
  const bool large = n > small_wave_rays();  // more than one wave of small blocks
  const int threads = large ? kBwdLarge : kBwdSmall;
  auto* kernel = large ? window_bwd_kernel<kBwdLarge> : window_bwd_kernel<kBwdSmall>;
  kernel<<<(n + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const float*>(g_surf), static_cast<const float*>(g_tend),
      static_cast<const float*>(surf), static_cast<const float*>(t_end),
      static_cast<float*>(grad), static_cast<float*>(g_tmax), static_cast<float*>(g_abs));
  return static_cast<int>(cudaGetLastError());
}

// Blocks per SM of the forward (which 0: its unrolled one-lane kernel, 3:
// its split kernel, 4: its generic loop) or the backward kernel (which 1:
// its small-launch block, 2: its large-launch block), and (threads !=
// null) the block size.
extern "C" int window_blocks_per_sm(int which, int* threads) {
  int blocks = -1, t = kThreads;
  if (which == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, window_fwd_kernel<kFixedS>, t, 0);
  } else if (which == 3) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, window_fwd_split_kernel<kFixedS, kSplit>, t, 0);
  } else if (which == 4) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, window_fwd_kernel<0>, t, 0);
  } else if (which == 1) {
    t = kBwdSmall;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, window_bwd_kernel<kBwdSmall>, t, 0);
  } else {
    t = kBwdLarge;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, window_bwd_kernel<kBwdLarge>, t, 0);
  }
  if (threads) *threads = t;
  return blocks;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // __CUDACC__
