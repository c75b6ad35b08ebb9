// fused_march.cu: the whole primary march of each ray, plus its sun-shadow
// march, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel raytracing_test_tpu/kernels/fused_march.py:_fused_kernel
// (Pallas). Its semantics are render/fast.py's, and the plain PyTorch version
// of this kernel is raytracing_test_tpu_torch/render/fast.py
// (fast_march + _shadow_march_fast), which the wrapper in
// kernels/fused_march.py runs for CPU tensors.
//
// What the TPU kernel did only because of the TPU is dropped: MXU one-hot
// table lookups (core/fused_tables.py), bf16 tables, SMEM LUT words, 4096-ray
// tiles, two steps per while trip, and the masked-brick z-run licence. Here
// each trip does one dependent u8 load from grid_enc (core/flatten.py): a
// value < 128 is the cell's material, a value >= 128 licenses an all-air
// Chebyshev box of radius v - 129, which the ray crosses in closed form
// (_aabb_advance_bounds). The palette flags (<= 128 ids) sit in shared
// memory.
//
// What bounds it on this card: a chain of dependent u8 loads per ray from a
// grid that stays resident in the 50 MB L2 (8.4 MB for the default world),
// each trip a few hundred instructions (two IEEE divisions among them), and
// lanes of a warp that wait for its longest ray: a grazing ray or one
// refracted through water takes many trips while its neighbours hit in a
// few, and the sun-shadow march runs on some lanes only. The instructions
// issued, not the bytes, set its time. The design (each step timed against
// the one-thread-per-ray original on the card, PERF.md):
//
//  - Compile-time modes. The kernel is a template on (materials, shadows,
//    prox); the lean and prox launches carry no material or shadow code
//    (9 blocks per SM against the runtime-flag kernel's 7).
//  - Warp tiles. When the rays are a row-major W x H image and the march is
//    long enough for its lanes to matter (the wrapper passes W: frames and
//    the exact seed passes), warp w marches the 8x4 pixel tile w (ray_of):
//    the warp's lanes take more alike paths. Every output is still written
//    at the ray's own index. Otherwise thread j runs ray j, whose stores and
//    loads a warp then makes whole.
//  - One ray per thread, 128 threads per block. Persistent warps that take
//    new rays as their lanes finish (Aila and Laine, HPG 2009) kept 97% of
//    lanes busy but ran 1.6-1.8x slower: the refill's ballots, shuffles and
//    resumable state cost more than the idle lanes they filled.
//
// Prox mode (the reference's prox_stop, fused_march.py:148, :275-278,
// :461-472): the seed march that stops at the first entry into an occupied
// 8^3 brick. The primary loop then reads prox_enc (core/flatten.py:
// build_prox_enc) instead of grid_enc: every value < 128 is a stop cell, the
// reserved code kProxAir marks its air cells and reports material 1, and the
// licences of the other cells are computed with the stop cells as occupied,
// so a box crossing never skips one. The start cell's material (mat0), y_max
// and the sky rule stay those of the real grid. Lean configs only.
//
// Arithmetic: built with -fmad=false and IEEE division/sqrt, every operation
// rounds once, in the same order as the PyTorch version, so DDA near-ties
// resolve identically. The DDA helpers shared with brick_march.cu are in
// dda.cuh.
//
// The per-ray code is plain C++ behind RT_DEV so that a host build of this
// file (without __CUDACC__) can exercise the same logic
// (tests/test_torch_host_kernels.py).

#include "dda.cuh"

#ifdef __CUDACC__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_HD inline
#endif

namespace rt {

constexpr int kIterCap = 2048;   // loop guard; the step budgets end marches first
constexpr int kMaxMat = 128;     // material ids fit 7 bits (grid_enc)
constexpr int kProxAir = 127;    // prox_enc: air cell of an occupied brick
constexpr int kLiquid = 0x10;
constexpr int kRefractive = 0x4;
constexpr float kIorWater = 1.1f;
constexpr float kEpsDir = 1e-12f;
// one warp's pixels when the rays are an image: kTileW x kTileH
constexpr int kTileW = 8, kTileH = 32 / kTileW;

struct Params {
  const uint8_t* grid_enc;  // [sx, sy, sz]
  const uint8_t* prox_enc;  // [sx, sy, sz], read by the primary loop in prox mode
  int sx, sy, sz, y_max;
  int budget, shadow_budget;
  float time_s;
  float sun[3];  // normalised sun direction (not sanitised)
  // initial state (render/fast.py:_init_state), [n, 3] or [n]
  const int32_t* cell0;
  const float *tmax0, *dir0, *step0, *abs0, *org0;
  int n;
  int width;  // > 0: the rays are a row-major image this wide (n % width == 0)
  // outputs
  int32_t *mat0, *mat, *cell, *la, *refl, *shad, *steps;
  float *dir, *step, *seg, *lt, *cmod;
};

// Work items of a launch: one per ray, or 32 per 8x4 tile of the image.
RT_HD int work_items(const Params& P) {
  if (P.width <= 0) return P.n;
  const int h = P.n / P.width;
  return ((P.width + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH) * 32;
}

// The ray of work item j, or -1 (a tile's pixel past the image's edge):
// item j is lane j % 32 of tile j / 32, tiles row-major over the image
// (kernels/fused_march.py:tile_order).
RT_HD int ray_of(const Params& P, int j) {
  if (P.width <= 0) return j < P.n ? j : -1;
  const int tiles_x = (P.width + kTileW - 1) / kTileW;
  const int w = j >> 5, l = j & 31;
  const int x = (w % tiles_x) * kTileW + (l % kTileW);
  const int y = (w / tiles_x) * kTileH + (l / kTileW);
  return (x < P.width && y < P.n / P.width) ? y * P.width + x : -1;
}

RT_DEV int gather_enc(const Params& P, const uint8_t* grid, const int c[3]) {
  const int wx = c[0] & 1023, wy = c[1] & 1023, wz = c[2] & 1023;
  if (wx < P.sx && wy < P.sy && wz < P.sz) {
    const size_t lin = ((size_t)wx * P.sy + wy) * P.sz + wz;
    return (int)RT_LDG(grid + lin);
  }
  return 129;  // outside the window: air, minimal licence
}

// renderer._build_ray on one component
RT_DEV void build_ray(float din, float& d, float& s, float& delta, float& a) {
  d = fabsf(din) < kEpsDir ? kEpsDir : din;
  s = d < 0.0f ? -1.0f : 1.0f;
  delta = 1.0f / d;
  a = fabsf(delta);
}

// renderer._init_tmax on one component
RT_DEV float init_tmax(float p, int c, float s, float delta, float a) {
  const float shifted = p + fminf(s, 0.0f);
  return a - (shifted - (float)c) * delta;
}

// Exit rules of fast._march_body, then the box bounds for the advance.
// Returns true when the ray leaves for good (outside moving away, or sky).
RT_DEV bool exit_or_bounds(const Params& P, const Dda& r, int enc, int lo[3], int hi[3]) {
  const int S[3] = {P.sx, P.sy, P.sz};
  bool inside = true, away = false;
  bool op[3], on[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    op[k] = r.c[k] >= S[k];
    on[k] = r.c[k] < 0;
    inside = inside && !(op[k] || on[k]);
    away = away || (op[k] && r.s[k] > 0.0f) || (on[k] && r.s[k] < 0.0f);
  }
  const bool sky = r.c[1] > P.y_max && r.s[1] > 0.0f;
  if (away || sky) return true;
  const int rad = enc - 129 > 0 ? enc - 129 : 0;  // licence radius (0 => one step)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = inside ? r.c[k] - rad : (op[k] ? S[k] : -kBig);
    hi[k] = inside ? r.c[k] + rad : (on[k] ? -1 : kBig);
  }
  return false;
}

// renderer.material_step for one ray that is at a reflective or refractive cell.
RT_DEV void material_step(const Params& P, Dda& r, float d[3], float o[3], float cm[3],
                          float& ior, bool is_refl, bool is_refr, int fl) {
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = o[k] + r.lt * d[k];

  if (is_refl) {  // reflectRay, low_res.frag:178-194
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k == r.la) {
        d[k] = -d[k];
        r.s[k] = -r.s[k];
        r.t[k] = r.t[k] - r.a[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = p[k] - r.lt * d[k];
      cm[k] = cm[k] * 0.94f;
    }
  }
  if (is_refr) {  // refractRay, low_res.frag:198-240
    const bool liquid = (fl & kLiquid) != 0;
    cm[0] = cm[0] * (liquid ? 0.94f : 0.95f);
    cm[1] = cm[1] * (liquid ? 0.97f : 0.95f);
    cm[2] = cm[2] * (liquid ? 1.0f : 0.95f);
    if (ior != kIorWater) {  // bend at the first refractive contact
      float nv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) nv[k] = (k == r.la ? 1.0f : 0.0f) * r.s[k];
      if (liquid) {
        const float wob = sinf((P.time_s + p[0] * 0.2f - p[2] * 0.1f) * 10.0f) * 0.2f;
        nv[0] = nv[0] + wob;
      }
      const float nn = sqrtf(nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2]);
      const float den = nn > 0.0f ? nn : 1.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) nv[k] = nv[k] / den;
      const float rr = ior / kIorWater;
      float c1 = nv[0] * d[0] + nv[1] * d[1] + nv[2] * d[2];
      if (c1 < 0.0f) {
#pragma unroll
        for (int k = 0; k < 3; ++k) nv[k] = -nv[k];
      }
      c1 = fabsf(c1);
      float q = 1.0f - rr * rr * (1.0f - c1 * c1);
      q = q < 0.0f ? 0.0f : q;
      const float c2 = sqrtf(q);
      const float kk = rr * c1 - c2;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float delta;
        build_ray(rr * d[k] + kk * nv[k], d[k], r.s[k], delta, r.a[k]);
        r.t[k] = init_tmax(p[k], r.c[k], r.s[k], delta, r.a[k]);
        o[k] = p[k];
      }
      r.lt = 0.0f;
    }
    ior = kIorWater;
  }
}

// _shadow_march_fast for one ray from the hit point p in cell c, leaving
// through face la. Returns true when a non-liquid block (or liquid at the
// budget) blocks the sun.
RT_DEV bool shadow_march(const Params& P, const int* flags_s, const float p[3],
                         const int c[3], int la) {
  Dda r;
  float delta[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float d;
    build_ray(P.sun[k], d, r.s[k], delta[k], r.a[k]);
    r.c[k] = c[k];
    r.t[k] = init_tmax(p[k], c[k], r.s[k], delta[k], r.a[k]);
    if (k == la) r.t[k] = r.t[k] - r.a[k];  // step out through the hit face (frag:380)
  }
  // the shadow loop starts by stepping: the hit block itself is not re-tested
  const int ax = argmin_axis(r.t[0], r.t[1], r.t[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k == ax) {
      r.lt = r.t[k];
      r.c[k] += (int)r.s[k];
      r.t[k] = r.t[k] + r.a[k];
    }
  }
  r.la = ax;
  r.steps = 1;

  int mat = 0;
  for (int it = 0; it < kIterCap; ++it) {
    const int enc = gather_enc(P, P.grid_enc, r.c);
    const int m = enc < kMaxMat ? enc : 0;
    mat = m;
    if (m != 0 && (flags_s[m] & kLiquid) == 0) break;  // occluder
    int lo[3], hi[3];
    if (exit_or_bounds(P, r, enc, lo, hi)) break;
    aabb_advance(r, lo, hi);
    if (r.steps >= P.shadow_budget) break;
  }
  return mat != 0;
}

// The whole per-ray program: start-cell specials, primary march with the
// reflect/refract state machine, then the sun-shadow march. The modes are
// compile-time: kMaterials (reflect/refract), kShadows, kProx (the loop reads
// prox_enc; lean only).
template <bool kMaterials, bool kShadows, bool kProx>
RT_DEV void march_ray(const Params& P, const int* flags_s, int i) {
  Dda r;
  float d[3], o[3], cm[3] = {1.0f, 1.0f, 1.0f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.c[k] = P.cell0[3 * i + k];
    r.t[k] = P.tmax0[3 * i + k];
    d[k] = P.dir0[3 * i + k];
    r.s[k] = P.step0[3 * i + k];
    r.a[k] = P.abs0[3 * i + k];
    o[k] = P.org0[3 * i + k];
  }
  r.la = 0;
  r.lt = 0.0f;
  r.steps = 0;

  // start-cell specials (frag:299-307)
  const int enc0 = gather_enc(P, P.grid_enc, r.c);
  const int mat0 = enc0 < kMaxMat ? enc0 : 0;
  const bool refr0 = (flags_s[mat0] & kRefractive) != 0;
  const bool raw0 = mat0 != 0 && !refr0;
  float ior = (mat0 != 0 && refr0) ? kIorWater : 1.0f;
  bool refl = false;
  int mat = raw0 ? mat0 : 0;

  if (!raw0) {
    const uint8_t* grid = kProx ? P.prox_enc : P.grid_enc;
    for (int it = 0; it < kIterCap; ++it) {
      const int enc = gather_enc(P, grid, r.c);
      const int m = enc < kMaxMat ? (kProx && enc == kProxAir ? 1 : enc) : 0;
      const int fl = flags_s[m];
      const int f7 = fl & 0x7;
      const bool solid = m != 0;
      const bool is_refl = kMaterials && solid && f7 == 0x3;
      const bool is_refr = kMaterials && solid && f7 == 0x5;
      mat = m;
      if (solid && !is_refl && !is_refr) break;  // hit
      if (is_refl || is_refr) {
        material_step(P, r, d, o, cm, ior, is_refl, is_refr, fl);
        refl = refl || is_refl;
      }
      int lo[3], hi[3];
      if (exit_or_bounds(P, r, enc, lo, hi)) break;
      aabb_advance(r, lo, hi);
      if (r.steps >= P.budget) break;  // budget freeze
    }
  }

  // sun shadow, for the lanes renderer.shade reads it on: hit (including
  // budget-frozen lanes inside a refractive block), facing the sun, not
  // reflected, not started inside a solid
  bool shad = false;
  if (kShadows && mat != 0 && !raw0 && !refl) {
    const float lam = sel3(P.sun, r.la) * -sel3(r.s, r.la);
    if (lam > 0.0f) {
      float p[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = o[k] + r.lt * d[k];
      shad = shadow_march(P, flags_s, p, r.c, r.la);
    }
  }

  P.mat0[i] = mat0;
  P.mat[i] = mat;
  P.la[i] = r.la;
  P.refl[i] = refl ? 1 : 0;
  P.shad[i] = shad ? 1 : 0;
  P.steps[i] = r.steps;
  P.lt[i] = r.lt;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    P.cell[3 * i + k] = r.c[k];
    P.dir[3 * i + k] = d[k];
    P.step[3 * i + k] = r.s[k];
    P.seg[3 * i + k] = o[k];
    P.cmod[3 * i + k] = cm[k];
  }
}

}  // namespace rt

#ifdef __CUDACC__

constexpr int kThreads = 128;
// Launch bounds: with no bound ptxas gave the full mode 64 registers and a
// spill, which ran slower; bounded to 128-thread blocks it holds the state
// in 72 registers without one. A minimum of 6 blocks per SM for the modes
// with materials ran 1-2% faster than a minimum of 1 (PERF.md).
constexpr int kMinBlocksMaterials = 6;

template <bool kMaterials, bool kShadows, bool kProx>
__global__ void __launch_bounds__(kThreads, kMaterials ? kMinBlocksMaterials : 1)
fused_march_kernel(rt::Params P, const int32_t* __restrict__ flags, int n_flags) {
  __shared__ int flags_s[rt::kMaxMat];
  for (int j = threadIdx.x; j < rt::kMaxMat; j += blockDim.x) {
    flags_s[j] = j < n_flags ? flags[j] : 0;
  }
  __syncthreads();
  const int i = rt::ray_of(P, blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= 0) rt::march_ray<kMaterials, kShadows, kProx>(P, flags_s, i);
}

namespace {

template <bool M, bool S, bool X>
int blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_march_kernel<M, S, X>, kThreads, 0);
  return blocks;
}

template <bool M, bool S, bool X>
int launch(const rt::Params& P, const int32_t* flags, int n_flags, cudaStream_t stream) {
  const int blocks = (rt::work_items(P) + kThreads - 1) / kThreads;
  fused_march_kernel<M, S, X><<<blocks, kThreads, 0, stream>>>(P, flags, n_flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: bit 0 materials, bit 1 shadows, or 4 for prox (lean only).
extern "C" int fused_march_blocks_per_sm(int mode) {
  switch (mode) {
    case 0: return blocks_per_sm<false, false, false>();
    case 1: return blocks_per_sm<true, false, false>();
    case 2: return blocks_per_sm<false, true, false>();
    case 3: return blocks_per_sm<true, true, false>();
    case 4: return blocks_per_sm<false, false, true>();
    default: return -1;
  }
}

extern "C" int fused_march_threads() { return kThreads; }

extern "C" int fused_march_launch(
    const void* grid_enc, const void* prox_enc, int prox, const void* flags, int n_flags,
    int sx, int sy, int sz, int y_max,
    int budget, int shadow_budget, int enable_materials, int enable_shadows,
    float time_s, float sun_x, float sun_y, float sun_z,
    const void* cell0, const void* tmax0, const void* dir0, const void* step0,
    const void* abs0, const void* org0,
    int n, int width,
    void* o_mat0, void* o_mat, void* o_cell, void* o_la, void* o_refl, void* o_shad,
    void* o_steps, void* o_dir, void* o_step, void* o_seg, void* o_lt, void* o_cmod,
    void* stream) {
  if (n <= 0) return 0;
  if (width < 0 || (width > 0 && n % width != 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (prox && (enable_materials || enable_shadows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rt::Params P;
  P.grid_enc = static_cast<const uint8_t*>(grid_enc);
  P.prox_enc = static_cast<const uint8_t*>(prox_enc);
  P.sx = sx; P.sy = sy; P.sz = sz; P.y_max = y_max;
  P.budget = budget; P.shadow_budget = shadow_budget;
  P.time_s = time_s;
  P.sun[0] = sun_x; P.sun[1] = sun_y; P.sun[2] = sun_z;
  P.cell0 = static_cast<const int32_t*>(cell0);
  P.tmax0 = static_cast<const float*>(tmax0);
  P.dir0 = static_cast<const float*>(dir0);
  P.step0 = static_cast<const float*>(step0);
  P.abs0 = static_cast<const float*>(abs0);
  P.org0 = static_cast<const float*>(org0);
  P.n = n;
  P.width = width;
  P.mat0 = static_cast<int32_t*>(o_mat0);
  P.mat = static_cast<int32_t*>(o_mat);
  P.cell = static_cast<int32_t*>(o_cell);
  P.la = static_cast<int32_t*>(o_la);
  P.refl = static_cast<int32_t*>(o_refl);
  P.shad = static_cast<int32_t*>(o_shad);
  P.steps = static_cast<int32_t*>(o_steps);
  P.dir = static_cast<float*>(o_dir);
  P.step = static_cast<float*>(o_step);
  P.seg = static_cast<float*>(o_seg);
  P.lt = static_cast<float*>(o_lt);
  P.cmod = static_cast<float*>(o_cmod);
  const auto* fl = static_cast<const int32_t*>(flags);
  auto s = static_cast<cudaStream_t>(stream);
  if (prox) return launch<false, false, true>(P, fl, n_flags, s);
  switch (enable_materials * 1 + enable_shadows * 2) {
    case 0: return launch<false, false, false>(P, fl, n_flags, s);
    case 1: return launch<true, false, false>(P, fl, n_flags, s);
    case 2: return launch<false, true, false>(P, fl, n_flags, s);
    default: return launch<true, true, false>(P, fl, n_flags, s);
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // __CUDACC__
