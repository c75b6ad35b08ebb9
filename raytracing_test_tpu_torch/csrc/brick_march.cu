// brick_march.cu: the two kernels of the brick engine, one thread per ray,
// for NVIDIA Hopper (sm_90a).
//
//   brick_advance replaces raytracing_test_tpu/kernels/brick_kernels.py:_brick_kernel
//     (Pallas, :100): the brick phase of one round. Each iteration reads the
//     brick-level Chebyshev distance with one u8 load of brick_dist (or
//     brick_dist_shadow) and crosses the certified all-air box of radius
//     d - 1 bricks (or the slab outside the window) in closed form.
//   brick_fine replaces _fine_kernel (:235): single DDA steps inside the
//     occupied brick blin, the voxel read from its brick_mat row, until a hit,
//     a material event (a reflect or refract block), leaving the brick or the
//     budget. It applies no material step: the PyTorch glue in
//     kernels/brick_kernels.py does, and launches it again.
//
// Their plain PyTorch versions are brick_advance_plain (render/bricks.py
// _brick_loop) and brick_fine_plain in raytracing_test_tpu_torch/kernels/
// brick_kernels.py, which the wrapper runs for CPU tensors.
//
// What the TPU kernels did only because of the TPU is dropped: the MXU one-hot
// lookup of a bf16 table of nibble pairs (_nib_lookup_kernel, _USE_2D_DOT),
// the 16 i32 word planes of the fetched brick row with their 16-way select,
// the (32, 128) ray tiles and their padding, done carried as i32, the
// three-step unroll that spared a cross-lane any(), and the SMEM scalar
// packing. The loop caps of the TPU (per tile) are caps per lane here; the
// step budgets end every lane long before them: each brick iteration that
// advances adds at least one step, and a ray crosses at most 3 * edge - 2
// cells of a brick (10 of a 4^3 brick, 46 of the largest, 16^3), so no lane
// stops on kFineCap inside its brick.
//
// What bounds them on this card: dependent loads per ray, a 131 KB distance
// table and the 64-byte voxel rows of the bricks a ray meets, all resident
// in L2 (brick_mat is 8.4 MB for the default world), plus warp divergence
// between rays that settle in one iteration and rays that take many. Most
// lanes of a launch have nothing to do (done, in air, or without an event
// in a glue pass), so what such a lane reads and writes sets much of a
// launch's time. The host loop around the two kernels (one launch each per
// round, a sync per round and per glue pass) costs more than the kernels at
// 1024^2. Fusing the rounds and the glue into one launch is later work.
//
// brick_advance's design for this card (each step timed against the
// kernel it replaced on the card, PERF.md):
//  - In place. It updates the march state it is given (the wrapper hands
//    it a writable one): a lane that is done reads its done byte and
//    returns; a lane waiting in an occupied brick reads its cell and step
//    signs (25 bytes) and returns; a lane that neither moves nor changes
//    writes nothing. Launched once per round over all N lanes, most of which
//    are done or waiting after the first round, it moves a few bytes for
//    each of those instead of the whole state (65 bytes in, 41 out).
//  - One lane per thread in natural order. 8x4 warp tiles of the image (as
//    the fused march has them) raised round 1's lane efficiency but cost
//    more in the later rounds, whose done and waiting lanes then read
//    scattered bytes; the largest-L1 carveout changed nothing; the table
//    staged in shared memory by persistent blocks was slower in every
//    round. The longest lane's chain of dependent iterations (a table load,
//    two IEEE divisions) sets the later rounds' time.
//
// brick_fine's design for this card (each step timed on the card, PERF.md):
//  - In place, like brick_advance (fine_in_place). A lane with blin < 0
//    reads its 4-byte blin, writes evt = 0 and returns; a done lane also
//    reads its done byte; a lane out of its brick also its cell. A lane
//    inside its brick reads its mat and the voxel of its cell; if that is
//    a hit or an event it writes mat (if it changed) and done (on a hit)
//    and returns without loading the DDA fields. Only a lane that steps
//    loads them (tmax, step, abs_delta, steps: 40 bytes) and stores the
//    DDA fields, mat if it differs and done if it ended. Most lanes that
//    change in a glue pass meet water or glass again at once and take no
//    step. Loading and storing the whole state of every lane moved
//    65 + 41 + 5 bytes a lane, most of them for nothing. Loading the
//    state of every lane inside its brick before its first voxel (timed
//    against this with kernel_ab.py on an NVIDIA H100 80GB HBM3 at 700 W)
//    took 1.48-1.49 ms over the 1024^2 bench frame's launches against
//    1.31, and made the 512^2 frame's round-2 launch, where nearly every
//    lane is inside its brick, 3% slower than the whole-state kernel
//    (0.0092-0.0094 ms against 0.0089-0.0090); deferred, it takes
//    0.0087-0.0088.
//  - The glue passes launch over their event lanes only. A launch can
//    append the lanes whose evt it sets to an int32 list (one warp-
//    aggregated atomicAdd on a device counter per warp with events); the
//    wrapper reads that count back (the sync that stood for evt.any()) and
//    the next pass runs K threads over the list, not N. Every other lane is
//    done, out of its brick or without one, and would come out unchanged
//    with evt = 0: no lane stops on kFineCap inside its brick. The order of
//    the list changes from run to run; each lane's result depends on that
//    lane alone, so the outputs do not. A launch zeroes the other list's
//    counter (the one the pass after it appends to); the wrapper reads each
//    count before it launches the next pass.
//  - One dependent one-byte load of the brick's voxel row per DDA step
//    (the rows a launch touches stay in L2).
//  - Tried and dropped (timed against this design on the card, kernel_ab.py,
//    PERF.md section 6): the 64-byte row of a 4^3 brick loaded once,
//    as four 16-byte loads, with each step's byte selected from registers.
//    It took 55 registers instead of 46 (9 blocks per SM instead of 10) and
//    was 5-7% slower on the round-2 launches, which hold most of the work;
//    a lane reads only a few of the 64 voxels of its brick.

// Arithmetic: built with -fmad=false and IEEE division, every operation
// rounds once, in the order of the PyTorch version, so DDA near-ties
// resolve identically. The box crossing and the axis tie-break are the
// fused march's (dda.cuh).
//
// The per-ray code is plain C++ behind RT_DEV so that a host build of this
// file (without __CUDACC__) can exercise the same logic.

#include "dda.cuh"

namespace rb {

constexpr int kBrickCap = 512;   // loop guard per lane (render/bricks.py _BRICK_CAP)
constexpr int kFineCap = 64;     // loop guard per lane (render/bricks.py _FINE_CAP)
static_assert(kFineCap > 3 * 16 - 2, "a lane must never stop on kFineCap inside a 16^3 brick");

// The march state of render/renderer.py:_March that the kernels read.
struct State {
  const int32_t* cell;   // [n, 3]
  const float* tmax;     // [n, 3]
  const float* step;     // [n, 3], +-1
  const float* abs_delta;  // [n, 3]
  const int32_t* mat;    // [n]
  const uint8_t* done;   // [n], torch.bool
  const float* lt;       // [n] last_t
  const int32_t* la;     // [n] last_axis
  const int32_t* steps;  // [n]
};

// The fields they write (kernels/brick_kernels.py allocates them).
struct Out {
  int32_t* mat;
  int32_t* cell;
  float* tmax;
  float* lt;
  int32_t* la;
  int32_t* steps;
  uint8_t* done;
};

struct Grid {
  int sx, sy, sz;  // window shape
  int shift;       // log2 of the brick edge
  int by, bz;      // bricks along y and z
};

// A lane of the march: its DDA state, the material at its cell, done.
struct Lane : rt::Dda {
  int mat;
  bool done;
};

RT_DEV void load(const State& S, int i, Lane& r) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.c[k] = S.cell[3 * i + k];
    r.t[k] = S.tmax[3 * i + k];
    r.s[k] = S.step[3 * i + k];
    r.a[k] = S.abs_delta[3 * i + k];
  }
  r.mat = S.mat[i];
  r.done = S.done[i] != 0;
  r.lt = S.lt[i];
  r.la = S.la[i];
  r.steps = S.steps[i];
}

RT_DEV void store(const Out& O, int i, const Lane& r) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    O.cell[3 * i + k] = r.c[k];
    O.tmax[3 * i + k] = r.t[k];
  }
  O.mat[i] = r.mat;
  O.done[i] = r.done ? 1 : 0;
  O.lt[i] = r.lt;
  O.la[i] = r.la;
  O.steps[i] = r.steps;
}

RT_DEV int brick_lin(const Grid& G, int wx, int wy, int wz) {
  const int sh = G.shift;
  return ((wx >> sh) * G.by + (wy >> sh)) * G.bz + (wz >> sh);
}

// The brick phase of one lane (render/bricks.py:_brick_step, repeated): runs
// until an iteration in which the lane does not advance. Returns the number
// of iterations in which it advanced.
RT_DEV int advance_lane(const uint8_t* dist, const Grid& G, int y_max, int budget, Lane& r) {
  const int S[3] = {G.sx, G.sy, G.sz};
  int it = 0;
  for (; it < kBrickCap; ++it) {
    const int w[3] = {r.c[0] & 1023, r.c[1] & 1023, r.c[2] & 1023};
    const bool in_w = w[0] < G.sx && w[1] < G.sy && w[2] < G.sz;
    const int d = in_w ? (int)RT_LDG(dist + brick_lin(G, w[0], w[1], w[2])) : 1;
    const bool occupied = in_w && d == 0;

    // exit rules (moving away outside the window, sky above y_max)
    bool inside = true, away = false, op[3], on[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      op[k] = r.c[k] >= S[k];
      on[k] = r.c[k] < 0;
      inside = inside && !(op[k] || on[k]);
      away = away || (op[k] && r.s[k] > 0.0f) || (on[k] && r.s[k] < 0.0f);
    }
    const bool sky = r.c[1] > y_max && r.s[1] > 0.0f;
    // an active lane in air (or leaving) stands in an air cell: mat 0
    if (!r.done && (!occupied || away || sky)) r.mat = 0;
    if (!r.done && (away || sky)) r.done = true;
    if (r.done || occupied) break;

    // the empty box, brick-aligned, inside the window; the slab outside it
    const int rad = d - 1 > 0 ? d - 1 : 0;
    const int bs = 1 << G.shift;
    int lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int bc = w[k] >> G.shift;
      lo[k] = inside ? (bc - rad) * bs : (op[k] ? S[k] : -rt::kBig);
      hi[k] = inside ? (bc + rad + 1) * bs - 1 : (on[k] ? -1 : rt::kBig);
    }
    rt::aabb_advance(r, lo, hi);
    if (r.steps >= budget) r.done = true;  // budget freeze
  }
  return it;
}

// Whether advance_lane leaves a live lane as it is: its first iteration
// finds it in an occupied brick, leaving by no exit rule. That needs the
// cell and the step signs alone.
RT_DEV bool stays(const State& S, const uint8_t* dist, const Grid& G, int y_max, int i) {
  const int S3[3] = {G.sx, G.sy, G.sz};
  int c[3];
  float s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = S.cell[3 * i + k];
    s[k] = S.step[3 * i + k];
  }
  const int w[3] = {c[0] & 1023, c[1] & 1023, c[2] & 1023};
  if (!(w[0] < G.sx && w[1] < G.sy && w[2] < G.sz)) return false;
  if (RT_LDG(dist + brick_lin(G, w[0], w[1], w[2])) != 0) return false;
  bool away = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    away = away || (c[k] >= S3[k] && s[k] > 0.0f) || (c[k] < 0 && s[k] < 0.0f);
  }
  const bool sky = c[1] > y_max && s[1] > 0.0f;
  return !away && !sky;
}

// brick_advance on lane i of a writable march state (S and O name the same
// tensors): a done lane reads its done byte and returns, a lane that stays
// reads its cell and step signs, and a lane that neither moves nor changes
// writes nothing.
RT_DEV void advance_in_place(const State& S, const Out& O, const uint8_t* dist, const Grid& G,
                             int y_max, int budget, int i) {
  if (S.done[i] || stays(S, dist, G, y_max, i)) return;
  Lane r;
  load(S, i, r);
  const int mat = r.mat;
  if (advance_lane(dist, G, y_max, budget, r) > 0 || r.mat != mat || r.done) store(O, i, r);
}

RT_DEV bool mask_bit(const uint32_t w[4], int m) {
  const int q = (m >> 5) < 3 ? (m >> 5) : 3;
  const uint32_t word = q == 0 ? w[0] : (q == 1 ? w[1] : (q == 2 ? w[2] : w[3]));
  return ((word >> (m & 31)) & 1u) != 0;
}

// The voxel of window cell (wx, wy, wz) in brick blin's row.
RT_DEV int voxel(const uint8_t* bmat, const Grid& G, int blin, int wx, int wy, int wz) {
  const int sh = G.shift;
  const int msk = (1 << sh) - 1;
  const int vox = ((((wx & msk) << sh) | (wy & msk)) << sh) | (wz & msk);
  return (int)RT_LDG(bmat + ((size_t)blin << (3 * sh)) + vox);
}

// One DDA step of a lane (render/bricks.py:dda_step), then the budget.
RT_DEV void fine_step(Lane& r, int budget) {
  const int ax = rt::argmin_axis(r.t[0], r.t[1], r.t[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k == ax) {
      r.lt = r.t[k];
      r.c[k] += r.s[k] > 0.0f ? 1 : -1;
      r.t[k] = r.t[k] + r.a[k];
    }
  }
  r.la = ax;
  r.steps += 1;
  if (r.steps >= budget) r.done = true;
}

// The fine phase of one lane inside brick blin after its first iteration
// (the caller read the voxel of its first cell, set r.mat, found no hit
// and no event there, and loaded the DDA fields): that iteration's step,
// then single steps until a hit, an event, leaving the brick, the budget
// or kFineCap iterations in all. Returns the event flag.
RT_DEV bool fine_lane(const uint8_t* bmat, const uint32_t hit[4], const uint32_t evt[4],
                      const Grid& G, int budget, int blin, Lane& r) {
  fine_step(r, budget);
  for (int it = 1; it < kFineCap; ++it) {
    const int wx = r.c[0] & 1023, wy = r.c[1] & 1023, wz = r.c[2] & 1023;
    const bool in_w = wx < G.sx && wy < G.sy && wz < G.sz;
    if (r.done || !in_w || brick_lin(G, wx, wy, wz) != blin) break;
    const int m = voxel(bmat, G, blin, wx, wy, wz);
    r.mat = m;
    if (m != 0 && mask_bit(hit, m)) {
      r.done = true;
      break;
    }
    if (m != 0 && mask_bit(evt, m)) return true;
    fine_step(r, budget);
  }
  return false;
}

// brick_fine on lane i of a writable march state (S and O name the same
// tensors) -> the event flag. A lane without a brick reads its blin, a done
// lane also its done byte, a lane out of its brick also its cell; each
// returns with nothing written. A lane inside its brick reads the voxel of
// its cell and its mat: a hit or an event there writes mat (if it
// changed) and done (on a hit) and takes no step, so it never loads the
// DDA fields. Only a lane that steps loads them, marches, and stores the
// DDA fields, mat if it changed and done if it ended.
RT_DEV bool fine_in_place(const State& S, const Out& O, const uint8_t* bmat,
                          const int32_t* luts, const int32_t* blin, const Grid& G, int budget,
                          int i) {
  const int b = RT_LDG(blin + i);
  if (b < 0 || S.done[i]) return false;
  Lane r;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.c[k] = S.cell[3 * i + k];
  const int wx = r.c[0] & 1023, wy = r.c[1] & 1023, wz = r.c[2] & 1023;
  if (!(wx < G.sx && wy < G.sy && wz < G.sz) || brick_lin(G, wx, wy, wz) != b) return false;
  uint32_t hit[4], evt[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hit[k] = (uint32_t)RT_LDG(luts + k);
    evt[k] = (uint32_t)RT_LDG(luts + 4 + k);
  }
  const int mat0 = S.mat[i];
  const int m = voxel(bmat, G, b, wx, wy, wz);
  const bool stop_hit = m != 0 && mask_bit(hit, m);
  if (stop_hit || (m != 0 && mask_bit(evt, m))) {  // no step: mat, done and evt
    if (m != mat0) O.mat[i] = m;
    if (stop_hit) O.done[i] = 1;
    return !stop_hit;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.t[k] = S.tmax[3 * i + k];
    r.s[k] = S.step[3 * i + k];
    r.a[k] = S.abs_delta[3 * i + k];
  }
  r.steps = S.steps[i];
  r.mat = m;
  r.done = false;
  const bool ev = fine_lane(bmat, hit, evt, G, budget, b, r);
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // it stepped: the DDA fields
    O.cell[3 * i + k] = r.c[k];
    O.tmax[3 * i + k] = r.t[k];
  }
  O.lt[i] = r.lt;
  O.la[i] = r.la;
  O.steps[i] = r.steps;
  if (r.mat != mat0) O.mat[i] = r.mat;
  if (r.done) O.done[i] = 1;
  return ev;
}

}  // namespace rb

#ifdef __CUDACC__

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
brick_advance_kernel(rb::State S, rb::Out O, const uint8_t* __restrict__ dist, rb::Grid G,
                     int y_max, int budget, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) rb::advance_in_place(S, O, dist, G, y_max, budget, i);
}

// brick_fine over all n lanes (lanes null) or over the n lanes listed in
// lanes, in place; with list_out, the lanes whose evt it sets are appended
// there and counted in *count_out. *count_clear is zeroed.
__global__ void __launch_bounds__(kThreads)
brick_fine_kernel(rb::State S, rb::Out O, uint8_t* __restrict__ o_evt,
                  const uint8_t* __restrict__ bmat, const int32_t* __restrict__ luts,
                  const int32_t* __restrict__ blin, rb::Grid G, int budget,
                  const int32_t* __restrict__ lanes, int n, int32_t* __restrict__ list_out,
                  int32_t* __restrict__ count_out, int32_t* __restrict__ count_clear) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (count_clear != nullptr && j == 0) *count_clear = 0;
  bool ev = false;
  int i = 0;
  if (j < n) {
    i = lanes != nullptr ? __ldg(lanes + j) : j;
    ev = rb::fine_in_place(S, O, bmat, luts, blin, G, budget, i);
    o_evt[i] = ev ? 1 : 0;
  }
  if (list_out != nullptr) {  // every thread of the warp gets here
    const unsigned ballot = __ballot_sync(0xffffffffu, ev);
    if (ballot != 0u) {
      const int lane = threadIdx.x & 31;
      int base = 0;
      if (lane == 0) base = atomicAdd(count_out, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (ev) list_out[base + __popc(ballot & ((1u << lane) - 1u))] = i;
    }
  }
}

namespace {

rb::State state_of(const void* cell, const void* tmax, const void* step, const void* abs_delta,
                   const void* mat, const void* done, const void* lt, const void* la,
                   const void* steps) {
  rb::State S;
  S.cell = static_cast<const int32_t*>(cell);
  S.tmax = static_cast<const float*>(tmax);
  S.step = static_cast<const float*>(step);
  S.abs_delta = static_cast<const float*>(abs_delta);
  S.mat = static_cast<const int32_t*>(mat);
  S.done = static_cast<const uint8_t*>(done);
  S.lt = static_cast<const float*>(lt);
  S.la = static_cast<const int32_t*>(la);
  S.steps = static_cast<const int32_t*>(steps);
  return S;
}

rb::Out out_of(void* mat, void* cell, void* tmax, void* lt, void* la, void* steps, void* done) {
  rb::Out O;
  O.mat = static_cast<int32_t*>(mat);
  O.cell = static_cast<int32_t*>(cell);
  O.tmax = static_cast<float*>(tmax);
  O.lt = static_cast<float*>(lt);
  O.la = static_cast<int32_t*>(la);
  O.steps = static_cast<int32_t*>(steps);
  O.done = static_cast<uint8_t*>(done);
  return O;
}

rb::Grid grid_of(int sx, int sy, int sz, int shift) {
  rb::Grid G;
  G.sx = sx; G.sy = sy; G.sz = sz;
  G.shift = shift;
  G.by = sy >> shift;
  G.bz = sz >> shift;
  return G;
}

}  // namespace

// brick_advance in place on the march state (cell, tmax, mat, done, lt, la
// and steps are read and written; step and abs_delta only read).
extern "C" int brick_advance_launch(
    const void* dist, int sx, int sy, int sz, int shift, int y_max, int budget,
    void* cell, void* tmax, const void* step, const void* abs_delta,
    void* mat, void* done, void* lt, void* la, void* steps, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  brick_advance_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      state_of(cell, tmax, step, abs_delta, mat, done, lt, la, steps),
      out_of(mat, cell, tmax, lt, la, steps, done),
      static_cast<const uint8_t*>(dist), grid_of(sx, sy, sz, shift), y_max, budget, n);
  return static_cast<int>(cudaGetLastError());
}

// Blocks per SM of brick_advance (which 0) or brick_fine (which 1), and
// (threads != null) the block size.
extern "C" int brick_blocks_per_sm(int which, int* threads) {
  int blocks = -1;
  if (which == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, brick_advance_kernel, kThreads, 0);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, brick_fine_kernel, kThreads, 0);
  }
  if (threads) *threads = kThreads;
  return blocks;
}

// brick_fine in place on the march state (cell, tmax, mat, done, lt, la and
// steps are read and written; step and abs_delta only read) and evt (written
// on the lanes launched): over all n lanes (lanes null), or over the n lanes
// listed in lanes. With list_out, the lanes whose evt it sets are appended
// there and counted in *count_out (zero on entry); *count_clear (if given)
// is zeroed.
extern "C" int brick_fine_launch(
    const void* brick_mat, const void* luts, int sx, int sy, int sz, int shift, int budget,
    void* cell, void* tmax, const void* step, const void* abs_delta,
    void* mat, void* done, void* lt, void* la, void* steps,
    const void* blin, void* evt, const void* lanes, int n,
    void* list_out, void* count_out, void* count_clear, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  brick_fine_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      state_of(cell, tmax, step, abs_delta, mat, done, lt, la, steps),
      out_of(mat, cell, tmax, lt, la, steps, done),
      static_cast<uint8_t*>(evt), static_cast<const uint8_t*>(brick_mat),
      static_cast<const int32_t*>(luts), static_cast<const int32_t*>(blin),
      grid_of(sx, sy, sz, shift), budget, static_cast<const int32_t*>(lanes), n,
      static_cast<int32_t*>(list_out), static_cast<int32_t*>(count_out),
      static_cast<int32_t*>(count_clear));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // __CUDACC__
