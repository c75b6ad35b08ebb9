// chebyshev.cu: the capped Chebyshev (L-inf) distance from each cell of a u8
// grid to its nearest occupied cell, one pass per axis, for NVIDIA Hopper
// (sm_90a).
//
// It replaces no TPU kernel. The reference builds its occupancy guide on the
// host with numpy (core/flatten.py: _air_licences' log-doubling dilations for
// grid_enc, chebyshev_distance_field's 3^3 dilations for the brick fields),
// and so did the port: the fit's guide rebuild copied the whole density field
// to the host every re-threshold period and the guide's tables back. This
// kernel lets core/flatten.py build the same Scene where the grid lives. Its
// plain PyTorch version is distance_plain in
// raytracing_test_tpu_torch/kernels/chebyshev.py, which the wrapper runs for
// CPU tensors.
//
// What it computes. D(p) = min(cap, L-inf distance from p to the nearest
// nonzero cell of its grid), cells outside the grid counted as empty. L-inf
// is separable under a max-combine:
//     D_a(p) = min over |k| <= cap of max(|k|, D_{a-1}(p + k e_a)),
// so three passes, one along each axis, each u8 in and u8 out, give D
// exactly. The first pass reads the grid itself (nonzero -> 0, else cap);
// each later one the pass before. In licence mode the last pass writes
// grid_enc instead of D: a solid cell keeps its material id, an air cell
// gets 128 + 2^j with 2^j the largest power of two <= D (cap 32), which is
// what _air_licences computes.
//
// What bounds it on this card: bytes. A pass reads each cell once and writes
// it once (the licence pass also reads the id grid), so 7 bytes a cell for
// grid_enc; the brick fields are 1/64 or 1/512 of that. The arithmetic is a
// few integer operations for each offset k a cell looks at.
//
// Design:
//  - A block stages a segment of its lines, with a halo of cap cells at each
//    end, in shared memory (the halo is cap outside the grid), so each cell is
//    read from device memory about (seg + 2 cap) / seg times, not 2 cap + 1.
//  - The strided axes (x and y): a block is 32 neighbouring columns (a warp's
//    32 consecutive bytes of a row) by a segment of 128 positions along the
//    axis. The contiguous axis (z): a block is 8 lines, a warp on each, by a
//    segment of 128 positions.
//  - A cell looks at offsets r = 0, 1, 2, ... on both sides and stops once r
//    reaches the best distance found: an offset of r cannot give less than r.
//    A cell next to a surface stops after a few offsets; only cells at the
//    cap look at all 2 cap + 1.
//  - Integers only, no float intermediate, and no 15-pass max-pool.

#include <cstdint>
#include <cuda_runtime.h>

namespace cd {

constexpr int kCols = 32;    // columns of a strided tile: one warp across
constexpr int kRows = 8;     // warps of a block
constexpr int kSeg = 128;    // positions along the axis that a block writes
constexpr int kMaxCap = 32;  // the largest cap (grid_enc's)
constexpr int kSpan = kSeg + 2 * kMaxCap;

constexpr int kFirst = 1;    // the input is the grid: nonzero is distance 0
constexpr int kLicence = 2;  // write grid_enc: the id if solid, else 128 + 2^j

// The input of a cell inside the grid, as a distance.
__device__ __forceinline__ int load(const uint8_t* in, size_t at, int cap, int mode) {
  const int v = in[at];
  return (mode & kFirst) ? (v != 0 ? 0 : cap) : v;
}

// min over |k| <= cap of max(|k|, s[k * stride]), with s[0] the cell itself.
__device__ __forceinline__ int line_min(const uint8_t* s, int stride) {
  int best = s[0];
  for (int r = 1; r < best; ++r) {
    const int v = min(s[r * stride], s[-r * stride]);
    best = min(best, max(r, v));
  }
  return best;
}

// What a pass stores: the distance, or in licence mode the grid_enc byte.
__device__ __forceinline__ uint8_t result(int d, const uint8_t* ids, size_t at, int mode) {
  if (!(mode & kLicence)) return static_cast<uint8_t>(d);
  const int id = ids[at];
  return static_cast<uint8_t>(id != 0 ? id : 128 + (1 << (31 - __clz(d))));
}

// A pass along a strided axis of the view [O, L, I] (I > 1). Block b covers
// line block o = b / n_col_blocks, columns ((b % n_col_blocks) * 32, +32) and
// positions (blockIdx.y * kSeg, +kSeg).
__global__ void __launch_bounds__(kCols * kRows)
cheb_strided(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
             const uint8_t* __restrict__ ids, int L, int I, int n_col_blocks, int cap, int mode) {
  __shared__ uint8_t tile[kSpan][kCols];
  const int o = blockIdx.x / n_col_blocks;
  const int i = (blockIdx.x % n_col_blocks) * kCols + threadIdx.x;
  const int l0 = blockIdx.y * kSeg;
  const size_t base = static_cast<size_t>(o) * L * I + i;
  const bool col = i < I;
  for (int r = threadIdx.y; r < kSeg + 2 * cap; r += kRows) {
    const int l = l0 - cap + r;
    tile[r][threadIdx.x] = static_cast<uint8_t>(
        col && l >= 0 && l < L ? load(in, base + static_cast<size_t>(l) * I, cap, mode) : cap);
  }
  __syncthreads();
  if (!col) return;
  for (int r = threadIdx.y; r < kSeg && l0 + r < L; r += kRows) {
    const size_t at = base + static_cast<size_t>(l0 + r) * I;
    out[at] = result(line_min(&tile[r + cap][threadIdx.x], kCols), ids, at, mode);
  }
}

// A pass along the contiguous axis of the view [O, L]: lines
// (blockIdx.x * kRows, +kRows), a warp each, positions (blockIdx.y * kSeg, +kSeg).
__global__ void __launch_bounds__(kCols * kRows)
cheb_contig(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            const uint8_t* __restrict__ ids, int O, int L, int cap, int mode) {
  __shared__ uint8_t tile[kRows][kSpan];
  const int o = blockIdx.x * kRows + threadIdx.y;
  const int l0 = blockIdx.y * kSeg;
  const size_t base = static_cast<size_t>(o) * L;
  const bool line = o < O;
  for (int r = threadIdx.x; r < kSeg + 2 * cap; r += kCols) {
    const int l = l0 - cap + r;
    tile[threadIdx.y][r] = static_cast<uint8_t>(
        line && l >= 0 && l < L ? load(in, base + l, cap, mode) : cap);
  }
  __syncthreads();
  if (!line) return;
  for (int r = threadIdx.x; r < kSeg && l0 + r < L; r += kCols) {
    const size_t at = base + l0 + r;
    out[at] = result(line_min(&tile[threadIdx.y][r + cap], 1), ids, at, mode);
  }
}

}  // namespace cd

// One pass along the middle axis of the view [O, L, I] of a contiguous u8
// tensor: out = the pass of in (first: in is the grid), ids the id grid of
// the licence pass (else null). 1 <= cap <= 32.
extern "C" int cheb_pass_launch(const void* in, void* out, const void* ids, int O, int L, int I,
                                int cap, int first, int licence, void* stream) {
  if (O <= 0 || L <= 0 || I <= 0) return 0;
  if (cap < 1 || cap > cd::kMaxCap) return static_cast<int>(cudaErrorInvalidValue);
  const int mode = (first ? cd::kFirst : 0) | (licence ? cd::kLicence : 0);
  const dim3 threads(cd::kCols, cd::kRows);
  const unsigned segs = static_cast<unsigned>((L + cd::kSeg - 1) / cd::kSeg);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  const auto* id = static_cast<const uint8_t*>(ids);
  auto s = static_cast<cudaStream_t>(stream);
  if (I == 1) {
    const dim3 blocks(static_cast<unsigned>((O + cd::kRows - 1) / cd::kRows), segs);
    cd::cheb_contig<<<blocks, threads, 0, s>>>(src, dst, id, O, L, cap, mode);
  } else {
    const int n_col = (I + cd::kCols - 1) / cd::kCols;
    const dim3 blocks(static_cast<unsigned>(static_cast<long long>(O) * n_col), segs);
    cd::cheb_strided<<<blocks, threads, 0, s>>>(src, dst, id, L, I, n_col, cap, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
