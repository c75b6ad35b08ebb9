// voxel_runtime — native host runtime for the TPU voxel framework.
//
// C++ re-expression of the reference's host-side hot path: the sparse 64-ary
// "tetrahexa" tree with its index-based slab allocator
// (ref: src/voxel_data/tetrahexa_tree.cpp, voxel_allocator.cpp), the seeded
// OpenSimplex terrain generator (ref: src/world_gen.cpp,
// include/OpenSimplexNoise.cpp), palette interning, dense-grid export for the
// device scene, and brick-granular dirty tracking (the analog of the
// reference's per-slab `modified` flags + glBufferSubData mirroring).
//
// Fresh implementation — same data design (16-byte nodes addressed by u32
// indices, so the structure is relocatable/flattenable), new code. Exposed as
// a plain C ABI for ctypes (see ../runtime.py). Semantics match
// core/tree.py (the pure-python twin), which is what the tests assert.
//
// This port's own copy of raytracing_test_tpu/native/src/voxel_runtime.cpp,
// unchanged but for this note; native/runtime.py builds it into _build/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <array>
#include <unordered_set>
#include <unordered_map>

namespace {

using u8 = uint8_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

constexpr int MAX_DEPTH = 6;     // node levels 0..5; unit leaves at depth 5
constexpr int WORLD_MASK = 1023; // addressable space is 1024^3
constexpr u32 LEAF = 1u;
constexpr u64 AIR_COLOR = ~0ull;

// ----------------------------------------------------------------- OpenSimplex

// Seed-exact 2D OpenSimplex (same public algorithm the reference vendors).
class Simplex2D {
 public:
  explicit Simplex2D(i64 seed) {
    int16_t source[256];
    for (int i = 0; i < 256; i++) source[i] = (int16_t)i;
    for (int i = 0; i < 3; i++) seed = lcg(seed);
    for (int i = 255; i >= 0; i--) {
      seed = lcg(seed);
      int r = (int)((seed + 31) % (i64)(i + 1));
      if (r < 0) r += i + 1;
      perm_[i] = source[r];
      source[r] = source[i];
    }
  }

  double eval(double x, double y) const {
    const double kStretch = -0.211324865405187;
    const double kSquish = 0.366025403784439;
    double so = (x + y) * kStretch;
    double xs = x + so, ys = y + so;
    int xsb = (int)std::floor(xs), ysb = (int)std::floor(ys);
    double sq = (xsb + ysb) * kSquish;
    double dx0 = x - (xsb + sq), dy0 = y - (ysb + sq);
    double xins = xs - xsb, yins = ys - ysb;
    double in_sum = xins + yins;

    double value = 0;
    double dx1 = dx0 - 1 - kSquish, dy1 = dy0 - kSquish;
    double a1 = 2 - dx1 * dx1 - dy1 * dy1;
    if (a1 > 0) { a1 *= a1; value += a1 * a1 * grad(xsb + 1, ysb, dx1, dy1); }
    double dx2 = dx0 - kSquish, dy2 = dy0 - 1 - kSquish;
    double a2 = 2 - dx2 * dx2 - dy2 * dy2;
    if (a2 > 0) { a2 *= a2; value += a2 * a2 * grad(xsb, ysb + 1, dx2, dy2); }

    int xe, ye; double dxe, dye;
    if (in_sum <= 1) {
      double zins = 1 - in_sum;
      if (zins > xins || zins > yins) {
        if (xins > yins) { xe = xsb + 1; ye = ysb - 1; dxe = dx0 - 1; dye = dy0 + 1; }
        else             { xe = xsb - 1; ye = ysb + 1; dxe = dx0 + 1; dye = dy0 - 1; }
      } else {
        xe = xsb + 1; ye = ysb + 1;
        dxe = dx0 - 1 - 2 * kSquish; dye = dy0 - 1 - 2 * kSquish;
      }
    } else {
      double zins = 2 - in_sum;
      if (zins < xins || zins < yins) {
        if (xins > yins) { xe = xsb + 2; ye = ysb; dxe = dx0 - 2 - 2 * kSquish; dye = dy0 - 2 * kSquish; }
        else             { xe = xsb; ye = ysb + 2; dxe = dx0 - 2 * kSquish; dye = dy0 - 2 - 2 * kSquish; }
      } else {
        xe = xsb; ye = ysb; dxe = dx0; dye = dy0;
      }
      xsb += 1; ysb += 1;
      dx0 = dx0 - 1 - 2 * kSquish; dy0 = dy0 - 1 - 2 * kSquish;
    }
    double a0 = 2 - dx0 * dx0 - dy0 * dy0;
    if (a0 > 0) { a0 *= a0; value += a0 * a0 * grad(xsb, ysb, dx0, dy0); }
    double ae = 2 - dxe * dxe - dye * dye;
    if (ae > 0) { ae *= ae; value += ae * ae * grad(xe, ye, dxe, dye); }
    return value / 47.0;
  }

 private:
  static i64 lcg(i64 s) {
    return (i64)((u64)s * 6364136223846793005ull + 1442695040888963407ull);
  }
  double grad(int xsb, int ysb, double dx, double dy) const {
    static const double g[16] = {5, 2, 2, 5, -5, 2, -2, 5, 5, -2, 2, -5, -5, -2, -2, -5};
    int idx = perm_[(perm_[xsb & 0xFF] + ysb) & 0xFF] & 0x0E;
    return g[idx] * dx + g[idx + 1] * dy;
  }
  int16_t perm_[256];
};

// ----------------------------------------------------------------------- tree

struct Node {
  u64 word;   // branch: child-occupancy bitmap | leaf: packed color
  u32 flags;  // bit0 = leaf, rest property bits
  u32 aux;    // branch: children-array index | leaf: metadata (float bits)
};

struct BrickKey {
  int x, y, z;
  bool operator==(const BrickKey& o) const { return x == o.x && y == o.y && z == o.z; }
};
struct BrickHash {
  size_t operator()(const BrickKey& k) const {
    return ((size_t)k.x * 73856093u) ^ ((size_t)k.y * 19349663u) ^ ((size_t)k.z * 83492791u);
  }
};

class Tree {
 public:
  Tree() {
    root_ = alloc_node();
    nodes_[root_].aux = alloc_array();
  }

  void put(int px, int py, int pz, u32 flags, u64 color, float meta, int level) {
    px &= WORLD_MASK; py &= WORLD_MASK; pz &= WORLD_MASK;
    int target = level - 1;
    mark_dirty(px, py, pz, level);
    u32 node = root_;
    for (int depth = 0; depth < MAX_DEPTH; depth++) {
      if (depth == target) {
        if (!(nodes_[node].flags & LEAF)) delete_children(node);
        nodes_[node].word = color;
        nodes_[node].flags = LEAF | flags;
        memcpy(&nodes_[node].aux, &meta, 4);
        return;
      }
      int idx = digit(px, py, pz, depth);
      if (nodes_[node].flags & LEAF) {
        split_leaf(node);
        node = arrays_[nodes_[node].aux][idx];
      } else if (!((nodes_[node].word >> idx) & 1)) {
        if (depth + 1 == target) {
          u32 leaf = alloc_node();
          nodes_[leaf].word = color;
          nodes_[leaf].flags = LEAF | flags;
          memcpy(&nodes_[leaf].aux, &meta, 4);
          nodes_[node].word |= 1ull << idx;
          arrays_[nodes_[node].aux][idx] = leaf;
          return;
        }
        u32 child = alloc_node();
        nodes_[child].aux = alloc_array();
        nodes_[node].word |= 1ull << idx;
        arrays_[nodes_[node].aux][idx] = child;
        node = child;
      } else {
        node = arrays_[nodes_[node].aux][idx];
      }
    }
  }

  // returns 1 if solid (fills outputs), 0 if air
  int get(int px, int py, int pz, u32* flags, u64* color, float* meta) const {
    px &= WORLD_MASK; py &= WORLD_MASK; pz &= WORLD_MASK;
    u32 node = root_;
    for (int depth = 0; depth < MAX_DEPTH; depth++) {
      const Node& n = nodes_[node];
      if (n.flags & LEAF) {
        *flags = n.flags; *color = n.word; memcpy(meta, &n.aux, 4);
        return 1;
      }
      int idx = digit(px, py, pz, depth);
      if (!((n.word >> idx) & 1)) return 0;
      node = arrays_[n.aux][idx];
    }
    return 0;  // unreachable for well-formed trees
  }

  // removes the block region at `level`; returns 1 if something was removed
  int del(int px, int py, int pz, int level) {
    px &= WORLD_MASK; py &= WORLD_MASK; pz &= WORLD_MASK;
    int target = level - 1;
    u32 node = root_;
    u32 parent = 0; int pidx = -1;
    for (int depth = 0; depth <= target; depth++) {
      if (depth == target) {
        if (pidx < 0) return 0;  // cannot delete the root region
        delete_children(node);
        free_node(node);
        nodes_[parent].word &= ~(1ull << pidx);
        arrays_[nodes_[parent].aux][pidx] = 0;
        mark_dirty(px, py, pz, level);
        return 1;
      }
      int idx = digit(px, py, pz, depth);
      if (nodes_[node].flags & LEAF) {
        split_leaf(node);
      } else if (!((nodes_[node].word >> idx) & 1)) {
        return 0;
      }
      parent = node; pidx = idx;
      node = arrays_[nodes_[node].aux][idx];
    }
    return 0;
  }

  int num_nodes() const { return (int)(nodes_.size() - free_nodes_.size()); }

  // Rasterize the window [0,sx)x[0,sy)x[0,sz) into a palette-interned u8 grid.
  // Returns palette count, or -1 if it would exceed max_pal.
  int export_dense(u8* grid, int sx, int sy, int sz, int max_pal,
                   u32* pal_flags, u64* pal_color, float* pal_meta) {
    pal_.clear();
    pal_list_.clear();
    pal_list_.push_back({0, AIR_COLOR, 0.f});  // id 0 = air
    max_pal_ = max_pal;
    memset(grid, 0, (size_t)sx * sy * sz);
    bool ok = fill(root_, 0, 0, 0, 0, grid, sx, sy, sz);
    if (!ok) return -1;
    for (size_t i = 0; i < pal_list_.size(); i++) {
      pal_flags[i] = pal_list_[i].flags;
      pal_color[i] = pal_list_[i].color;
      pal_meta[i] = pal_list_[i].meta;
    }
    return (int)pal_list_.size();
  }

  int dirty_count() const { return (int)dirty_.size(); }
  void get_dirty(int* out) const {
    int i = 0;
    for (const auto& k : dirty_) { out[i++] = k.x; out[i++] = k.y; out[i++] = k.z; }
  }
  void clear_dirty() { dirty_.clear(); }

 private:
  struct PalEntry { u32 flags; u64 color; float meta; };

  static int digit(int px, int py, int pz, int depth) {
    int shift = (MAX_DEPTH - 2 - depth) * 2;
    int x = (px >> shift) & 3, y = (py >> shift) & 3, z = (pz >> shift) & 3;
    return z << 4 | y << 2 | x;
  }

  u32 alloc_node() {
    if (!free_nodes_.empty()) {
      u32 i = free_nodes_.back(); free_nodes_.pop_back();
      nodes_[i] = Node{0, 0, 0};
      return i;
    }
    nodes_.push_back(Node{0, 0, 0});
    return (u32)(nodes_.size() - 1);
  }
  u32 alloc_array() {
    if (!free_arrays_.empty()) {
      u32 i = free_arrays_.back(); free_arrays_.pop_back();
      arrays_[i].fill(0);
      return i;
    }
    arrays_.emplace_back();
    arrays_.back().fill(0);
    return (u32)(arrays_.size() - 1);
  }
  void free_node(u32 i) { free_nodes_.push_back(i); }
  void free_array(u32 i) { free_arrays_.push_back(i); }

  void split_leaf(u32 node) {
    Node leaf = nodes_[node];
    u32 arr = alloc_array();
    u32 base = (u32)nodes_.size();
    nodes_.resize(nodes_.size() + 64, leaf);  // 64 consecutive clones
    for (int i = 0; i < 64; i++) arrays_[arr][i] = base + i;
    nodes_[node].flags = 0;
    nodes_[node].word = ~0ull;
    nodes_[node].aux = arr;
  }

  void delete_children(u32 node) {
    if (nodes_[node].flags & LEAF) return;
    u32 arr = nodes_[node].aux;
    u64 bm = nodes_[node].word;
    for (int i = 0; i < 64; i++) {
      if ((bm >> i) & 1) {
        u32 c = arrays_[arr][i];
        delete_children(c);
        free_node(c);
      }
    }
    free_array(arr);
  }

  void mark_dirty(int px, int py, int pz, int level) {
    int size = 1 << (2 * (MAX_DEPTH - level));
    int bx0 = (px & ~(size - 1)) >> 3, bx1 = ((px & ~(size - 1)) + size - 1) >> 3;
    int by0 = (py & ~(size - 1)) >> 3, by1 = ((py & ~(size - 1)) + size - 1) >> 3;
    int bz0 = (pz & ~(size - 1)) >> 3, bz1 = ((pz & ~(size - 1)) + size - 1) >> 3;
    for (int x = bx0; x <= bx1; x++)
      for (int y = by0; y <= by1; y++)
        for (int z = bz0; z <= bz1; z++) dirty_.insert({x, y, z});
  }

  // returns palette id, or -1 if the palette is full
  int intern(u32 flags, u64 color, float meta) {
    u64 key = color ^ ((u64)flags << 1);
    u32 mbits; memcpy(&mbits, &meta, 4);
    key ^= (u64)mbits << 17;
    auto it = pal_.find(key);
    if (it != pal_.end()) return it->second;
    if ((int)pal_list_.size() >= max_pal_ || pal_list_.size() >= 256) return -1;
    u8 id = (u8)pal_list_.size();
    pal_list_.push_back({flags, color, meta});
    pal_[key] = id;
    return id;
  }

  bool fill(u32 node, int depth, int x0, int y0, int z0, u8* grid,
            int sx, int sy, int sz) {
    int size = 1 << (2 * (MAX_DEPTH - 1 - depth));
    if (x0 >= sx || y0 >= sy || z0 >= sz) return true;
    const Node n = nodes_[node];
    if (n.flags & LEAF) {
      float meta; memcpy(&meta, &n.aux, 4);
      int iid = intern(n.flags, n.word, meta);
      if (iid < 0) return false;
      u8 id = (u8)iid;
      int x1 = std::min(x0 + size, sx), y1 = std::min(y0 + size, sy), z1 = std::min(z0 + size, sz);
      for (int x = x0; x < x1; x++)
        for (int y = y0; y < y1; y++)
          memset(grid + ((size_t)x * sy + y) * sz + z0, id, z1 - z0);
      return true;
    }
    int cs = size / 4;
    for (int i = 0; i < 64; i++) {
      if ((n.word >> i) & 1) {
        int cx = i & 3, cy = (i >> 2) & 3, cz = (i >> 4) & 3;
        if (!fill(arrays_[n.aux][i], depth + 1, x0 + cx * cs, y0 + cy * cs,
                  z0 + cz * cs, grid, sx, sy, sz))
          return false;
      }
    }
    return true;
  }

  u32 root_;
  std::vector<Node> nodes_;
  std::vector<std::array<u32, 64>> arrays_;
  std::vector<u32> free_nodes_, free_arrays_;
  std::unordered_set<BrickKey, BrickHash> dirty_;
  std::unordered_map<u64, u8> pal_;
  std::vector<PalEntry> pal_list_;
  int max_pal_ = 256;
};

// round half away from zero, like C round() in the reference recipe
inline double c_round(double v) { return std::round(v); }

}  // namespace

// ------------------------------------------------------------------- C ABI

extern "C" {

void* vt_create() { return new Tree(); }
void vt_destroy(void* t) { delete (Tree*)t; }

void vt_put_block(void* t, int x, int y, int z, u32 flags, u64 color,
                  float meta, int level) {
  ((Tree*)t)->put(x, y, z, flags, color, meta, level);
}

int vt_get_block(void* t, int x, int y, int z, u32* flags, u64* color, float* meta) {
  return ((Tree*)t)->get(x, y, z, flags, color, meta);
}

int vt_delete_block(void* t, int x, int y, int z, int level) {
  return ((Tree*)t)->del(x, y, z, level);
}

int vt_num_nodes(void* t) { return ((Tree*)t)->num_nodes(); }

int vt_export_dense(void* t, u8* grid, int sx, int sy, int sz, int max_pal,
                    u32* pal_flags, u64* pal_color, float* pal_meta) {
  return ((Tree*)t)->export_dense(grid, sx, sy, sz, max_pal, pal_flags,
                                  pal_color, pal_meta);
}

int vt_dirty_count(void* t) { return ((Tree*)t)->dirty_count(); }
void vt_get_dirty(void* t, int* out) { ((Tree*)t)->get_dirty(out); }
void vt_clear_dirty(void* t) { ((Tree*)t)->clear_dirty(); }

// Seed-exact noise (for tests and tooling)
double vt_noise2(i64 seed, double x, double y) {
  Simplex2D n(seed);
  return n.eval(x, y);
}

// The reference worldgen recipe (world_gen.cpp): 3-octave terrain columns +
// water below the waterline, issued as per-voxel putBlock calls like the
// reference's ~2M-insert storm — this is the native hot path.
void vt_gen_world(void* tp, int width, int length, i64 s1, i64 s2, i64 s3,
                  int base_height, int water_level, u64 grass, u64 dirt,
                  u64 stone, u64 water_color, u32 water_flags) {
  Tree* t = (Tree*)tp;
  Simplex2D o1(s1), o2(s2), o3(s3);
  for (int x = 0; x < width; x++) {
    for (int z = 0; z < length; z++) {
      int y = (int)(c_round(o1.eval(x * 0.005, z * 0.005) * 30) +
                    c_round(o2.eval(x * 0.05, z * 0.05) * 5) +
                    c_round(o3.eval(x * 0.1, z * 0.1) * 3)) + base_height;
      if (y < water_level) {
        for (int i = water_level; i > y; i--)
          t->put(x, i, z, water_flags, water_color, 0.f, 6);
        t->put(x, y, z, 0, dirt, 0.f, 6);
      } else {
        t->put(x, y, z, 0, grass, 0.f, 6);
      }
      y--;
      for (int i = 3; y > 0 && i; i--, y--) t->put(x, y, z, 0, dirt, 0.f, 6);
      for (; y > 0; y--) t->put(x, y, z, 0, stone, 0.f, 6);
    }
  }
}

}  // extern "C"
