"""Host-side sparse 64-ary voxel tree ("tetrahexa tree"), structure-of-arrays.

Re-expression of the reference's pointer-based tree + slab allocator
(src/voxel_data/tetrahexa_tree.cpp, src/voxel_data/voxel_allocator.cpp) as
index-based numpy pools. Design decisions, TPU-first:

  - Nodes are u32 indices into growable pools (the reference is also index-based —
    its u32 node indices make the structure GPU-relocatable,
    voxel_allocator.hpp:93-99 — we keep that property, it is exactly what a
    device-flattenable structure needs).
  - The 16-byte node union {Branch{u64 bitmap; u32 flags; u32 children} |
    Leaf{u64 packedColor; u32 flags; float metadata}} (voxel_data/types.hpp:29-47)
    becomes parallel arrays sharing slots: bitmap/color share a u64 column,
    children/metadata share a u32 column, interpreted by flags bit 0.
  - Free slots are recycled through free lists like the reference's 4096-entry
    rings (voxel_allocator.hpp:20-33), but unbounded.
  - Dirty tracking is at brick granularity (core/flatten.py) instead of 4 MiB
    slabs: edits mark touched bricks, and only those re-flatten to the device.

Semantics parity (tetrahexa_tree.cpp):
  - depth 0 is the root covering WORLD_EXTENT^3 = 1024^3; unit leaves at depth 5.
  - child slot = z2<<4 | y2<<2 | x2 of the per-level 2-bit digits (line 85).
  - put_block at a shallower level overwrites (collapsing branches, lines 197-217);
    en-route leaves split into 64 cloned children (lines 221-247).
  - get_block returns the AIR sentinel where the occupancy bitmap bit is clear
    (lines 139-141).
  - delete_block: the reference's deleteBlock(pos, 6) path runs off the end of its
    stack (tetrahexa_tree.cpp:348 triggers with depth beyond unit leaves and a
    32-bit `1 << index` at line 352 — both UB). We implement the evident intent:
    remove the leaf at depth level-1, splitting en-route coarser leaves, clearing
    the parent bitmap bit with 64-bit arithmetic.

Bulk construction from a dense grid (``VoxelTree.from_dense``) is vectorized
bottom-up compaction — semantically equivalent to the reference worldgen's ~2M
serial putBlock calls (world_gen.cpp:19-40) but array-shaped. A per-voxel native
C++ path lives in native/ for the reference-shaped allocation storm.

This port's own copy of ``raytracing_test_tpu/core/tree.py``, whole: world
generation, picking and the edit session (``delete_block``) use it, the
tests ``to_dense`` and ``traverse``. The port imports nothing of the JAX
package. The arithmetic is unchanged, so worlds, trees and palettes come out
bit for bit the same (tests/test_torch_host.py, tests/test_torch_session.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from .types import AIR, AIR_COLOR, MAX_DEPTH, UNIT_LEVEL, WORLD_MASK, Block

_LEAF = np.uint32(1)
_U64_1 = np.uint64(1)


def _digit(pos: Tuple[int, int, int], depth: int) -> int:
    """Child slot chosen at ``depth`` while descending to ``pos``.

    Ref: tetrahexa_tree.cpp:127-129 — posOffset starts at (maxDepth-1)*2 and is
    decremented *before* the first selection, so depth d consumes bit pair
    (maxDepth - 2 - d) * 2.
    """
    shift = (MAX_DEPTH - 2 - depth) * 2
    x = (pos[0] >> shift) & 0b11
    y = (pos[1] >> shift) & 0b11
    z = (pos[2] >> shift) & 0b11
    return z << 4 | y << 2 | x


class VoxelTree:
    """Mutable sparse voxel world over the [0, 1024)^3 address space."""

    def __init__(self, capacity: int = 1024):
        cap = max(capacity, 64)
        # Node pool (SoA of the 16-byte union).
        self.flags = np.zeros(cap, dtype=np.uint32)  # bit0: leaf; rest: properties
        self.word = np.zeros(cap, dtype=np.uint64)  # branch bitmap | leaf color
        self.aux_u32 = np.zeros(cap, dtype=np.uint32)  # branch children-array index
        self.aux_f32 = np.zeros(cap, dtype=np.float32)  # leaf metadata
        # Child-pointer-array pool (the 64xu32 arrays, voxel_allocator's 256 B units).
        self.children = np.zeros((cap, 64), dtype=np.uint32)
        self._n_nodes = 0
        self._n_arrays = 0
        self._free_nodes: List[int] = []
        self._free_arrays: List[int] = []
        # Brick-granular dirty tracking for incremental device mirroring
        # (the analog of the reference's per-slab `modified` flags,
        # voxel_allocator.hpp:38-78). Keys are brick coords at BRICK shift 3 (8^3).
        self.dirty_bricks: Set[Tuple[int, int, int]] = set()
        self.root = self._alloc_node()
        arr = self._alloc_array()
        self.word[self.root] = 0  # empty bitmap
        self.flags[self.root] = 0
        self.aux_u32[self.root] = arr

    # ---------------------------------------------------------------- allocator

    def _grow(self) -> None:
        cap = len(self.flags)
        new = cap * 2
        for name in ("flags", "word", "aux_u32", "aux_f32"):
            a = getattr(self, name)
            b = np.zeros((new,) + a.shape[1:], dtype=a.dtype)
            b[:cap] = a
            setattr(self, name, b)

    def _grow_arrays(self) -> None:
        cap = len(self.children)
        b = np.zeros((cap * 2, 64), dtype=np.uint32)
        b[:cap] = self.children
        self.children = b

    def _alloc_node(self) -> int:
        if self._free_nodes:
            i = self._free_nodes.pop()
        else:
            if self._n_nodes >= len(self.flags):
                self._grow()
            i = self._n_nodes
            self._n_nodes += 1
        self.flags[i] = 0
        self.word[i] = 0
        self.aux_u32[i] = 0
        self.aux_f32[i] = 0
        return i

    def _alloc_nodes(self, count: int) -> int:
        """Allocate ``count`` consecutive node slots (ref allocConsecNodes)."""
        while self._n_nodes + count > len(self.flags):
            self._grow()
        i = self._n_nodes
        self._n_nodes += count
        return i

    def _alloc_array(self) -> int:
        if self._free_arrays:
            i = self._free_arrays.pop()
        else:
            if self._n_arrays >= len(self.children):
                self._grow_arrays()
            i = self._n_arrays
            self._n_arrays += 1
        self.children[i] = 0
        return i

    def _free_node(self, i: int) -> None:
        self._free_nodes.append(i)

    def _free_array(self, i: int) -> None:
        self._free_arrays.append(i)

    @property
    def num_nodes(self) -> int:
        return self._n_nodes - len(self._free_nodes)

    # ---------------------------------------------------------------- queries

    def get_block(self, pos: Tuple[int, int, int]) -> Block:
        """Lookup the block at a unit voxel position (ref getBlock, lines 113-157).

        Coordinates wrap modulo 1024, matching the reference's bit-mask address
        digests for out-of-range/negative inputs.
        """
        pos = tuple(int(p) & WORLD_MASK for p in pos)
        node = self.root
        for depth in range(MAX_DEPTH):
            if self.flags[node] & _LEAF:
                return Block(
                    int(self.flags[node]),
                    int(self.word[node]),
                    float(self.aux_f32[node]),
                )
            idx = _digit(pos, depth)
            if not (int(self.word[node]) >> idx) & 1:
                return AIR
            node = int(self.children[self.aux_u32[node]][idx])
        raise RuntimeError("hit max depth without finding leaf node")

    def traverse(self, positions: Iterable[Tuple[int, int, int]]) -> List[Block]:
        """Batch lookup (ref traverseTree, lines 43-111). The reference restarts
        each query from the last common ancestor; with index pools the plain
        per-query descent is already cheap, so this is simply a loop."""
        return [self.get_block(p) for p in positions]

    # ---------------------------------------------------------------- editing

    def _mark_dirty(self, pos: Tuple[int, int, int], size: int) -> None:
        b0 = tuple(p >> 3 for p in pos)
        b1 = tuple((p + size - 1) >> 3 for p in pos)
        for bx in range(b0[0], b1[0] + 1):
            for by in range(b0[1], b1[1] + 1):
                for bz in range(b0[2], b1[2] + 1):
                    self.dirty_bricks.add((bx, by, bz))

    def _split_leaf(self, node: int) -> None:
        """Materialize 64 cloned children under a leaf (ref lines 221-247)."""
        leaf_flags = self.flags[node]
        leaf_color = self.word[node]
        leaf_meta = self.aux_f32[node]
        arr = self._alloc_array()
        base = self._alloc_nodes(64)
        sl = slice(base, base + 64)
        self.flags[sl] = leaf_flags
        self.word[sl] = leaf_color
        self.aux_f32[sl] = leaf_meta
        self.aux_u32[sl] = 0
        self.children[arr] = np.arange(base, base + 64, dtype=np.uint32)
        self.flags[node] = 0
        self.word[node] = np.uint64(0xFFFFFFFFFFFFFFFF)  # all 64 children present
        self.aux_u32[node] = arr

    def _delete_children(self, node: int) -> None:
        """Recursively free a branch's subtree (ref deleteChildren, lines 159-173)."""
        if self.flags[node] & _LEAF:
            return
        arr = int(self.aux_u32[node])
        bitmap = int(self.word[node])
        for i in range(64):
            if (bitmap >> i) & 1:
                child = int(self.children[arr][i])
                self._delete_children(child)
                self._free_node(child)
        self._free_array(arr)

    def put_block(self, pos: Tuple[int, int, int], block: Block, level: int = UNIT_LEVEL) -> None:
        """Place a block; level 6 = unit voxel, level 5 = 4^3 region, ...
        (ref putBlock, tetrahexa_tree.cpp:176-291)."""
        pos = tuple(int(p) & WORLD_MASK for p in pos)
        target = level - 1  # zero-based depth of the written leaf
        size = 1 << (2 * (MAX_DEPTH - level))
        base = tuple((p >> (2 * (MAX_DEPTH - level))) << (2 * (MAX_DEPTH - level)) for p in pos)
        node = self.root
        depth = 0
        while depth < MAX_DEPTH:
            if depth == target:
                if not (self.flags[node] & _LEAF):
                    self._delete_children(node)  # branch -> leaf collapse (line 209)
                self.word[node] = np.uint64(block.color)
                self.flags[node] = _LEAF | np.uint32(block.flags)
                self.aux_f32[node] = np.float32(block.metadata)
                self._mark_dirty(base, size)
                return
            idx = _digit(pos, depth)
            if self.flags[node] & _LEAF:
                self._split_leaf(node)
                node = int(self.children[self.aux_u32[node]][idx])
                depth += 1
            elif not (int(self.word[node]) >> idx) & 1:
                if depth + 1 == target:
                    leaf = self._alloc_node()
                    self.word[leaf] = np.uint64(block.color)
                    self.flags[leaf] = _LEAF | np.uint32(block.flags)
                    self.aux_f32[leaf] = np.float32(block.metadata)
                    self.word[node] |= _U64_1 << np.uint64(idx)
                    self.children[self.aux_u32[node]][idx] = leaf
                    self._mark_dirty(base, size)
                    return
                child = self._alloc_node()
                arr = self._alloc_array()
                self.aux_u32[child] = arr
                self.word[node] |= _U64_1 << np.uint64(idx)
                self.children[self.aux_u32[node]][idx] = child
                node = child
                depth += 1
            else:
                node = int(self.children[self.aux_u32[node]][idx])
                depth += 1
        raise RuntimeError("hit max depth without finding leaf node")

    def delete_block(self, pos: Tuple[int, int, int], level: int = UNIT_LEVEL) -> Block:
        """Remove the block covering ``pos`` at ``level``; returns what was there.

        Intended semantics of ref deleteBlock (tetrahexa_tree.cpp:293-359) with its
        stack-overrun and 32-bit bitmap-shift bugs fixed (see module docstring).
        """
        pos = tuple(int(p) & WORLD_MASK for p in pos)
        target = level - 1
        size = 1 << (2 * (MAX_DEPTH - level))
        base = tuple((p >> (2 * (MAX_DEPTH - level))) << (2 * (MAX_DEPTH - level)) for p in pos)
        node = self.root
        parent = -1
        parent_idx = -1
        depth = 0
        while depth <= target:
            if depth == target:
                if parent < 0:
                    raise ValueError("cannot delete the root region")
                # node may be a leaf or a branch (mixed region) — both delete
                # their whole subtree, as ref deleteChildren does (lines 348-353)
                prev = Block(
                    int(self.flags[node]), int(self.word[node]), float(self.aux_f32[node])
                )
                self._delete_children(node)
                self._free_node(node)
                self.word[parent] = np.uint64(self.word[parent]) & ~(
                    _U64_1 << np.uint64(parent_idx)
                )
                self.children[self.aux_u32[parent]][parent_idx] = 0
                self._mark_dirty(base, size)
                return prev
            idx = _digit(pos, depth)
            if self.flags[node] & _LEAF:
                self._split_leaf(node)  # ref lines 313-336
            elif not (int(self.word[node]) >> idx) & 1:
                return AIR  # nothing there (ref lines 338-341)
            parent, parent_idx = node, idx
            node = int(self.children[self.aux_u32[node]][idx])
            depth += 1
        raise RuntimeError("unreachable")

    # ------------------------------------------------------- bulk construction

    @classmethod
    def from_dense(
        cls,
        materials: np.ndarray,
        palette: "Palette",
        origin: Tuple[int, int, int] = (0, 0, 0),
    ) -> "VoxelTree":
        """Vectorized bottom-up build from a dense material-id grid.

        ``materials`` is uint16/int32 [S, S, S] (0 = air) positioned at ``origin``
        in the 1024^3 address space; S must be a power of 4 <= 1024 and origin
        aligned to S... actually origin must be aligned to the coarsest uniform
        block granularity; we require origin aligned to 4 and insert top-down.

        Uniform 4^3 regions collapse into multi-resolution leaves, matching what
        put_block would produce semantically (identical get_block results).
        """
        tree = cls(capacity=max(1024, materials.size // 32))
        tree._bulk_insert(materials, palette, origin)
        tree.dirty_bricks.clear()  # a fresh build implies a full flatten anyway
        return tree

    def _bulk_insert(self, materials: np.ndarray, palette: "Palette", origin) -> None:
        # pad non-cubic / non-power-of-4 grids up to the next power-of-4 cube
        # with air — air cells are never inserted, so padding costs nothing
        S = 1
        while S < max(materials.shape):
            S *= 4
        if materials.shape != (S, S, S):
            padded = np.zeros((S, S, S), materials.dtype)
            sx, sy, sz = materials.shape
            padded[:sx, :sy, :sz] = materials
            materials = padded
        # Build uniformity pyramid: level k has cells of edge 4^k; a cell is
        # uniform if all 64 children agree. pyr[k] holds the material id if
        # uniform, else -1.
        pyr = [materials.astype(np.int32)]
        size = S
        while size > 1:
            cur = pyr[-1]
            n = size // 4
            c = cur.reshape(n, 4, n, 4, n, 4).transpose(0, 2, 4, 1, 3, 5).reshape(n, n, n, 64)
            uniform = np.all(c == c[..., :1], axis=-1)
            nxt = np.where(uniform, c[..., 0], -1)
            pyr.append(nxt)
            size = n
        # Insert top-down: at each pyramid level, any uniform non-air cell whose
        # parent cell was NOT uniform becomes one put_block at that level.
        ox, oy, oz = origin
        for k in range(len(pyr) - 1, -1, -1):
            cell = 1 << (2 * k)  # edge length of a level-k cell
            level = UNIT_LEVEL - k  # put_block level for this cell size
            cur = pyr[k]
            mask = cur > 0
            if k + 1 < len(pyr):
                parent_uniform = np.repeat(
                    np.repeat(np.repeat(pyr[k + 1] >= 0, 4, 0), 4, 1), 4, 2
                )
                mask &= ~parent_uniform
            xs, ys, zs = np.nonzero(mask)
            for x, y, z in zip(xs, ys, zs):
                mat = int(cur[x, y, z])
                blk = palette.block(mat)
                self.put_block(
                    (ox + int(x) * cell, oy + int(y) * cell, oz + int(z) * cell),
                    blk,
                    level,
                )

    # ------------------------------------------------------------- direct dense

    def to_dense(self, extent: int, origin: Tuple[int, int, int] = (0, 0, 0)):
        """Rasterize the tree into dense (flags, color, metadata) arrays of shape
        [extent]^3 — the inverse of from_dense, used by flatten.py and tests."""
        flags = np.zeros((extent,) * 3, dtype=np.uint32)
        color = np.full((extent,) * 3, AIR_COLOR, dtype=np.uint64)
        meta = np.zeros((extent,) * 3, dtype=np.float32)
        self._fill_dense(self.root, 0, (0, 0, 0), flags, color, meta, extent, origin)
        return flags, color, meta

    def _fill_dense(self, node, depth, corner, flags, color, meta, extent, origin):
        size = 1 << (2 * (MAX_DEPTH - 1 - depth))  # region edge at this depth
        ox, oy, oz = origin
        x0, y0, z0 = corner
        # clip against the window [origin, origin+extent)
        if (
            x0 + size <= ox or x0 >= ox + extent
            or y0 + size <= oy or y0 >= oy + extent
            or z0 + size <= oz or z0 >= oz + extent
        ):
            return
        if self.flags[node] & _LEAF:
            xs = slice(max(x0 - ox, 0), min(x0 + size - ox, extent))
            ys = slice(max(y0 - oy, 0), min(y0 + size - oy, extent))
            zs = slice(max(z0 - oz, 0), min(z0 + size - oz, extent))
            flags[xs, ys, zs] = self.flags[node]
            color[xs, ys, zs] = self.word[node]
            meta[xs, ys, zs] = self.aux_f32[node]
            return
        child_size = size // 4
        bitmap = int(self.word[node])
        arr = self.children[self.aux_u32[node]]
        for idx in range(64):
            if (bitmap >> idx) & 1:
                cx = idx & 0b11
                cy = (idx >> 2) & 0b11
                cz = (idx >> 4) & 0b11
                self._fill_dense(
                    int(arr[idx]),
                    depth + 1,
                    (x0 + cx * child_size, y0 + cy * child_size, z0 + cz * child_size),
                    flags, color, meta, extent, origin,
                )


@dataclass
class Palette:
    """Material palette: the deduplicated set of (flags, color, metadata) blocks.

    Device arrays carry compact material ids; the palette maps id -> properties.
    Id 0 is always air.
    """

    flags: np.ndarray = field(default_factory=lambda: np.zeros(1, dtype=np.int32))
    color: np.ndarray = field(default_factory=lambda: np.full(1, AIR_COLOR, dtype=np.uint64))
    metadata: np.ndarray = field(default_factory=lambda: np.zeros(1, dtype=np.float32))
    _index: Dict[Tuple[int, int, float], int] = field(default_factory=dict)

    MAX_IDS = 128  # grid_enc reserves values >= 128 for air distances

    def id_for(self, block: Block) -> int:
        if block.is_air:
            return 0
        key = (int(block.flags) | 1, int(block.color), float(block.metadata))
        i = self._index.get(key)
        if i is None:
            if len(self.flags) >= self.MAX_IDS:
                # palette full: merge into the perceptually-nearest existing
                # material with identical flags/metadata (graceful degradation
                # instead of a hard failure — a long multi-color edit session
                # keeps working with quantized colors)
                return self._nearest(key)
            i = len(self.flags)
            self.flags = np.append(self.flags, np.int32(key[0]))
            self.color = np.append(self.color, np.uint64(key[1]))
            self.metadata = np.append(self.metadata, np.float32(key[2]))
            self._index[key] = i
        return i

    def _nearest(self, key) -> int:
        from .color import u64_to_unit_f32

        fl, col, meta = key
        same = np.nonzero(
            (self.flags[1:] == fl) & (self.metadata[1:] == np.float32(meta))
        )[0]
        cand = same + 1 if len(same) else np.arange(1, len(self.flags))
        want = u64_to_unit_f32(np.asarray([col], np.uint64))[0]
        have = u64_to_unit_f32(self.color[cand])
        i = int(cand[np.argmin(((have - want[None, :]) ** 2).sum(axis=1))])
        self._index[key] = i  # future lookups of this block stay stable
        return i

    def block(self, mat_id: int) -> Block:
        if mat_id == 0:
            return AIR
        return Block(int(self.flags[mat_id]), int(self.color[mat_id]), float(self.metadata[mat_id]))

    def __len__(self) -> int:
        return len(self.flags)
