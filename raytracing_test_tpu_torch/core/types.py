"""Core voxel types: block property flags and the Block record.

Reference parity: src/globals.hpp:68-80 (properties enum, Block struct),
src/voxel_data/types.hpp (Node/Branch/Leaf 16-byte format — re-expressed here as
structure-of-arrays, see core/tree.py).

The reference packs a block as {u32 flags; u64 color; float metadata}. Flags are a
bitfield; bit 0 is the node-level "is leaf" marker (src/voxel_data/types.hpp:29-47),
so a stored solid block always has flags = 1 | properties.

This port's own copy of ``raytracing_test_tpu/core/types.py``: the port imports nothing of
the JAX package. The arithmetic is unchanged, so worlds and palettes
come out bit for bit the same (tests/test_torch_host.py).
"""

from __future__ import annotations

import enum
from typing import NamedTuple


class Properties(enum.IntFlag):
    """Block property bitfield (ref: src/globals.hpp:68-74)."""

    NONE = 0
    LEAF = 0x1  # node-format leaf marker (ref: src/voxel_data/types.hpp:44)
    REFLECTIVE = 0x2
    REFRACTIVE = 0x4
    LUMINESCENT = 0x8
    LIQUID = 0x10


# Sentinel color for "air" / no block: all-ones u64 (ref: tetrahexa_tree.cpp:141
# returns Block{0,-1ull,0}).
AIR_COLOR = (1 << 64) - 1


class Block(NamedTuple):
    """A voxel block: property flags, 63-bit packed RGB color, float metadata.

    Ref: src/globals.hpp:76-80. ``color`` is the 21-bit-per-channel packed u64
    (see core/color.py); ``metadata`` carries material parameters (reflectivity,
    refractive index) in the reference hotbar (src/globals.cpp:36-62).
    """

    flags: int
    color: int
    metadata: float = 0.0

    @property
    def is_air(self) -> bool:
        return self.color == AIR_COLOR


AIR = Block(0, AIR_COLOR, 0.0)

# World geometry constants. The reference tree is depth-6 with 2 address bits per
# axis per level below the root; the root's own digit is never consumed
# (tetrahexa_tree.cpp:116 starts posOffset at (maxDepth-1)*2 and decrements before
# the first child selection), so the addressable space is 4^5 = 1024 per axis.
MAX_DEPTH = 6  # node levels 0..5; unit-voxel leaves live at depth 5
WORLD_BITS = 10  # log2 of addressable extent per axis
WORLD_EXTENT = 1 << WORLD_BITS  # 1024
WORLD_MASK = WORLD_EXTENT - 1

# putBlock/deleteBlock "level" parameter: level 6 places a 1x1x1 block, level 5 a
# 4x4x4 block, etc. (ref: tetrahexa_tree.cpp:175 comment). A leaf written at
# zero-based depth d covers 4^(5-d) voxels per axis.
UNIT_LEVEL = 6


def level_size(level: int) -> int:
    """Edge length in voxels of a block placed at ``level`` (1-based, ref API)."""
    return 1 << (2 * (UNIT_LEVEL - level))


# The reference's default hotbar palette (src/globals.cpp:36-62). Colors are given
# here as raw (r, g, b) bytes; pack with core.color.rgb_to_u64.
HOTBAR_RGB = [
    (Properties.NONE, (255, 0, 0), 0.0),
    (Properties.NONE, (0, 255, 0), 0.0),
    (Properties.REFLECTIVE, (255, 0, 0), 0.94),
    (Properties.REFLECTIVE, (255, 255, 255), 0.94),
    (Properties.REFRACTIVE, (0, 0, 0), 1.5),
]
