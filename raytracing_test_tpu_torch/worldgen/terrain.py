"""Terrain generation: the reference's 3-octave OpenSimplex column world,
vectorized.

Reference recipe (src/world_gen.cpp:13-42), per column (x, z):

    h = round(o1(x*.005, z*.005)*30) + round(o2(x*.05, z*.05)*5)
      + round(o3(x*.1, z*.1)*3) + 32          (seeds 42 / 64 / 100)

    if h < 20:  water (REFRACTIVE|LIQUID, rgb(0,150,10)) fills (h, 20],
                and the surface block at h is dirt rgb(45,18,0)
    else:       grass rgb(0,150,10) at h
    then 3 dirt layers below the surface (while y > 0),
    then stone rgb(33,33,33) down to y = 1.   (y = 0 is never filled)

The reference makes ~2M serial putBlock calls; here the whole world is computed
as numpy arrays: vectorized noise -> heightmap -> per-column material spans ->
dense material-id grid. The sparse tree view is derived from the grid on demand
(core.tree.VoxelTree.from_dense), and the startup smoke-test blocks of
initTetraHexaTree (tetrahexa_tree.cpp:20-27) are stamped in for parity.

This port's own copy of ``raytracing_test_tpu/worldgen/terrain.py``: the port imports nothing of
the JAX package. The arithmetic is unchanged, so worlds and palettes
come out bit for bit the same (tests/test_torch_host.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import WorldConfig
from ..core.color import rgb_to_u64
from ..core.tree import Palette, VoxelTree
from ..core.types import Block, Properties
from .opensimplex import OpenSimplex2D


def heightmap(cfg: WorldConfig) -> np.ndarray:
    """Integer terrain heights [width, length], bit-exact with the reference.

    C's round() rounds half away from zero; numpy's rounds half to even, so we
    use sign*floor(|v|+0.5).
    """

    def c_round(v: np.ndarray) -> np.ndarray:
        return np.sign(v) * np.floor(np.abs(v) + 0.5)

    x = np.arange(cfg.width, dtype=np.float64)[:, None]
    z = np.arange(cfg.length, dtype=np.float64)[None, :]
    h = np.zeros((cfg.width, cfg.length), dtype=np.float64)
    for seed, freq, amp in zip(cfg.seeds, cfg.octave_freqs, cfg.octave_amps):
        noise = OpenSimplex2D(seed)
        h += c_round(noise.eval_vec(x * freq, z * freq) * amp)
    return (h + cfg.base_height).astype(np.int32)


# Terrain material blocks (ref world_gen.cpp:26-38, globals.hpp flags)
GRASS = Block(int(Properties.NONE), int(rgb_to_u64(0, 150, 10)))
DIRT = Block(int(Properties.NONE), int(rgb_to_u64(45, 18, 0)))
STONE = Block(int(Properties.NONE), int(rgb_to_u64(33, 33, 33)))
WATER = Block(
    int(Properties.REFRACTIVE | Properties.LIQUID), int(rgb_to_u64(0, 150, 10))
)

# initTetraHexaTree's smoke-test blocks: (pos, Block{flags, color=0, meta=0}, level)
# (ref tetrahexa_tree.cpp:20-27). The flags values 1..8 are raw bitfields — e.g.
# Block{2,..} is REFLECTIVE, Block{4,..} REFRACTIVE.
INIT_BLOCKS = [
    ((1000, 1000, 1000), Block(1, 0, 0.0), 5),
    ((10, 100, 10), Block(2, 0, 0.0), 6),
    ((100, 10, 100), Block(3, 0, 0.0), 6),
    ((20, 10, 200), Block(4, 0, 0.0), 5),
    ((1, 10, 10), Block(5, 0, 0.0), 6),
    ((2, 10, 10), Block(6, 0, 0.0), 6),
    ((3, 10, 10), Block(7, 0, 0.0), 6),
    ((4, 10, 10), Block(8, 0, 0.0), 6),
]


def gen_world_grid(cfg: WorldConfig) -> Tuple[np.ndarray, Palette]:
    """Generate the dense material-id grid [Sx, Sy, Sz] (0 = air) + palette."""
    Sx, Sy, Sz = cfg.grid_shape
    grid = np.zeros(cfg.grid_shape, dtype=np.uint8)
    pal = Palette()
    grass = pal.id_for(GRASS)
    dirt = pal.id_for(DIRT)
    stone = pal.id_for(STONE)
    water = pal.id_for(WATER)

    # Startup smoke blocks first — terrain overwrites them where columns collide,
    # matching the reference's call order (main.cpp:183 init, then genWorld).
    if cfg.include_init_blocks:
        for (bx, by, bz), blk, level in INIT_BLOCKS:
            size = 1 << (2 * (6 - level))
            base = tuple((c >> (2 * (6 - level))) << (2 * (6 - level)) for c in (bx, by, bz))
            if all(0 <= base[i] and base[i] + size <= cfg.grid_shape[i] for i in range(3)):
                mid = pal.id_for(blk)
                grid[
                    base[0] : base[0] + size,
                    base[1] : base[1] + size,
                    base[2] : base[2] + size,
                ] = mid

    h = heightmap(cfg)  # [width, length]
    W = min(cfg.width, Sx)
    L = min(cfg.length, Sz)
    hh = np.clip(h[:W, :L], 0, Sy - 1)
    ys = np.arange(Sy, dtype=np.int32)[None, None, :]  # broadcast over columns
    hcol = hh[:, :, None]

    # stone: 1 <= y <= h-4
    col = np.where((ys >= 1) & (ys <= hcol - 4), stone, 0).astype(np.uint8)
    # dirt: the 3 layers below the surface, h-3 <= y <= h-1, y > 0
    col = np.where((ys >= np.maximum(hcol - 3, 1)) & (ys <= hcol - 1), dirt, col).astype(np.uint8)
    # surface block at y == h (>=0): grass normally, dirt under water
    surface_mat = np.where(hcol < cfg.water_level, dirt, grass)
    col = np.where(ys == hcol, surface_mat, col).astype(np.uint8)
    # water above low terrain: h < y <= water_level
    col = np.where((hcol < cfg.water_level) & (ys > hcol) & (ys <= cfg.water_level), water, col).astype(np.uint8)

    # terrain writes only where it places a block (air leaves smoke blocks alone)
    region = grid[:W, :, :L].transpose(0, 2, 1)  # -> [W, L, Sy]
    grid[:W, :, :L] = np.where(col > 0, col, region).transpose(0, 2, 1)
    return grid, pal


def gen_world_tree(cfg: WorldConfig, grid: Optional[np.ndarray] = None, palette: Optional[Palette] = None) -> VoxelTree:
    """Build the sparse tree view of the generated world (for picking/editing).

    Includes the out-of-window smoke block at (1000,1000,1000) which the dense
    grid cannot hold.
    """
    if grid is None or palette is None:
        grid, palette = gen_world_grid(cfg)
    tree = VoxelTree.from_dense(grid, palette)
    if cfg.include_init_blocks:
        for pos, blk, level in INIT_BLOCKS:
            size = 1 << (2 * (6 - level))
            inside = all(
                0 <= (pos[i] >> (2 * (6 - level))) << (2 * (6 - level))
                and ((pos[i] >> (2 * (6 - level))) << (2 * (6 - level))) + size <= cfg.grid_shape[i]
                for i in range(3)
            )
            if not inside:  # only the blocks the dense path dropped
                tree.put_block(pos, blk, level)
    tree.dirty_bricks.clear()
    return tree
