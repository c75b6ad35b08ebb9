"""The edit loop's check: the reference generates the world again and
replays the edit log with its own pick ray (a delete clears the voxel the
pick hits, a place writes the hotbar block into the cell before it), then
compares

    table_off   entries of the session's scene tables after the window that
                differ from the reference's tables of the replayed world:
                cells of grid_enc (a material compared by its flags, albedo
                and metadata, an air cell by its licence byte), voxels of
                brick_mat, entries of brick_dist and brick_dist_shadow, and
                y_max (its difference); exact, so its limit is 0
    px_off      the worst kept frame's share of pixels off the reference
                frame of the replayed world at that edit by more than 1e-6

``control(run, out)`` is the reference with its frames' ray directions
rounded to bfloat16, the precision below the configuration's float32, in
the program's place (its tables are the reference's own).
"""

from __future__ import annotations

import numpy as np
import torch

from checks.frames import px_off, reference_frame
from reference import march as rm
from reference import scene as rs
from reference import world as rw


def _canon(albedo, flags, meta, shared: dict) -> np.ndarray:
    """Each material id's index in ``shared``, keyed by what a material is
    (flags, albedo, metadata), so two palettes' ids compare."""
    keys = [(int(flags[i]), np.asarray(albedo[i], np.float32).tobytes(),
             np.float32(meta[i]).tobytes()) for i in range(len(flags))]
    return np.array([shared.setdefault(k, len(shared)) for k in keys], np.int64)


def _by_material(ids: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """grid_enc / brick_mat values with material ids mapped through ``lut``
    and air licences (>= 128) kept apart."""
    v = ids.astype(np.int64)
    solid = v < 128
    return np.where(solid, lut[np.minimum(v, len(lut) - 1)], 1 << 20 | v)


def table_off(tables: dict, grid: np.ndarray, albedo, flags, meta) -> int:
    shared: dict = {}
    lut_p = _canon(tables["albedo"], tables["flags"], tables["metadata"], shared)
    lut_r = _canon(albedo, flags, meta, shared)
    n = int((_by_material(tables["grid_enc"], lut_p)
             != _by_material(rs.build_grid_enc(grid), lut_r)).sum())
    b_mat, b_dist, b_shadow = rs.brick_fields(grid, flags)
    n += int((_by_material(tables["brick_mat"], lut_p) != _by_material(b_mat, lut_r)).sum())
    n += int((tables["brick_dist"] != b_dist).sum())
    n += int((tables["brick_dist_shadow"] != b_shadow).sum())
    return n + abs(tables["y_max"] - rs.y_max(grid))


def replay(run, out, dir_dtype=torch.float32):
    """(grid after the log, (albedo, flags, metadata), {log index: frame})
    of the reference world under the edit log."""
    grid, pal = rw.gen_world(run.config["world"])
    hotbar = [pal.id_for(fl, rw.rgb_to_u64(*rgb), meta) for fl, rgb, meta in rw.HOTBAR]
    albedo, flags, meta = pal.arrays()
    Sx, Sy, Sz = grid.shape
    want = {i for i, _ in out["frames"]}
    frames = {}
    for i, (op, slot, pose) in enumerate(out["log"]):
        pos, yaw, pitch = pose
        pick = rm.cast_ray(grid, flags, pos, np.asarray(rm.yaw_pitch_dir(yaw, pitch), np.float32))
        if op == "delete" and pick.steps:
            x, y, z = pick.pos
            if 0 <= x < Sx and 0 <= y < Sy and 0 <= z < Sz:
                grid[x, y, z] = 0
        elif op == "place":
            x, y, z = pick.last_pos
            if 0 <= x < Sx and 0 <= y < Sy and 0 <= z < Sz:
                grid[x, y, z] = hotbar[slot % len(hotbar)]
        if i in want:
            scene = rs.ref_scene(grid, albedo, flags, run.device)
            frames[i] = reference_frame(scene, grid, flags, pose, 0.0, out["rcfg"], dir_dtype)
    return grid, (albedo, flags, meta), frames


def control(run, out) -> dict:
    grid, (albedo, flags, meta), frames = replay(run, out, torch.bfloat16)
    b_mat, b_dist, b_shadow = rs.brick_fields(grid, flags)
    tables = {"grid_enc": rs.build_grid_enc(grid), "brick_mat": b_mat, "brick_dist": b_dist,
              "brick_dist_shadow": b_shadow, "albedo": albedo, "flags": flags, "metadata": meta,
              "y_max": rs.y_max(grid)}
    return dict(out, tables=tables, frames=[(i, f.cpu()) for i, f in frames.items()])


def check(run, out) -> dict:
    grid, (albedo, flags, meta), frames = replay(run, out)
    worst = max((px_off(img, frames[i]) for i, img in out["frames"]), default=0.0)
    return {"table_off": table_off(out["tables"], grid, albedo, flags, meta), "px_off": worst}
