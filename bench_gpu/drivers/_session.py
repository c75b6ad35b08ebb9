"""Shared by the session drivers (frames, edits): the session of a
configuration, the render settings, and a table of camera poses that the
seed visits in an order of its own."""

from __future__ import annotations

import math

import numpy as np


def render_config(run):
    from raytracing_test_tpu_torch.config import RenderConfig

    r = run.config["render"]
    tr = run.traffic
    return RenderConfig(width=tr["width"], height=tr["height"], max_steps=r["max_steps"],
                        shadow_steps=r["shadow_steps"], fov_degrees=r["fov_degrees"],
                        sun_dir=tuple(r["sun_dir"]))


def session(run):
    """A native ``WorldSession`` of the configuration's world."""
    from raytracing_test_tpu_torch.app.session import WorldSession
    from raytracing_test_tpu_torch.config import WorldConfig

    world = {k: tuple(v) if isinstance(v, list) else v for k, v in run.config["world"].items()}
    return WorldSession(WorldConfig(**world), use_native=True, device=run.device)


def yaw_pitch(look):
    """(yaw, pitch) in degrees of a look direction, in the session's
    convention (dir = (cos p sin y, -sin p, cos p cos y))."""
    x, y, z = look
    n = math.sqrt(x * x + y * y + z * z)
    return math.degrees(math.atan2(x, z)), math.degrees(math.asin(-y / n))


def pose_table(tr) -> list:
    """``poses`` (position, yaw, pitch) around the traffic's base pose,
    drawn once from the fixed ``walk_seed``: every run visits the same
    poses, in the order its own seed gives."""
    w = tr["walk"]
    yaw0, pitch0 = yaw_pitch(tr["look"]) if "look" in tr else (tr["yaw"], tr["pitch"])
    rng = np.random.default_rng(w["walk_seed"])
    out = []
    for _ in range(w["poses"]):
        pos = np.asarray(tr["pos"], np.float64) + rng.uniform(-w["move"], w["move"], 3)
        out.append((pos, yaw0 + rng.uniform(-w["yaw_deg"], w["yaw_deg"]),
                    pitch0 + rng.uniform(-w["pitch_deg"], w["pitch_deg"])))
    return out


def set_pose(s, pose) -> None:
    pos, yaw, pitch = pose
    s.pos = np.array(pos, np.float64)
    s.yaw, s.pitch = float(yaw), float(pitch)
