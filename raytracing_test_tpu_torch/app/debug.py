"""Debug output channels + pixel probe.

Port of ``raytracing_test_tpu/app/debug.py``. The reference's debug-frame
system renders one of ~10 internal per-pixel quantities instead of colour and
reads the pixel under the mouse back with glReadPixels (main.cpp:21-43,
low_res.frag:335-341). Here the reference renderer (``render/renderer.py:
render_rays``) returns its internals as named tensors (the aux dict), so any
channel is a render away and probing is an index. The channels come back to
the host as numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import RenderConfig
from ..core.flatten import Scene
from ..render import renderer
from ..render.camera import Camera, ray_directions

# the reference's channel names (main.cpp:21-33), mapped to aux keys; frames
# 1-6 are per-ray march internals, 7-0 are camera-model quantities (added in
# render_debug from the camera directly)
CHANNELS = {
    "hit_pos": "hit_pos",  # 1 "ray hit pos"
    "ray_dir": "ray_dir",  # 2 "ray dir" (post-material: current segment dir)
    "ray_ratios_a": "ray_ratios_a",  # 3 "ray ratios Y/X, Y/Z, X/Y"
    "ray_ratios_b": "ray_ratios_b",  # 4 "ray ratios X/Z, Z/X, Z/Y"
    "ray_deltas": "ray_deltas",  # 5 "ray deltas" (|1/dir|)
    "ray_origin": "ray_origin",  # 6 "ray origin" (current segment origin)
    "steps": "steps",
    "cell": "cell",
    "normal": "normal",
    "mat": "mat",
    "hit": "hit",
    "last_axis": "last_axis",
    "reflected": "reflected",
}


def render_debug(scene: Scene, camera: Camera, cfg: RenderConfig) -> Dict[str, np.ndarray]:
    """Render all debug channels as [H, W, ...] numpy arrays (plus the
    camera-model channels 7-0: camDir / proj-plane intersection / x vec /
    camOrigin, computed in numpy from the camera)."""
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, aux = renderer.render_rays(scene, camera.pos, dirs, cfg)
    H, W = cfg.height, cfg.width
    out = {"color": col.cpu().numpy().reshape(H, W, 3)}
    for name, key in CHANNELS.items():
        a = aux[key].cpu().numpy()
        out[name] = a.reshape((H, W) + a.shape[1:])
    # camera-model channels (debug frames 7, 8, 9, 0)
    pos = camera.pos.cpu().numpy().astype(np.float32)
    d = camera.dir.cpu().numpy().astype(np.float32)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    ppl = np.cross(d, up)  # "x vec" (the unnormalized plane basis)
    out["cam_dir"] = np.broadcast_to(d, (H, W, 3)).copy()
    out["x_vec"] = np.broadcast_to(ppl, (H, W, 3)).copy()
    out["cam_origin"] = np.broadcast_to(pos, (H, W, 3)).copy()
    # proj-plane intersection = camera pos + unnormalized pixel offset vector
    out["proj_pln_inter"] = out["cam_origin"] + dirs.cpu().numpy().reshape(H, W, 3)
    return out


def probe_pixel(channels: Dict[str, np.ndarray], row: int, col: int) -> Dict[str, object]:
    """The dumpPixelData analog (main.cpp:35-43): every channel at one pixel."""
    return {name: np.asarray(arr[row, col]).tolist() for name, arr in channels.items()}
