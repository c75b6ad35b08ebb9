"""Camera model: projection-plane ray generation, matching the reference.

Port of ``raytracing_test_tpu/render/camera.py``. The shader's arithmetic is
kept as-is (src/shaders/low_res.frag:279-288):

    ppl  = cross(cameraDir, (0,1,0))                 # NOT normalised
    dir  = normalize(cameraDir
                     + ppl * -(projX * (fx - 0.5))
                     + cross(cameraDir, ppl) * (0.5 - fy) * projY)

with (fx, fy) the GL fragment coordinate, y measured from the BOTTOM. The
unnormalised plane basis bakes a pitch-dependent scale into the frustum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..config import CameraConfig


@dataclass(frozen=True)
class Camera:
    pos: torch.Tensor  # f32[3]
    dir: torch.Tensor  # f32[3], stored as given (the reference never normalises it)


def make_camera(cfg: CameraConfig, device) -> Camera:
    """The camera of a ``CameraConfig`` on ``device``."""
    return Camera(
        pos=torch.as_tensor(cfg.pos, dtype=torch.float32, device=device),
        dir=torch.as_tensor(cfg.dir, dtype=torch.float32, device=device),
    )


def yaw_pitch_dir(yaw_deg: float, pitch_deg: float):
    """Camera direction from yaw/pitch in the reference convention
    (src/input.cpp:19-28): dir = (cos p * sin y, -sin p, cos p * cos y)."""
    p = math.radians(pitch_deg)
    y = math.radians(yaw_deg)
    return (
        math.cos(p) * math.sin(y),
        -math.sin(p),
        math.cos(p) * math.cos(y),
    )


def camera_from_yaw_pitch(pos, yaw_deg: float, pitch_deg: float, device) -> Camera:
    d = yaw_pitch_dir(yaw_deg, pitch_deg)
    return Camera(
        pos=torch.as_tensor(pos, dtype=torch.float32, device=device),
        dir=torch.as_tensor(d, dtype=torch.float32, device=device),
    )


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def ray_directions(camera: Camera, width: int, height: int, fov_degrees: float = 90.0):
    """Per-pixel normalised ray directions, f32 [height*width, 3], on the
    camera's device. Row 0 of the image is the TOP of the screen."""
    f32 = torch.float32
    dev = camera.dir.device
    proj_x = math.tan(math.radians(fov_degrees / 2.0))
    proj_y = proj_x * height / width

    d = camera.dir.to(f32)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=f32, device=dev)
    ppl = _cross(d, up)  # unnormalised, as in the shader
    ppd = _cross(d, ppl)  # points down for y-up d

    row = (torch.arange(height, dtype=f32, device=dev) + 0.5) / height  # top -> bottom
    col = (torch.arange(width, dtype=f32, device=dev) + 0.5) / width
    fy = 1.0 - row  # GL bottom-up fragment coordinate
    fx = col

    cx = -(proj_x * (fx - 0.5))  # [W]
    cy = (0.5 - fy) * proj_y  # [H]
    dirs = (
        d[None, None, :]
        + ppl[None, None, :] * cx[None, :, None]
        + ppd[None, None, :] * cy[:, None, None]
    )
    n = torch.sqrt(
        dirs[..., 0] * dirs[..., 0] + dirs[..., 1] * dirs[..., 1] + dirs[..., 2] * dirs[..., 2]
    )
    dirs = dirs / n[..., None]
    return dirs.reshape(height * width, 3)
