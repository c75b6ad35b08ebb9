"""Command-line interface of the PyTorch port: render / animate / fit.

Port of the ``render``, ``animate`` and ``fit`` verbs of
``raytracing_test_tpu/app/cli.py`` with its arguments and defaults, plus
``--device`` (default ``cuda``; the tests pass ``--device cpu``). Each frame
mirrors ``WorldSession.render``: pick the looked-at block on the host tree
(``app/picking.cast_ray``), then draw through the fused march
(``kernels/fused_march.render_image_fused``), or with ``render --mode
bricks`` / ``bricks-pallas`` through the brick engine
(``kernels/brick_kernels.render_image_bricks_pallas``: its two kernels on
the card, their plain versions on ``--device cpu``; the reference's
XLA / Pallas split has no meaning on the card, and both names are kept so
that a command line of the JAX package runs unchanged). ``fit`` runs
``app/fit.fit_world``: the fused step, through ``render_rays_diff_guided``;
``--engine '' --guided`` runs the same step.

    python -m raytracing_test_tpu_torch.app.cli render --out frame.png
    python -m raytracing_test_tpu_torch.app.cli render --mode bricks-pallas --out frame.png
    python -m raytracing_test_tpu_torch.app.cli animate --frames 8 --out-dir anim/
    python -m raytracing_test_tpu_torch.app.cli fit --steps 20
    python -m raytracing_test_tpu_torch.app.cli fit --engine "" --guided --steps 20

``edit`` and ``probe``, and the render modes ``fast``, ``reference``,
``progressive``, ``spatial`` and ``handoff``, are not ported yet
(ROADMAP.md). ``pallas`` is rejected: the JAX CLI offers it, but its
``WorldSession.render`` has no renderer for it and raises
``unknown render mode 'pallas'``.
"""

from __future__ import annotations

import argparse
import os
import struct
import time
import zlib
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..config import CameraConfig, FitConfig, RenderConfig, world_for_size
from ..core.flatten import Scene, scene_from_grid
from ..kernels.brick_kernels import render_image_bricks_pallas
from ..kernels.fused_march import render_image_fused
from ..render.camera import Camera, yaw_pitch_dir
from ..worldgen import terrain
from . import picking

RENDER_MODES = ("fused", "bricks", "bricks-pallas")
UNPORTED_MODES = ("fast", "reference", "progressive", "spatial", "handoff")
NO_RENDERER_MODES = ("pallas",)  # offered by the JAX CLI, rendered by nothing there


def write_png(img: np.ndarray, path: str) -> None:
    """Float RGB image [H, W, 3] in [0, 1] -> 8-bit PNG (stdlib only).
    Raises on non-finite pixels rather than writing them as black."""
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {img.shape}")
    if not np.isfinite(img).all():
        raise ValueError(f"refusing to write {path}: the frame has non-finite pixels")
    px = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    H, W, _ = px.shape
    raw = b"".join(b"\x00" + px[r].tobytes() for r in range(H))  # filter 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF
        )

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


@dataclass
class View:
    """World, scene and camera state of a CLI run (WorldSession's render half)."""

    scene: Scene
    tree: object  # host tree for picking (core.tree.VoxelTree)
    pos: np.ndarray
    yaw: float
    pitch: float
    time: float = 0.0

    def camera_dir(self) -> np.ndarray:
        return np.asarray(yaw_pitch_dir(self.yaw, self.pitch), np.float32)

    def rotate(self, yaw_delta: float, pitch_delta: float) -> None:
        """rotateCamera parity: pitch hard-clamped, yaw wrapped."""
        if not (-90 < self.pitch + pitch_delta < 90):
            pitch_delta = 0.0
        self.pitch += pitch_delta
        self.yaw += yaw_delta
        if self.yaw > 180:
            self.yaw -= 360
        if self.yaw < -180:
            self.yaw += 360

    def render(self, rcfg: RenderConfig, mode: str = "fused") -> torch.Tensor:
        """One frame: pick for the looked-at highlight, then draw with the
        fused march or (``bricks``, ``bricks-pallas``) the brick engine."""
        res = picking.cast_ray(self.tree, self.pos, self.camera_dir(), 30)
        if res.steps:
            rcfg = replace(rcfg, looking_at=res.pos)
        rcfg = replace(rcfg, time=self.time)
        dev = self.scene.device
        cam = Camera(
            pos=torch.as_tensor(self.pos, dtype=torch.float32, device=dev),
            dir=torch.as_tensor(self.camera_dir(), dtype=torch.float32, device=dev),
        )
        if mode == "fused":
            return render_image_fused(self.scene, cam, rcfg, time_s=rcfg.time)
        if mode in ("bricks", "bricks-pallas"):
            return render_image_bricks_pallas(self.scene, cam, rcfg, time_s=rcfg.time)
        raise ValueError(f"unknown render mode {mode!r}")


def make_view(args) -> View:
    wcfg = world_for_size(args.world)
    grid, pal = terrain.gen_world_grid(wcfg)
    tree = terrain.gen_world_tree(wcfg, grid, pal)
    scene = scene_from_grid(grid, pal, torch.device(args.device))
    pos = (
        np.asarray([float(v) for v in args.pos.split(",")], np.float64)
        if args.pos
        else np.asarray(CameraConfig().pos, np.float64)
    )
    return View(scene=scene, tree=tree, pos=pos, yaw=args.yaw, pitch=args.pitch)


def _rcfg(args) -> RenderConfig:
    return RenderConfig(
        width=args.width,
        height=args.height,
        enable_ao=args.ao,
        enable_shadows=not args.no_shadows,
    )


def cmd_render(args) -> None:
    v = make_view(args)
    img = v.render(_rcfg(args), args.mode)
    write_png(img.cpu().numpy(), args.out)
    print(f"wrote {args.out}")


def cmd_animate(args) -> None:
    v = make_view(args)
    os.makedirs(args.out_dir, exist_ok=True)
    rcfg = _rcfg(args)
    sync = torch.cuda.synchronize if v.scene.device.type == "cuda" else (lambda: None)
    for i in range(args.frames):
        v.time = i / 10.0  # drives the water surface animation
        v.rotate(args.spin, 0.0)
        t0 = time.perf_counter()
        img = v.render(rcfg)
        sync()
        dt = time.perf_counter() - t0
        write_png(img.cpu().numpy(), os.path.join(args.out_dir, f"frame_{i:04d}.png"))
        print(f"frame {i}: {dt * 1e3:.1f} ms ({rcfg.width * rcfg.height / dt:.3e} rays/s, "
              f"host clock, pick + render, {v.scene.device})")


def cmd_fit(args) -> None:
    from . import fit as fitmod

    if args.out:
        raise NotImplementedError(
            "fit --out renders with the blind volumetric scan (render_image_diff), "
            "which is not ported yet; see ROADMAP.md, 'Modules to port', item 10"
        )
    grid, pal = terrain.gen_world_grid(world_for_size(args.world))
    scene = scene_from_grid(grid, pal, torch.device(args.device))
    fcfg = FitConfig(
        views=args.views, steps=args.steps, lr=args.lr, resolution=args.fit_res,
        guided=args.guided, engine=args.engine, shading=args.shading,
    )
    _, losses = fitmod.fit_world(scene, grid.shape, fcfg, ckpt_path=args.ckpt or None,
                                 batch=args.batch)
    print(f"fit done: loss {losses[0]:.5f} -> {losses[-1]:.5f}")


def _render_mode(value: str) -> str:
    if value in RENDER_MODES:
        return value
    if value in UNPORTED_MODES:
        raise argparse.ArgumentTypeError(
            f"render mode {value!r} is not ported yet; see ROADMAP.md, 'Modules to port'")
    if value in NO_RENDERER_MODES:
        raise argparse.ArgumentTypeError(
            f"render mode {value!r} has no renderer: the reference does not render this mode "
            f"either (its WorldSession.render raises for it)")
    raise argparse.ArgumentTypeError(
        f"unknown render mode {value!r} (choose from {', '.join(RENDER_MODES)})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracing_test_tpu_torch")
    p.add_argument("--device", default="cuda", help="torch device: cuda[:n] (default) or cpu")
    p.add_argument("--world", type=int, default=200, help="world columns per side")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--pos", type=str, default="")
    p.add_argument("--yaw", type=float, default=45.0)
    p.add_argument("--pitch", type=float, default=25.0)  # positive pitch looks down (ref convention)
    p.add_argument("--ao", action="store_true", help="hemisphere AO (not ported yet: raises)")
    p.add_argument("--no-shadows", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render")
    r.add_argument("--out", default="frame.png")
    r.add_argument("--mode", type=_render_mode, default="fused",
                   help=f"render path: {', '.join(RENDER_MODES)} (bricks and bricks-pallas "
                   "both run the brick kernels on the card)")
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate")
    a.add_argument("--frames", type=int, default=8)
    a.add_argument("--spin", type=float, default=3.0)
    a.add_argument("--out-dir", default="anim")
    a.set_defaults(fn=cmd_animate)

    f = sub.add_parser("fit")
    f.add_argument("--views", type=int, default=8)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--lr", type=float, default=0.05)
    f.add_argument("--fit-res", type=int, default=64)
    f.add_argument("--batch", type=int, default=8192)
    f.add_argument("--ckpt", default="")
    f.add_argument("--guided", action="store_true",
                   help="surface-guided sampling with occupancy re-thresholding (the fused "
                   "engine always is)")
    f.add_argument("--engine", default="fused", choices=["", "fused"],
                   help="training engine: 'fused' = the seed march + window kernel pair "
                   "(render_rays_diff_guided); '' with --guided = the same step, else the "
                   "blind scan, not ported (raises)")
    f.add_argument("--shading", action="store_true",
                   help="fit face-shaded targets (matches the hard renderer's output)")
    f.add_argument("--out", default="", help="render the fit (not ported yet: raises)")
    f.set_defaults(fn=cmd_fit)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
