"""Command-line interface of the PyTorch port: render / animate / edit / fit / probe.

Port of ``raytracing_test_tpu/app/cli.py`` with its verbs, arguments and
defaults, plus ``--device`` (default ``cuda``; the tests pass ``--device
cpu``). ``render``, ``animate``, ``edit`` and ``probe`` run on
``app/session.WorldSession``, as in the JAX CLI: the world is generated by
the native C++ runtime (``--no-native``: the python tree), each frame syncs
the edits, picks the looked-at block and draws through the mode's renderer.
``fast``, ``fused`` (the default) and ``progressive`` march through the fused
march kernel (``kernels/fused_march``: the CUDA kernel on the card, its
plain version on ``--device cpu``), ``bricks`` / ``bricks-pallas`` through the
brick kernels, ``reference`` (or ``--slow``) through the per-cell reference
march as PyTorch operations, ``spatial`` and ``handoff`` with the world split
along x over every rank (parallel/spatial.py, parallel/handoff.py). ``--ao``
adds hemisphere AO in every mode but ``handoff``.
``edit`` reads a command script (or ``-`` for stdin) with the verbs the
reference binds to keys and mouse: look, rotate, move, goto, select, place,
delete, pick, time, render, save. ``probe`` prints every debug channel at
one pixel of the reference render. ``fit`` runs ``app/fit.fit_world``: at
its default (``--engine ''``) the blind volumetric scan's step
(``parallel/sharding.make_train_step``, 96 steps); ``--engine fused`` and
``--engine '' --guided`` the guided step through ``render_rays_diff_guided``
(the seed march and the window kernel pair). ``fit --out`` renders the fitted
fields with ``render_image_diff`` from the CLI's camera.

    python -m raytracing_test_tpu_torch.app.cli render --out frame.png
    python -m raytracing_test_tpu_torch.app.cli render --mode reference --ao --out ref.png
    python -m raytracing_test_tpu_torch.app.cli render --mode bricks-pallas --out frame.png
    python -m raytracing_test_tpu_torch.app.cli animate --frames 8 --out-dir anim/
    echo "look 55 -25; place; render out.png; save w.npz" | \
        python -m raytracing_test_tpu_torch.app.cli edit -
    python -m raytracing_test_tpu_torch.app.cli probe --row 256 --col 256
    python -m raytracing_test_tpu_torch.app.cli fit --steps 20 --out fit.png
    python -m raytracing_test_tpu_torch.app.cli fit --engine fused --steps 20
    python -m raytracing_test_tpu_torch.app.cli fit --engine "" --guided --steps 20

Several ranks: under ``torchrun --nproc-per-node K`` every rank joins the
process group (``--backend``, default NCCL for ``cuda``, gloo for ``cpu``)
on ``cuda:<LOCAL_RANK>``; ``spatial`` and ``handoff`` split the world over
the K ranks, ``fit`` is data parallel over them, and rank 0 alone prints
the fit and writes the PNGs. A plain process is a world of one.

    torchrun --nproc-per-node 4 -m raytracing_test_tpu_torch.app.cli render --mode handoff
    torchrun --nproc-per-node 4 -m raytracing_test_tpu_torch.app.cli fit --steps 20

``pallas`` is rejected: the JAX CLI offers it, but its
``WorldSession.render`` has no renderer for it and raises ``unknown render
mode 'pallas'``.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import zlib

import numpy as np
import torch

from ..config import CameraConfig, FitConfig, RenderConfig, world_for_size
from ..core.flatten import scene_from_grid
from ..utils.log import debug, set_debug_level
from ..utils.profiling import FrameStats, sync, trace
from ..worldgen import terrain
from ..parallel import mesh as meshlib
from .session import RENDER_MODES, WorldSession

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


def camera_pos(args) -> np.ndarray:
    """``--pos`` as "x,y,z", else the reference's default camera position."""
    if args.pos:
        return np.asarray([float(v) for v in args.pos.split(",")], np.float64)
    return np.asarray(CameraConfig().pos, np.float64)


def make_session(args) -> WorldSession:
    """The JAX CLI's ``_mk_session``: the world for ``--world``, on ``--device``,
    with the camera of ``--pos`` / ``--yaw`` / ``--pitch``."""
    s = WorldSession(world_for_size(args.world), use_native=not args.no_native,
                     device=args.device)
    s.pos = camera_pos(args)
    s.yaw, s.pitch = args.yaw, args.pitch
    return s


def _save(img: torch.Tensor, path: str) -> None:
    """Write the frame as a PNG: on rank 0 only, when several ranks render."""
    if meshlib.process_rank() != 0:
        return
    write_png(img.cpu().numpy(), path)
    debug(1, f"wrote {path}")


def _rcfg(args) -> RenderConfig:
    return RenderConfig(
        width=args.width,
        height=args.height,
        enable_ao=args.ao,
        enable_shadows=not args.no_shadows,
    )


def cmd_render(args) -> None:
    s = make_session(args)
    mode = "reference" if args.slow else args.mode
    _save(s.render(_rcfg(args), mode=mode), args.out)


def cmd_animate(args) -> None:
    s = make_session(args)
    os.makedirs(args.out_dir, exist_ok=True)
    rcfg = _rcfg(args)
    stats = FrameStats()  # the reference's rolling frame average (main.cpp:221)
    with trace(args.trace):
        for i in range(args.frames):
            s.time = i / 10.0  # drives the water surface animation
            s.rotate(args.spin, 0.0)
            stats.start()
            img = s.render(rcfg)
            sync(img)
            stats.stop(rays=rcfg.width * rcfg.height)
            _save(img, os.path.join(args.out_dir, f"frame_{i:04d}.png"))
            debug(1, f"frame {i}: {stats.status()} (host clock, sync + pick + render, "
                     f"{s.device})")


def cmd_edit(args) -> None:
    s = make_session(args)
    rcfg = _rcfg(args)
    if args.script == "-":
        text = sys.stdin.read()
    else:
        with open(args.script) as f:
            text = f.read()
    for raw in text.replace(";", "\n").splitlines():
        parts = raw.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        op, rest = parts[0], parts[1:]
        if op == "look":
            s.yaw, s.pitch = float(rest[0]), float(rest[1])
        elif op == "rotate":
            s.rotate(float(rest[0]), float(rest[1]))
        elif op == "move":
            s.move(*(float(v) for v in rest))
        elif op == "goto":
            s.pos = np.asarray([float(v) for v in rest], np.float64)
        elif op == "select":
            s.selected = int(rest[0]) % len(s.hotbar)
        elif op == "place":
            pos = s.place(int(rest[0]) if rest else None)
            debug(1, f"placed at {pos}")
        elif op == "delete":
            pos = s.delete()
            debug(1, f"deleted {pos}" if pos else "nothing to delete in range")
        elif op == "pick":
            debug(1, f"pick: {s.pick()}")
        elif op == "time":
            s.time = float(rest[0])
        elif op == "render":
            _save(s.render(rcfg), rest[0] if rest else "frame.png")
        elif op == "save":
            from . import checkpoint

            s.sync()
            checkpoint.save_world(rest[0], s.grid, s.palette)
            debug(1, f"world saved to {rest[0]}")
        else:
            debug(0, f"unknown edit command: {op}")


def cmd_fit(args) -> None:
    from ..parallel.sharding import params_to_scene
    from ..render.camera import camera_from_yaw_pitch
    from ..render.diff import render_image_diff
    from . import fit as fitmod

    grid, pal = terrain.gen_world_grid(world_for_size(args.world))
    scene = scene_from_grid(grid, pal, torch.device(args.device))
    fcfg = FitConfig(
        views=args.views, steps=args.steps, lr=args.lr, resolution=args.fit_res,
        guided=args.guided, engine=args.engine, shading=args.shading,
    )
    mesh = None
    if meshlib.launched_world() > 1:  # data parallel over the ranks torchrun started
        mesh = meshlib.make_mesh(meshlib.world_size(), 1, scene.device)
    params, losses = fitmod.fit_world(scene, grid.shape, fcfg, ckpt_path=args.ckpt or None,
                                      batch=args.batch, mesh=mesh)
    if meshlib.process_rank() == 0:
        print(f"fit done: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if args.out:
        cam = camera_from_yaw_pitch(camera_pos(args), args.yaw, args.pitch, scene.device)
        with torch.no_grad():
            img = render_image_diff(params_to_scene(params), cam, _rcfg(args))
        _save(img, args.out)


def cmd_probe(args) -> None:
    from . import debug as dbg

    s = make_session(args)
    s.sync()
    ch = dbg.render_debug(s.scene, s.camera(), _rcfg(args))
    for k, v in dbg.probe_pixel(ch, args.row, args.col).items():
        print(f"{k}: {v}")


def _render_mode(value: str) -> str:
    if value in RENDER_MODES:
        return value
    if value in NO_RENDERER_MODES:
        raise argparse.ArgumentTypeError(
            f"render mode {value!r} has no renderer: the reference does not render this mode "
            f"either (its WorldSession.render raises for it)")
    raise argparse.ArgumentTypeError(
        f"unknown render mode {value!r} (choose from {', '.join(RENDER_MODES)})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracing_test_tpu_torch")
    p.add_argument("--device", default="cuda", help="torch device: cuda[:n] (default) or cpu; "
                   "under torchrun, cuda means cuda:<LOCAL_RANK>")
    p.add_argument("--backend", default="",
                   help="process group backend under torchrun (default: nccl for cuda, gloo "
                   "for cpu)")
    p.add_argument("--debug-level", type=int, default=1)
    p.add_argument("--world", type=int, default=200, help="world columns per side")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--pos", type=str, default="")
    p.add_argument("--yaw", type=float, default=45.0)
    p.add_argument("--pitch", type=float, default=25.0)  # positive pitch looks down (ref convention)
    p.add_argument("--ao", action="store_true", help="hemisphere AO, in every render mode")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--no-native", action="store_true",
                   help="the python tree instead of the native C++ runtime")
    p.add_argument("--slow", action="store_true", help="use the reference path")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render")
    r.add_argument("--out", default="frame.png")
    r.add_argument("--mode", type=_render_mode, default="fused",
                   help=f"render path: {', '.join(RENDER_MODES)} (fast, fused and progressive "
                   "run the fused march kernel, bricks and bricks-pallas the brick kernels, "
                   "reference PyTorch operations, spatial and handoff split the world over "
                   "the ranks; see app/session.py render)")
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate")
    a.add_argument("--frames", type=int, default=8)
    a.add_argument("--spin", type=float, default=3.0)
    a.add_argument("--out-dir", default="anim")
    a.add_argument("--trace", default=None, help="torch.profiler trace dir")
    a.set_defaults(fn=cmd_animate)

    e = sub.add_parser("edit")
    e.add_argument("script", help="command script path, or - for stdin")
    e.set_defaults(fn=cmd_edit)

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
    f.add_argument("--engine", default="", choices=["", "fused"],
                   help="training engine: '' = the blind volumetric scan (96 steps), or with "
                   "--guided the guided step; 'fused' = the guided step: the seed march + "
                   "window kernel pair (render_rays_diff_guided)")
    f.add_argument("--shading", action="store_true",
                   help="fit face-shaded targets (matches the hard renderer's output)")
    f.add_argument("--out", default="",
                   help="write a PNG of the fitted fields (render_image_diff, 192 steps) from "
                   "the camera of --pos / --yaw / --pitch at --width x --height")
    f.set_defaults(fn=cmd_fit)

    pr = sub.add_parser("probe")
    pr.add_argument("--row", type=int, default=0)
    pr.add_argument("--col", type=int, default=0)
    pr.set_defaults(fn=cmd_probe)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    set_debug_level(args.debug_level)
    owned = not meshlib.in_group()  # leave a caller's process group as it is
    if meshlib.launched_world() > 1:
        if args.device == "cuda":
            args.device = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
        meshlib.initialize_multihost(backend=args.backend or meshlib.default_backend(args.device))
    try:
        args.fn(args)
    finally:
        if owned:
            meshlib.shutdown()


if __name__ == "__main__":
    main()
