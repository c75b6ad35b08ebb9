"""Smoke run of the PyTorch port on one CUDA card: build, parity, frames, timing.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

  1. device  -- the card's name and power limit; no CUDA means exit 2.
  2. build   -- nvcc builds raytracing_test_tpu_torch/csrc/*.cu.
  3. world   -- the default WorldConfig world (200x200 columns in a
                256x128x256 grid) as a Scene on the card.
  4. parity  -- at 1024x1024 the CUDA kernel against its plain PyTorch version
                on the same card and inputs: full-feature and lean from the
                bench camera, and a water view with mirror and glass blocks
                at time 1.2; and the CLI's default view at its 512x512
                frame size. Contract (tests/test_render_parity.py
                assert_images_close): |diff| <= 1e-5 on >= 99% of pixels;
                mat and cell equal on >= 99.9% of rays.
  5. frames  -- the port's CLI, in-process: ``render`` at its defaults, then
                ``animate --frames 4``. The kernel's launch count is reset
                just before and must rise by at least one per frame.
  6. timing  -- CUDA events after warm-up, 1024x1024: kernel and plain
                version ms per frame, rays/s, full-feature and lean.

The line before the last holds the card's name and power limit, the one
before it the per-kernel JSON; the last line is the ok JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FULL = 1024  # frame side for parity and timing
BENCH_POS = (100.0, 60.0, 40.0)  # bench.py's camera
BENCH_DIR = (0.55, -0.4, 0.55)
WATER_TIME = 1.2
ATOL, MAX_BAD_FRAC, MIN_EQ_FRAC = 1e-5, 0.01, 0.999


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Mean ms per call from CUDA events around ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def water_world():
    """The default world with mirror and glass blocks placed by a lake, and a
    camera looking across it (so reflection and refraction both occur)."""
    from raytracing_test_tpu.config import WorldConfig
    from raytracing_test_tpu.core.color import rgb_to_u64
    from raytracing_test_tpu.core.types import Block, Properties
    from raytracing_test_tpu.worldgen import terrain

    cfg = WorldConfig()
    grid, pal = terrain.gen_world_grid(cfg)
    xs, zs = np.nonzero(terrain.heightmap(cfg) < 18)
    x, z = int(xs[0]), int(zs[0])
    mirror = pal.id_for(Block(int(Properties.REFLECTIVE), int(rgb_to_u64(255, 255, 255)), 0.94))
    glass = pal.id_for(Block(int(Properties.REFRACTIVE), int(rgb_to_u64(0, 0, 0)), 1.5))
    grid[x + 4:x + 12, 21:27, z + 14] = mirror
    grid[x + 14, 21:25, z + 2:z + 8] = glass
    return grid, pal, (x - 6.0, 26.0, z - 6.0), (0.55, -0.35, 0.55)


def march_state(scene, pos, dirn, side):
    from raytracing_test_tpu_torch.render import fast
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions

    dev = scene.device
    cam = Camera(pos=torch.tensor(pos, device=dev), dir=torch.tensor(dirn, device=dev))
    dirs = ray_directions(cam, side, side)
    return fast._init_state(cam.pos, dirs, torch.ones(dirs.shape[0], device=dev))


def parity(name, scene, s, rcfg, time_s, side):
    """Kernel vs plain version on one state; returns (max_abs_err, kernel dict)."""
    from raytracing_test_tpu_torch.kernels import fused_march as fm

    ok = fm.fused_march_call(scene, s, rcfg, time_s)
    torch.cuda.synchronize()
    op = fm.fused_march_plain(scene, s, rcfg, time_s)
    ck, _ = fm.shade_outputs(scene, ok, rcfg)
    cp, _ = fm.shade_outputs(scene, op, rcfg)
    ck, cp = ck.cpu().numpy(), cp.cpu().numpy()
    if not (np.isfinite(ck).all() and ck.shape == (side * side, 3)):
        raise AssertionError(f"{name}: kernel image not finite or wrong shape {ck.shape}")
    d = np.abs(ck - cp).max(axis=-1)
    bad = float((d > ATOL).mean())
    mat_eq = float((ok["mat"] == op["mat"]).float().mean())
    cell_eq = float((ok["cell"] == op["cell"]).all(dim=1).float().mean())
    print(f"parity {name}: max_abs_err {d.max():.3e} bad_frac {bad:.6f} "
          f"mat_eq {mat_eq:.6f} cell_eq {cell_eq:.6f} "
          f"hit {float((ok['mat'] != 0).float().mean()):.4f}")
    if bad > MAX_BAD_FRAC or mat_eq < MIN_EQ_FRAC or cell_eq < MIN_EQ_FRAC:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return float(d.max()), ok


def check_png(path, side):
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[16:24] != side.to_bytes(4, "big") * 2:
        raise AssertionError(f"{path}: not a {side}x{side} PNG")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    return run(torch.device("cuda:0"), FULL)


def run(dev: torch.device, side: int) -> int:
    from raytracing_test_tpu.config import CameraConfig, RenderConfig, WorldConfig
    from raytracing_test_tpu.worldgen import terrain
    from raytracing_test_tpu_torch.app import cli
    from raytracing_test_tpu_torch.core.flatten import scene_from_grid
    from raytracing_test_tpu_torch.kernels import build
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.render.camera import Camera, yaw_pitch_dir

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({build.BUILD_INFO['path']})")
    for line in build.BUILD_INFO.get("nvcc_report", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")

    # 3. world
    t0 = time.perf_counter()
    grid, pal = terrain.gen_world_grid(WorldConfig())
    scene = scene_from_grid(grid, pal, dev)
    torch.cuda.synchronize()
    print(f"world: grid {tuple(scene.shape3)}, palette {len(pal)}, y_max {scene.y_max}, "
          f"scene tensors {scene.nbytes} bytes, built in {time.perf_counter() - t0:.2f} s")

    # 4. parity, kernel vs plain version on the card
    full = RenderConfig(width=side, height=side)
    lean = RenderConfig(width=side, height=side, enable_materials=False, enable_shadows=False)
    s_bench = march_state(scene, BENCH_POS, BENCH_DIR, side)
    err_full, _ = parity("full", scene, s_bench, full, 0.0, side)
    err_lean, _ = parity("lean", scene, s_bench, lean, 0.0, side)
    wgrid, wpal, wpos, wdir = water_world()
    wscene = scene_from_grid(wgrid, wpal, dev)
    err_water, ow = parity("water", wscene, march_state(wscene, wpos, wdir, side),
                           full, WATER_TIME, side)
    n_refl = int(ow["refl"].sum())
    n_tint = int((ow["color_mod"] < 1.0).any(dim=1).sum())
    print(f"water: {n_refl} reflected rays, {n_tint} tinted rays")
    if n_refl == 0 or n_tint == 0:
        raise AssertionError("water view: expected reflected and tinted (refracted) rays")
    # the CLI's own view and frame size (the main path's shapes)
    d = cli.build_parser().parse_args(["render"])
    cli_cfg = RenderConfig(width=d.width, height=d.height)
    err_cli, _ = parity("cli-view", scene,
                        march_state(scene, CameraConfig().pos, yaw_pitch_dir(d.yaw, d.pitch), d.width),
                        cli_cfg, 0.0, d.width)
    max_err = max(err_full, err_lean, err_water, err_cli)

    # 5. frames through the CLI; only these launches are counted
    with tempfile.TemporaryDirectory() as tmp:
        fm.LAUNCHES = 0
        t0 = time.perf_counter()
        cli.main(["--device", str(dev), "render", "--out", os.path.join(tmp, "frame.png")])
        cli.main(["--device", str(dev), "animate", "--frames", "4",
                  "--out-dir", os.path.join(tmp, "anim")])
        torch.cuda.synchronize()
        launches = fm.LAUNCHES
        print(f"frames: 5 frames at 512x512 in {time.perf_counter() - t0:.2f} s "
              f"(world generation included), fused_march launches {launches}")
        if launches < 5:
            raise AssertionError(f"main path launched the kernel {launches} times for 5 frames")
        check_png(os.path.join(tmp, "frame.png"), 512)
        for i in range(4):
            check_png(os.path.join(tmp, "anim", f"frame_{i:04d}.png"), 512)

    # 6. timing at 1024^2 (grid resident in L2 across frames, as when rendering)
    n = side * side
    times = {}
    for name, rcfg in (("full", full), ("lean", lean)):
        k_ms = cuda_ms(lambda: fm.fused_march_call(scene, s_bench, rcfg, 0.0), reps=20, warmup=3)
        p_ms = cuda_ms(lambda: fm.fused_march_plain(scene, s_bench, rcfg, 0.0), reps=3, warmup=1)
        cam = Camera(pos=torch.tensor(BENCH_POS, device=dev), dir=torch.tensor(BENCH_DIR, device=dev))
        f_ms = cuda_ms(lambda: fm.render_image_fused(scene, cam, rcfg, 0.0), reps=10, warmup=2)
        times[name] = (k_ms, p_ms)
        print(f"timing {name} {side}x{side}: kernel {k_ms:.4f} ms/frame ({n / k_ms * 1e3:.4e} rays/s), "
              f"plain {p_ms:.3f} ms/frame ({n / p_ms * 1e3:.4e} rays/s), "
              f"speedup {p_ms / k_ms:.1f}x, whole frame (rays+kernel+shade) {f_ms:.4f} ms "
              f"| {card}")

    print(json.dumps({"kernels": [{
        "name": "fused_march",
        "route": "cuda",
        "source": "raytracing_test_tpu_torch/csrc/fused_march.cu",
        "replaces": "raytracing_test_tpu/kernels/fused_march.py:139",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["full"][0],
        "plain_ms": times["full"][1],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
