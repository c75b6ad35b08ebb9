"""Smoke run of the PyTorch port on one CUDA card: build, parity, serving
frames, training steps, timing.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

  1. device  -- the card's name and power limit; no CUDA means exit 2.
  2. build   -- one nvcc per raytracing_test_tpu_torch/csrc/*.cu, all at once.
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
  7. train   -- the training slice at the bench shapes (default world,
                solid_density 50, bench camera, 1024x1024 rays, 24 steps):
                a. seed: seed_depth_fused (coarse x4 then full-resolution lean
                   march, margin 3);
                b. window parity: window_fwd/window_bwd against window_plain
                   on the same seeds, forward with sky off, sky on, and
                   shading with shadow_steps 6; gradients of mean(rgb) in
                   density, albedo, origin and dirs. Contract: forward
                   |diff| <= 1e-5 on >= 99% of pixels, gradients within 1e-5
                   max-scaled (atomic ordering is the only difference);
                c. train: five make_train_step_fused steps on one fixed batch
                   of 16384 rays from make_targets: finite losses, the fifth
                   below the first, one window_fwd and one window_bwd per step;
                d. cli: ``fit --steps 10`` at its defaults, in-process;
                e. timing: seed, window_fwd, window_bwd, the whole
                   loss+backward, rays/s, the plain versions' times and the
                   peak device memory of a train step. The kernels' launch
                   counts are reset just before c and read just after d.

The line before the last holds the card's name and power limit, the one
before it the per-kernel JSON (time, launches, plain time and the bound:
the larger of the bytes the kernel must move over 3.35 TB/s and its float32
operations over 67 TFLOP/s, the H100 SXM data-sheet peaks); the last line is
the ok JSON.
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
GRAD_TOL = 1e-5  # max-scaled, kernel vs plain version
NUM_STEPS = 24  # bench.py's window length
SOLID_DENSITY = 50.0  # bench.py's diff scene
TRAIN_BATCH = 16384
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
# float32 operations each unit of work needs at the least (for the bound):
MARCH_OPS_PER_CROSSING = 3  # two compares pick the axis, one add advances it
WINDOW_FWD_OPS_PER_SAMPLE = 20  # enumerate 5, exp + composite 11, w_sum/t_exp 4
WINDOW_BWD_OPS_PER_SAMPLE = 36  # enumerate 5, exp + weights 4, g_od 7, grads 8, pose 12


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


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time for these bytes and operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def water_world():
    """The default world with mirror and glass blocks placed by a lake, and a
    camera looking across it (so reflection and refraction both occur)."""
    from raytracing_test_tpu_torch.config import WorldConfig
    from raytracing_test_tpu_torch.core.color import rgb_to_u64
    from raytracing_test_tpu_torch.core.types import Block, Properties
    from raytracing_test_tpu_torch.worldgen import terrain

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


def window_rows(cell, tmax, istep, abs_delta, shape3) -> int:
    """Distinct in-grid field rows the windows of these rays read (the bytes
    a window launch must move, for its bound)."""
    from raytracing_test_tpu_torch.render.diff import _window_lin
    from raytracing_test_tpu_torch.render.renderer import _argmin_axis

    rows = []
    with torch.no_grad():
        for _ in range(NUM_STEPS):
            lin, inside = _window_lin(shape3, cell)
            rows.append(lin[inside])
            oh = torch.nn.functional.one_hot(_argmin_axis(tmax).long(), 3).to(torch.bool)
            cell = torch.where(oh, cell + istep, cell)
            tmax = torch.where(oh, tmax + abs_delta, tmax)
    return int(torch.unique(torch.cat(rows)).numel())


def window_grads(render, ds, cam, dirs, seed, **kw):
    """rgb and the gradients of mean(rgb) in density, albedo, origin and dirs."""
    from raytracing_test_tpu_torch.render.diff import DiffScene

    leaves = [t.detach().clone().requires_grad_(True)
              for t in (ds.density, ds.albedo, cam.pos, dirs)]
    rgb = render(DiffScene(leaves[0], leaves[1]), leaves[2], leaves[3],
                 num_steps=NUM_STEPS, start_t=seed, **kw)
    rgb.mean().backward()
    torch.cuda.synchronize()
    return [rgb.detach()] + [t.grad for t in leaves]


def window_parity(fw, ds, cam, dirs, seed):
    """Kernels vs plain version, forward and gradients, three configurations.
    Returns (forward max_abs_err, gradient max_abs_err)."""
    fwd_err = grad_err = 0.0
    for kw in (dict(sky=False), dict(sky=True), dict(sky=True, shading=True, shadow_steps=6)):
        k = window_grads(fw.render_window_fused, ds, cam, dirs, seed, **kw)
        p = window_grads(fw.render_window_plain, ds, cam, dirs, seed, **kw)
        d = (k[0] - p[0]).abs().max(dim=1).values
        bad = float((d > ATOL).float().mean())
        if not torch.isfinite(k[0]).all() or bad > MAX_BAD_FRAC:
            raise AssertionError(f"window {kw}: forward disagrees (bad fraction {bad})")
        fwd_err = max(fwd_err, float(d.max()))
        scaled = {}
        for name, a, b in zip(("density", "albedo", "origin", "dirs"), k[1:], p[1:]):
            m = torch.isfinite(b)
            if not torch.equal(torch.isfinite(a), m):
                raise AssertionError(f"window {kw}: {name} gradient finite on other entries")
            err = (a[m] - b[m]).abs().max()
            scaled[name] = float(err / b[m].abs().max())
            grad_err = max(grad_err, float(err))
        print(f"parity window {kw}: forward max_abs_err {float(d.max()):.3e} bad_frac {bad:.6f}; "
              "gradients max-scaled " + " ".join(f"{k_} {v:.3e}" for k_, v in scaled.items()))
        if max(scaled.values()) > GRAD_TOL:
            raise AssertionError(f"window {kw}: gradients disagree beyond {GRAD_TOL} max-scaled")
    return fwd_err, grad_err


def profile_step(fn, card, steps: int = 5):
    """Where a train step's time goes: torch.profiler over ``steps`` calls of
    ``fn``; device busy time, idle share, kernels per step, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy = sum(sum(v) for v in per_name.values())
    launches = sum(len(v) for v in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    print(f"profile train step (loss+backward, {steps} steps): host {wall_us / steps / 1e3:.4f} ms, "
          f"device busy {busy / steps / 1e3:.4f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{launches / steps:.0f} device kernels per step | {card}")
    for name, v in top:
        print(f"  {sum(v) / steps / 1e3:.4f} ms/step x{len(v) // steps}: {name[:90]}")


def train_phase(dev, card, side, grid, pal, scene, cli, fm, fw):
    from raytracing_test_tpu_torch.app import fit
    from raytracing_test_tpu_torch.config import WorldConfig
    from raytracing_test_tpu_torch.core.flatten import palette_arrays
    from raytracing_test_tpu_torch.parallel import sharding
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions
    from raytracing_test_tpu_torch.render.diff import DiffScene, _pack_fields, diff_scene_from_grid
    from raytracing_test_tpu_torch.render.fast import sun_unit

    n = side * side
    shape3 = tuple(WorldConfig().grid_shape)
    ds = diff_scene_from_grid(grid, palette_arrays(pal)[0], dev, solid_density=SOLID_DENSITY)
    cam = Camera(pos=torch.tensor(BENCH_POS, device=dev), dir=torch.tensor(BENCH_DIR, device=dev))
    dirs = ray_directions(cam, side, side)

    # a. seed
    fm.LAUNCHES = 0
    seed = fm.seed_depth_fused(scene, cam.pos, dirs, (side, side))
    torch.cuda.synchronize()
    n_miss = int((seed >= 9.9e5).sum())
    print(f"train seed: {side}x{side} seeds, {n_miss} sky rays, fused_march launches {fm.LAUNCHES}")
    if fm.LAUNCHES < 2 or not torch.isfinite(seed).all() or n_miss == n:
        raise AssertionError("seed pass: expected two lean march launches and surface hits")

    # b. window parity on the same seeds
    fwd_err, grad_err = window_parity(fw, ds, cam, dirs, seed)

    # c. five train steps on one fixed batch; the main path's counts start here
    fm.LAUNCHES = fw.LAUNCHES_FWD = fw.LAUNCHES_BWD = 0
    g = WorldConfig().grid_shape
    cams = fit.ring_cameras((g[0] / 2, g[1] / 3, g[2] / 2), 0.8 * g[0], 0.9 * g[1], 8, device=dev)
    origins, rdirs, targets = fit.make_targets(scene, cams, 64)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, origins.shape[0], TRAIN_BATCH)).to(dev)
    batch = (origins[idx], rdirs[idx], targets[idx])
    params = sharding.init_params(shape3, dev)
    opt = torch.optim.Adam(params.parameters(), lr=0.05)
    step_fn = sharding.make_train_step_fused(params, opt, sharding.guide_scene_from_params(params))
    losses = []
    for i in range(5):
        before = (fw.LAUNCHES_FWD, fw.LAUNCHES_BWD)
        loss, _ = step_fn(*batch)
        losses.append(float(loss))
        if (fw.LAUNCHES_FWD, fw.LAUNCHES_BWD) != (before[0] + 1, before[1] + 1):
            raise AssertionError("a train step did not launch window_fwd and window_bwd once each")
    print(f"train: 5 steps on {TRAIN_BATCH} rays, losses {' '.join(f'{v:.6f}' for v in losses)}")
    if not np.isfinite(losses).all() or not losses[4] < losses[0]:
        raise AssertionError(f"train: losses not finite or not decreasing: {losses}")

    # d. the fit verb at its defaults
    t0 = time.perf_counter()
    cli.main(["--device", str(dev), "fit", "--steps", "10"])
    torch.cuda.synchronize()
    counts = {"window_fwd": fw.LAUNCHES_FWD, "window_bwd": fw.LAUNCHES_BWD}
    march_launches = fm.LAUNCHES
    print(f"cli fit: 10 steps in {time.perf_counter() - t0:.2f} s (world and targets included); "
          f"main-path launches {counts}, fused_march {march_launches}")
    if counts != {"window_fwd": 15, "window_bwd": 15}:
        raise AssertionError(f"train path launches {counts}, expected 15 each")

    # e. timing at the bench shapes (1024^2 rays x 24 steps)
    out = {"march_launches": march_launches}
    field = _pack_fields(ds)
    _, _, cell, tmax, istep, absd = fw.window_inputs(shape3, cam.pos, dirs, seed)
    sun = sun_unit((2.0, 1.0, 4.0))
    wargs = (field, cell, tmax, istep, absd, shape3, sun, NUM_STEPS, False)
    surf, t_end, _, _ = fw._launch_fwd(*wargs)
    g_surf = torch.full((n, 3), 1.0 / (3 * n), device=dev)
    g_tend = torch.zeros(n, device=dev)
    seed_ms = cuda_ms(lambda: fm.seed_depth_fused(scene, cam.pos, dirs, (side, side)), reps=10, warmup=2)
    fwd_ms = cuda_ms(lambda: fw._launch_fwd(*wargs), reps=20, warmup=3)
    bwd_ms = cuda_ms(lambda: fw._launch_bwd(*wargs, g_surf, g_tend, surf, t_end), reps=20, warmup=3)

    def step(render):
        d = ds.density.detach().requires_grad_(True)
        a = ds.albedo.detach().requires_grad_(True)
        render(DiffScene(d, a), cam.pos, dirs, num_steps=NUM_STEPS, start_t=seed,
               sky=False).mean().backward()

    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(fw.render_window_fused), reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    plain_step_ms = cuda_ms(lambda: step(fw.render_window_plain), reps=3, warmup=1)
    grad_leaves = [field.detach().requires_grad_(True), tmax.detach().requires_grad_(True),
                   absd.detach().requires_grad_(True)]
    plain_out = fw.window_plain(grad_leaves[0], cell, grad_leaves[1], istep, grad_leaves[2],
                                shape3, sun, NUM_STEPS, False)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        plain_out[:2], grad_leaves, (g_surf, g_tend), retain_graph=True), reps=3, warmup=1)
    with torch.no_grad():
        plain_fwd_ms = cuda_ms(lambda: fw.window_plain(*wargs), reps=3, warmup=1)
    print(f"timing train {side}x{side}x{NUM_STEPS}: seed {seed_ms:.4f} ms, window_fwd {fwd_ms:.4f} ms, "
          f"window_bwd {bwd_ms:.4f} ms (gradient zero-fill included), loss+backward "
          f"{step_ms:.4f} ms ({n / step_ms * 1e3:.4e} rays/s); plain: window {plain_fwd_ms:.3f} ms, "
          f"backward {plain_bwd_ms:.3f} ms, loss+backward {plain_step_ms:.3f} ms "
          f"({n / plain_step_ms * 1e3:.4e} rays/s); peak memory of a step {peak} bytes | {card}")

    profile_step(lambda: step(fw.render_window_fused), card)

    # bounds from this run's windows: per-ray planes, the field rows these
    # seeds touch, and for the backward the zero-filled gradient field plus a
    # read-modify-write of every touched row
    rows = window_rows(cell, tmax, istep, absd, shape3)
    V = field.shape[0]
    samples = n * NUM_STEPS
    fwd_bytes = n * (48 + 24) + rows * 16
    bwd_bytes = n * (48 + 32 + 24) + rows * 16 + V * 16 + rows * 32
    out["window_fwd"] = dict(ms=fwd_ms, plain_ms=plain_fwd_ms, launches=counts["window_fwd"],
                             max_abs_err=fwd_err,
                             bound=bound(fwd_bytes, samples * WINDOW_FWD_OPS_PER_SAMPLE))
    out["window_bwd"] = dict(ms=bwd_ms, plain_ms=plain_bwd_ms, launches=counts["window_bwd"],
                             max_abs_err=grad_err,
                             bound=bound(bwd_bytes, samples * WINDOW_BWD_OPS_PER_SAMPLE))
    for name in ("window_fwd", "window_bwd"):
        b = out[name]["bound"]
        print(f"bound {name}: {fwd_bytes if name == 'window_fwd' else bwd_bytes} bytes "
              f"({rows} field rows touched of {V}), {samples} samples -> {b[0]:.4f} ms ({b[1]}), "
              f"kernel at {b[0] / out[name]['ms']:.3f} of it")
    return out


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
    from raytracing_test_tpu_torch.config import CameraConfig, RenderConfig, WorldConfig
    from raytracing_test_tpu_torch.worldgen import terrain
    from raytracing_test_tpu_torch.app import cli
    from raytracing_test_tpu_torch.core.flatten import scene_from_grid
    from raytracing_test_tpu_torch.kernels import build
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.kernels import fused_window as fw
    from raytracing_test_tpu_torch.render.camera import Camera, yaw_pitch_dir

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, info in sorted(build.BUILD_INFO.items()):
        print(f"  {name}: {info['path']}")
        for line in info.get("nvcc_report", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"    nvcc: {line.strip()}")

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
    err_full, o_full = parity("full", scene, s_bench, full, 0.0, side)
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
        serve_launches = fm.LAUNCHES
        print(f"frames: 5 frames at 512x512 in {time.perf_counter() - t0:.2f} s "
              f"(world generation included), fused_march launches {serve_launches}")
        if serve_launches < 5:
            raise AssertionError(f"main path launched the kernel {serve_launches} times for 5 frames")
        check_png(os.path.join(tmp, "frame.png"), 512)
        for i in range(4):
            check_png(os.path.join(tmp, "anim", f"frame_{i:04d}.png"), 512)

    # 6. timing at 1024^2 (grid resident in L2 across frames, as when rendering)
    n = side * side
    times = {}
    crossings = int(o_full["steps"].to(torch.int64).sum())  # primary crossings of the frame
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

    # full-feature frame: grid_enc and palette flags read once, 72 bytes of
    # rays in and 88 bytes out per ray; one march step per primary crossing
    march_bytes = scene.grid_enc.numel() + scene.flags.numel() * 4 + n * (72 + 88)
    march_bound = bound(march_bytes, crossings * MARCH_OPS_PER_CROSSING)
    print(f"bound fused_march full {side}x{side}: {march_bytes} bytes, {crossings} primary "
          f"crossings -> {march_bound[0]:.4f} ms ({march_bound[1]}), "
          f"kernel at {march_bound[0] / times['full'][0]:.3f} of it")

    # 7. the training slice
    train = train_phase(dev, card, side, grid, pal, scene, cli, fm, fw)
    launches = serve_launches + train["march_launches"]

    kernels = [{
        "name": "fused_march",
        "route": "cuda",
        "source": "raytracing_test_tpu_torch/csrc/fused_march.cu",
        "replaces": "raytracing_test_tpu/kernels/fused_march.py:139",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["full"][0],
        "plain_ms": times["full"][1],
        "bound_ms": march_bound[0],
        "bound_by": march_bound[1],
        "library_ms": None,
    }]
    for name, line in (("window_fwd", 324), ("window_bwd", 417)):
        k = train[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "raytracing_test_tpu_torch/csrc/fused_window.cu",
            "replaces": f"raytracing_test_tpu/kernels/fused_window.py:{line}",
            "launches": k["launches"],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
