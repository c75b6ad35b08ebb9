"""Old-against-new timing of the port's march, window and brick kernels on
one CUDA card, each tree of the port in a process of its own.

    mkdir -p _ab/old && git archive <commit> raytracing_test_tpu_torch | tar -x -C _ab/old
    python3 kernel_ab.py _ab/old .

Each TREE is a directory that holds a ``raytracing_test_tpu_torch/``
package of PR 4 or later (a checkout, or an unpacked ``git archive`` of
one; ``_ab/`` is gitignored). A tree's process imports that tree's
package, builds its kernels from that tree's sources into its own
``_build/``, and drives the same inputs through the wrappers that every
such tree has (``fused_march_call``, ``_launch_fwd``, ``_launch_bwd``,
``brick_advance``, ``brick_fine``), at the shapes the main paths launch:

  march       -- from the bench camera: 1024^2 full, full without shadows,
                 lean (the seed's fine pass), both prox passes (1024^2 and
                 256^2) and full at 256^2; 256^2 lean (the seed's coarse
                 pass); the CLI's 512^2 render view; one 64^2 target view
                 of the fit (materials on, shadows off); the lean seeds of
                 a 16384- and an 8192-ray train batch. Frames and the
                 exact seed passes get the image width where the tree's
                 ``fused_march_call`` takes ``image_w``, as its main path
                 passes it;
  window_fwd,
  window_bwd  -- 1024^2 x 24 on the bench seeds, and 16384 x 24 and
                 8192 x 24 on train batches (rays of the fit's ring views,
                 seeded by the lean march);
  brick_advance -- the input of the first and of the third round's
                 brick_advance launch of the primary march (the plain brick
                 path's states) of the 1024^2 bench frame and of the CLI's
                 512^2 frame. A tree whose brick_advance works in place
                 copies the state in each call; only the kernel's device
                 time counts;
  brick_fine  -- at the same two views, from the plain brick path's
                 states: the input of round 2's first launch, of the
                 march's first glue pass (the material glue applied to the
                 event lanes of the launch before; a tree whose
                 ``_launch_fine`` takes ``lanes`` runs that pass over the
                 event lanes only, in place on a copy of the state, an
                 older tree over all lanes through ``brick_fine``; the
                 CLI's view has no material event) and of round 8's first
                 launch.

The trees run in turns, forward then back (A, B, ..., B, A), so every tree
is timed before and after every other. In each turn a kernel's time is the
mean device time of its launches over 20 calls of its wrapper, read by
torch.profiler in one session (window_bwd's gradient zero-fill is another
kernel: it is timed apart, with CUDA events), beside the wrapper's own
time per call (CUDA events, host work included). Each turn also times the
paths these kernels serve, with CUDA events around whole calls and as the
device time of all their kernels (torch.profiler): the CLI's 512^2 brick
frame, the 1024^2 bench brick frame (each with the summed device time of
its brick_fine and brick_advance launches) and the training loss+backward
at 1024^2 x 24 on the bench seeds.

In its first turn each tree is held to its own plain versions: every march
output and every brick_advance and brick_fine output equal to the bit
(fused_march_plain, brick_advance_plain, brick_fine_plain over all lanes),
window_fwd's outputs exact against window_plain,
window_bwd's gradients within 1e-5 max-scaled of window_plain's autograd.
It prints a digest of each
launch's outputs (equal digests: equal bits across trees), its nvcc
register report and, where its wrappers export them, its blocks per SM.
The line before the last holds the card's name and power limit; the last
is one JSON object with every time. Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

SIDE, CF = cs.FULL, 4  # frame side, coarse factor of the seed
REPS = 20  # calls of each wrapper per shape and turn
KERNEL_NAMES = {"march": "fused_march_kernel", "window_fwd": "window_fwd",
                "window_bwd": "window_bwd_kernel", "brick_advance": "brick_advance",
                "brick_fine": "brick_fine"}
ROUNDS = (1, 3)  # the brick_advance launches timed: their round in the primary march
FINE_ROUNDS = (2, 8)  # the brick_fine launches timed: round 2 (and its first glue pass), a late round


def march_cases(pkg, scene, dev):
    """[(name, state, config, prox, image width as the main path passes it)]."""
    from raytracing_test_tpu_torch.app import cli, fit
    from raytracing_test_tpu_torch.config import CameraConfig, RenderConfig, WorldConfig
    from raytracing_test_tpu_torch.render import fast, progressive
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions, yaw_pitch_dir

    fm = pkg["fm"]
    lean = dict(enable_materials=False, enable_shadows=False)
    cam = Camera(pos=torch.tensor(cs.BENCH_POS, device=dev), dir=torch.tensor(cs.BENCH_DIR, device=dev))
    dirs = ray_directions(cam, SIDE, SIDE)
    s_bench = fast._init_state(cam.pos, dirs, torch.ones(SIDE * SIDE, device=dev))
    cdirs = dirs.reshape(SIDE, SIDE, 3)[CF // 2::CF, CF // 2::CF].reshape(-1, 3).contiguous()
    s_coarse = fast._init_state(cam.pos, cdirs, torch.ones(cdirs.shape[0], device=dev))
    rc = RenderConfig(width=SIDE // CF, height=SIDE // CF, **lean)
    depth = fm.hit_seeds(scene, cam.pos, cdirs, rc, margin=0.0, prox=True)
    st = progressive.seed_from_depth(depth.reshape(SIDE // CF, SIDE // CF), CF, SIDE, SIDE)
    s_prox = fast._init_state(cam.pos, dirs, torch.ones(SIDE * SIDE, device=dev), start_t=st)
    rd = cli.build_parser().parse_args(["render"])
    s_cli = cs.march_state(scene, CameraConfig().pos, yaw_pitch_dir(rd.yaw, rd.pitch), rd.width)
    s_256 = cs.march_state(scene, cs.BENCH_POS, cs.BENCH_DIR, 256)
    g = WorldConfig().grid_shape
    ring = fit.ring_cameras((g[0] / 2, g[1] / 3, g[2] / 2), 0.8 * g[0], 0.9 * g[1], 8, device=dev)
    tdirs = ray_directions(ring[0], 64, 64)
    s_tgt = fast._init_state(ring[0].pos, tdirs, torch.ones(64 * 64, device=dev))
    cases = [
        (f"full {SIDE}^2", s_bench, RenderConfig(width=SIDE, height=SIDE), False, SIDE),
        (f"full, shadows off {SIDE}^2", s_bench,
         RenderConfig(width=SIDE, height=SIDE, enable_shadows=False), False, SIDE),
        (f"lean {SIDE}^2 (seed fine pass)", s_bench, RenderConfig(width=SIDE, height=SIDE, **lean),
         False, SIDE),
        (f"prox {SIDE}^2 full pass", s_prox, RenderConfig(width=SIDE, height=SIDE, **lean), True, 0),
        (f"prox {SIDE // CF}^2 coarse pass", s_coarse, rc, True, 0),
        (f"full {rd.width}^2 (CLI render view)", s_cli, RenderConfig(width=rd.width, height=rd.height),
         False, rd.width),
        ("full 256^2 (bench view)", s_256, RenderConfig(width=256, height=256), False, 256),
        (f"lean {SIDE // CF}^2 (seed coarse pass)", s_coarse, rc, False, SIDE // CF),
        ("materials 64^2 (a target view of the fit)", s_tgt,
         RenderConfig(width=64, height=64, enable_shadows=False), False, 0),
    ]
    for nb, (o_b, d_b) in pkg["batches"].items():
        cases.append((f"lean {nb} rays (a train batch's seed)",
                      fast._init_state(o_b, d_b, torch.ones(nb, device=dev)),
                      RenderConfig(width=1, height=nb, **lean), False, 0))
    return cases, cam, dirs


def window_cases(pkg, scene, ds, cam, dirs, dev):
    """[(name, window arguments, g_surf, g_tend, surf, t_end)]."""
    from raytracing_test_tpu_torch.config import WorldConfig
    from raytracing_test_tpu_torch.render import progressive
    from raytracing_test_tpu_torch.render.diff import _pack_fields
    from raytracing_test_tpu_torch.render.fast import sun_unit

    fm, fw = pkg["fm"], pkg["fw"]
    field = _pack_fields(ds).detach().contiguous()
    shape3 = tuple(WorldConfig().grid_shape)
    sun = sun_unit((2.0, 1.0, 4.0))
    rays = [(f"{SIDE}^2 x {cs.NUM_STEPS} (bench seeds)", cam.pos, dirs,
             fm.seed_depth_fused(scene, cam.pos, dirs, (SIDE, SIDE)))]
    for nb, (o_b, d_b) in pkg["batches"].items():
        rays.append((f"{nb} x {cs.NUM_STEPS} (a train batch)", o_b, d_b,
                     progressive.guided_seeds(fm.render_rays_fused, scene, o_b, d_b, 3.0)))
    cases = []
    for name, o, d, seed in rays:
        _, _, cell, tmax, istep, absd = fw.window_inputs(shape3, o, d, seed)
        n = cell.shape[0]
        wargs = (field, cell, tmax, istep, absd, shape3, sun, cs.NUM_STEPS, False)
        surf, t_end, _, _ = fw._launch_fwd(*wargs)
        cases.append((name, wargs, torch.full((n, 3), 1.0 / (3 * n), device=dev),
                      torch.zeros(n, device=dev), surf, t_end))
    return cases


def brick_cases(scene, dev):
    """[(name, state, budget)]: the primary march's
    brick_advance input in the rounds of ROUNDS, from the plain brick path,
    at the 1024^2 bench view and the CLI's 512^2 view."""
    from raytracing_test_tpu_torch.app import cli
    from raytracing_test_tpu_torch.config import CameraConfig, RenderConfig
    from raytracing_test_tpu_torch.render import bricks, fast
    from raytracing_test_tpu_torch.render.camera import yaw_pitch_dir

    rd = cli.build_parser().parse_args(["render"])
    cases = []
    for label, pos, dirn, side in (("bench", cs.BENCH_POS, cs.BENCH_DIR, SIDE),
                                   ("CLI", CameraConfig().pos, yaw_pitch_dir(rd.yaw, rd.pitch),
                                    rd.width)):
        rcfg = RenderConfig(width=side, height=side)
        s, _, _ = fast.start_cell(scene, cs.march_state(scene, pos, dirn, side))
        for r in range(1, max(ROUNDS) + 1):
            blin = bricks.occupied_brick(scene, scene.brick_dist, s)
            s = bricks._fine_loop(scene, s, blin, rcfg, rcfg.max_steps, False, 0.0)
            if r in ROUNDS:
                cases.append((f"{side}^2 {label} frame, round {r} ({int((~s.done).sum())} of "
                              f"{s.cell.shape[0]} lanes live)", s, rcfg.max_steps))
            s = bricks._brick_loop(scene, scene.brick_dist, s, rcfg.max_steps)
    return cases


def glue(scene, s, evt, rcfg, time_s):
    """The material glue between two brick_fine launches (fine_loop's), from
    the render functions every tree has."""
    from raytracing_test_tpu_torch.render import bricks
    from raytracing_test_tpu_torch.render.renderer import classify, material_step

    fl = scene.flags[s.mat.long()]
    is_refl, is_refr, _ = classify(fl, s.mat, evt, rcfg)
    d, st, ab, tm, seg, lt, cm, ior, refl = material_step(s, is_refl, is_refr, fl, rcfg, time_s)
    s = s._replace(dir=d, step=st, abs_delta=ab, tmax=tm, seg_origin=seg, last_t=lt, color_mod=cm,
                   ior=ior, reflected=refl)
    return bricks.dda_step(s, evt, rcfg.max_steps)


def fine_cases(pkg, scene, dev):
    """[(name, state, blin, luts, budget, lanes)]: brick_fine's input in the
    primary march of the plain brick path (its fine phases as fine_loop runs
    them) at the 1024^2 bench view and the CLI's 512^2 view: the first
    launch of the rounds in FINE_ROUNDS and the march's first glue pass,
    with its event lanes (``lanes``, None for a launch over all)."""
    from raytracing_test_tpu_torch.app import cli
    from raytracing_test_tpu_torch.config import CameraConfig, RenderConfig
    from raytracing_test_tpu_torch.render import bricks, fast
    from raytracing_test_tpu_torch.render.camera import yaw_pitch_dir

    bk = pkg["bk"]
    rd = cli.build_parser().parse_args(["render"])
    cases = []
    for label, pos, dirn, side in (("bench", cs.BENCH_POS, cs.BENCH_DIR, SIDE),
                                   ("CLI", CameraConfig().pos, yaw_pitch_dir(rd.yaw, rd.pitch),
                                    rd.width)):
        rcfg = RenderConfig(width=side, height=side)
        budget = rcfg.max_steps
        luts = bk._prop_luts(scene, False, True)
        s, _, _ = fast.start_cell(scene, cs.march_state(scene, pos, dirn, side))
        glued = False
        for r in range(1, max(FINE_ROUNDS) + 1):
            blin = bricks.occupied_brick(scene, scene.brick_dist, s)
            live = int((~s.done).sum())
            if r in FINE_ROUNDS:
                cases.append((f"{side}^2 {label} frame, round {r} first launch ({live} of "
                              f"{s.cell.shape[0]} lanes live)", s, blin, luts, budget, None))
            s, evt = bk.brick_fine_plain(scene, s, blin, luts, budget)
            passes = 0
            while bool(evt.any()) and passes < 64:
                lanes = torch.nonzero(evt).flatten().to(torch.int32)
                s = glue(scene, s, evt, rcfg, 0.0)
                if not glued:
                    glued = True
                    cases.append((f"{side}^2 {label} frame, round {r} first glue pass "
                                  f"({lanes.numel()} event lanes)", s, blin, luts, budget, lanes))
                s, evt = bk.brick_fine_plain(scene, s, blin, luts, budget)
                passes += 1
            s = bricks._brick_loop(scene, scene.brick_dist, s, budget)
    return cases


def end_to_end_ms(scene, ds, cam, dirs, dev, card) -> dict:
    """{path: (ms per call, device busy ms per call, {kernel: its device ms
    per call})} of the CLI's 512^2 brick frame, the 1024^2 bench brick frame
    and the training loss+backward at 1024^2 x 24 on the bench seeds: CUDA
    events around whole calls (host work included), the sum of the device
    time of every kernel of a call, and of brick_fine's and brick_advance's
    launches (torch.profiler, 3 calls)."""
    from raytracing_test_tpu_torch.app import cli
    from raytracing_test_tpu_torch.config import CameraConfig, RenderConfig
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.kernels import fused_window as fw
    from raytracing_test_tpu_torch.render.camera import Camera, yaw_pitch_dir
    from raytracing_test_tpu_torch.render.diff import DiffScene

    rd = cli.build_parser().parse_args(["render"])
    cli_cam = Camera(pos=torch.tensor(CameraConfig().pos, device=dev),
                     dir=torch.tensor(yaw_pitch_dir(rd.yaw, rd.pitch), device=dev))
    seed = fm.seed_depth_fused(scene, cam.pos, dirs, (SIDE, SIDE))

    def step():
        d = ds.density.detach().requires_grad_(True)
        a = ds.albedo.detach().requires_grad_(True)
        fw.render_window_fused(DiffScene(d, a), cam.pos, dirs, num_steps=cs.NUM_STEPS,
                               start_t=seed, sky=False).mean().backward()

    cli_cfg = RenderConfig(width=rd.width, height=rd.height)
    bench_cfg = RenderConfig(width=SIDE, height=SIDE)
    paths = {
        f"brick frame {rd.width}^2 (CLI view)": (
            lambda: bk.render_image_bricks_pallas(scene, cli_cam, cli_cfg, 0.0), 5),
        f"brick frame {SIDE}^2 (bench view)": (
            lambda: bk.render_image_bricks_pallas(scene, cam, bench_cfg, 0.0), 3),
        f"train loss+backward {SIDE}^2 x {cs.NUM_STEPS}": (step, 10),
    }
    out = {}
    for name, (fn, reps) in paths.items():
        wall = cs.cuda_ms(fn, reps=reps, warmup=1)
        per_name = cs.profile_step(fn, card, steps=3, label=name)
        kernels = {k: sum(sum(v) for n, v in per_name.items() if k in n) / 3 / 1e3
                   for k in ("brick_fine", "brick_advance")}
        out[name] = (wall, sum(sum(v) for v in per_name.values()) / 3 / 1e3, kernels)
    return out


def digest(out) -> str:
    h = hashlib.sha256()
    for k in sorted(out):
        t = out[k]
        t = t.to(torch.int32) if t.dtype == torch.bool else t
        h.update(k.encode() + t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check_window_fwd(fw, name, wargs, card) -> float:
    """window_fwd's outputs against window_plain's; returns the largest
    difference and raises unless it is 0."""
    with torch.no_grad():
        got = fw._launch_fwd(*wargs)
        want = fw.window_plain(*wargs)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"  parity window_fwd {name}: max_abs_err {err:.3e} against window_plain | {card}")
    if err > 0:
        raise AssertionError(f"window_fwd {name}: differs from window_plain")
    return err


def check_window(fw, name, wargs, g_surf, g_tend, surf, t_end, card) -> float:
    """window_bwd's gradients against window_plain's autograd; returns the
    largest max-scaled difference and raises beyond cs.GRAD_TOL."""
    grads = fw._launch_bwd(*wargs, g_surf, g_tend, surf, t_end)
    leaves = [wargs[i].detach().clone().requires_grad_(True) for i in (0, 2, 4)]
    plain = fw.window_plain(leaves[0], wargs[1], leaves[1], wargs[3], leaves[2], *wargs[5:])
    ref = torch.autograd.grad(plain[:2], leaves, (g_surf, g_tend))
    err = 0.0
    for a, b in zip(grads, ref):
        m = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), m):
            raise AssertionError(f"window_bwd {name}: gradients finite on other entries")
        err = max(err, cs.max_scaled(a[m], b[m]))
    print(f"  parity window_bwd {name}: gradients within {err:.3e} max-scaled of "
          f"window_plain's autograd | {card}")
    if err > cs.GRAD_TOL:
        raise AssertionError(f"window_bwd {name}: gradients disagree beyond {cs.GRAD_TOL}")
    return err


def profiled_ms(calls) -> dict:
    """{case: mean device ms of its kernel's launches}: every call of
    ``calls`` ([(case, kind, thunk)]) run REPS times in one
    torch.profiler session, each launch of kind's kernel attributed to its
    case by time order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, _, fn in calls:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler can drop an event: a short session is made again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _, _, fn in calls:
                for _ in range(REPS):
                    fn()
                torch.cuda.synchronize()
        device = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                        for e in prof.events() if e.device_type == DeviceType.CUDA)
        out, short = {}, []
        for kind, kernel in KERNEL_NAMES.items():
            us = [t for _, t, name in device if kernel in name]
            cases = [c for c, k, _ in calls if k == kind]
            if len(us) != REPS * len(cases):
                short.append(f"{len(us)} launches of {kernel} profiled, expected "
                             f"{REPS} x {len(cases)}")
            for j, case in enumerate(cases):
                out[case] = sum(us[j * REPS:(j + 1) * REPS]) / REPS / 1e3
        if not short:
            return out
    raise AssertionError("; ".join(short))


def worker(tree: Path, first: bool, out_path: Path) -> int:
    sys.path.insert(0, str(tree))
    import raytracing_test_tpu_torch

    if not Path(raytracing_test_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"the package was not imported from {tree}")
    import inspect

    from raytracing_test_tpu_torch.app import fit
    from raytracing_test_tpu_torch.config import WorldConfig
    from raytracing_test_tpu_torch.core.flatten import palette_arrays, scene_from_grid
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk
    from raytracing_test_tpu_torch.kernels import build
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.kernels import fused_window as fw
    from raytracing_test_tpu_torch.render.diff import diff_scene_from_grid
    from raytracing_test_tpu_torch.worldgen import terrain

    dev = torch.device("cuda:0")
    card = cs.card_line()
    t0 = time.perf_counter()
    build.build_all()
    result = {"tree": str(tree), "build_s": time.perf_counter() - t0, "ms": {}, "wrapper_ms": {},
              "zero_fill_ms": {}, "digest": {}, "grad_max_scaled": {}}
    if first:
        for name in ("fused_march", "fused_window", "brick_march"):
            report = build.BUILD_INFO.get(name, {}).get("nvcc_report")
            if report is None:
                print(f"  nvcc {name}: built before this run, no report")
            for line in (report or "").splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"  nvcc {name}: {line.strip()}")
        occ = {}
        for mod in (fm, fw, bk):
            if hasattr(mod, "occupancy"):
                occ |= mod.occupancy()
        result["blocks_per_sm"] = occ or "not exported"
        print(f"  blocks per SM: {result['blocks_per_sm']} | {card}")

    grid, pal = terrain.gen_world_grid(WorldConfig())
    scene = scene_from_grid(grid, pal, dev)
    g = WorldConfig().grid_shape
    ring = fit.ring_cameras((g[0] / 2, g[1] / 3, g[2] / 2), 0.8 * g[0], 0.9 * g[1], 8, device=dev)
    origins, rdirs, _ = fit.make_targets(scene, ring, 64)
    rng = np.random.default_rng(0)
    batches = {}
    for nb in (cs.TRAIN_BATCH, cs.CLI_BATCH):
        idx = torch.from_numpy(rng.integers(0, origins.shape[0], nb)).to(dev)
        batches[nb] = (origins[idx].contiguous(), rdirs[idx].contiguous())
    pkg = {"fm": fm, "fw": fw, "bk": bk, "batches": batches}
    tiles = "image_w" in inspect.signature(fm.fused_march_call).parameters
    result["tiles"] = tiles
    mcases, cam, dirs = march_cases(pkg, scene, dev)
    ds = diff_scene_from_grid(grid, palette_arrays(pal)[0], dev, solid_density=cs.SOLID_DENSITY)
    wcases = window_cases(pkg, scene, ds, cam, dirs, dev)

    calls = []
    for name, s, rcfg, prox, w in mcases:
        kw = {"image_w": w} if tiles and w else {}
        fn = (lambda s=s, rcfg=rcfg, prox=prox, kw=kw:
              fm.fused_march_call(scene, s, rcfg, 0.0, prox=prox, **kw))
        out = fn()
        result["digest"][name] = digest(out)
        if first:
            cs.march_parity(f"  {name}", out, fm.fused_march_plain(scene, s, rcfg, 0.0, prox), card)
        calls.append((name, "march", fn))
    for name, wargs, g_surf, g_tend, surf, t_end in wcases:
        if first:
            check_window_fwd(fw, name, wargs, card)
            result["grad_max_scaled"][name] = check_window(fw, name, wargs, g_surf, g_tend, surf,
                                                           t_end, card)
        calls.append((f"window_fwd {name}", "window_fwd", lambda a=wargs: fw._launch_fwd(*a)))
        result["digest"][f"window_fwd {name}"] = digest(dict(zip(
            ("surf", "t_end", "w_sum", "t_exp"), fw._launch_fwd(*wargs))))
        calls.append((name, "window_bwd", lambda a=(*wargs, g_surf, g_tend, surf, t_end):
                      fw._launch_bwd(*a)))
        zero = torch.zeros_like(wargs[0])
        result["zero_fill_ms"][name] = cs.cuda_ms(lambda: zero.zero_(), reps=REPS, warmup=3)
    for name, s, budget in brick_cases(scene, dev):
        case = f"brick_advance {name}"
        fn = lambda s=s, budget=budget: bk.brick_advance(scene, scene.brick_dist, s, budget)
        out = fn()
        result["digest"][case] = digest({f: getattr(out, f) for f in cs.STATE_FIELDS})
        if first:
            cs.state_parity(f"  {case}", out, bk.brick_advance_plain(scene, scene.brick_dist, s,
                                                                     budget))
        calls.append((case, "brick_advance", fn))
    lists = "lanes" in inspect.signature(getattr(bk, "_launch_fine", lambda: None)).parameters
    result["fine_lists"] = lists

    def listed(s, blin, luts, budget, lanes):
        from raytracing_test_tpu_torch.render import bricks

        out, evt = bricks.writable(s), torch.zeros_like(s.done)
        bk._launch_fine(scene, out, blin, luts, budget, evt, lanes, lanes.numel())
        return out, evt

    for name, s, blin, luts, budget, lanes in fine_cases(pkg, scene, dev):
        case = f"brick_fine {name}"
        if lists and lanes is not None:
            fn = lambda s=s, blin=blin, luts=luts, budget=budget, lanes=lanes: listed(
                s, blin, luts, budget, lanes)
        else:
            fn = lambda s=s, blin=blin, luts=luts, budget=budget: bk.brick_fine(
                scene, s, blin, luts, budget)
        out, evt = fn()
        result["digest"][case] = digest({**{f: getattr(out, f) for f in cs.STATE_FIELDS},
                                         "evt": evt})
        if first:
            p, pe = bk.brick_fine_plain(scene, s, blin, luts, budget)
            cs.state_parity(f"  {case}", out, p, evt, pe)
        calls.append((case, "brick_fine", fn))
    for name, _, fn in calls:
        result["wrapper_ms"][name] = cs.cuda_ms(fn, reps=REPS, warmup=3)
    result["ms"] = profiled_ms(calls)
    result["e2e_ms"] = end_to_end_ms(scene, ds, cam, dirs, dev, card)
    out_path.write_text(json.dumps(result))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path, help="directories that hold the package")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--first", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker.resolve(), args.first, args.out)
    if not args.trees:
        ap.error("name at least one tree")
    trees = [t.resolve() for t in args.trees]
    for t in trees:
        if not (t / "raytracing_test_tpu_torch" / "csrc").is_dir():
            ap.error(f"{t} holds no raytracing_test_tpu_torch/csrc/")
    card = cs.card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    runs = {str(t): [] for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        for k, tree in enumerate(trees + trees[::-1]):
            first = k < len(trees)
            out = Path(tmp) / f"turn{k}.json"
            print(f"turn {k}: {tree}", flush=True)
            cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", str(tree),
                   "--out", str(out)] + (["--first"] if first else [])
            subprocess.run(cmd, check=True, timeout=900)
            runs[str(tree)].append(json.loads(out.read_text()))
    base = str(trees[0])
    cases = list(runs[base][0]["ms"])
    print(f"kernel device ms per launch (torch.profiler, {REPS} calls a turn; both turns), "
          f"change of the mean against {base} | {card}")
    for case in cases:
        b = np.mean([r["ms"][case] for r in runs[base]])
        print(f"  {case}:")
        for tree, rs in runs.items():
            ms = [r["ms"][case] for r in rs]
            z = rs[0]["zero_fill_ms"].get(case)
            print(f"    {ms[0]:.4f} / {ms[1]:.4f} ({np.mean(ms) / b - 1:+.1%}); through the "
                  f"wrapper {rs[0]['wrapper_ms'][case]:.4f} / {rs[1]['wrapper_ms'][case]:.4f}"
                  + (f"; zero-fill {z:.4f}" if z is not None else "")
                  + (f"; digest {rs[0]['digest'][case]}" if case in rs[0]["digest"] else "")
                  + f": {tree}")
    print(f"end to end, ms per call (CUDA events, host work included) and device busy ms per "
          f"call (torch.profiler); both turns | {card}")
    for case in runs[base][0]["e2e_ms"]:
        print(f"  {case}:")
        for tree, rs in runs.items():
            (w0, d0, k0), (w1, d1, k1) = (r["e2e_ms"][case] for r in rs)
            print(f"    {w0:.4f} / {w1:.4f}; device busy {d0:.4f} / {d1:.4f}"
                  + "".join(f"; {k} {k0[k]:.4f} / {k1[k]:.4f}" for k in k0 if k0[k] or k1[k])
                  + f": {tree}")
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
