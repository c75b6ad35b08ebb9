"""Smoke run of the PyTorch port on one CUDA card: build, parity, serving
frames, training steps, the edit session, the differentiable renders, timing.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

  1. device  -- the card's name and power limit; no CUDA means exit 2.
  2. build   -- one nvcc per raytracing_test_tpu_torch/csrc/*.cu, all at once;
                each kernel's registers, stack and spills (-Xptxas -v).
  3. world   -- the default WorldConfig world (200x200 columns in a
                256x128x256 grid) as a Scene on the card.
  4. parity  -- at 1024x1024 the CUDA kernel against its plain PyTorch version
                on the same card and inputs: full-feature and lean from the
                bench camera, and a water view with mirror and glass blocks
                at time 1.2; and the CLI's default view at its 512x512
                frame size, each launched in 8x4 warp tiles (as frames and
                the exact seed passes launch it) and in natural order (as
                ray batches do). Contract: every output of the march equal
                to the bit (integer fields equal, float fields bit-equal), and
                the shaded images within tests/test_render_parity.py
                assert_images_close (|diff| <= 1e-5 on >= 99% of pixels).
  5. frames  -- the port's CLI, in-process: ``render`` at its defaults, then
                ``animate --frames 4``. The kernel's launch count is reset
                just before and must rise by at least one per frame.
  6. timing  -- the march: blocks per SM and the nvcc register report;
                kernel ms (CUDA events on raw launches of fixed inputs,
                after warm-up) at the shapes the main paths launch (1024^2
                full, full without shadows and lean; the 512^2 render
                frame; the 256^2 coarse seed pass; a 64^2 target view of the
                fit), each with its lane efficiency (trips of live lanes over
                32 x the warps' trips: from the plain loop's per-ray trips
                for one ray per thread in natural order and in 8x4 tiles);
                at 1024^2 the wrapper's ms (the kernels line's ms), the
                plain version's and the whole frame's.
  7. train   -- the training slice at the bench shapes (default world,
                solid_density 50, bench camera, 1024x1024 rays, 24 steps):
                a. seed: seed_depth_fused (coarse x4 then full-resolution lean
                   march, margin 3);
                b. window parity: window_fwd/window_bwd against window_plain
                   on the same seeds, forward with sky off, sky on, and
                   shading with shadow_steps 6; gradients of mean(rgb) in
                   density, albedo, origin and dirs; the same at both train
                   batches in part e (the forward's split kernel). Contract:
                   forward exact on every pixel (as the one-thread-per-ray
                   kernel measured, PERF.md), gradients within 1e-5
                   max-scaled (atomic ordering is the only difference);
                c. train: five make_train_step_fused steps on one fixed batch
                   of 16384 rays from make_targets: finite losses, the fifth
                   below the first, one window_fwd and one window_bwd per step;
                d. cli: ``fit --engine fused --steps 10``, in-process;
                   then the guide rebuild on the card (guide_check) at the
                   default world's 256x128x256 and world-512's 512x128x512,
                   on init_params, after fit_world's steps, on a random
                   field and on the world's solid cells: the distance kernel (csrc/chebyshev.cu) against
                   its plain version on the same CUDA tensors, and the
                   card-built guide against the numpy builders' (every
                   field to the bit); one rebuild's host and device time
                   and the kernel's launches against their bound, beside
                   the numpy path's (readback, host builders, upload);
                e. timing: seed, window_fwd, window_bwd, the whole
                   loss+backward, rays/s, the plain versions' times and the
                   peak device memory of a train step; window_bwd's kernel
                   alone and its gradient zero-fill alone, its occupancy and
                   its gradient row updates, at 1024^2 and at the train
                   batches (16384 and the CLI fit's 8192 rays), where its
                   gradients are held to window_plain's autograd (1e-5
                   max-scaled: each block size the wrapper picks);
                   window_fwd's device time back to back (torch.profiler)
                   and inside a train step, after the seed march and the
                   preamble. The kernels' launch counts are reset just
                   before c and read just after d.
  8. bricks  -- the brick engine (kernels/brick_kernels.py, csrc/brick_march.cu)
                on the default world at 1024x1024 from the bench camera:
                a. kernel parity: brick_fine and brick_advance against
                   brick_fine_plain and brick_advance_plain on the states of
                   the first two rounds of the primary and the shadow march;
                   integer fields equal, float fields equal to the bit;
                b. frame parity: the brick frame on the kernels (the hooks
                   of render_rays_bricks_pallas, both kernels in place;
                   every brick_fine launch, the glue passes' launches over
                   their event lanes too, held to the bit to
                   brick_fine_plain on its input, state and evt; every
                   brick_advance launch to brick_advance_plain and to
                   brick_advance on a copy)
                   against render_rays_fused on the fused kernel and
                   against the plain brick path (render/bricks.py) on the
                   card, in four configurations: full, lean, the water view
                   at 1.2 (reflected and refracted rays required) and the
                   CLI's view at 512x512. Contract: assert_images_close, and
                   mat equal on >= 99.9% of rays, cell and steps on >= 99.9%
                   of the rays that hit (a sky ray ends where an exit rule
                   first fires, which depends on the air boxes it crossed);
                c. cli: ``render --mode bricks-pallas`` at its defaults,
                   in-process; both launch counts are reset just before and
                   must rise;
                d. timing: every brick_advance launch of the 1024^2 bench
                   frame and of the CLI's 512^2 frame (lanes live on entry,
                   lanes that advance, advancing iterations, lane efficiency
                   in natural order and in 8x4 tiles, device time from
                   torch.profiler, the launch's own bound) and the frame's
                   lost time, the sum of (ms - bound); every brick_fine
                   launch of the same two frames (lanes launched, live and
                   changed, events, DDA steps, device time, the bound of
                   what its inputs need; summed by march and pass, with
                   the lost time; each launch at 512^2), beside what
                   launches over all lanes would need and what a kernel
                   that loads and stores every lane's whole state moves;
                   per launch (the first round's advance
                   input and the second round's fine input, on fresh
                   copies, device time; kernel and plain version), per
                   frame (rounds, glue passes and launches,
                   primary and shadow; the per-lane loop caps checked), the
                   brick frame against the fused frame and the plain brick
                   frame, and one torch.profiler pass over the brick frame;
                e. bounds of those two launches from their data, and the
                   same two launches (parity, time, bound) at the CLI brick
                   frame's 512^2 view.
  9. prox   -- the march's prox mode (the seed march that stops at the first
                entry into an occupied 8^3 brick) and the prox-seeded window
                render, on the default world at 1024x1024 from the bench
                camera:
                a. kernel parity: the prox kernel against the plain prox march
                   on both passes of the prox seed (coarse x4, then the full
                   resolution from the coarse seeds); integer fields equal,
                   float fields equal to the bit;
                b. conservative seed: prox seeds (margin 0) <= exact seeds + 1e-4
                   on every ray the exact march hits, and every such ray a prox
                   hit; the rays only the prox march calls hits (grazes of a
                   surface brick that reach the sky) are counted, and so are
                   the rays seeded at the coarse pass's far cap whose wrapped
                   start cell would make a hit (the port calls them sky);
                c. orchestration: render_rays_guided_prox at its default budget
                   on the kernels against the same pipeline on the plain
                   versions on the card (the march and the window wrappers
                   swapped for their plain versions): assert_images_close,
                   gradients of mean(rgb^2) in density and albedo within 1e-5
                   max-scaled, the same patch counts; n_need, patch_capacity
                   and grads_dropped are printed (an overflow is a finding);
                d. against the exact-seed render: at patch_div 1, against
                   render_rays_diff_guided(image_hw=(1024, 1024)), rgb within
                   2e-3, gradients within 5e-3 max-scaled (density on the solid
                   cells: the two pipelines sample other air) at sat_eps 1e-6;
                   at the default sat_eps 1e-3 the same but for the density
                   gradient, which is printed (unpatched windows end with up
                   to 1e-3 of transmittance); the reference's own measure
                   (density on every cell over the whole field's maximum) is
                   printed at both;
                e. main path: one render_rays_guided_prox loss+backward with the
                   launch counts reset just before and read just after; then
                   ``fit --engine '' --guided --steps 5`` through the CLI,
                   in-process, counts reset again;
                f. timing: prox seed against exact seed, the prox kernel per
                   pass and its plain version, the prox pipeline's
                   loss+backward against the exact-seed pipeline's, and the
                   prox kernel's bound from this run's data.

 10. edit   -- the edit session (app/session.py WorldSession, core/mirror.py)
                on the card: a native session of the default world; 40
                edits, each synced (8 place/delete pairs and 4 places by
                pick, a tower of 8 blocks that raises y_max and is removed
                again, blocks at two corners of the window, the top one
                raising y_max to the grid's height); the session's frames
                at the CLI's 512x512 in the modes fused, fast, progressive,
                reference and fused with AO, and 5 frames each after a
                place; the CLI's ``edit`` verb (place, delete, place, two
                frames, save), ``render --ao`` in the modes fast,
                progressive and reference, and ``probe`` at the centre
                pixel, in-process.
                The fused_march launch count is reset before and read after
                these and must reach the frames that go through the kernel.
                Then: the mirrored Scene against scene_from_grid of the
                session's grid, every field equal to the bit (prox_enc and
                y_max too); the 512x512 fused frames of the two Scenes at an
                edit's view bit-equal; fast, progressive and reference
                against fused at the CLI view within test_session_render_
                modes' rule (<= 1% of pixels off by > 1e-6), progressive
                bit-equal to itself on the plain march, the AO frame within
                assert_images_close of the plain march with AO; the saved
                world reloaded equal to the same edits in a session; the
                departures of progressive and reference from fused at two
                other views printed. Each scripted edit's sync runs with
                CUDA's sync debug mode at "error" (no read back from the
                card) and builds each dirty brick's boxes once on the card
                (mirror.BOX_BUILDS) with 6 cheb_pass launches. Timing: each
                edit's sync (total; tree rasterization, the upload and row
                writes, the box builders, the wait for the card apart;
                median and max), each mode's frame, the frame after an
                edit, the AO march alone.

 11. diff   -- the differentiable renders that are PyTorch operations here, as
                they are XLA operations in the reference (render/diff.py), on
                the default world:
                a. hard limit: the blind scan (render_rays_diff, solid density
                   1e4, 192 steps) at the CLI's 512x512 view against the lean
                   fused march's first-hit albedo on the rays whose hit lies
                   within the scan's steps, and the skybox on the sky rays:
                   <= 1% of them off by more than 1e-4;
                b. card vs CPU: the blind scan (96 steps, sky off, solid
                   density 50) on one fixed 8192-ray batch of the fit's rays on
                   the card and on the CPU: rgb within 1e-5, the train loss's
                   gradients in density and albedo within 1e-5 and in origin
                   and dirs within 1e-4 max-scaled; the card's results stay on
                   the card;
                c. the window kernel pair against render_rays_diff_window
                   (accum="scatter", the XLA-style window) at both train
                   batches and at 1024x1024 x 24 from the bench camera (one
                   origin a ray), sky off, sky on, shading with shadow_steps
                   6: at most 1% near-tie rays (off by more than 1e-5: the
                   soft shadow's transmittance is steep in its start point,
                   which the two sum in other orders; or with an exact
                   crossing tie, whose dt gradient the reference splits and
                   the kernels pass whole), and on the other rays rgb and
                   the gradients of their mean within 1e-5 max-scaled (ray
                   gradients non-finite on the same entries, as in 7b);
                d. train: five make_train_step steps (the unguided step: blind
                   scan, MSE, Adam) on the batch of b, finite losses, the fifth
                   below the first; then ``fit --engine '' --steps 5 --out``
                   through the CLI in-process, its PNG checked, with every
                   launch count reset just before: fused_march launched once
                   per target view, nothing else;
                e. ao_diff at the hit points of the CLI's 512x512 frame:
                   occlusion finite and in [0, 1], a finite non-zero density
                   gradient;
                f. timing: the unguided step (ms, rays/s, peak memory) at 8192
                   and 16384 rays x 96 steps; its loss+backward with remat on
                   and off in turns, and with autograd's own row gather (a
                   zero [V, 4] gradient per step) in place of the scan's one
                   gradient buffer; render_image_diff at 512x512 x 192 steps
                   (fit --out); ao_diff forward and forward+backward; the
                   window's loss+backward on the kernel pair and on
                   render_rays_diff_window at the train batches.
 12. multi  -- multi-device execution (parallel/):
                a. a world of one rank over NCCL on the card, at full width:
                   render_rays_fused_dp at 1024x1024 bit-equal to
                   render_image_fused; render_image_sharded at the CLI's
                   512x512 view bit-equal to the reference frame;
                   render_window_fused_dp at 1024x1024 x 24 (bench seeds):
                   rgb exact, field gradients within 1e-5 max-scaled of
                   render_window_fused's; five dp fused steps at 16384 rays
                   and two dp unguided steps at 8192 rays x 96, each loss
                   within 1e-6 of the one-device step's and falling;
                   ``render --mode spatial`` / ``handoff`` through the CLI
                   (PNG bytes) and its session (floats) bit-equal to
                   ``reference`` / ``fast``; each path's ms beside its
                   one-device counterpart's, the gradient all-reduce's ms,
                   and torch.profiler's device busy time and idle share;
                b. two gloo ranks sharing the card (launch.run_ranks): one dp
                   fused step at 8192 rays against (a)'s (loss within 1e-6,
                   fields within 1e-5 max-scaled); spatial and handoff on a
                   (1, 2) mesh at 128x128 from the bench camera bit-equal to
                   one rank's, lanes shipped; dryrun_multichip(2); the
                   render scaling harness's overhead_table for 1 and 2 ranks
                   (time-sharing one card: an overhead, not scaling).
                The dp launches of (a) are added to the kernels' counts.

After phase 12 the kernels are ordered by the time they lose on the main
paths: launches x (ms - bound) at the shape each launch has (512^2 frames,
64^2 target views, the train batches' seeds and window pairs, the 512^2
brick frame's launches, both prox passes); for the two brick kernels the
512^2 frame's own launches, each with its time and bound (8d).

The line before the last holds the card's name and power limit, the one
before it the per-kernel JSON (time, launches, plain time and the bound:
the larger of the bytes the kernel must move over 3.35 TB/s and its float32
operations over 67 TFLOP/s, the H100 SXM data-sheet peaks; the brick
kernels' times and bounds are per launch, on the inputs named in 8d: for
brick_advance the first round's, with every lane live; for brick_fine the
second round's, its bound counted from what that launch's inputs need);
the last line is the ok JSON.
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
WINDOW_FWD_ERR = 0.0  # window forward vs window_plain: exact, as the earlier kernel measured
# prox pipeline against the exact-seed guided render (the reference's own
# contract, tests/test_fused_window.py::test_guided_prox_matches_exact_pipeline):
# rgb, and gradients max-scaled
PROX_RGB_TOL, PROX_GRAD_TOL = 2e-3, 5e-3
NUM_STEPS = 24  # bench.py's window length
SOLID_DENSITY = 50.0  # bench.py's diff scene
TRAIN_BATCH = 16384
CLI_BATCH = 8192  # the fit verb's default batch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
# float32 operations each unit of work needs at the least (for the bound):
MARCH_OPS_PER_CROSSING = 3  # two compares pick the axis, one add advances it
WINDOW_FWD_OPS_PER_SAMPLE = 20  # enumerate 5, exp + composite 11, w_sum/t_exp 4
WINDOW_BWD_OPS_PER_SAMPLE = 36  # enumerate 5, exp + weights 4, g_od 7, grads 8, pose 12
BRICK_ADVANCE_OPS_PER_ITER = 20  # t_exit 6, argmin 2, two crossing counts 6, tmax update 6
BRICK_FINE_OPS_PER_STEP = 3  # two compares pick the axis, one add advances it
# march state bytes per ray (kernels/brick_kernels.py _state_args / _outputs)
BRICK_STATE_IN = 65  # cell, tmax, step, abs_delta 48; mat, last_t, last_axis, steps 16; done 1
BRICK_STATE_OUT = 41  # mat, cell, tmax, last_t, last_axis, steps, done
BRICK_WAIT_IN = 25  # done, cell and the step signs: what shows that a live lane stays
STATE_FIELDS = ("mat", "cell", "tmax", "last_t", "last_axis", "steps", "done")


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
    """Kernel vs plain version on one state, the kernel launched as frames and
    the exact seed passes launch it (8x4 warp tiles over the side x side
    image) and in natural order (as ray batches launch it); returns
    (max_abs_err, the tiled launch's dict)."""
    from raytracing_test_tpu_torch.kernels import fused_march as fm

    ok = fm.fused_march_call(scene, s, rcfg, time_s, image_w=side)
    on = fm.fused_march_call(scene, s, rcfg, time_s)
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
    card = card_line()
    march_parity(f"{name} march outputs, 8x4 warp tiles", ok, op, card)
    march_parity(f"{name} march outputs, natural order", on, op, card)
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


def march_trips(scene, s, rcfg, time_s, prox=False):
    """Per-ray trips of the primary and the shadow loop ([N] int32 each),
    counted on the plain version: a ray takes one trip in each iteration of
    the plain loop that finds it live, as the kernel's loop does."""
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.render import fast

    calls, plain_loop = [], fast.fast_march

    def counting(scene_, state, cfg_, budget, shadow=False, time_s=None, prox=False):
        trips = torch.zeros(state.cell.shape[0], dtype=torch.int32, device=state.cell.device)
        i = 0
        while i < fast._ITER_CAP and bool((~state.done).any()):
            trips += (~state.done).to(torch.int32)
            enc = fast._gather_enc(scene_, state.cell, prox)
            state = fast._march_body(scene_, state, enc, cfg_, budget, shadow, time_s, prox)
            i += 1
        calls.append(trips)
        return state, i

    fast.fast_march = counting
    try:
        fm.fused_march_plain(scene, s, rcfg, time_s, prox)
    finally:
        fast.fast_march = plain_loop
    return calls[0], calls[1] if len(calls) > 1 else torch.zeros_like(calls[0])


def natural_order(n: int) -> torch.Tensor:
    """Ray of each thread when thread i runs ray i (-1: no ray)."""
    pad = -n % 32
    return torch.cat([torch.arange(n), torch.full((pad,), -1, dtype=torch.int64)])


def tile_order_for(n: int, width: int) -> torch.Tensor:
    """Ray of each thread of a launch in 8x4 warp tiles over a row-major
    image ``width`` wide (natural order when the rays are no such image)."""
    from raytracing_test_tpu_torch.kernels import fused_march as fm

    if not width or n % width:
        return natural_order(n)
    return fm.tile_order(width, n // width)


def lane_efficiency(p_trips, s_trips, order) -> dict:
    """Sum of trips / (32 x sum over warps of the warp's longest trip count),
    warps formed by ``order`` (32 threads each), for the primary loop, the
    shadow loop and the two run one after the other (a one-ray-per-thread
    launch)."""
    valid = (order >= 0).to(p_trips.device)
    idx = order.clamp(min=0).to(p_trips.device)
    pp = torch.where(valid, p_trips[idx], 0).reshape(-1, 32).to(torch.int64)
    ss = torch.where(valid, s_trips[idx], 0).reshape(-1, 32).to(torch.int64)

    def eff(*xs):
        work = sum(float(x.sum()) for x in xs)
        lanes = 32 * sum(float(x.max(dim=1).values.sum()) for x in xs)
        return work / lanes if lanes else 1.0

    return {"primary": eff(pp), "shadow": eff(ss), "whole": eff(pp, ss)}


def window_row_updates(cell, tmax, istep, abs_delta, shape3) -> dict:
    """Gradient row updates of window_bwd over its S steps, from the plain
    DDA's cells: one per (warp of 32 rays in natural order, step, distinct
    in-grid row), and as many per block of 128 rays (a block-level
    aggregation); and the in-grid samples."""
    from raytracing_test_tpu_torch.render.diff import _window_lin
    from raytracing_test_tpu_torch.render.renderer import _argmin_axis

    ray = torch.arange(cell.shape[0], device=cell.device)
    out = {"row_updates_per_warp": 0, "row_updates_per_block128": 0, "samples_in_grid": 0}
    with torch.no_grad():
        for _ in range(NUM_STEPS):
            lin, inside = _window_lin(shape3, cell)
            rows, rays = lin[inside], ray[inside]
            out["samples_in_grid"] += int(rows.numel())
            for key, group in (("row_updates_per_warp", 32), ("row_updates_per_block128", 128)):
                out[key] += int(torch.unique((rays // group) * (1 << 24) + rows).numel())
            oh = torch.nn.functional.one_hot(_argmin_axis(tmax).long(), 3).to(torch.bool)
            cell = torch.where(oh, cell + istep, cell)
            tmax = torch.where(oh, tmax + abs_delta, tmax)
    return out


def window_grads(render, ds, origin, dirs, seed, keep=None, **kw):
    """rgb and the gradients of mean(rgb) in density, albedo, origin and dirs
    (with ``keep``, of the mean over all rays of rgb on the kept rays)."""
    from raytracing_test_tpu_torch.render.diff import DiffScene

    leaves = [t.detach().clone().requires_grad_(True)
              for t in (ds.density, ds.albedo, origin, dirs)]
    rgb = render(DiffScene(leaves[0], leaves[1]), leaves[2], leaves[3],
                 num_steps=NUM_STEPS, start_t=seed, **kw)
    if keep is None:
        rgb.mean().backward()
    else:
        (rgb * keep[:, None]).sum().div(rgb.numel()).backward()
    torch.cuda.synchronize()
    return [rgb.detach()] + [t.grad for t in leaves]


def window_parity(fw, ds, origin, dirs, seed, label):
    """Kernels vs plain version on ``label``'s rays, forward and gradients,
    three configurations. The forward must be exact (WINDOW_FWD_ERR) on
    every pixel. Returns (forward
    max_abs_err, gradient max_abs_err)."""
    fwd_err = grad_err = 0.0
    for kw in (dict(sky=False), dict(sky=True), dict(sky=True, shading=True, shadow_steps=6)):
        k = window_grads(fw.render_window_fused, ds, origin, dirs, seed, **kw)
        p = window_grads(fw.render_window_plain, ds, origin, dirs, seed, **kw)
        d = (k[0] - p[0]).abs().max(dim=1).values
        bad = float((d > ATOL).float().mean())
        if not torch.isfinite(k[0]).all() or bad > 0 or float(d.max()) > WINDOW_FWD_ERR:
            raise AssertionError(f"window {label} {kw}: forward disagrees (bad fraction {bad}, "
                                 f"max_abs_err {float(d.max()):.3e})")
        fwd_err = max(fwd_err, float(d.max()))
        scaled = {}
        for name, a, b in zip(("density", "albedo", "origin", "dirs"), k[1:], p[1:]):
            m = torch.isfinite(b)
            if not torch.equal(torch.isfinite(a), m):
                raise AssertionError(f"window {label} {kw}: {name} gradient finite on other "
                                     "entries")
            err = (a[m] - b[m]).abs().max()
            scaled[name] = float(err / b[m].abs().max())
            grad_err = max(grad_err, float(err))
        print(f"parity window {label} {kw}: forward max_abs_err {float(d.max()):.3e} "
              f"bad_frac {bad:.6f}; "
              "gradients max-scaled " + " ".join(f"{k_} {v:.3e}" for k_, v in scaled.items()))
        if max(scaled.values()) > GRAD_TOL:
            raise AssertionError(f"window {label} {kw}: gradients disagree beyond {GRAD_TOL} "
                                 "max-scaled")
    return fwd_err, grad_err


def profile_step(fn, card, steps: int = 5, label: str = "train step (loss+backward)"):
    """Where a step's time goes: torch.profiler over ``steps`` calls of
    ``fn``; device busy time, idle share, kernels per step, the top kernels.
    Returns {kernel name: device microseconds of each launch}."""
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
    print(f"profile {label}, {steps} calls: host {wall_us / steps / 1e3:.4f} ms, "
          f"device busy {busy / steps / 1e3:.4f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{launches / steps:.0f} device kernels per call | {card}")
    for name, v in top:
        print(f"  {sum(v) / steps / 1e3:.4f} ms/call x{len(v) / steps:.1f}: {name[:90]}")
    return per_name


def raw_march_ms(scene, s, rcfg, image_w, prox=False, reps=20):
    """(ms, bound) of one fused_march launch on fixed inputs and outputs (no
    wrapper work on the host between launches), after warm-up. The bound is
    phase 6's: the grid the loop reads and the palette flags once, 72 bytes
    of rays in and 88 out per ray, three operations per primary crossing."""
    from raytracing_test_tpu_torch.kernels import fused_march as fm

    fn, args, out, keep = fm._launch_args(scene, s, rcfg, 0.0, prox, image_w)

    def launch():
        if fn(*args) != 0:
            raise AssertionError("a timing launch of fused_march failed")
    ms = cuda_ms(launch, reps=reps, warmup=3)
    n = s.cell.shape[0]
    grid = scene.prox_enc if prox else scene.grid_enc
    crossings = int(out["steps"].to(torch.int64).sum())
    b = bound(grid.numel() + scene.flags.numel() * 4 + n * (72 + 88),
              crossings * MARCH_OPS_PER_CROSSING)
    del keep
    return ms, b


def march_phase(dev, card, side, scene, s_bench, o_full, full, lean, cli_state, cli_cfg):
    """Phase 6: the march kernel at the shapes the main paths launch, its
    occupancy and lane efficiency, the plain version and the whole frame.
    Returns ({mode: (kernel ms through its wrapper, plain ms)} at side^2,
    bound of the full frame, {shape: (kernel ms on raw launches, bound
    ms)})."""
    from raytracing_test_tpu_torch.app import fit
    from raytracing_test_tpu_torch.config import RenderConfig, WorldConfig
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.render import fast
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions

    n = side * side
    cf = 4
    cam = Camera(pos=torch.tensor(BENCH_POS, device=dev), dir=torch.tensor(BENCH_DIR, device=dev))
    dirs = ray_directions(cam, side, side)
    cdirs = dirs.reshape(side, side, 3)[cf // 2::cf, cf // 2::cf].reshape(-1, 3).contiguous()
    s_coarse = fast._init_state(cam.pos, cdirs, torch.ones(cdirs.shape[0], device=dev))
    g = WorldConfig().grid_shape
    ring = fit.ring_cameras((g[0] / 2, g[1] / 3, g[2] / 2), 0.8 * g[0], 0.9 * g[1], 8, device=dev)
    tdirs = ray_directions(ring[0], 64, 64)
    s_tgt = fast._init_state(ring[0].pos, tdirs, torch.ones(64 * 64, device=dev))
    origins, rdirs, _ = fit.make_targets(scene, ring, 64)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, origins.shape[0], TRAIN_BATCH))
    b_dirs = rdirs[idx.to(dev)].contiguous()
    s_batch = fast._init_state(origins[idx.to(dev)].contiguous(), b_dirs,
                               torch.ones(TRAIN_BATCH, device=dev))
    s_cli_batch = fast._init_state(origins[idx[:CLI_BATCH].to(dev)].contiguous(),
                                   b_dirs[:CLI_BATCH].contiguous(), torch.ones(CLI_BATCH, device=dev))
    no_shadow = RenderConfig(width=side, height=side, enable_shadows=False)
    lean_kw = dict(enable_materials=False, enable_shadows=False)
    print(f"march occupancy: {fm.occupancy()} (blocks per SM, cudaOccupancy"
          f"MaxActiveBlocksPerMultiprocessor) | {card}")

    # the launches of the main paths, at their shapes, each as its wrapper
    # issues it (image width for the tiled ones)
    shapes = [
        (f"full {side}^2 (bench frame)", s_bench, full, side),
        (f"full, shadows off {side}^2", s_bench, no_shadow, side),
        (f"lean {side}^2 (seed fine pass)", s_bench, lean, side),
        (f"full {cli_cfg.width}^2 (render/animate frame)", cli_state, cli_cfg, cli_cfg.width),
        (f"lean {side // cf}^2 (seed coarse pass)", s_coarse,
         RenderConfig(width=side // cf, height=side // cf, **lean_kw), side // cf),
        ("materials 64^2 (a target view of the fit)", s_tgt,
         RenderConfig(width=64, height=64, enable_shadows=False), 0),
        (f"lean {TRAIN_BATCH} rays (a train step's seed)", s_batch,
         RenderConfig(width=1, height=TRAIN_BATCH, **lean_kw), 0),
        (f"lean {CLI_BATCH} rays (a CLI fit step's seed)", s_cli_batch,
         RenderConfig(width=1, height=CLI_BATCH, **lean_kw), 0),
    ]
    raw = {}
    for name, s, rcfg, w in shapes:
        ms, b = raw_march_ms(scene, s, rcfg, w, reps=20 if s.cell.shape[0] >= 2**18 else 100)
        p_trips, s_trips = march_trips(scene, s, rcfg, 0.0)
        eff = {k: lane_efficiency(p_trips, s_trips, o)["whole"]
               for k, o in (("natural", natural_order(s.cell.shape[0])),
                            ("tiles", tile_order_for(s.cell.shape[0], w)))}
        raw[name] = (ms, b[0])
        print(f"timing fused_march {name}: kernel {ms:.4f} ms ({s.cell.shape[0] / ms * 1e3:.4e} "
              f"rays/s), bound {b[0]:.4f} ms ({b[1]}), {'8x4 warp tiles' if w else 'natural order'}; "
              f"lane efficiency "
              f"(primary and shadow loops) in natural order {eff['natural']:.4f}, in 8x4 tiles "
              f"{eff['tiles']:.4f}; trips per ray mean {float(p_trips.float().mean()):.2f} max "
              f"{int(p_trips.max())}, shadow rays {int((s_trips > 0).sum())} | {card}")

    times = {}
    for name, rcfg in (("full", full), ("lean", lean)):
        k_ms = raw[f"{name} {side}^2 (bench frame)" if name == "full"
                   else f"lean {side}^2 (seed fine pass)"][0]
        w_ms = cuda_ms(lambda: fm.fused_march_call(scene, s_bench, rcfg, 0.0, image_w=side),
                       reps=20, warmup=3)
        p_ms = cuda_ms(lambda: fm.fused_march_plain(scene, s_bench, rcfg, 0.0), reps=3, warmup=1)
        f_ms = cuda_ms(lambda: fm.render_image_fused(scene, cam, rcfg, 0.0), reps=10, warmup=2)
        times[name] = (w_ms, p_ms)
        print(f"timing {name} {side}x{side}: kernel through its wrapper {w_ms:.4f} ms/frame "
              f"({n / w_ms * 1e3:.4e} rays/s; raw launches {k_ms:.4f} ms), plain {p_ms:.3f} "
              f"ms/frame ({n / p_ms * 1e3:.4e} rays/s), speedup {p_ms / w_ms:.1f}x, whole frame "
              f"(rays+kernel+shade) {f_ms:.4f} ms | {card}")

    # full-feature frame: grid_enc and palette flags read once, 72 bytes of
    # rays in and 88 bytes out per ray; one march step per primary crossing
    crossings = int(o_full["steps"].to(torch.int64).sum())
    march_bytes = scene.grid_enc.numel() + scene.flags.numel() * 4 + n * (72 + 88)
    march_bound = bound(march_bytes, crossings * MARCH_OPS_PER_CROSSING)
    print(f"bound fused_march full {side}x{side}: {march_bytes} bytes, {crossings} primary "
          f"crossings -> {march_bound[0]:.4f} ms ({march_bound[1]}), "
          f"kernel at {march_bound[0] / times['full'][0]:.3f} of it through its wrapper, "
          f"{march_bound[0] / raw[f'full {side}^2 (bench frame)'][0]:.3f} on raw launches | {card}")
    return times, march_bound, raw


def window_bounds(wargs):
    """(forward bound, backward bound) of a window launch pair on these rays,
    from phase 7e's formulas: per-ray planes, the field rows the windows
    touch, and for the backward the zero-filled gradient field plus a
    read-modify-write of every touched row."""
    field, cell, tmax, istep, absd, shape3 = wargs[:6]
    n, V = cell.shape[0], field.shape[0]
    rows = window_rows(cell, tmax, istep, absd, shape3)
    samples = n * NUM_STEPS
    fwd_bytes = n * (48 + 24) + rows * 16
    bwd_bytes = n * (48 + 32 + 24) + rows * 16 + V * 16 + rows * 32
    return (bound(fwd_bytes, samples * WINDOW_FWD_OPS_PER_SAMPLE),
            bound(bwd_bytes, samples * WINDOW_BWD_OPS_PER_SAMPLE), rows)


def window_bwd_diagnosis(name, card, fw, wargs, g_surf, g_tend, surf, t_end):
    """window_bwd's gradients on one batch against window_plain's autograd
    (GRAD_TOL max-scaled: the block size the wrapper picks for this batch),
    then the window pair as raw launches on fixed inputs: window_fwd,
    window_bwd's kernel alone (into one zeroed gradient) and the gradient's
    zero-fill alone, the occupancy, the gradient row updates (one float4
    atomicAdd each) from the plain DDA, and the bounds. Returns {kernel:
    (ms, bound ms)} (window_fwd's device time back to back, window_bwd's
    CUDA-event ms with its zero-fill), and "grad_err", the largest gradient
    difference."""
    fwd_fn, fwd_args, _ = fw._fwd_args(*wargs)
    fn, args, grad, g_tmax, g_abs, _ = fw._bwd_args(*wargs, g_surf, g_tend, surf, t_end)

    def launch(f, a):
        if f(*a) != 0:
            raise AssertionError("a launch of a window kernel failed")
    n = wargs[1].shape[0]
    launch(fn, args)
    leaves = [wargs[i].detach().clone().requires_grad_(True) for i in (0, 2, 4)]
    plain = fw.window_plain(leaves[0], wargs[1], leaves[1], wargs[3], leaves[2], *wargs[5:])
    ref = torch.autograd.grad(plain[:2], leaves, (g_surf, g_tend))
    scaled, grad_err = {}, 0.0
    for key, a, b in zip(("field", "tmax", "abs_delta"), (grad, g_tmax, g_abs), ref):
        m = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), m):
            raise AssertionError(f"window_bwd {name}: {key} gradient finite on other entries")
        scaled[key] = max_scaled(a[m], b[m])
        grad_err = max(grad_err, float((a[m] - b[m]).abs().max()))
    print(f"parity window_bwd {name} vs window_plain's autograd: gradients max-scaled "
          + " ".join(f"{k} {v:.3e}" for k, v in scaled.items()) + f" | {card}")
    if max(scaled.values()) > GRAD_TOL:
        raise AssertionError(f"window_bwd {name}: gradients disagree beyond {GRAD_TOL} max-scaled")
    del plain, ref, leaves
    reps = 20 if n >= 2**18 else 100
    f_ms = cuda_ms(lambda: launch(fwd_fn, fwd_args), reps=reps, warmup=3)
    f_dev = launch_device_ms(lambda: launch(fwd_fn, fwd_args), "window_fwd", reps)[0]
    k_ms = cuda_ms(lambda: launch(fn, args), reps=reps, warmup=3)
    z_ms = cuda_ms(lambda: grad.zero_(), reps=reps, warmup=3)
    upd = window_row_updates(*wargs[1:6])
    fb, bb, rows = window_bounds(wargs)
    print(f"timing window pair {name}: window_fwd {f_ms:.4f} ms ({f_dev:.4f} ms of device time "
          f"back to back; bound {fb[0]:.4f}, {fb[1]}); "
          f"window_bwd kernel {k_ms:.4f} ms + zero-fill of the [V, 4] gradient {z_ms:.4f} ms "
          f"(bound of both {bb[0]:.4f}, {bb[1]}); occupancy {fw.occupancy()}; {rows} rows "
          f"touched, {upd['samples_in_grid']} in-grid samples, {upd['row_updates_per_warp']} "
          f"row updates (one per warp, step and row), {upd['row_updates_per_block128']} if "
          f"summed per block of 128 | {card}")
    return {"window_fwd": (f_dev, fb[0]), "window_bwd": (k_ms + z_ms, bb[0]), "grad_err": grad_err,
            "window_fwd_device": f_dev}


GUIDE_WORLDS = ("ref-world", "world-512")  # the benchmark's two worlds (bench_gpu/configs)
GUIDE_FIT_STEPS = 6  # fit_world steps before the second check (rebuilds at 0, 2, 4)


def guide_fields_equal(a, b) -> list:
    """Names of the Scene fields in which ``a`` and ``b`` differ."""
    import dataclasses

    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            same = x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        else:
            same = type(x) is type(y) and x == y
        if not same:
            bad.append(f.name)
    return bad


def guide_check(dev, card) -> dict:
    """Phase 7d: the fit's guide rebuild on the card at both benchmark sizes.
    fit_world's GUIDE_FIT_STEPS steps must build every guide from a tensor
    and launch the distance kernel six times a rebuild (counters zeroed
    just before the fit). For each field (init_params; fit_world's after
    the steps; a random one; one occupied where the world is solid) the
    distance kernel is held to its plain version on the same CUDA tensors,
    grid_enc and both brick fields, and the guide guide_scene_from_params
    builds on the card to the numpy builders' Scene of the same threshold,
    every field to the bit. Then one rebuild's host time (synchronised) and
    device busy time (torch.profiler), beside the numpy path's host time;
    and the kernel's six passes against their plain version on the same
    inputs (the fitted field's occupancy and its brick occupancy), with the
    bound of what the function needs (the ids and brick occupancy read
    once, grid_enc and the brick fields written once) and, beside it, the
    traffic of the three-pass design. Returns the kernels-line entry of
    the kernel (world-512)."""
    from raytracing_test_tpu_torch.app import fit
    from raytracing_test_tpu_torch.config import FitConfig, WorldConfig, world_for_size
    from raytracing_test_tpu_torch.core import flatten
    from raytracing_test_tpu_torch.kernels import chebyshev
    from raytracing_test_tpu_torch.parallel import sharding
    from raytracing_test_tpu_torch.worldgen import terrain

    entry = {"name": "cheb_pass", "route": "cuda",
             "source": "raytracing_test_tpu_torch/csrc/chebyshev.cu",
             "replaces": "none (the host's core/flatten.py:_air_licences and "
                         "chebyshev_distance_field)",
             "launches": 0, "max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
             "bound_by": "bytes", "library_ms": None}
    for label in GUIDE_WORLDS:
        wcfg = WorldConfig() if label == "ref-world" else world_for_size(512)
        shape = tuple(wcfg.grid_shape)
        grid, pal = terrain.gen_world_grid(wcfg)
        scene = flatten.scene_from_grid(grid, pal, dev)
        solid = torch.from_numpy(grid != 0).to(dev)
        del grid
        fcfg = FitConfig(views=8, resolution=64, steps=GUIDE_FIT_STEPS, rethreshold_every=2,
                         engine="fused")
        flatten.SCENES_FROM_NUMPY = flatten.SCENES_FROM_TENSOR = chebyshev.LAUNCHES = 0
        fitted, _ = fit.fit_world(scene, shape, fcfg, log_every=10 ** 9)
        built = (flatten.SCENES_FROM_NUMPY, flatten.SCENES_FROM_TENSOR)
        fit_launches = chebyshev.LAUNCHES
        print(f"guide {label}: fit_world's {GUIDE_FIT_STEPS} steps built (numpy, tensor) "
              f"{built} Scenes, {fit_launches} cheb_pass launches")
        if built != (0, 3) or fit_launches != 6 * built[1]:
            raise AssertionError(f"guide {label}: fit_world built (numpy, tensor) {built} "
                                 f"Scenes with {fit_launches} cheb_pass launches, expected "
                                 f"(0, 3) and 18")
        rnd = sharding.init_params(shape, dev)
        with torch.no_grad():
            gen = torch.Generator(device=dev).manual_seed(7)
            rnd.density_raw.copy_(torch.randn(shape, device=dev, generator=gen) * 1.5 - 3.5)
            world = sharding.init_params(shape, dev)  # occupied where the world is solid
            world.density_raw.copy_(torch.where(solid, 5.0, -10.0))
        s = flatten.pick_brick_shift(shape)

        def brick_occ(occ):
            b = occ.reshape(shape[0] >> s, 1 << s, shape[1] >> s, 1 << s,
                            shape[2] >> s, 1 << s).amax(dim=(1, 3, 5))
            return torch.stack([b, b])  # brick_dist's and brick_dist_shadow's

        for which, p in (("init_params", sharding.init_params(shape, dev)),
                         (f"after {GUIDE_FIT_STEPS} fit steps", fitted), ("random field", rnd),
                         ("the world's solid cells", world)):
            occ = sharding.guide_occupancy(p)
            k_enc = chebyshev.distance(occ, 32, licence=True)
            p_enc = chebyshev.distance_plain(occ, 32, licence=True)
            bocc = brick_occ(occ)
            k_b, p_b = chebyshev.distance(bocc, 8), chebyshev.distance_plain(bocc, 8)
            guide = sharding.guide_scene_from_params(p)
            want = flatten.scene_from_grid(occ.cpu().numpy(), sharding.guide_palette(), dev)
            bad = guide_fields_equal(guide, want)
            share = float(occ.float().mean())
            print(f"guide {label} {which}: occupied share {share:.4f}, y_max {guide.y_max}; "
                  f"kernel vs plain: grid_enc {torch.equal(k_enc, p_enc)}, brick fields "
                  f"{torch.equal(k_b, p_b)}; card guide vs numpy guide: "
                  f"{'equal in every field' if not bad else 'differs in ' + ', '.join(bad)}")
            if not torch.equal(k_enc, p_enc) or not torch.equal(k_b, p_b) or bad:
                raise AssertionError(f"guide {label} {which}: the card's guide is not the "
                                     f"numpy builders'")

        # one rebuild on the fitted field: the card path, then the path it
        # replaced (the float density read back, thresholded by numpy)
        p = fitted
        sharding.guide_scene_from_params(p)
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            sharding.guide_scene_from_params(p)
        card_ms = (time.perf_counter() - t0) * 1e3 / reps
        per_name = profile_step(lambda: sharding.guide_scene_from_params(p), card, steps=reps,
                                label=f"guide rebuild {label} on the card")
        busy = sum(sum(v) for v in per_name.values()) / reps / 1e3
        t0 = time.perf_counter()
        with torch.no_grad():
            dens = (torch.nn.functional.softplus(p.density_raw) * 25.0).cpu().numpy()
        flatten.scene_from_grid((dens > 1.0).astype(np.uint8), sharding.guide_palette(), dev)
        torch.cuda.synchronize()
        numpy_ms = (time.perf_counter() - t0) * 1e3
        print(f"guide rebuild {label} {shape}: card {card_ms:.3f} ms host (synchronised), "
              f"device busy {busy:.4f} ms; numpy path {numpy_ms:.1f} ms host (readback, "
              f"builders, upload) | {card}")

        # the kernel's six passes and their plain version, on the same inputs
        occ = sharding.guide_occupancy(p)
        bocc = brick_occ(occ)
        kernel = lambda: (chebyshev.distance(occ, 32, licence=True), chebyshev.distance(bocc, 8))
        plain = lambda: (chebyshev.distance_plain(occ, 32, licence=True),
                         chebyshev.distance_plain(bocc, 8))
        cheb = launch_device_ms(kernel, "cheb_", reps=reps, per_call=6)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        n, nb = occ.numel(), bocc.numel()
        floor_ms = bound(2 * n + 2 * nb, 0)[0]  # ids and brick occupancy in, fields out
        design = [2 * n, 2 * n, 3 * n] + [2 * nb] * 3  # grid_enc z y x (ids read in x), bricks
        design_ms = [bound(b, 0)[0] for b in design]
        print(f"  cheb_pass launches (grid_enc z y x, bricks z y x) ms "
              f"{' '.join(f'{v:.4f}' for v in cheb)}, sum {sum(cheb):.4f}; plain version "
              f"{plain_ms:.3f} ms; bound of the function ({2 * n + 2 * nb} B) "
              f"{floor_ms:.4f} ({floor_ms / sum(cheb):.3f}); the three-pass design's traffic "
              f"{sum(design)} B, {sum(design_ms):.4f} ms ({sum(design_ms) / sum(cheb):.3f}) "
              f"| {card}")
        if label == "world-512":
            entry.update(launches=fit_launches, ms=sum(cheb), plain_ms=plain_ms,
                         bound_ms=floor_ms)
    return entry


def train_phase(dev, card, side, grid, pal, scene, cli, fm, fw):
    from raytracing_test_tpu_torch.app import fit
    from raytracing_test_tpu_torch.config import WorldConfig
    from raytracing_test_tpu_torch.core.flatten import palette_arrays
    from raytracing_test_tpu_torch.parallel import sharding
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions
    from raytracing_test_tpu_torch.render import progressive
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
    fwd_err, grad_err = window_parity(fw, ds, cam.pos, dirs, seed, f"{side}^2")

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
    cli.main(["--device", str(dev), "fit", "--engine", "fused", "--steps", "10"])
    torch.cuda.synchronize()
    counts = {"window_fwd": fw.LAUNCHES_FWD, "window_bwd": fw.LAUNCHES_BWD}
    march_launches = fm.LAUNCHES
    print(f"cli fit: 10 steps in {time.perf_counter() - t0:.2f} s (world and targets included); "
          f"main-path launches {counts}, fused_march {march_launches}")
    if counts != {"window_fwd": 15, "window_bwd": 15}:
        raise AssertionError(f"train path launches {counts}, expected 15 each")
    guide = guide_check(dev, card)

    # e. timing at the bench shapes (1024^2 rays x 24 steps)
    out = {"march_launches": march_launches, "seeds": counts["window_fwd"], "guide": guide,
           "steps": {TRAIN_BATCH: len(losses), CLI_BATCH: counts["window_fwd"] - len(losses)}}
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
    bench_bwd = window_bwd_diagnosis(f"{side}^2 x {NUM_STEPS} (bench seeds)", card, fw, wargs,
                                     g_surf, g_tend, surf, t_end)
    grad_err = max(grad_err, bench_bwd["grad_err"])
    # the train path's batches: rays of the fit's ring views, seeded on the scene
    rng = np.random.default_rng(1)
    out["batches"] = {}
    for nb in (TRAIN_BATCH, CLI_BATCH):
        idx = torch.from_numpy(rng.integers(0, origins.shape[0], nb)).to(dev)
        o_b, d_b = origins[idx].contiguous(), rdirs[idx].contiguous()
        sd = progressive.guided_seeds(fm.render_rays_fused, scene, o_b, d_b, 3.0)
        errs = window_parity(fw, ds, o_b, d_b, sd, f"{nb} rays (a train batch)")
        fwd_err, grad_err = max(fwd_err, errs[0]), max(grad_err, errs[1])
        _, _, bc, bt, bi, ba = fw.window_inputs(shape3, o_b, d_b, sd)
        bargs = (field, bc, bt, bi, ba, shape3, sun, NUM_STEPS, False)
        b_surf, b_tend, _, _ = fw._launch_fwd(*bargs)
        out["batches"][nb] = window_bwd_diagnosis(
            f"{nb} x {NUM_STEPS} (a train batch)", card, fw, bargs,
            torch.full((nb, 3), 1.0 / (3 * nb), device=dev), torch.zeros(nb, device=dev),
            b_surf, b_tend)
        grad_err = max(grad_err, out["batches"][nb]["grad_err"])

    # window_fwd inside a train step, after the seed march and the preamble,
    # against its back-to-back launches above
    for nb in (TRAIN_BATCH, CLI_BATCH):
        idx = torch.from_numpy(rng.integers(0, origins.shape[0], nb)).to(dev)
        b = (origins[idx], rdirs[idx], targets[idx])
        in_step = launch_device_ms(lambda: step_fn(*b), "window_fwd", reps=5)[0]
        print(f"window_fwd {nb} x {NUM_STEPS}: {in_step:.4f} ms of device time inside a train "
              f"step, {out['batches'][nb]['window_fwd_device']:.4f} back to back | {card}")

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

    per_name = profile_step(lambda: step(fw.render_window_fused), card)
    in_step = [t for k, v in per_name.items() if "window_fwd" in k for t in v]
    print(f"window_fwd {side}^2 x {NUM_STEPS}: {sum(in_step) / len(in_step) / 1e3:.4f} ms of "
          f"device time inside loss+backward, {bench_bwd['window_fwd_device']:.4f} back to back "
          f"| {card}")

    # bounds from this run's windows (window_bounds)
    fb, bb, rows = window_bounds(wargs)
    out["window_fwd"] = dict(ms=fwd_ms, plain_ms=plain_fwd_ms, launches=counts["window_fwd"],
                             max_abs_err=fwd_err, bound=fb)
    out["window_bwd"] = dict(ms=bwd_ms, plain_ms=plain_bwd_ms, launches=counts["window_bwd"],
                             max_abs_err=grad_err, bound=bb)
    for name in ("window_fwd", "window_bwd"):
        b = out[name]["bound"]
        print(f"bound {name}: {rows} field rows touched of {field.shape[0]}, "
              f"{n * NUM_STEPS} samples -> {b[0]:.4f} ms ({b[1]}), kernel at "
              f"{b[0] / out[name]['ms']:.3f} of it | {card}")
    return out


def state_parity(name, k, p, evt_k=None, evt_p=None, verbose=True) -> float:
    """Kernel vs plain output states: integer fields equal, float fields
    equal to the bit (and evt equal). Prints the comparison (with
    ``verbose``, else only a difference) and raises on a difference;
    returns the largest float difference."""
    err, bad = 0.0, []
    for f in STATE_FIELDS:
        a, b = getattr(k, f), getattr(p, f)
        if a.is_floating_point():
            same = a.view(torch.int32) == b.view(torch.int32)
            err = max(err, float((a - b).abs().max()))
        else:
            same = a == b
        n_bad = int((~same.reshape(a.shape[0], -1).all(dim=1)).sum())
        if n_bad:
            bad.append(f"{f} on {n_bad} lanes")
    if evt_k is not None and not torch.equal(evt_k, evt_p):
        bad.append(f"evt on {int((evt_k != evt_p).sum())} lanes")
    extra = "" if evt_k is None else f", {int(evt_k.sum())} events"
    if verbose or bad:
        print(f"parity {name}: {int((~p.done).sum())} lanes left{extra}, max_abs_err {err:.3e}, "
              + ("all fields equal" if not bad else "DIFFER: " + "; ".join(bad)))
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def brick_kernel_parity(scene, s, rcfg, o_full):
    """(a) Both brick kernels against their plain versions on the states of
    the first two rounds of the primary march from ``s`` and of the shadow
    march from the fused kernel's hits ``o_full``. Rounds move on with the
    plain twins. Returns (max_abs_err, {(march, round): (fine input, blin,
    advance input)})."""
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk
    from raytracing_test_tpu_torch.render import bricks, fast
    from raytracing_test_tpu_torch.render.renderer import _get

    sun = torch.from_numpy(fast.sun_unit(rcfg.sun_dir)).to(s.cell.device)
    s, raw0, _ = fast.start_cell(scene, s)
    la = o_full["la"]
    facing = sun[la.long()] * -_get(o_full["step"], la) > 0
    active = (o_full["mat"] != 0) & facing & ~o_full["refl"] & ~raw0
    p = o_full["seg_origin"] + o_full["lt"][:, None] * o_full["dir"]
    shadow0 = bricks.shadow_start(scene, p, o_full["cell"], la, rcfg, sun, active)
    err, inputs = 0.0, {}
    for march, st, shadow in (("primary", s, False), ("shadow", shadow0, True)):
        table = scene.brick_dist_shadow if shadow else scene.brick_dist
        luts = bk._prop_luts(scene, shadow, rcfg.enable_materials)
        budget = rcfg.shadow_steps if shadow else rcfg.max_steps
        for r in (1, 2):
            blin = bricks.occupied_brick(scene, table, st)
            kf, ke = bk.brick_fine(scene, st, blin, luts, budget)
            pf, pe = bk.brick_fine_plain(scene, st, blin, luts, budget)
            err = max(err, state_parity(f"brick_fine {march} round {r}", kf, pf, ke, pe))
            after_fine = bricks._fine_loop(scene, st, blin, rcfg, budget, shadow, 0.0)
            ka = bk.brick_advance(scene, table, after_fine, budget)
            pa = bk.brick_advance_plain(scene, table, after_fine, budget)
            err = max(err, state_parity(f"brick_advance {march} round {r}", ka, pa))
            inputs[(march, r)] = (st, blin, after_fine)
            st = pa
    torch.cuda.synchronize()
    return err, inputs


def checked_advance(name):
    """brick_march's brick hook as the main path has it (advance_loop, in
    place), with every launch held to the bit to brick_advance_plain on its
    input, and brick_advance on a copy of that input held to it too. The
    hook's ``errs`` collects each launch's largest float difference."""
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk

    def hook(sc, table, s, budget):
        p = bk.brick_advance_plain(sc, table, s, budget)
        copy = bk.brick_advance(sc, table, s, budget)
        out = bk.advance_loop(sc, table, s, budget)
        k = len(hook.errs)
        hook.errs.append(max(
            state_parity(f"brick_advance {name} launch {k}, in place", out, p, verbose=False),
            state_parity(f"brick_advance {name} launch {k}, on a copy", copy, p, verbose=False)))
        return out

    hook.errs = []
    return hook


class watched_fine:
    """Within this block every brick_fine launch goes through
    brick_kernels._launch_fine wrapped (fine_loop and brick_fine look it up
    at each launch): the fields it writes are copied before the launch, and
    ``check(scene, s_in, blin, luts, budget, lanes, s_out, evt, listing)``
    sees the launch after it (``lanes``: None for a launch over all lanes,
    else the K listed; ``listing``: the launch appends its event lanes to a
    list)."""

    def __init__(self, check):
        self.check = check

    def __enter__(self):
        from raytracing_test_tpu_torch.kernels import brick_kernels as bk
        from raytracing_test_tpu_torch.render import bricks

        real = self.real = bk._launch_fine

        def launch(scene, s, blin, luts, budget, evt, lanes=None, k=0, list_out=None,
                   counts=None, w=0):
            s_in = bricks.writable(s)
            real(scene, s, blin, luts, budget, evt, lanes, k, list_out, counts, w)
            self.check(scene, s_in, blin, luts, budget, None if lanes is None else lanes[:k], s,
                       evt, list_out is not None)

        bk._launch_fine = launch
        return self

    def __exit__(self, *exc):
        from raytracing_test_tpu_torch.kernels import brick_kernels as bk

        bk._launch_fine = self.real


def checked_fine(name):
    """A check for watched_fine that holds a brick_fine launch to the bit to
    brick_fine_plain on its input over all lanes, state and evt, and
    collects each launch's largest float difference in its ``errs``."""
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk

    def check(sc, s_in, blin, luts, budget, lanes, out, evt, listing):
        p, pe = bk.brick_fine_plain(sc, s_in, blin, luts, budget)
        check.errs.append(state_parity(f"brick_fine {name} launch {len(check.errs)}", out, p, evt,
                                       pe, verbose=False))

    check.errs = []
    return check


def brick_frame_parity(name, scene, pos, dirn, rcfg, time_s, card):
    """(b) The brick frame on the kernels against the fused frame and the
    plain brick frame on the card: render_rays_bricks_pallas's hooks, with
    every brick_fine and brick_advance launch held to its plain version
    (checked_fine, checked_advance). Returns ({reference: max_abs_err}, aux,
    ray directions)."""
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.render import bricks
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions

    dev = scene.device
    cam = Camera(pos=torch.tensor(pos, device=dev), dir=torch.tensor(dirn, device=dev))
    dirs = ray_directions(cam, rcfg.width, rcfg.height)
    adv, fine = checked_advance(name), checked_fine(name)
    with watched_fine(fine):
        cb, ab = bricks.render_rays_bricks(scene, cam.pos, dirs, rcfg, time_s=time_s,
                                           fine_loop=bk.fine_loop, brick_loop=adv)
    torch.cuda.synchronize()
    print(f"parity bricks {name}: every brick_fine launch of the frame ({len(fine.errs)}) equal "
          f"to brick_fine_plain (state and evt), max_abs_err {max(fine.errs):.3e}; every "
          f"brick_advance launch ({len(adv.errs)}) equal to brick_advance_plain, in place and on "
          f"a copy, max_abs_err {max(adv.errs):.3e} | {card}")
    if not (torch.isfinite(cb).all() and cb.shape == (rcfg.width * rcfg.height, 3)):
        raise AssertionError(f"bricks {name}: frame not finite or of the wrong shape")
    errs = {}
    for ref, (c, a) in (("fused", fm.render_rays_fused(scene, cam.pos, dirs, rcfg, time_s=time_s)),
                        ("plain bricks", bricks.render_rays_bricks(scene, cam.pos, dirs, rcfg,
                                                                   time_s=time_s))):
        d = (cb - c).abs().max(dim=1).values
        bad = float((d > ATOL).float().mean())
        hit = a["mat"] != 0
        eq = {"mat": ab["mat"] == a["mat"], "cell": (ab["cell"] == a["cell"]).all(dim=1),
              "steps": ab["steps"] == a["steps"]}
        frac = {k: float(v.float().mean()) for k, v in eq.items()}
        frac_hit = {k: float(v[hit].float().mean()) if bool(hit.any()) else 1.0
                    for k, v in eq.items()}
        errs[ref] = max(float(d.max()), max(adv.errs), max(fine.errs))
        print(f"parity bricks {name} vs {ref}: max_abs_err {d.max():.3e} bad_frac {bad:.6f}; "
              "equal on all rays " + " ".join(f"{k} {v:.6f}" for k, v in frac.items())
              + "; on hit rays " + " ".join(f"{k} {v:.6f}" for k, v in frac_hit.items())
              + f"; hit {float(hit.float().mean()):.4f}, rounds {ab['march_rounds']} | {card}")
        if bad > MAX_BAD_FRAC or frac["mat"] < MIN_EQ_FRAC or min(frac_hit.values()) < MIN_EQ_FRAC:
            raise AssertionError(f"bricks {name}: the brick frame disagrees with the {ref} frame")
    return errs, ab, dirs


def counted_brick_frame(scene, pos, dirn, rcfg):
    """One brick frame on the kernels with counting hooks: rounds, glue
    passes and launches, primary and shadow, and the most loop iterations
    of any lane in any launch: for brick_advance its advancing iterations
    (advance_iterations) + 1; for brick_fine the DDA steps the fine phase
    took + 1, an upper bound (each iteration that does not end a lane's
    loop takes one step)."""
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk
    from raytracing_test_tpu_torch.render import bricks
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions

    dev = scene.device
    st = {"adv_iter": 0, "fine_iter": 0, "fine_calls": [0, 0], "glue": [0, 0], "glue_max": 0,
          "adv": [0, 0], "fine": [0, 0]}

    def adv(sc, table, s, budget):
        st["adv"][int(table is sc.brick_dist_shadow)] += 1
        st["adv_iter"] = max(st["adv_iter"], int(advance_iterations(sc, table, s, budget).max()) + 1)
        return bk.advance_loop(sc, table, s, budget)

    def fine(sc, s, blin, cfg, budget, shadow, t):
        n0 = bk.LAUNCHES_FINE
        out = bk.fine_loop(sc, s, blin, cfg, budget, shadow, t)
        n = bk.LAUNCHES_FINE - n0
        st["fine"][int(shadow)] += n
        st["fine_calls"][int(shadow)] += 1
        st["glue"][int(shadow)] += n - 1
        st["glue_max"] = max(st["glue_max"], n - 1)
        st["fine_iter"] = max(st["fine_iter"], int((out.steps - s.steps).max()) + 1)
        return out

    cam = Camera(pos=torch.tensor(pos, device=dev), dir=torch.tensor(dirn, device=dev))
    dirs = ray_directions(cam, rcfg.width, rcfg.height)
    _, aux = bricks.render_rays_bricks(scene, cam.pos, dirs, rcfg, fine_loop=fine, brick_loop=adv)
    torch.cuda.synchronize()
    st["rounds"] = [aux["march_rounds"], st["fine_calls"][1]]
    caps = {"advance iterations per lane": (st["adv_iter"], bricks._BRICK_CAP),
            "fine iterations per lane": (st["fine_iter"], bricks._FINE_CAP),
            "glue passes per fine phase": (st["glue_max"], bk._GLUE_CAP),
            "rounds per march": (max(st["rounds"]), bricks._ROUND_CAP)}
    for what, (got, cap) in caps.items():
        if got >= cap:
            raise AssertionError(f"a lane reached the cap on {what}: {got} of {cap}")
    st["caps"] = caps
    return st


def advance_iterations(scene, table, s, budget, with_state=False):
    """Advancing iterations of each lane in brick_advance on ``s``, counted
    by the plain loop's march masks (kernel and plain version take the same
    iterations, part a); with ``with_state`` also the advanced state."""
    from raytracing_test_tpu_torch.render import bricks

    count = torch.zeros_like(s.steps)
    for _ in range(bricks._BRICK_CAP):
        s, march = bricks._brick_step(scene, table, s, budget)
        if not bool(march.any()):
            break
        count += march.to(count.dtype)
    return (count, s) if with_state else count


def warp_efficiency(work, order) -> float:
    """Sum of ``work`` over 32 x the sum over warps of the warp's largest
    work, warps of 32 threads formed by ``order`` (the ray of each thread,
    -1: none)."""
    valid = (order >= 0).to(work.device)
    w = torch.where(valid, work[order.clamp(min=0).to(work.device)], 0).reshape(-1, 32)
    lanes = 32 * float(w.max(dim=1).values.to(torch.int64).sum())
    return float(w.to(torch.int64).sum()) / lanes if lanes else 1.0


def advance_launch_stats(scene, table, s, budget, width) -> dict:
    """What one brick_advance launch on ``s`` has to do: lanes live on entry
    and lanes that advance, the advancing iterations (total; mean over the
    live lanes; mean over warps of the warp's largest count, in natural
    order), lane efficiency in natural order and in 8x4 pixel tiles of the
    ``width``-wide image, and the launch's bound: the full state in and out
    of each lane that changes, the bytes that show that a live lane stays
    (BRICK_WAIT_IN), 1 byte for each done lane, the table once, and 20
    operations per advancing iteration."""
    from raytracing_test_tpu_torch.render import bricks

    it, out = advance_iterations(scene, table, s, budget, with_state=True)
    n = it.shape[0]
    live = int((~s.done).sum())
    changed = torch.zeros_like(s.done)
    for f in bricks.HOOK_WRITES:
        a, b = getattr(out, f), getattr(s, f)
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        changed |= (a != b).reshape(n, -1).any(dim=1)
    moved = int(changed.sum())
    nat, til = natural_order(n), tile_order_for(n, width)
    pad = torch.cat([it, it.new_zeros(-n % 32)]).reshape(-1, 32)
    total = int(it.to(torch.int64).sum())
    nbytes = (moved * (BRICK_STATE_IN + BRICK_STATE_OUT) + (live - moved) * BRICK_WAIT_IN
              + (n - live) + table.numel())
    return {"n": n, "live": live, "advancing": int((it > 0).sum()), "iterations": total,
            "mean": total / max(live, 1), "warp_max": float(pad.max(dim=1).values.float().mean()),
            "eff_natural": warp_efficiency(it, nat), "eff_tiles": warp_efficiency(it, til),
            "bound": bound(nbytes, total * BRICK_ADVANCE_OPS_PER_ITER), "bytes": nbytes}


def launch_device_ms(fn, kernel: str, reps: int, per_call: int = 1) -> list:
    """Device ms of each of the ``per_call`` launches of the kernel whose
    name holds ``kernel`` in one call of ``fn``, in launch order, each the
    mean over ``reps`` calls (torch.profiler, after one warm-up call). The
    profiler can drop an event (one brick_advance launch of 20 went missing
    in every session of two runs on the card): with one launch a call, the
    mean of the launches it saw (at least half of them) is taken; with more,
    a session that saw another count than reps x per_call is made again, up
    to three times. Each session starts with a one-element fill that no
    ``kernel`` name matches, in case the event lost is a session's first
    kernel (six bare cheb_pass launches a call lost one of 30 in each of
    three sessions; inside a rebuild, after other kernels, none was lost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [t for _, t in sorted((e.time_range.start, e.time_range.elapsed_us())
                                   for e in prof.events()
                                   if e.device_type == DeviceType.CUDA and kernel in e.name)]
        if per_call == 1 and reps // 2 <= len(us) <= reps:
            return [sum(us) / len(us) / 1e3]
        if len(us) == reps * per_call:
            return [sum(us[r * per_call + i] for r in range(reps)) / reps / 1e3
                    for i in range(per_call)]
    raise AssertionError(f"{len(us)} launches of {kernel} profiled in {reps} calls, "
                         f"expected {reps * per_call}")


def advance_frame(scene, pos, dirn, rcfg, card, label, reps=3):
    """Every brick_advance launch of one brick frame on the main path's
    hooks: per launch its work (advance_launch_stats, from the input state
    of a frame whose hook counts before it launches), its device time
    (launch_device_ms over ``reps`` frames) and its bound; then the frame's
    lost time, the sum over launches of (ms - bound). Returns the sums
    {"launches", "ms", "bound", "lost"}."""
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk
    from raytracing_test_tpu_torch.render import bricks
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions

    dev = scene.device
    cam = Camera(pos=torch.tensor(pos, device=dev), dir=torch.tensor(dirn, device=dev))
    dirs = ray_directions(cam, rcfg.width, rcfg.height)
    stats = []

    def adv(sc, table, s, budget):
        st = advance_launch_stats(sc, table, s, budget, rcfg.width)
        st["march"] = "shadow" if table is sc.brick_dist_shadow else "primary"
        stats.append(st)
        return bk.advance_loop(sc, table, s, budget)

    bricks.render_rays_bricks(scene, cam.pos, dirs, rcfg, fine_loop=bk.fine_loop, brick_loop=adv)
    ms = launch_device_ms(lambda: bk.render_rays_bricks_pallas(scene, cam.pos, dirs, rcfg),
                          "brick_advance", reps, per_call=len(stats))
    if len(ms) != len(stats):
        raise AssertionError(f"{len(ms)} brick_advance launches profiled, {len(stats)} counted")
    print(f"brick_advance, every launch of the {label} brick frame (device ms: torch.profiler, "
          f"mean of {reps} frames) | {card}")
    for i, (st, t) in enumerate(zip(stats, ms)):
        b, by = st["bound"]
        print(f"  {i:2d} {st['march']:7s}: {st['live']:7d} live of {st['n']}, {st['advancing']:7d} "
              f"advance; iterations {st['iterations']} (mean {st['mean']:.2f} a live lane, warps' "
              f"largest {st['warp_max']:.2f} on average); lane efficiency natural "
              f"{st['eff_natural']:.3f}, 8x4 tiles {st['eff_tiles']:.3f}; {t:.4f} ms, bound "
              f"{b:.4f} ({by}), share {b / t:.3f}")
    sums = {"launches": len(ms), "ms": sum(ms), "bound": sum(st["bound"][0] for st in stats)}
    sums["lost"] = sums["ms"] - sums["bound"]
    first = stats[0]
    r1 = bound(first["n"] * (BRICK_STATE_IN + BRICK_STATE_OUT) + scene.brick_dist.numel(),
               first["iterations"] * BRICK_ADVANCE_OPS_PER_ITER)[0]
    print(f"brick_advance {label} frame: {sums['launches']} launches, {sums['ms']:.4f} ms, bound "
          f"{sums['bound']:.4f} ms, lost {sums['lost']:.4f} ms (sum of ms - bound); round-1 launch "
          f"{ms[0]:.4f} ms against the all-lanes bound {r1:.4f} ({r1 / ms[0]:.3f}); launches x "
          f"round 1's (ms - all-lanes bound) would say {len(ms) * (ms[0] - r1):.4f} ms | {card}")
    return sums


def fine_launch_stats(scene, s_in, blin, luts, budget, lanes, out, evt, listing) -> dict:
    """What one brick_fine launch had to do (its input ``s_in``, its output
    ``out`` and ``evt``; ``lanes``: None for a launch over all lanes, else
    the K listed; ``listing``: it appends its event lanes to a list), and
    its bound from what these inputs need, lane by lane:

      every lane launched: blin read (4 B), evt written (1 B), and in a
        list launch its list entry read (4 B);
      a lane with a brick (blin >= 0): its done byte read;
      a live one: its cell read (12 B), which shows whether it stands in
        its brick;
      one inside its brick: its mat (4 B: written where it changes, else
        read to show that it stays) and the voxel of its cell;
      one that steps: tmax and steps read (16 B), and step and abs_delta
        (8 B) on each axis it steps along; cell and tmax (8 B) on those
        axes, last_t, last_axis and steps (12 B) written;
      one whose done changes: 1 B written;
      a listing launch: 4 B for each event lane it appends, and its two
        counters (8 B);

    plus one 32-byte sector of each brick_mat row a lane inside its brick
    reads (the least a read of the row moves; a lane reads a few of its 64
    voxels) and the 32 bytes of luts; 3 float32 operations per DDA step.
    ``full_bytes`` is the same count for a launch over all N lanes,
    ``whole_bytes`` what a kernel moves that loads and stores the whole
    state of every lane. Lanes that change without a step (a hit or an
    event at their first cell) need no DDA field: ``no_step`` counts
    them."""
    from raytracing_test_tpu_torch.render import bricks

    n = blin.shape[0]
    sel = torch.ones(n, dtype=torch.bool, device=blin.device)
    if lanes is not None:
        sel = torch.zeros_like(sel)
        sel[lanes.long()] = True
    changed = evt.clone()
    for f in bricks.HOOK_WRITES:
        a, b = getattr(out, f), getattr(s_in, f)
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        changed |= (a != b).reshape(n, -1).any(dim=1)
    if bool((changed & ~sel).any()):
        raise AssertionError("brick_fine changed a lane it was not given")
    wc, in_w = bricks._wrap_window(scene, s_in.cell)
    occ = blin >= 0
    live = occ & ~s_in.done
    inside = live & in_w & (bricks.brick_lin(scene, wc) == blin)
    stepped = out.steps != s_in.steps
    axes = int((out.cell != s_in.cell)[stepped].sum())
    rows = int(torch.unique(blin[inside]).numel())
    events = int(evt[sel].sum())
    moved = (int(stepped.sum()) * 28 + axes * 16 + int((out.done != s_in.done).sum())
             + rows * 32 + (luts.numel() * 4 if bool(inside.any()) else 0)
             + (4 * events + 8 if listing else 0))

    def need(m, listed):
        k = int(m.sum())
        return (k * (5 + (4 if listed else 0)) + int((occ & m).sum()) + 12 * int((live & m).sum())
                + 4 * int((inside & m).sum()) + moved)

    nbytes = need(sel, lanes is not None)
    full = need(torch.ones_like(sel), False)
    steps = int((out.steps - s_in.steps).sum())
    ops = steps * BRICK_FINE_OPS_PER_STEP
    return {"n": n, "launched": int(sel.sum()), "live": int((live & sel).sum()),
            "inside": int(inside.sum()), "changed": int(changed.sum()),
            "no_step": int((changed & ~stepped).sum()), "stepped": int(stepped.sum()),
            "events": events, "rows": rows, "steps": steps, "bytes": nbytes,
            "bound": bound(nbytes, ops), "kind": "full" if lanes is None else "list",
            "full_bytes": full, "full_bound": bound(full, ops)[0],
            "whole_bytes": n * (BRICK_STATE_IN + BRICK_STATE_OUT + 4 + 1) + rows * 64
            + luts.numel() * 4}


def fine_frame(scene, pos, dirn, rcfg, card, label, reps=3, each=False):
    """Every brick_fine launch of one brick frame on the main path's hooks:
    per launch its work and bound (fine_launch_stats, through watched_fine;
    brick_frame_parity holds the same frames' launches to
    brick_fine_plain), its device time (launch_device_ms over ``reps``
    frames); summed over the frame by march and pass (a round's first
    launch, the glue passes after it), with the lost time, the sum of
    (ms - bound). ``each`` prints every launch. Returns the sums
    {"launches", "ms", "bound", "lost"}."""
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk
    from raytracing_test_tpu_torch.render import bricks
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions

    dev = scene.device
    cam = Camera(pos=torch.tensor(pos, device=dev), dir=torch.tensor(dirn, device=dev))
    dirs = ray_directions(cam, rcfg.width, rcfg.height)
    stats = []

    def check(sc, s_in, blin, luts, budget, lanes, out, evt, listing):
        stats.append(fine_launch_stats(sc, s_in, blin, luts, budget, lanes, out, evt, listing))

    def fine(sc, s, blin, cfg, budget, shadow, t):
        first = len(stats)
        out = bk.fine_loop(sc, s, blin, cfg, budget, shadow, t)
        for k, st in enumerate(stats[first:]):
            st["march"], st["pass"] = ("shadow" if shadow else "primary"), k
        return out

    with watched_fine(check):
        bricks.render_rays_bricks(scene, cam.pos, dirs, rcfg, fine_loop=fine,
                                  brick_loop=bk.advance_loop)
    ms = launch_device_ms(lambda: bk.render_rays_bricks_pallas(scene, cam.pos, dirs, rcfg),
                          "brick_fine", reps, per_call=len(stats))
    if len(ms) != len(stats):
        raise AssertionError(f"{len(ms)} brick_fine launches profiled, {len(stats)} counted")
    for st, t in zip(stats, ms):
        st["ms"] = t
    print(f"brick_fine, every launch of the {label} brick frame (device ms: torch.profiler, "
          f"mean of {reps} frames) | {card}")
    if each:
        for i, st in enumerate(stats):
            b, by = st["bound"]
            print(f"  {i:3d} {st['march']:7s} pass {st['pass']:2d} ({st['kind']}): "
                  f"{st['launched']:7d} lanes launched, {st['live']:7d} live, {st['changed']:7d} "
                  f"change ({st['no_step']} without a step), {st['events']:6d} events, "
                  f"{st['steps']:8d} DDA steps; {st['ms']:.4f} ms, "
                  f"bound {b:.4f} ({by}, {st['bytes']} B), share {b / st['ms']:.3f}")
    groups = {}
    for st in stats:
        key = f"{st['march']} {'first launches' if st['pass'] == 0 else 'glue passes'}"
        groups.setdefault(key, []).append(st)
    for key, g in groups.items():
        t, b = sum(s["ms"] for s in g), sum(s["bound"][0] for s in g)
        print(f"  {key}: {len(g)} launches, {sum(s['launched'] for s in g)} lanes launched, "
              f"{sum(s['live'] for s in g)} live, {sum(s['changed'] for s in g)} change "
              f"({sum(s['no_step'] for s in g)} without a step), {sum(s['events'] for s in g)} "
              f"events, {sum(s['bytes'] for s in g)} B needed; {t:.4f} ms, bound {b:.4f}, lost "
              f"{t - b:.4f} ms, share {b / t:.3f}")
    top = sorted(stats, key=lambda s: -(s["ms"] - s["bound"][0]))[:5]
    print("  most lost: " + "; ".join(
        f"{s['march']} pass {s['pass']} {s['launched']} lanes {s['ms']:.4f} ms bound "
        f"{s['bound'][0]:.4f}" for s in top))
    sums = {"launches": len(ms), "ms": sum(ms), "bound": sum(s["bound"][0] for s in stats)}
    sums["lost"] = sums["ms"] - sums["bound"]
    need = sum(s["bytes"] for s in stats)
    full = sum(s["full_bytes"] for s in stats)
    whole = sum(s["whole_bytes"] for s in stats)
    print(f"brick_fine {label} frame: {sums['launches']} launches "
          f"({sum(s['kind'] == 'list' for s in stats)} over a list of event lanes), "
          f"{sum(s['launched'] for s in stats)} lane slots launched, "
          f"{sum(s['changed'] for s in stats)} lanes change "
          f"({sum(s['no_step'] for s in stats)} without a step); {sums['ms']:.4f} ms, bound "
          f"{sums['bound']:.4f} ms ({need} B needed), lost {sums['lost']:.4f} ms, share "
          f"{sums['bound'] / sums['ms']:.3f}; launches over all lanes would need {full} B "
          f"({sum(s['full_bound'] for s in stats):.4f} ms); loading and storing every lane's "
          f"whole state moves {whole} B ({whole / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory "
          f"rate) | {card}")
    return sums


def brick_launches(scene, inputs, rcfg, card, label):
    """brick_advance on the first round's and brick_fine on the second
    round's primary states (``inputs`` of brick_kernel_parity), with their
    bounds from the data: {kernel: (ms per launch, bound)}. Both kernels
    work in place, so each call of their public wrappers copies the state
    first; only the kernel's device time counts (torch.profiler). The
    brick_fine bound is what that launch's inputs need (fine_launch_stats)."""
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk
    from raytracing_test_tpu_torch.kernels import build
    from raytracing_test_tpu_torch.render import bricks

    lib = build.library("brick_march")
    s_adv = inputs[("primary", 1)][2]
    s_fine, blin_fine, _ = inputs[("primary", 2)]
    n = s_adv.cell.shape[0]
    luts = bk._prop_luts(scene, False, rcfg.enable_materials)

    def advance_fresh():
        fresh = bricks.writable(s_adv)
        args, _ = bk._advance_args(scene, scene.brick_dist, fresh, rcfg.max_steps)
        if lib.brick_advance_launch(*args) != 0:
            raise AssertionError("a timing launch of brick_advance failed")
        del fresh  # held until the launch is queued

    adv_ms = launch_device_ms(advance_fresh, "brick_advance", reps=20)[0]
    fine_ms = launch_device_ms(lambda: bk.brick_fine(scene, s_fine, blin_fine, luts,
                                                     rcfg.max_steps), "brick_fine", reps=20)[0]
    iters = int(advance_iterations(scene, scene.brick_dist, s_adv, rcfg.max_steps).sum())
    adv_bytes = n * (BRICK_STATE_IN + BRICK_STATE_OUT) + scene.brick_dist.numel()
    adv_bound = bound(adv_bytes, iters * BRICK_ADVANCE_OPS_PER_ITER)
    fine_out, fine_evt = bk.brick_fine_plain(scene, s_fine, blin_fine, luts, rcfg.max_steps)
    st = fine_launch_stats(scene, s_fine, blin_fine, luts, rcfg.max_steps, None, fine_out, fine_evt,
                           False)
    fine_bound = st["bound"]
    for name, k_ms, nbytes, work, b in (
            ("brick_advance", adv_ms, adv_bytes,
             f"round 1, {n} lanes, {iters} advancing iterations", adv_bound),
            ("brick_fine", fine_ms, st["bytes"],
             f"round 2, {st['live']} lanes live in {st['rows']} occupied bricks, "
             f"{st['changed']} change ({st['no_step']} without a step), {st['steps']} DDA "
             f"steps", fine_bound)):
        print(f"timing {name} per launch, {label} ({work}): kernel {k_ms:.4f} ms; bound "
              f"{nbytes} bytes -> {b[0]:.4f} ms ({b[1]}), kernel at {b[0] / k_ms:.3f} of it "
              f"| {card}")
    print(f"  brick_fine on that input: loading and storing every lane's whole state moves "
          f"{st['whole_bytes']} bytes ({st['whole_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms at the "
          f"memory rate) | {card}")
    return {"brick_advance": (adv_ms, adv_bound), "brick_fine": (fine_ms, fine_bound)}


def bricks_phase(dev, card, side, scene, o_full, wscene, wpos, wdir, cli):
    """Phase 8, the brick engine. Returns its two entries of the kernels line."""
    from raytracing_test_tpu_torch.config import CameraConfig, RenderConfig
    from raytracing_test_tpu_torch.kernels import brick_kernels as bk
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.render import bricks
    from raytracing_test_tpu_torch.render.camera import Camera, yaw_pitch_dir

    n = side * side
    full = RenderConfig(width=side, height=side)
    lean = RenderConfig(width=side, height=side, enable_materials=False, enable_shadows=False)

    # a. kernel parity on the first two rounds' states
    kerr, inputs = brick_kernel_parity(scene, march_state(scene, BENCH_POS, BENCH_DIR, side),
                                       full, o_full)

    # b. frame parity, four configurations
    errs = [brick_frame_parity("full", scene, BENCH_POS, BENCH_DIR, full, 0.0, card)[0],
            brick_frame_parity("lean", scene, BENCH_POS, BENCH_DIR, lean, 0.0, card)[0]]
    werr, wa, wdirs = brick_frame_parity("water", wscene, wpos, wdir, full, WATER_TIME, card)
    errs.append(werr)
    n_refl = int(wa["reflected"].sum())
    n_refr = int(((wa["ray_dir"] != wdirs).any(dim=1) & ~wa["reflected"]).sum())
    print(f"bricks water: {n_refl} reflected rays, {n_refr} refracted (bent) rays")
    if n_refl == 0 or n_refr == 0:
        raise AssertionError("bricks water view: expected reflected and refracted rays")
    d = cli.build_parser().parse_args(["render"])
    errs.append(brick_frame_parity("cli-view", scene, CameraConfig().pos,
                                   yaw_pitch_dir(d.yaw, d.pitch),
                                   RenderConfig(width=d.width, height=d.height), 0.0, card)[0])
    # kernels against their plain versions: the launches of part a and the
    # frames against the plain brick path (the fused frame is no plain version)
    max_err = max([kerr] + [e["plain bricks"] for e in errs])
    print(f"bricks: max_abs_err kernels vs plain versions {max_err:.3e}, brick frame vs fused "
          f"frame {max(e['fused'] for e in errs):.3e} (near-ties) | {card}")

    # c. the CLI's brick mode; only these launches are counted
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bricks.png")
        bk.LAUNCHES_ADVANCE = bk.LAUNCHES_FINE = 0
        t0 = time.perf_counter()
        cli.main(["--device", str(dev), "render", "--mode", "bricks-pallas", "--out", out])
        torch.cuda.synchronize()
        launches = {"brick_advance": bk.LAUNCHES_ADVANCE, "brick_fine": bk.LAUNCHES_FINE}
        print(f"cli render --mode bricks-pallas: 512x512 in {time.perf_counter() - t0:.2f} s "
              f"(world generation included), launches {launches} | {card}")
        if min(launches.values()) == 0:
            raise AssertionError(f"the brick mode did not launch both kernels: {launches}")
        check_png(out, 512)

    # d. timing: per frame (counted), per launch, whole frames
    print(f"brick kernels occupancy: {bk.occupancy()} (blocks per SM, cudaOccupancy"
          f"MaxActiveBlocksPerMultiprocessor) | {card}")
    st = counted_brick_frame(scene, BENCH_POS, BENCH_DIR, full)
    print(f"bricks frame {side}x{side} full: rounds primary {st['rounds'][0]} shadow "
          f"{st['rounds'][1]}; glue passes primary {st['glue'][0]} shadow {st['glue'][1]}; "
          f"brick_advance launches primary {st['adv'][0]} shadow {st['adv'][1]}; brick_fine "
          f"launches primary {st['fine'][0]} shadow {st['fine'][1]}; caps (max seen, cap): "
          + ", ".join(f"{k} {v[0]} of {v[1]}" for k, v in st["caps"].items()) + f" | {card}")
    d = cli.build_parser().parse_args(["render"])
    cfg_cli = RenderConfig(width=d.width, height=d.height)
    cli_view = (CameraConfig().pos, yaw_pitch_dir(d.yaw, d.pitch))
    advance_frame(scene, BENCH_POS, BENCH_DIR, full, card, f"{side}^2 bench")
    adv_cli = advance_frame(scene, *cli_view, cfg_cli, card, f"{d.width}^2 CLI")
    fine_frame(scene, BENCH_POS, BENCH_DIR, full, card, f"{side}^2 bench")
    fine_cli = fine_frame(scene, *cli_view, cfg_cli, card, f"{d.width}^2 CLI", each=True)
    at_side = brick_launches(scene, inputs, full, card, f"{side}^2 bench view")
    adv_ms, adv_bound = at_side["brick_advance"]
    fine_ms, fine_bound = at_side["brick_fine"]
    s_adv = inputs[("primary", 1)][2]
    s_fine, blin_fine, _ = inputs[("primary", 2)]
    luts = bk._prop_luts(scene, False, True)
    adv_plain_ms = cuda_ms(lambda: bk.brick_advance_plain(scene, scene.brick_dist, s_adv,
                                                          full.max_steps), reps=2, warmup=1)
    fine_plain_ms = cuda_ms(lambda: bk.brick_fine_plain(scene, s_fine, blin_fine, luts,
                                                        full.max_steps), reps=2, warmup=1)
    print(f"timing brick plain versions per launch: brick_advance {adv_plain_ms:.3f} ms, "
          f"brick_fine {fine_plain_ms:.3f} ms | {card}")
    cam = Camera(pos=torch.tensor(BENCH_POS, device=dev), dir=torch.tensor(BENCH_DIR, device=dev))
    frame = {}
    for name, rcfg in (("full", full), ("lean", lean)):
        frame[name] = (
            cuda_ms(lambda: bk.render_image_bricks_pallas(scene, cam, rcfg, 0.0), reps=5, warmup=2),
            cuda_ms(lambda: fm.render_image_fused(scene, cam, rcfg, 0.0), reps=10, warmup=2))
    plain_frame_ms = cuda_ms(lambda: bricks.render_image_bricks(scene, cam, full, 0.0),
                             reps=1, warmup=0)
    for name, (b_ms, f_ms) in frame.items():
        print(f"timing bricks frame {name} {side}x{side}: brick frame {b_ms:.4f} ms "
              f"({n / b_ms * 1e3:.4e} rays/s), fused frame {f_ms:.4f} ms, ratio {b_ms / f_ms:.2f}"
              + (f"; plain brick frame {plain_frame_ms:.1f} ms" if name == "full" else "")
              + f" | {card}")
    per_name = profile_step(lambda: bk.render_image_bricks_pallas(scene, cam, full, 0.0), card,
                            steps=3, label=f"brick frame full {side}x{side}")
    for k in ("brick_advance", "brick_fine"):
        v = [t for name, ts in per_name.items() if k in name for t in ts]
        print(f"  {k}: {len(v) / 3:.1f} launches and {sum(v) / 3e3:.4f} ms of device time per "
              f"frame, {sum(v) / max(len(v), 1) / 1e3:.4f} ms per launch | {card}")

    # e. the same two launches at the CLI brick frame's shape (its 512^2 view)
    s_cli = march_state(scene, *cli_view, d.width)
    _, inputs_cli = brick_kernel_parity(scene, s_cli, cfg_cli,
                                        fm.fused_march_call(scene, s_cli, cfg_cli, 0.0))
    brick_launches(scene, inputs_cli, cfg_cli, card, f"{d.width}^2 render view")
    common = {"route": "cuda", "source": "raytracing_test_tpu_torch/csrc/brick_march.cu",
              "max_abs_err": max_err, "library_ms": None}
    return [
        dict(name="brick_advance", replaces="raytracing_test_tpu/kernels/brick_kernels.py:100",
             launches=launches["brick_advance"], ms=adv_ms, plain_ms=adv_plain_ms,
             bound_ms=adv_bound[0], bound_by=adv_bound[1], **common),
        dict(name="brick_fine", replaces="raytracing_test_tpu/kernels/brick_kernels.py:235",
             launches=launches["brick_fine"], ms=fine_ms, plain_ms=fine_plain_ms,
             bound_ms=fine_bound[0], bound_by=fine_bound[1], **common),
    ], launches, adv_cli, fine_cli


def march_parity(name, k, p, card) -> float:
    """A fused_march_call dict against its plain version's: integer fields
    equal, float fields equal to the bit. Returns the largest float difference."""
    err, bad = 0.0, []
    for f in k:
        a, b = k[f], p[f]
        if a.is_floating_point():
            same = a.view(torch.int32) == b.view(torch.int32)
            err = max(err, float((a - b).abs().max()))
        else:
            same = a == b
        n_bad = int((~same.reshape(a.shape[0], -1).all(dim=1)).sum())
        if n_bad:
            bad.append(f"{f} on {n_bad} rays")
    print(f"parity {name}: {k['mat'].shape[0]} rays, {int((k['mat'] != 0).sum())} stopped, "
          f"max_abs_err {err:.3e}, " + ("all fields equal" if not bad else "DIFFER: " + "; ".join(bad))
          + f" | {card}")
    if bad:
        raise AssertionError(f"{name}: the march kernel disagrees with its plain version")
    return err


class plain_versions:
    """Within this block the march and window wrappers run their plain
    versions on CUDA tensors (the pipeline the kernels are held against)."""

    def __enter__(self):
        from raytracing_test_tpu_torch.kernels import fused_march as fm
        from raytracing_test_tpu_torch.kernels import fused_window as fw

        self.saved = (fm.fused_march_call, fw.window_call)
        fm.fused_march_call = lambda scene, s, cfg, time_s=None, prox=False, image_w=0: (
            fm.fused_march_plain(scene, s, cfg, cfg.time if time_s is None else time_s, prox))
        fw.window_call = fw.window_plain

    def __exit__(self, *exc):
        from raytracing_test_tpu_torch.kernels import fused_march as fm
        from raytracing_test_tpu_torch.kernels import fused_window as fw

        fm.fused_march_call, fw.window_call = self.saved


def counts():
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.kernels import fused_window as fw

    return {"fused_march": fm.LAUNCHES, "fused_march_prox": fm.LAUNCHES_PROX,
            "window_fwd": fw.LAUNCHES_FWD, "window_bwd": fw.LAUNCHES_BWD}


def reset_counts():
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.kernels import fused_window as fw

    fm.LAUNCHES = fm.LAUNCHES_PROX = fw.LAUNCHES_FWD = fw.LAUNCHES_BWD = 0


def prox_grads(render, ds, cam, dirs):
    """rgb, aux and the gradients of mean(rgb^2) in density and albedo."""
    from raytracing_test_tpu_torch.render.diff import DiffScene

    d = ds.density.detach().clone().requires_grad_(True)
    a = ds.albedo.detach().clone().requires_grad_(True)
    out = render(DiffScene(d, a), cam.pos, dirs)
    rgb, aux = out if isinstance(out, tuple) else (out, None)
    torch.mean(rgb ** 2).backward()
    torch.cuda.synchronize()
    return rgb.detach(), aux, d.grad, a.grad


def max_scaled(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def prox_phase(dev, card, side, grid, pal, scene, cli):
    """Phase 9, the prox seed and the prox-seeded window render. Returns its
    entry of the kernels line."""
    from raytracing_test_tpu_torch.config import RenderConfig
    from raytracing_test_tpu_torch.core.flatten import PROX_AIR, palette_arrays
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.render import diff, fast, progressive
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions

    n = side * side
    cf = 4
    cam = Camera(pos=torch.tensor(BENCH_POS, device=dev), dir=torch.tensor(BENCH_DIR, device=dev))
    dirs = ray_directions(cam, side, side)
    t0 = time.perf_counter()
    prox_enc = scene.prox_enc
    torch.cuda.synchronize()
    print(f"prox grid: built in {time.perf_counter() - t0:.3f} s (host, once per Scene), "
          f"{float((prox_enc < 128).float().mean()):.4f} of the cells are stop cells")

    # a. kernel parity on both passes of the prox seed
    lean = dict(enable_materials=False, enable_shadows=False)
    rc = RenderConfig(width=side // cf, height=side // cf, **lean)
    rn = RenderConfig(width=side, height=side, **lean)
    cdirs = dirs.reshape(side, side, 3)[cf // 2::cf, cf // 2::cf].reshape(-1, 3).contiguous()
    s_c = fast._init_state(cam.pos, cdirs, torch.ones(cdirs.shape[0], device=dev))
    err = march_parity("prox coarse pass", fm.fused_march_call(scene, s_c, rc, 0.0, prox=True),
                       fm.fused_march_plain(scene, s_c, rc, 0.0, prox=True), card)
    depth = fm.hit_seeds(scene, cam.pos, cdirs, rc, margin=0.0, prox=True)
    st = progressive.seed_from_depth(depth.reshape(side // cf, side // cf), cf, side, side)
    s_f = fast._init_state(cam.pos, dirs, torch.ones(n, device=dev), start_t=st)
    o_f = fm.fused_march_call(scene, s_f, rn, 0.0, prox=True)
    err = max(err, march_parity("prox full pass", o_f, fm.fused_march_plain(scene, s_f, rn, 0.0, prox=True),
                                card))
    air_stop = fast._gather_enc(scene, o_f["cell"], prox=True) == PROX_AIR

    # rays seeded at the coarse pass's far cap: the &1023 wrap of their start
    # cell, 1e5 cells out, makes "hits" that the port calls sky
    wrapped = {}
    for mode, start in (("prox", st), ("exact", progressive.seed_from_depth(
            fm.hit_seeds(scene, cam.pos, cdirs, rc, margin=0.0).reshape(side // cf, side // cf),
            cf, side, side))):
        _, aux = fm.render_rays_fused(scene, cam.pos, dirs, rn, start_t=start, prox=mode == "prox")
        wrapped[mode] = (int((start >= progressive.FAR_SEED).sum()),
                         int((aux["hit"] & (start >= progressive.FAR_SEED)).sum()))
    print(f"far cap: rays seeded at {progressive.FAR_SEED:g} (seeded, of them hit by the wrap): "
          f"{wrapped} | {card}")

    # b. the prox seed is conservative
    seed_p = fm.seed_depth_fused(scene, cam.pos, dirs, (side, side), margin=0.0, prox=True)
    seed_e = fm.seed_depth_fused(scene, cam.pos, dirs, (side, side), margin=0.0)
    hit_p, hit_e = seed_p < 9.9e5, seed_e < 9.9e5
    n_lost = int((hit_e & ~hit_p).sum())
    n_late = int((seed_p[hit_e] > seed_e[hit_e] + 1e-4).sum())
    gap = (seed_e - seed_p)[hit_e]
    print(f"prox seed: {int(hit_e.sum())} exact hits, {int(hit_p.sum())} prox hits "
          f"({int((hit_p & ~hit_e).sum())} only prox: grazes of a surface brick that reach the sky), "
          f"{n_lost} exact hits missed, {n_late} prox seeds beyond the exact seed + 1e-4; exact - prox "
          f"seed mean {float(gap.mean()):.3f} max {float(gap.max()):.3f} cells; "
          f"{int(air_stop.sum())} full-pass rays stopped in the air of a surface brick | {card}")
    if n_lost or n_late:
        raise AssertionError("the prox seed is not conservative against the exact seed")

    # c. orchestration on the kernels against the same pipeline on the plain versions
    ds = diff.diff_scene_from_grid(grid, palette_arrays(pal)[0], dev, solid_density=SOLID_DENSITY)

    def prox_render(patch_div=64, sat_eps=1e-3):
        return lambda s, o, d: diff.render_rays_guided_prox(
            s, scene, o, d, (side, side), patch_div=patch_div, sat_eps=sat_eps, return_aux=True)

    k = prox_grads(prox_render(), ds, cam, dirs)
    before = counts()
    with plain_versions():
        p = prox_grads(prox_render(), ds, cam, dirs)
    if counts() != before:
        raise AssertionError("the plain pipeline launched a kernel")
    d = (k[0] - p[0]).abs().max(dim=1).values
    bad = float((d > ATOL).float().mean())
    g_err = {"density": max_scaled(k[2], p[2]), "albedo": max_scaled(k[3], p[3])}
    print(f"parity prox pipeline (patch_div 64) vs its plain versions: max_abs_err {float(d.max()):.3e} "
          f"bad_frac {bad:.6f}; gradients max-scaled " + " ".join(f"{a} {v:.3e}" for a, v in g_err.items())
          + f"; aux {k[1]} (plain {p[1]}) | {card}")
    if (bad > MAX_BAD_FRAC or max(g_err.values()) > GRAD_TOL or k[1] != p[1]
            or not torch.isfinite(k[0]).all()):
        raise AssertionError("the prox pipeline on the kernels disagrees with its plain versions")

    # d. against the exact-seed guided render, every patch inside the budget.
    # Windows that end with transmittance up to sat_eps are not patched: at
    # sat_eps 1e-6 the whole contract holds; at the default 1e-3 the density
    # gradient is printed (edge rays, barely absorbed, dominate it)
    ref = prox_grads(lambda s, o, d_: diff.render_rays_diff_guided(
        s, scene, o, d_, num_steps=NUM_STEPS, sky=False, image_hw=(side, side)), ds, cam, dirs)
    solid = ds.density > 0
    for sat_eps in (1e-6, 1e-3):
        k1 = prox_grads(prox_render(patch_div=1, sat_eps=sat_eps), ds, cam, dirs)
        e_rgb = float((k1[0] - ref[0]).abs().max())
        e_d, e_a = max_scaled(k1[2][solid], ref[2][solid]), max_scaled(k1[3], ref[3])
        e_air = max_scaled(k1[2][~solid], ref[2][~solid])
        e_whole = max_scaled(k1[2], ref[2])
        print(f"prox pipeline (patch_div 1, sat_eps {sat_eps:g}) vs the exact-seed guided render: "
              f"aux {k1[1]}, rgb max_abs_err {e_rgb:.3e}, gradients max-scaled density (solid "
              f"cells) {e_d:.3e} albedo {e_a:.3e}; density on air cells {e_air:.3e} (other empty "
              f"space sampled); the reference's measure, density on every cell over the whole "
              f"field's maximum, {e_whole:.3e} | {card}")
        e_grad = max(e_d, e_a) if sat_eps < 1e-3 else e_a
        if k1[1]["grads_dropped"] or e_rgb > PROX_RGB_TOL or e_grad > PROX_GRAD_TOL:
            raise AssertionError("the prox pipeline disagrees with the exact-seed guided render")

    # e. the main path: the prox pipeline once, then the guided fit through the CLI
    reset_counts()
    prox_grads(prox_render(), ds, cam, dirs)
    main = counts()
    print(f"main path render_rays_guided_prox loss+backward: launches {main}")
    if main["fused_march_prox"] != 2 or min(main["window_fwd"], main["window_bwd"]) == 0:
        raise AssertionError(f"the prox pipeline did not launch its kernels: {main}")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--device", str(dev), "fit", "--engine", "", "--guided", "--steps", "5"])
    torch.cuda.synchronize()
    fit_counts = counts()
    print(f"cli fit --engine '' --guided: 5 steps in {time.perf_counter() - t0:.2f} s (world and "
          f"targets included); launches {fit_counts} | {card}")
    if fit_counts["window_fwd"] != 5 or fit_counts["window_bwd"] != 5 or fit_counts["fused_march"] < 13:
        raise AssertionError(f"the guided fit did not run through the kernels: {fit_counts}")

    # f. timing
    seed_p_ms = cuda_ms(lambda: fm.seed_depth_fused(scene, cam.pos, dirs, (side, side), margin=0.5,
                                                    prox=True), reps=10, warmup=2)
    seed_e_ms = cuda_ms(lambda: fm.seed_depth_fused(scene, cam.pos, dirs, (side, side)), reps=10,
                        warmup=2)
    coarse_ms, coarse_b = raw_march_ms(scene, s_c, rc, 0, prox=True, reps=100)
    full_ms, _ = raw_march_ms(scene, s_f, rn, 0, prox=True)
    lean_ms, _ = raw_march_ms(scene, s_f, rn, side)
    wrapped_ms = cuda_ms(lambda: fm.fused_march_call(scene, s_f, rn, 0.0, prox=True),
                         reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: fm.fused_march_plain(scene, s_f, rn, 0.0, prox=True), reps=3, warmup=1)

    def step(render):
        return lambda: prox_grads(render, ds, cam, dirs)

    exact_render = lambda s, o, d_: diff.render_rays_diff_guided(  # noqa: E731
        s, scene, o, d_, num_steps=NUM_STEPS, sky=False, image_hw=(side, side))
    pipe_ms = {"prox": cuda_ms(step(prox_render()), reps=5, warmup=2),
               "exact": cuda_ms(step(exact_render), reps=5, warmup=2)}
    print(f"timing prox {side}x{side}: seed prox {seed_p_ms:.4f} ms vs exact {seed_e_ms:.4f} ms; prox "
          f"kernel coarse pass {coarse_ms:.4f} ms, full pass {full_ms:.4f} ms ({wrapped_ms:.4f} ms "
          f"through its wrapper; the lean kernel on the same start points, tiled, "
          f"{lean_ms:.4f} ms), plain prox march {plain_ms:.3f} ms; loss+backward with the "
          f"seed: prox pipeline {pipe_ms['prox']:.4f} ms, exact-seed pipeline {pipe_ms['exact']:.4f} ms "
          f"| {card}")
    profile_step(step(prox_render()), card, steps=3, label="prox pipeline (seed + windows + patch)")

    # bound of the full pass from its data: prox_enc and the palette flags read
    # once, 72 bytes of rays in and 88 out per ray; one step per crossing
    crossings = int(o_f["steps"].to(torch.int64).sum())
    nbytes = prox_enc.numel() + scene.flags.numel() * 4 + n * (72 + 88)
    b = bound(nbytes, crossings * MARCH_OPS_PER_CROSSING)
    print(f"bound fused_march_prox full pass: {nbytes} bytes, {crossings} crossings -> {b[0]:.4f} ms "
          f"({b[1]}), kernel at {b[0] / wrapped_ms:.3f} of it through its wrapper, "
          f"{b[0] / full_ms:.3f} on raw launches | {card}")
    entry = dict(name="fused_march_prox", route="cuda",
                 source="raytracing_test_tpu_torch/csrc/fused_march.cu",
                 replaces="raytracing_test_tpu/kernels/fused_march.py:148",
                 launches=main["fused_march_prox"], max_abs_err=err, ms=wrapped_ms, plain_ms=plain_ms,
                 bound_ms=b[0], bound_by=b[1], library_ms=None)
    return entry, {"coarse": (coarse_ms, coarse_b[0]), "full": (full_ms, b[0])}


EDIT_POS = (100.3, 84.6, 97.2)  # phase 10's camera, above the edits
EDIT_VIEWS = [(-150.0 + 40.0 * k, 52.0 + 4.0 * (k % 3)) for k in range(8)]  # yaw, pitch
TOWER = (120, 130)  # the column (x, z) of the tower that raises y_max
SCENE_FIELDS = ("grid_enc", "macro", "albedo", "flags", "metadata", "brick_mat", "brick_dist",
                "brick_dist_shadow", "prox_enc")


def mode_rule(img, base) -> float:
    """Share of pixels off by more than 1e-6 (tests/test_app.py
    test_session_render_modes' rule: at most 1%)."""
    return float((img - base).abs().gt(1e-6).any(dim=-1).float().mean())


def scripted_edits(s):
    """Phase 10's edits through the session, a sync after each: 8 place /
    delete pairs and 4 places by pick from EDIT_POS; then a tower of 8 blocks
    above y_max, removed again; then a block at each of two corners of the
    window (the second at the top, y_max = Sy), removed again with one at
    the origin corner. Each sync runs under ``set_sync_debug_mode("error")``
    (a read back from the card in it raises) and must build the boxes of
    each dirty brick once (``mirror.BOX_BUILDS``) with 6 ``cheb_pass``
    launches. Returns the per-edit sync times [(total, rasterize, boxes,
    apply) ms]."""
    from raytracing_test_tpu_torch.core import mirror
    from raytracing_test_tpu_torch.kernels import chebyshev

    Sx, Sy, Sz = s.grid.shape

    def look(k, yaw_off=0.0):
        s.pos, s.yaw, s.pitch = np.asarray(EDIT_POS), EDIT_VIEWS[k][0] + yaw_off, EDIT_VIEWS[k][1]

    picks = []
    for k in range(len(EDIT_VIEWS)):
        picks += [lambda k=k: (look(k), s.place(k)), s.delete]
    picks += [lambda k=k: (look(k, 13.0), s.place(k + 2)) for k in range(4)]
    times, y_maxes, bricks = [], [], []

    def run(edits):
        for edit in edits:
            edit()
            launches, builds = chebyshev.LAUNCHES, mirror.BOX_BUILDS
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                n = s.sync()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            if n == 0:
                raise AssertionError("an edit of phase 10 left no dirty brick")
            got = (mirror.BOX_BUILDS - builds, chebyshev.LAUNCHES - launches)
            if got != (n, 6 * n):
                raise AssertionError(f"phase 10: a sync of {n} dirty bricks built {got[0]} boxes "
                                     f"with {got[1]} cheb_pass launches, not {n} and {6 * n}")
            times.append((total, s.sync_ms["rasterize"], s.sync_ms["boxes"], s.sync_ms["apply"]))
            y_maxes.append(s.scene.y_max)
            bricks.append(n)

    run(picks)
    y0 = s.scene.y_max
    tower = [(TOWER[0], y0 + i, TOWER[1]) for i in range(8)]
    corners = [(Sx - 1, 5, Sz - 1), (0, Sy - 1, Sz - 1)]
    run([lambda p=p: s.tree.put_block(p, s.hotbar[1], 6) for p in tower]
        + [lambda p=p: s.tree.delete_block(p, 6) for p in reversed(tower)]
        + [lambda p=p: s.tree.put_block(p, s.hotbar[2], 6) for p in corners]
        + [lambda: s.tree.delete_block(corners[1], 6), lambda: s.tree.delete_block((0, 3, 0), 6)])
    t = len(picks)
    ys = (y0, y_maxes[t + 7], y_maxes[t + 15], y_maxes[t + 17], y_maxes[-1])
    print(f"edit: {len(times)} edits, y_max {ys[0]} -> {ys[1]} (tower) -> {ys[2]} (removed) -> "
          f"{ys[3]} (top corner) -> {ys[4]}; {sum(bricks)} dirty bricks, each built once on the "
          f"card with 6 cheb_pass launches, no read back from the card in any sync")
    if ys[1:] != (y0 + 8, y0, Sy, y0):
        raise AssertionError(f"phase 10: y_max did not follow the tower and the corner: {ys}")
    return times


def session_cfg(s, cfg):
    """The config ``WorldSession.render`` draws with: the looked-at block
    highlighted, the session's clock."""
    from dataclasses import replace

    look = s.pick()
    return replace(cfg, time=s.time, **({"looking_at": look.pos} if look.steps else {}))


def images_bad(img, ref) -> float:
    """tests/test_render_parity.py assert_images_close's measure: the share of
    pixels off by more than ATOL (contract: at most MAX_BAD_FRAC)."""
    return float((img - ref).abs().amax(dim=-1).gt(ATOL).float().mean())


def edit_phase(dev, card, cli):
    """Phase 10, the edit session on the card: a native WorldSession of the
    default world, scripted edits each synced, the mirrored Scene against a
    full rebuild, the session's render modes at the CLI's 512^2, AO, the
    ``edit`` and ``probe`` verbs in-process. Returns its fused_march
    launches (all of the main path) and its timings."""
    import contextlib
    import io

    from raytracing_test_tpu_torch.app import checkpoint
    from raytracing_test_tpu_torch.app.session import WorldSession
    from raytracing_test_tpu_torch.config import CameraConfig, RenderConfig, WorldConfig
    from raytracing_test_tpu_torch.core.flatten import scene_from_grid
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.render import fast, progressive, renderer
    from raytracing_test_tpu_torch.render.camera import ray_directions

    d = cli.build_parser().parse_args(["render"])
    cfg = RenderConfig(width=d.width, height=d.height)
    cfg_ao = RenderConfig(width=d.width, height=d.height, enable_ao=True)
    edit_view = (np.asarray(EDIT_POS), EDIT_VIEWS[3][0] + 13.0, EDIT_VIEWS[3][1])
    cli_view = (np.asarray(CameraConfig().pos), d.yaw, d.pitch)

    # the main path, counted: session, edits, frames, the edit and probe verbs
    reset_counts()
    kernel_frames = 0
    t0 = time.perf_counter()
    s = WorldSession(WorldConfig(), device=dev)
    torch.cuda.synchronize()
    print(f"edit session: native world {s.grid.shape}, palette {len(s.palette)}, y_max "
          f"{s.scene.y_max}, built in {time.perf_counter() - t0:.2f} s")
    times = np.asarray(scripted_edits(s))
    s.pos, s.yaw, s.pitch = edit_view
    img_edit = s.render(cfg, highlight=False, mode="fused")
    kernel_frames += 1

    s.pos, s.yaw, s.pitch = cli_view
    imgs, frame_ms = {}, {}
    for mode, c, reps, launches in (("fused", cfg, 5, 1), ("fast", cfg, 3, 1),
                                    ("progressive", cfg, 3, 2), ("reference", cfg, 2, 0),
                                    ("fused AO", cfg_ao, 3, 1)):
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            imgs[mode] = s.render(c, mode=mode.split()[0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            kernel_frames += launches
        frame_ms[mode] = float(np.median(ms))
    hcfg = session_cfg(s, cfg)
    after = []
    for k in range(5):
        s.pos, s.yaw, s.pitch = np.asarray(EDIT_POS), *EDIT_VIEWS[k]
        s.place(1)
        t0 = time.perf_counter()
        s.render(cfg, mode="fused")  # syncs the edit, picks, draws
        torch.cuda.synchronize()
        after.append((time.perf_counter() - t0) * 1e3)
        kernel_frames += 1
    frame_ms["fused after an edit (its sync included)"] = float(np.median(after))

    with tempfile.TemporaryDirectory() as tmp:
        a, b, w = (os.path.join(tmp, f) for f in ("a.png", "b.png", "w.npz"))
        script = os.path.join(tmp, "edit.txt")
        pose = (f"goto {EDIT_POS[0]} {EDIT_POS[1]} {EDIT_POS[2]}; "
                f"look {EDIT_VIEWS[2][0]} {EDIT_VIEWS[2][1]}")
        with open(script, "w") as f:
            f.write(f"{pose}; place 2; render {a}; delete; place 3; time 0.7; render {b}; "
                    f"save {w}\n")
        t0 = time.perf_counter()
        cli.main(["--device", str(dev), "edit", script])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        kernel_frames += 2
        check_png(a, 512)
        check_png(b, 512)
        grid, pal = checkpoint.load_world(w)
        for mode, launches in (("fast", 1), ("progressive", 2), ("reference", 0)):
            png = os.path.join(tmp, f"{mode}.png")
            cli.main(["--device", str(dev), "--ao", "render", "--mode", mode, "--out", png])
            check_png(png, 512)
            kernel_frames += launches
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["--device", str(dev), "probe", "--row", "256", "--col", "256"])
    launches = counts()["fused_march"]
    print(f"edit main path: {len(times)} edits, {kernel_frames} frames through the kernel, cli edit "
          f"(place, delete, place, 2 frames, save) in {cli_s:.2f} s with its world generation, "
          f"cli render --ao in the modes fast, progressive and reference, probe; fused_march "
          f"launches {launches} | {card}")
    if launches < kernel_frames:
        raise AssertionError(f"phase 10 launched fused_march {launches} times for "
                             f"{kernel_frames} frames through the kernel")
    probe = dict(ln.split(": ", 1) for ln in out.getvalue().splitlines())
    if not {"color", "hit_pos", "steps", "cam_dir", "proj_pln_inter"} <= set(probe) or \
            not np.isfinite(json.loads(probe["color"])).all():
        raise AssertionError(f"probe: unexpected output {out.getvalue()[:500]}")
    print(f"probe (256, 256): color {probe['color']}, hit {probe['hit']}, mat {probe['mat']}, "
          f"steps {probe['steps']}, cell {probe['cell']}")

    # checks against a rebuild, the plain versions and a second session (not counted)
    rebuilt = scene_from_grid(s.grid, s.palette, dev)
    bad = [f for f in SCENE_FIELDS if not torch.equal(getattr(s.scene, f), getattr(rebuilt, f))]
    if bad or s.scene.y_max != rebuilt.y_max:
        raise AssertionError(f"phase 10: mirrored Scene differs from a rebuild: {bad}, y_max "
                             f"{s.scene.y_max} vs {rebuilt.y_max}")
    s.pos, s.yaw, s.pitch = edit_view
    from dataclasses import replace

    mirrored = s.render(cfg, highlight=False, mode="fused")  # syncs the 5 places above
    frame_rebuilt = fm.render_image_fused(scene_from_grid(s.grid, s.palette, dev), s.camera(),
                                          replace(cfg, time=s.time))
    if not torch.equal(mirrored, frame_rebuilt):
        raise AssertionError("phase 10: the frame of the mirrored Scene differs from the rebuilt one")
    edited = mode_rule(img_edit, frame_rebuilt)
    print(f"edit: mirrored Scene equal to scene_from_grid ({', '.join(SCENE_FIELDS)}, y_max); "
          f"the 512^2 fused frame at the edit view bit-equal between the two; the 5 later places "
          f"changed {edited:.4f} of its pixels | {card}")

    s.pos, s.yaw, s.pitch = cli_view
    cam = s.camera()
    base = imgs["fused"]
    rules = {m: mode_rule(imgs[m], base) for m in ("fast", "progressive", "reference")}
    with plain_versions():
        prog_plain = progressive.render_image_progressive(s.scene, cam, hcfg)[0]
    prog_err = float((imgs["progressive"] - prog_plain).abs().max())
    ao_plain = fast.render_image_fast(s.scene, cam, replace(hcfg, enable_ao=True))
    ao_err, ao_bad = float((imgs["fused AO"] - ao_plain).abs().max()), images_bad(
        imgs["fused AO"], ao_plain)
    print(f"modes at the CLI view, share of pixels off fused by > 1e-6 (rule: <= 1%): {rules}; "
          f"progressive on the kernel vs on the plain march: max |diff| {prog_err:.3e}; AO frame "
          f"on the kernel vs the plain march: max |diff| {ao_err:.3e}, bad {ao_bad:.4f}; AO "
          f"changes {mode_rule(imgs['fused AO'], base):.4f} of the pixels | {card}")
    if max(rules.values()) > MAX_BAD_FRAC or ao_bad > MAX_BAD_FRAC or prog_err != 0.0:
        raise AssertionError(f"phase 10: modes {rules}, AO bad {ao_bad}, progressive vs plain "
                             f"{prog_err}")
    other = {}
    for name, view in (("edit view", edit_view), ("bench view", (np.asarray(BENCH_POS), 45.0, 35.0))):
        s.pos, s.yaw, s.pitch = view
        f_img = s.render(cfg, mode="fused")
        other[name] = {m: mode_rule(s.render(cfg, mode=m), f_img) for m in ("progressive", "reference")}
    print(f"modes at other views, share of pixels off fused by > 1e-6 (the reference's own "
          f"departures, PERF.md): {other}")

    s2 = WorldSession(WorldConfig(), device=dev)
    s2.pos, s2.yaw, s2.pitch = np.asarray(EDIT_POS), *EDIT_VIEWS[2]
    for edit in (lambda: s2.place(2), s2.delete, lambda: s2.place(3)):
        edit()
        s2.sync()  # as the script's render and save verbs sync
    if not (np.array_equal(grid, s2.grid) and all(
            np.array_equal(getattr(pal, k), getattr(s2.palette, k))
            for k in ("flags", "color", "metadata"))):
        raise AssertionError("cli edit: the saved world differs from the same edits in a session")
    print("cli edit: the saved world reloads equal to the same edits in a session")

    # timing: the AO march alone at the CLI frame's hit points
    _, aux = fm.render_rays_fused(s.scene, cam.pos, ray_directions(cam, d.width, d.height), hcfg)
    ao_ms = cuda_ms(lambda: renderer._ao_march(s.scene, aux["hit_pos"], aux["normal"], cfg_ao),
                    reps=5, warmup=1)
    profile_step(lambda: s.render(cfg, mode="reference"), card, steps=1,
                 label="reference frame 512^2 (the session's render)")
    profile_step(lambda: s.render(cfg_ao, mode="fused"), card, steps=3,
                 label="fused frame with AO 512^2 (the session's render)")
    q = lambda col: f"median {np.median(col):.3f} max {col.max():.3f}"  # noqa: E731
    print(f"edit timing: per-edit sync ms ({len(times)} edits, host clock with the device "
          f"synchronised): total {q(times[:, 0])}; tree rasterization (512 get_block calls a "
          f"brick) {q(times[:, 1])}; upload and brick_mat row writes (host launch time) "
          f"{q(times[:, 3])}; box builders (host launch time) {q(times[:, 2])}; waiting for the "
          f"card after them {q(times[:, 0] - times[:, 1:].sum(axis=1))} | {card}")
    print("edit timing: frame ms at 512x512 (host clock, sync + pick + render, median): "
          + ", ".join(f"{k} {v:.3f}" for k, v in frame_ms.items())
          + f"; AO march alone {ao_ms:.3f} ms (CUDA events, {d.width * d.height} points x 20 "
          f"rays x {cfg_ao.ao_steps} steps) | {card}")
    return {"launches": launches, "times": times, "frame_ms": frame_ms, "ao_ms": ao_ms}


DIFF_STEPS = 96  # the unguided fit's blind scan (app/fit.py, as the reference's)
IMAGE_STEPS = 192  # render_image_diff's default (fit --out)
HARD_ATOL = 1e-4  # hard-limit contract (tests/test_diff.py:27)
RAY_GRAD_TOL = 1e-4  # max-scaled, ray gradients card vs CPU (tests/test_torch_diff.py)


def scaled_err(a, b) -> float:
    """max |a - b| over max |b|: 0 for two empty or all-zero tensors, inf
    where b is all zero and a is not, NaN where a is."""
    if b.numel() == 0:
        return 0.0
    err, den = float((a - b).abs().max()), float(b.abs().max())
    return err / den if den > 0 else (0.0 if err == 0 else float("inf"))


def blind_grads(ds, origin, dirs, targets, **kw):
    """rgb of the blind scan (``DIFF_STEPS``, sky off) and the gradients of
    the train loss, mean((rgb - targets)^2), in density, albedo, origin and
    dirs, on the device of ``ds``."""
    from raytracing_test_tpu_torch.render.diff import DiffScene, render_rays_diff

    leaves = [t.detach().clone().requires_grad_(True)
              for t in (ds.density, ds.albedo, origin, dirs)]
    rgb = render_rays_diff(DiffScene(leaves[0], leaves[1]), leaves[2], leaves[3],
                           num_steps=DIFF_STEPS, sky=False, **kw)
    torch.mean((rgb - targets) ** 2).backward()
    return [rgb.detach()] + [t.grad for t in leaves]


def peak_ms(fn, reps: int):
    """(ms per call, peak device bytes a call adds to what was allocated
    before it) of ``fn``, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(fn, reps=reps, warmup=0)
    return ms, torch.cuda.max_memory_allocated() - base


def diff_phase(dev, card, grid, pal, scene, cli):
    """Phase 11, the differentiable renders as PyTorch operations on the card:
    the blind scan's hard limit, the blind scan against itself on the CPU,
    the window kernel pair against the XLA-style window, the unguided train
    step and ``fit --engine '' --out`` through the CLI, ``ao_diff``, and their
    timings. Returns the fused_march launches of its main path (the fit
    verb's target views)."""
    from functools import partial

    from raytracing_test_tpu_torch.app import fit
    from raytracing_test_tpu_torch.config import CameraConfig, RenderConfig, WorldConfig
    from raytracing_test_tpu_torch.core.flatten import palette_arrays
    from raytracing_test_tpu_torch.kernels import fused_march as fm
    from raytracing_test_tpu_torch.kernels import fused_window as fw
    from raytracing_test_tpu_torch.parallel import sharding
    from raytracing_test_tpu_torch.render import diff, progressive
    from raytracing_test_tpu_torch.render.camera import Camera, camera_from_yaw_pitch, ray_directions
    from raytracing_test_tpu_torch.render.fast import sun_unit
    from raytracing_test_tpu_torch.render.renderer import _build_ray, skybox

    albedo = palette_arrays(pal)[0]
    shape3 = tuple(WorldConfig().grid_shape)
    d = cli.build_parser().parse_args(["fit"])
    side_cli = d.width
    cam = camera_from_yaw_pitch(CameraConfig().pos, d.yaw, d.pitch, dev)
    dirs_cli = ray_directions(cam, d.width, d.height)

    # a. the hard limit at the CLI's view: solid density 1e4, 192 steps,
    # against the lean fused march's first hit on the rays whose hit lies
    # within the scan's steps (its cells are the start cell's L1 neighbours)
    hard = diff.diff_scene_from_grid(grid, albedo, dev)
    with torch.no_grad():
        vol = diff.render_rays_diff(hard, cam.pos, dirs_cli, num_steps=IMAGE_STEPS)
    lean = RenderConfig(width=d.width, height=d.height, enable_materials=False,
                        enable_shadows=False)
    _, aux = fm.render_rays_fused(scene, cam.pos, dirs_cli, lean)
    start = torch.floor(cam.pos).to(torch.int32)
    reach = (aux["cell"] - start[None, :]).abs().sum(dim=1) < IMAGE_STEPS
    hit = aux["hit"]
    sel = ~hit | reach
    want = torch.where(hit[:, None], torch.from_numpy(albedo).to(dev)[aux["mat"].long()],
                       skybox(_build_ray(dirs_cli)[0],
                              torch.from_numpy(sun_unit(lean.sun_dir)).to(dev)))
    err = (vol - want).abs().amax(dim=1)[sel]
    bad = float(err.gt(HARD_ATOL).float().mean())
    print(f"diff hard limit {d.width}x{d.height} x {IMAGE_STEPS} steps: {int((hit & reach).sum())} "
          f"hits within the steps, {int((~hit).sum())} sky rays, {int((hit & ~reach).sum())} hits "
          f"beyond them (not compared); off by > {HARD_ATOL}: {bad:.6f} of the compared rays "
          f"(max {float(err.max()):.3e})")
    if not torch.isfinite(vol).all() or bad > MAX_BAD_FRAC or int((hit & reach).sum()) == 0:
        raise AssertionError(f"diff hard limit: {bad} of rays off the first-hit albedo")

    # b. the blind scan on the card against the same code on the CPU, one
    # fixed batch of the fit's rays at the CLI batch
    g = WorldConfig().grid_shape
    cams = fit.ring_cameras((g[0] / 2, g[1] / 3, g[2] / 2), 0.8 * g[0], 0.9 * g[1], d.views,
                            device=dev)
    origins, rdirs, targets = fit.make_targets(scene, cams, d.fit_res)
    idx = torch.from_numpy(np.random.default_rng(2).integers(0, origins.shape[0], CLI_BATCH)).to(dev)
    batch = (origins[idx].contiguous(), rdirs[idx].contiguous(), targets[idx].contiguous())
    ds = diff.diff_scene_from_grid(grid, albedo, dev, solid_density=SOLID_DENSITY)
    k = blind_grads(ds, *batch)
    torch.cuda.synchronize()
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    p = blind_grads(diff.DiffScene(cpu(ds.density), cpu(ds.albedo)), *(cpu(t) for t in batch))
    if any(t.device != dev for t in k):
        raise AssertionError("diff: the blind scan on the card's tensors left the card")
    rgb_err = float((cpu(k[0]) - p[0]).abs().max())
    scaled = {name: scaled_err(cpu(a), b) for name, a, b in
              zip(("density", "albedo", "origin", "dirs"), k[1:], p[1:])}
    print(f"diff blind scan card vs CPU, {CLI_BATCH} rays x {DIFF_STEPS} steps: rgb max_abs_err "
          f"{rgb_err:.3e}; gradients max-scaled " + " ".join(f"{n} {v:.3e}" for n, v in scaled.items()))
    if (not rgb_err <= ATOL or not all(scaled[n] <= GRAD_TOL for n in ("density", "albedo"))
            or not all(scaled[n] <= RAY_GRAD_TOL for n in ("origin", "dirs"))
            or not all(torch.isfinite(t).all() for t in k)):
        raise AssertionError(f"diff: blind scan card vs CPU beyond ({ATOL}, {GRAD_TOL}, "
                             f"{RAY_GRAD_TOL}): rgb {rgb_err}, {scaled}")

    # c. the window kernel pair against the XLA-style window at both train
    # batches (guided seeds on the fit's rays) and at 1024^2 (bench seeds)
    xla = partial(diff.render_rays_diff_window, accum="scatter")
    bench = Camera(pos=torch.tensor(BENCH_POS, device=dev), dir=torch.tensor(BENCH_DIR, device=dev))
    bench_dirs = ray_directions(bench, FULL, FULL)
    views = [(f"{FULL}^2", bench.pos, bench_dirs,
              fm.seed_depth_fused(scene, bench.pos, bench_dirs, (FULL, FULL)))]
    rng = np.random.default_rng(3)
    for nb in (TRAIN_BATCH, CLI_BATCH):
        i = torch.from_numpy(rng.integers(0, origins.shape[0], nb)).to(dev)
        o_b, d_b = origins[i].contiguous(), rdirs[i].contiguous()
        views.append((f"{nb} rays", o_b, d_b,
                      progressive.guided_seeds(fm.render_rays_fused, scene, o_b, d_b, 3.0)))
    for label, o, dd, sd in views:
        # one origin a ray: a ray's own origin gradient, not a sum over the view
        o = o.expand(dd.shape).contiguous() if o.ndim == 1 else o
        with torch.no_grad():
            _, _, cell, tmax, step, absd = diff._ray_start(shape3, o, dd, sd, park_misses=True)
            _, inside, dt, _ = diff._enumerate_window(shape3, None, None, step, absd, cell, tmax,
                                                      NUM_STEPS)
            ties = ((dt == 0) & inside).any(dim=1) & (sd < diff.MISS_SEED_MIN)
        for kw in (dict(sky=False), dict(sky=True), dict(sky=True, shading=True, shadow_steps=6)):
            # near-tie rays are held to the image budget and left out of the
            # gradients: rays off by more than ATOL (the soft shadow starts at
            # hit point + 0.75 sun, the two sum the hit point in other orders,
            # and the shadow's transmittance is steep in it), and rays with an
            # exact crossing tie (a zero-length segment in the grid, whose dt
            # gradient the reference splits at the max(dt, 0) and the kernels
            # pass whole)
            with torch.no_grad():
                fa = fw.render_window_fused(ds, o, dd, num_steps=NUM_STEPS, start_t=sd, **kw)
                fb = xla(ds, o, dd, num_steps=NUM_STEPS, start_t=sd, **kw)
            keep = ((fa - fb).abs().amax(dim=1) <= ATOL) & ~ties
            off = 1.0 - float(keep.float().mean())
            a = window_grads(fw.render_window_fused, ds, o, dd, sd, keep=keep, **kw)
            b = window_grads(xla, ds, o, dd, sd, keep=keep, **kw)
            errs = {"rgb": scaled_err(a[0][keep], b[0][keep])}
            for name, x, y in zip(("density", "albedo", "origin", "dirs"), a[1:], b[1:]):
                m = torch.isfinite(y)
                if not torch.equal(torch.isfinite(x), m):
                    raise AssertionError(f"window vs XLA window {label} {kw}: {name} gradient "
                                         "finite on other entries")
                errs[name] = scaled_err(x[m], y[m])
            print(f"window pair vs render_rays_diff_window(accum='scatter') {label} {kw}: near-tie "
                  f"rays {off:.6f} ({int(ties.sum())} with a crossing tie; max "
                  f"|rgb diff| {float((fa - fb).abs().max()):.3e}); on the others max-scaled "
                  + " ".join(f"{n} {v:.3e}" for n, v in errs.items()))
            if off > MAX_BAD_FRAC or not all(v <= GRAD_TOL for v in errs.values()):
                raise AssertionError(f"window pair vs XLA window {label} {kw}: {off} of rays off, "
                                     f"beyond {GRAD_TOL} max-scaled: {errs}")

    # d. five unguided train steps on the batch of b, then the fit verb
    # (engine '', the blind step) with --out; only the verb's launches count
    params = sharding.init_params(shape3, dev)
    opt = torch.optim.Adam(params.parameters(), lr=d.lr)
    step_fn = sharding.make_train_step(params, opt, num_steps=DIFF_STEPS)
    losses = [float(step_fn(*batch)[0]) for _ in range(5)]
    print(f"diff train: 5 make_train_step steps on {CLI_BATCH} rays x {DIFF_STEPS} steps, losses "
          + " ".join(f"{v:.6f}" for v in losses))
    if not np.isfinite(losses).all() or not losses[4] < losses[0]:
        raise AssertionError(f"diff train: losses not finite or not decreasing: {losses}")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "fit.png")
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--device", str(dev), "fit", "--engine", "", "--steps", "5", "--out", png])
        torch.cuda.synchronize()
        launched = counts()
        print(f"cli fit --engine '' --steps 5 --out: {time.perf_counter() - t0:.2f} s (world, "
              f"targets and the {d.width}x{d.height} x {IMAGE_STEPS} frame included); "
              f"launches {launched}")
        check_png(png, side_cli)
    if launched != {"fused_march": d.views, "fused_march_prox": 0, "window_fwd": 0,
                    "window_bwd": 0}:
        raise AssertionError(f"fit --engine '': launches {launched}, expected {d.views} target "
                             "views through fused_march and nothing else")

    # e. ao_diff at the CLI frame's hit points
    full_cli = RenderConfig(width=d.width, height=d.height)
    _, faux = fm.render_rays_fused(scene, cam.pos, dirs_cli, full_cli)
    pts, nrm = faux["hit_pos"][faux["hit"]].contiguous(), faux["normal"][faux["hit"]].contiguous()
    dens = ds.density.detach().clone().requires_grad_(True)
    occ = diff.ao_diff(diff.DiffScene(dens, ds.albedo), pts, nrm,
                       torch.Generator(device=dev).manual_seed(0))
    occ.sum().backward()
    occ, gd = occ.detach(), dens.grad
    print(f"ao_diff: {pts.shape[0]} hit points x 20 rays x 5 steps: occlusion mean "
          f"{float(occ.mean()):.4f}, min {float(occ.min()):.4f}, max {float(occ.max()):.4f}; "
          f"density gradient: {int((gd != 0).sum())} cells, max |g| {float(gd.abs().max()):.3e}")
    if (not torch.isfinite(occ).all() or float(occ.min()) < 0 or float(occ.max()) > 1
            or not torch.isfinite(gd).all() or not bool((gd != 0).any())):
        raise AssertionError("ao_diff: occlusion outside [0, 1] or density gradient not finite "
                             "and non-zero")

    # f. timing
    autograd_taker = lambda packed: partial(packed.index_select, 0)  # noqa: E731
    for nb in (CLI_BATCH, TRAIN_BATCH):
        i = torch.from_numpy(rng.integers(0, origins.shape[0], nb)).to(dev)
        b = (origins[i].contiguous(), rdirs[i].contiguous(), targets[i].contiguous())
        step_ms, peak = peak_ms(lambda: step_fn(*b), reps=3)
        print(f"timing unguided train step {nb} x {DIFF_STEPS} (make_train_step: loss, backward, "
              f"Adam; remat on): {step_ms:.3f} ms, {nb / step_ms * 1e3:.4e} rays/s, peak memory "
              f"{peak} bytes above the {torch.cuda.memory_allocated()} allocated before it "
              f"(parameters, Adam state, this run's scenes) | {card}")

        def loss_backward(remat, b):
            opt.zero_grad(set_to_none=True)
            rgb = diff.render_rays_diff(sharding.params_to_scene(params), b[0], b[1],
                                        num_steps=DIFF_STEPS, sky=False, remat=remat)
            torch.mean((rgb - b[2]) ** 2).backward()

        def variant(remat, taker, b=b):
            """loss+backward with ``remat`` and the scan's row gather ``taker``."""
            def run():
                diff._row_taker = taker
                try:
                    loss_backward(remat, b)
                finally:
                    diff._row_taker = row_taker
            return run

        row_taker = diff._row_taker
        variants = {"remat on": variant(True, row_taker), "remat off": variant(False, row_taker),
                    # autograd's own gather: a zero [V, 4] gradient per scan step
                    "autograd gather, remat on": variant(True, autograd_taker)}
        res = {}
        for label in list(variants) + list(variants)[::-1]:  # in turns: A B C C B A
            res.setdefault(label, []).append(peak_ms(variants[label], reps=2))
        print(f"timing blind loss+backward {nb} x {DIFF_STEPS}, in turns: " + "; ".join(
            f"{k} " + " / ".join(f"{ms:.3f} ms ({pk} bytes)" for ms, pk in v)
            for k, v in res.items()) + f" | {card}")
        if nb == CLI_BATCH:
            for label, fn in variants.items():
                profile_step(fn, card, steps=2, label=f"blind loss+backward {nb} x {DIFF_STEPS}, "
                                                      f"{label}")
        opt.zero_grad(set_to_none=True)

    with torch.no_grad():
        img_ms = cuda_ms(lambda: diff.render_image_diff(sharding.params_to_scene(params), cam,
                                                        full_cli), reps=3, warmup=1)
    print(f"timing render_image_diff {d.width}x{d.height} x {IMAGE_STEPS} steps (fit --out): "
          f"{img_ms:.3f} ms | {card}")
    with torch.no_grad():
        profile_step(lambda: diff.render_image_diff(sharding.params_to_scene(params), cam,
                                                    full_cli), card, steps=1,
                     label=f"render_image_diff {d.width}x{d.height} x {IMAGE_STEPS}")
    gen = torch.Generator(device=dev)
    with torch.no_grad():
        ao_ms = cuda_ms(lambda: diff.ao_diff(ds, pts, nrm, gen.manual_seed(0)), reps=3, warmup=1)

    def ao_step():
        dd = ds.density.detach().requires_grad_(True)
        diff.ao_diff(diff.DiffScene(dd, ds.albedo), pts, nrm, gen.manual_seed(0)).sum().backward()

    ao_bwd_ms, ao_peak = peak_ms(ao_step, reps=3)
    print(f"timing ao_diff {pts.shape[0]} points x 20 rays x 5 steps: forward {ao_ms:.3f} ms, "
          f"forward+backward {ao_bwd_ms:.3f} ms (peak memory {ao_peak} bytes) | {card}")
    for label, o, dd, sd in views[1:]:
        def win_step(render, o=o, dd=dd, sd=sd):
            de = ds.density.detach().requires_grad_(True)
            al = ds.albedo.detach().requires_grad_(True)
            render(diff.DiffScene(de, al), o, dd, num_steps=NUM_STEPS, start_t=sd,
                   sky=False).mean().backward()

        pair = cuda_ms(lambda: win_step(fw.render_window_fused), reps=5, warmup=1)
        xla_ms = cuda_ms(lambda: win_step(xla), reps=5, warmup=1)
        print(f"timing window loss+backward {label} x {NUM_STEPS}: kernel pair {pair:.3f} ms, "
              f"render_rays_diff_window(accum='scatter') {xla_ms:.3f} ms | {card}")
    return d.views


# ---------------------------------------------------------------- phase 12

MULTI_BATCH = 8192  # the two-rank step's batch (gloo carries its gradient through the host)
MULTI_SIDE = 128  # the two-rank spatial / handoff frames
MULTI_TIMEOUT = 300.0  # the two-rank world's limit (rank start-up included)


def world_fields(scene) -> dict:
    """The Scene's arrays as numpy (``core.flatten.scene_from_jax`` takes them)."""
    out = {k: getattr(scene, k).cpu().numpy()
           for k in ("grid_enc", "macro", "albedo", "flags", "metadata")}
    out["y_max"] = np.int64(scene.y_max)
    return out


def host_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the host clock, the card synchronised
    after each call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def two_rank_checks(tmp: str, device: str, side: int) -> dict:
    """Phase 12b, on each of two gloo ranks sharing cuda:0 (launch.run_ranks):
    the dp fused step at MULTI_BATCH rays against (a)'s one-rank step, the
    spatial and handoff frames on a (1, 2) mesh, dryrun_multichip(2) and the
    render scaling harness over 1 and 2 ranks at ``side``^2. Returns what the
    rank reports."""
    from raytracing_test_tpu_torch.config import RenderConfig
    from raytracing_test_tpu_torch.core.flatten import scene_from_jax
    from raytracing_test_tpu_torch.parallel import dryrun, handoff, mesh as meshlib
    from raytracing_test_tpu_torch.parallel import scaling, sharding, spatial
    from raytracing_test_tpu_torch.render.camera import Camera

    dev = torch.device(device)
    mesh = meshlib.make_mesh(2, 1, dev)
    scene = scene_from_jax(dict(np.load(os.path.join(tmp, "world.npz"))), dev)
    batch = [t.to(dev) for t in torch.load(os.path.join(tmp, "batch.pt"))]
    out = {"backend": mesh.backend, "rank": meshlib.process_rank()}

    params = sharding.init_params(scene.shape3, dev)
    opt = torch.optim.Adam(params.parameters(), lr=0.05)
    step = sharding.make_train_step_fused(params, opt, sharding.guide_scene_from_params(params),
                                          mesh=mesh)
    loss, aux = step(*batch)
    ref = torch.load(os.path.join(tmp, "step_ref.pt"))
    out["step_loss"] = float(loss)
    out["step_aux"] = aux
    out["step_field_err"] = max(scaled_err(p.detach(), r.to(dev)) for p, r in zip(
        (params.density_raw, params.albedo_raw), ref["fields"]))
    del ref

    cam = Camera(pos=torch.tensor(BENCH_POS, device=dev), dir=torch.tensor(BENCH_DIR, device=dev))
    rcfg = RenderConfig(width=MULTI_SIDE, height=MULTI_SIDE)
    space = meshlib.make_mesh(1, 2, dev)
    sc = spatial.shard_scene_spatial(scene, space)
    out["slab"] = tuple(sc.slab.grid_enc.shape)
    out["spatial"] = spatial.render_image_spatial(sc, cam, rcfg, space).cpu()
    img, out["handoff_stats"] = handoff.render_image_handoff(sc, cam, rcfg, space,
                                                             return_stats=True)
    out["handoff"] = img.cpu()
    out["dryrun"] = dryrun.dryrun_multichip(2, dev)
    full = RenderConfig(width=side, height=side)
    out["render_rates"] = scaling.measure_render_scaling(scene, cam, full, [1, 2], iters=5,
                                                         device=dev)
    out["host_copies"] = mesh.host_copies + space.host_copies
    return out


def multi_phase(dev, card, grid, pal, scene, cli):
    """Phase 12, multi-device execution: (a) every data-parallel and
    space-sharded path on a world of one rank over NCCL at full width, each
    against its one-device counterpart, with times; (b) two gloo ranks
    sharing the card (two_rank_checks). Returns the phase's main-path launch
    counts; any mismatch, timeout or failed rank raises."""
    from raytracing_test_tpu_torch.app import fit
    from raytracing_test_tpu_torch.config import CameraConfig, RenderConfig, WorldConfig
    from raytracing_test_tpu_torch.core.flatten import palette_arrays
    from raytracing_test_tpu_torch.kernels import fused_march as fm, fused_window as fw
    from raytracing_test_tpu_torch.parallel import handoff, launch, mesh as meshlib
    from raytracing_test_tpu_torch.parallel import scaling, sharding, spatial
    from raytracing_test_tpu_torch.render import renderer
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions, yaw_pitch_dir
    from raytracing_test_tpu_torch.render.diff import diff_scene_from_grid

    t_phase = time.perf_counter()
    mesh = meshlib.make_mesh(1, 1, dev, backend=meshlib.default_backend(dev))
    print(f"multi a: world {meshlib.world_size()} rank, backend {mesh.backend}, {mesh.device}")
    launches = {"fused_march": 0, "window_fwd": 0, "window_bwd": 0}

    def main_path(fn):
        """Run one call of a multi-device entry point with the counts set to
        0 just before it and read just after; the comparisons' launches are
        not counted."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        c = counts()
        for k in launches:
            launches[k] += c[k]
        return out, c

    cam = Camera(pos=torch.tensor(BENCH_POS, device=dev), dir=torch.tensor(BENCH_DIR, device=dev))
    full = RenderConfig(width=FULL, height=FULL)
    dirs = ray_directions(cam, FULL, FULL)
    times = {}

    # the fused march, rays split over the data axis, gathered
    (col, aux), c = main_path(lambda: fm.render_rays_fused_dp(scene, cam.pos, dirs, full, mesh,
                                                               image_hw=(FULL, FULL)))
    one = fm.render_image_fused(scene, cam, full).reshape(-1, 3)
    if c["fused_march"] != 1 or not torch.equal(col, one):
        raise AssertionError(f"render_rays_fused_dp: launches {c}, equal to render_image_fused "
                             f"{torch.equal(col, one)}")
    times[f"render_rays_fused_dp {FULL}^2"] = (
        cuda_ms(lambda: fm.render_rays_fused_dp(scene, cam.pos, dirs, full, mesh,
                                                image_hw=(FULL, FULL)), 10, 2),
        cuda_ms(lambda: fm.render_image_fused(scene, cam, full), 10, 2))

    # the reference frame, rays split over the data axis
    d = cli.build_parser().parse_args(["render"])
    cli_cam = Camera(pos=torch.tensor(CameraConfig().pos, dtype=torch.float32, device=dev),
                     dir=torch.tensor(yaw_pitch_dir(d.yaw, d.pitch), dtype=torch.float32,
                                      device=dev))
    half = RenderConfig(width=d.width, height=d.height)
    img, _ = main_path(lambda: sharding.render_image_sharded(scene, cli_cam, half, mesh))
    if not torch.equal(img, renderer.render_jit(scene, cli_cam, half)):
        raise AssertionError("render_image_sharded differs from the reference frame")
    times[f"render_image_sharded {d.width}^2"] = (
        host_ms(lambda: sharding.render_image_sharded(scene, cli_cam, half, mesh), 2),
        host_ms(lambda: renderer.render_jit(scene, cli_cam, half), 2))

    # the window pair, rays split over the data axis, field gradients summed
    ds = diff_scene_from_grid(grid, palette_arrays(pal)[0], dev, solid_density=SOLID_DENSITY)
    seed = fm.seed_depth_fused(scene, cam.pos, dirs, (FULL, FULL))

    def window(render, **kw):
        leaves = [t.detach().clone().requires_grad_(True) for t in (ds.density, ds.albedo)]
        from raytracing_test_tpu_torch.render.diff import DiffScene

        rgb = render(DiffScene(*leaves), cam.pos, dirs, num_steps=NUM_STEPS, sky=False,
                     start_t=seed, **kw)
        rgb.mean().backward()
        return rgb.detach(), leaves[0].grad, leaves[1].grad

    (rgb, gd, ga), c = main_path(lambda: window(fw.render_window_fused_dp, mesh=mesh))
    rgb1, gd1, ga1 = window(fw.render_window_fused)
    w_err = (float((rgb - rgb1).abs().max()), scaled_err(gd, gd1), scaled_err(ga, ga1))
    print(f"window dp {FULL}^2 x {NUM_STEPS}: rgb max |diff| {w_err[0]:.3g}, gradients "
          f"max-scaled {w_err[1]:.3g} (density) {w_err[2]:.3g} (albedo), launches {c}")
    if w_err[0] != 0.0 or max(w_err[1:]) > GRAD_TOL or (c["window_fwd"], c["window_bwd"]) != (1, 1):
        raise AssertionError(f"render_window_fused_dp: {w_err}, launches {c}")
    times[f"render_window_fused_dp {FULL}^2 x {NUM_STEPS} (loss+backward)"] = (
        cuda_ms(lambda: window(fw.render_window_fused_dp, mesh=mesh), 5, 1),
        cuda_ms(lambda: window(fw.render_window_fused), 5, 1))
    del ds, rgb, gd, ga, rgb1, gd1, ga1

    # the train steps: data parallel against one device, on the same batch
    g = WorldConfig().grid_shape
    cams = fit.ring_cameras((g[0] / 2, g[1] / 3, g[2] / 2), 0.8 * g[0], 0.9 * g[1], 8, device=dev)
    origins, rdirs, targets = fit.make_targets(scene, cams, 64)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, origins.shape[0], TRAIN_BATCH))
    batch = [t[idx.to(dev)] for t in (origins, rdirs, targets)]

    def steps_pair(make, n_steps, rays, **kw):
        """(dp losses, one-device losses, dp ms, one-device ms) of n_steps
        alternate steps of the two from the same weights on one batch."""
        out = []
        for m in (mesh, None):
            p = sharding.init_params(tuple(g), dev)
            opt = torch.optim.Adam(p.parameters(), lr=0.05)
            out.append((p, make(p, opt, mesh=m, **kw)))
        b = [t[:rays] for t in batch]
        losses = ([], [])
        for _ in range(n_steps):
            (l_dp, aux), c = main_path(lambda: out[0][1](*b))
            losses[0].append(float(l_dp))
            losses[1].append(float(out[1][1](*b)[0]))
            if aux != {"n_escaped": 0, "grads_dropped": False}:
                raise AssertionError(f"dp step aux {aux}")
        ms = tuple(host_ms(lambda: st(*b), 2) for _, st in out)
        return losses, ms, lambda: out[0][1](*b)

    guide = sharding.guide_scene_from_params(sharding.init_params(tuple(g), dev))
    dp_steps = {}
    for name, make, n_steps, rays, kw in (
            ("fused", sharding.make_train_step_fused, 5, TRAIN_BATCH, {"guide_scene": guide}),
            ("unguided", sharding.make_train_step, 2, CLI_BATCH, {"num_steps": 96})):
        (dp, one), ms, dp_steps[f"{name} dp step {rays} rays"] = steps_pair(make, n_steps, rays,
                                                                            **kw)
        print(f"{name} dp step, {n_steps} steps x {rays} rays: losses {dp}, one device {one}")
        if any(abs(a - b) > 1e-6 * abs(b) for a, b in zip(dp, one)) or not dp[-1] < dp[0] \
                or not np.isfinite(dp).all():
            raise AssertionError(f"{name} dp step: losses {dp} against one device {one}")
        times[f"{name} dp step {rays} rays"] = ms

    # (b)'s reference: one fused step at MULTI_BATCH rays on this rank
    tmp = tempfile.mkdtemp(prefix="multi-")
    p = sharding.init_params(tuple(g), dev)
    step = sharding.make_train_step_fused(p, torch.optim.Adam(p.parameters(), lr=0.05), guide,
                                          mesh=mesh)
    b8 = [t[:MULTI_BATCH] for t in batch]
    (loss_ref, _), _ = main_path(lambda: step(*b8))
    torch.save({"fields": [p.density_raw.detach().cpu(), p.albedo_raw.detach().cpu()]},
               os.path.join(tmp, "step_ref.pt"))
    torch.save([t.cpu() for t in b8], os.path.join(tmp, "batch.pt"))
    np.savez(os.path.join(tmp, "world.npz"), **world_fields(scene))
    del p, step

    # the gradient all-reduce alone: the coalesced [V, 4] float32 buffer
    buf = torch.zeros(4 * int(np.prod(g)), dtype=torch.float32, device=dev)
    times[f"all-reduce of the field gradients ({buf.numel() * 4 / 1e6:.0f} MB)"] = (
        cuda_ms(lambda: mesh.psum_(buf, meshlib.DATA_AXIS), 10, 2), float("nan"))
    del buf

    # the world split over the space axis, through the CLI and its session
    with tempfile.TemporaryDirectory() as pngs:
        frames = {}
        for mode in ("spatial", "reference", "handoff", "fast"):
            path = os.path.join(pngs, f"{mode}.png")
            argv = ["--device", str(dev), "render", "--mode", mode, "--out", path]
            if mode in ("spatial", "handoff"):
                main_path(lambda: cli.main(argv))
            else:
                cli.main(argv)
            with open(path, "rb") as f:
                frames[mode] = f.read()
        if frames["spatial"] != frames["reference"] or frames["handoff"] != frames["fast"]:
            raise AssertionError("CLI: spatial / handoff PNGs differ from reference / fast")
    args = cli.build_parser().parse_args(["--device", str(dev), "render"])
    sess = cli.make_session(args)
    rcfg = cli._rcfg(args)
    imgs = {m: sess.render(rcfg, mode=m) for m in ("spatial", "reference", "handoff", "fast")}
    if not (torch.equal(imgs["spatial"], imgs["reference"])
            and torch.equal(imgs["handoff"], imgs["fast"])):
        raise AssertionError("session: spatial / handoff frames differ from reference / fast")
    for m in ("spatial", "handoff"):
        other = {"spatial": "reference", "handoff": "fast"}[m]
        times[f"{m} {args.width}^2 (one rank) vs {other}"] = (
            host_ms(lambda: sess.render(rcfg, mode=m), 2),
            host_ms(lambda: sess.render(rcfg, mode=other), 2))
    space = meshlib.make_mesh(1, 1, dev)
    sc = spatial.shard_scene_spatial(scene, space)
    small = RenderConfig(width=MULTI_SIDE, height=MULTI_SIDE)
    one_spatial = spatial.render_image_spatial(sc, cam, small, space).cpu()
    one_handoff, st1 = handoff.render_image_handoff(sc, cam, small, space, return_stats=True)
    one_handoff = one_handoff.cpu()
    if not torch.equal(one_handoff, fm.render_image_fused(scene, cam, small).cpu()):
        raise AssertionError(f"handoff {MULTI_SIDE}^2 differs from the fused kernel's frame")

    print(f"multi a: times (ms; multi-device path, one-device counterpart) | {card}")
    for k, (a, b) in times.items():
        print(f"  {k}: {a:.3f}, {b:.3f}")
    # where each path's time goes (device busy time and idle share)
    profile_step(lambda: fm.render_rays_fused_dp(scene, cam.pos, dirs, full, mesh,
                                                 image_hw=(FULL, FULL)),
                 card, steps=3, label=f"render_rays_fused_dp {FULL}^2")
    profile_step(lambda: sharding.render_image_sharded(scene, cli_cam, half, mesh), card,
                 steps=1, label=f"render_image_sharded {d.width}^2")
    ds = diff_scene_from_grid(grid, palette_arrays(pal)[0], dev, solid_density=SOLID_DENSITY)
    profile_step(lambda: window(fw.render_window_fused_dp, mesh=mesh), card, steps=3,
                 label=f"render_window_fused_dp {FULL}^2 x {NUM_STEPS} (loss+backward)")
    del ds
    for k, fn in dp_steps.items():
        profile_step(fn, card, steps=2, label=k)
    for m in ("spatial", "handoff"):
        profile_step(lambda: sess.render(rcfg, mode=m), card, steps=1,
                     label=f"{m} {args.width}^2, one rank")
    print(f"multi a: {time.perf_counter() - t_phase:.1f} s, main-path launches {launches}")

    # (b) two gloo ranks sharing the card
    t0 = time.perf_counter()
    res = launch.run_ranks(two_rank_checks, 2, backend="gloo", device=str(dev),
                           timeout=MULTI_TIMEOUT, args=(tmp, str(dev), FULL))
    r0 = res[0]
    for k in ("step_loss", "step_field_err"):
        print(f"multi b: {k} {[r[k] for r in res]}")
    print(f"multi b: backend {r0['backend']}, host copies {[r['host_copies'] for r in res]}, "
          f"slab {r0['slab']}, handoff {r0['handoff_stats']}, one rank {st1}")
    rates = r0["render_rates"]
    print(f"multi b: render rays/s {rates}, overhead_table {scaling.overhead_table(rates)} "
          "(two ranks time-share one card: an overhead, not a scaling figure) | " + card)
    print(f"multi b: dryrun {r0['dryrun']}")
    bad = []
    for r in res:
        if abs(r["step_loss"] - float(loss_ref)) > 1e-6 * abs(float(loss_ref)):
            bad.append(f"rank {r['rank']} loss {r['step_loss']} vs {float(loss_ref)}")
        if r["step_field_err"] > GRAD_TOL:
            bad.append(f"rank {r['rank']} fields {r['step_field_err']}")
        if not (torch.equal(r["spatial"], one_spatial) and torch.equal(r["handoff"], one_handoff)):
            bad.append(f"rank {r['rank']} spatial / handoff frames differ from one rank's")
    if r0["backend"] != "gloo" or r0["handoff_stats"]["lanes_shipped"] <= 0 or bad:
        raise AssertionError(f"multi b: {bad}, backend {r0['backend']}, "
                             f"stats {r0['handoff_stats']}")
    print(f"multi b: {time.perf_counter() - t0:.1f} s; phase 12 {time.perf_counter() - t_phase:.1f} s")
    meshlib.shutdown()
    return launches


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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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
    cli_state = march_state(scene, CameraConfig().pos, yaw_pitch_dir(d.yaw, d.pitch), d.width)
    err_cli, _ = parity("cli-view", scene, cli_state, cli_cfg, 0.0, d.width)
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

    # 6. timing and diagnosis of the march (grid resident in L2 across
    # frames, as when rendering)
    n = side * side
    times, march_bound, march_shapes = march_phase(dev, card, side, scene, s_bench, o_full, full,
                                                   lean, cli_state, cli_cfg)

    # 7. the training slice
    train = train_phase(dev, card, side, grid, pal, scene, cli, fm, fw)
    launches = serve_launches + train["march_launches"]

    # 8. the brick engine
    brick_kernels, brick_counts, adv_cli, fine_cli = bricks_phase(
        dev, card, side, scene, o_full, wscene, wpos, wdir, cli)

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
    kernels += brick_kernels
    kernels.append(train["guide"])

    # 9. the prox seed and the prox-seeded window render
    prox_entry, prox_passes = prox_phase(dev, card, side, grid, pal, scene, cli)
    kernels.append(prox_entry)

    # 10. the edit session
    t0 = time.perf_counter()
    edit = edit_phase(dev, card, cli)
    print(f"edit phase: {time.perf_counter() - t0:.1f} s")
    kernels[0]["launches"] += edit["launches"]

    # 11. the differentiable renders as PyTorch operations
    t0 = time.perf_counter()
    diff_launches = diff_phase(dev, card, grid, pal, scene, cli)
    print(f"diff phase: {time.perf_counter() - t0:.1f} s")
    kernels[0]["launches"] += diff_launches

    # 12. multi-device: one rank over NCCL, then two gloo ranks on the card
    multi = multi_phase(dev, card, grid, pal, scene, cli)
    for k in kernels:
        k["launches"] += multi.get(k["name"], 0)

    # where the kernels lose time on the main paths: launches x (ms - bound)
    # at the shape each launch has (the launch counts are this run's)
    views = train["march_launches"] - train["seeds"] + diff_launches
    w16, w8 = train["batches"][TRAIN_BATCH], train["batches"][CLI_BATCH]
    order = [
        ("fused_march full, 512^2 frames: render/animate and the edit session's (with "
         "progressive's 128^2 coarse passes)",
         serve_launches + edit["launches"],
         march_shapes[f"full {cli_cfg.width}^2 (render/animate frame)"]),
        ("fused_march materials, 64^2 target views of the fit", views,
         march_shapes["materials 64^2 (a target view of the fit)"]),
        (f"fused_march lean, {TRAIN_BATCH}-ray train seeds", train["steps"][TRAIN_BATCH],
         march_shapes[f"lean {TRAIN_BATCH} rays (a train step's seed)"]),
        (f"fused_march lean, {CLI_BATCH}-ray CLI fit seeds", train["steps"][CLI_BATCH],
         march_shapes[f"lean {CLI_BATCH} rays (a CLI fit step's seed)"]),
        (f"window_fwd, {TRAIN_BATCH} x {NUM_STEPS}", train["steps"][TRAIN_BATCH], w16["window_fwd"]),
        (f"window_fwd, {CLI_BATCH} x {NUM_STEPS}", train["steps"][CLI_BATCH], w8["window_fwd"]),
        (f"window_bwd, {TRAIN_BATCH} x {NUM_STEPS} (zero-fill included)", train["steps"][TRAIN_BATCH],
         w16["window_bwd"]),
        (f"window_bwd, {CLI_BATCH} x {NUM_STEPS} (zero-fill included)", train["steps"][CLI_BATCH],
         w8["window_bwd"]),
        ("brick_advance, 512^2 brick frame (each launch's own ms and bound, averaged)",
         brick_counts["brick_advance"],
         (adv_cli["ms"] / adv_cli["launches"], adv_cli["bound"] / adv_cli["launches"])),
        ("brick_fine, 512^2 brick frame (each launch's own ms and bound, averaged)",
         brick_counts["brick_fine"],
         (fine_cli["ms"] / fine_cli["launches"], fine_cli["bound"] / fine_cli["launches"])),
        (f"fused_march prox, {side // 4}^2 coarse pass", 1, prox_passes["coarse"]),
        (f"fused_march prox, {side}^2 full pass", 1, prox_passes["full"]),
    ]
    order.sort(key=lambda r: -r[1] * (r[2][0] - r[2][1]))
    print(f"order of the kernels' lost time on the main paths | {card}")
    for name, count, (ms, b_ms) in order:
        print(f"  {count} x ({ms:.4f} - {b_ms:.4f}) = {count * (ms - b_ms):.4f} ms: {name}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
