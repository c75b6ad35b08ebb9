"""The brick engine on the card: two CUDA kernels and the glue between them
(csrc/brick_march.cu).

Port of ``raytracing_test_tpu/kernels/brick_kernels.py``:

  - ``brick_advance`` (kernel A, replaces ``_brick_kernel``, :100): the brick
    phase of a round. Its plain version ``brick_advance_plain`` is
    ``render/bricks.py:_brick_loop``.
  - ``brick_fine`` (kernel B, replaces ``_fine_kernel``, :235): lanes march
    inside their brick ``blin`` and stop on a hit, a material event (a
    reflect or refract block), leaving the brick or the budget. Returns
    ``(state, evt)`` like ``fine_steps_pallas`` and applies no
    ``material_step``. Its plain version is ``brick_fine_plain``.
  - The material glue of ``make_pallas_loops`` (:503-559) stays in PyTorch,
    as the reference keeps it in XLA: ``material_step`` and one DDA step on
    the event lanes, then kernel B again, until no event is left (at most 64
    passes).

``render_rays_bricks_pallas`` / ``render_image_bricks_pallas`` keep the
reference's names: the brick path of ``render/bricks.py`` with both inner
loops on the kernels.

Dispatch is by the device of the tensors, as in ``kernels/fused_march.py``:
CPU tensors run the plain versions, CUDA tensors launch the kernels or
raise. There is no fallback from one to the other. ``LAUNCHES_ADVANCE`` and
``LAUNCHES_FINE`` count kernel launches.

Both kernels work in place on a writable march state. ``brick_advance`` and
``brick_fine`` leave their caller's state as it is: they copy the fields
the kernel writes (``bricks.writable``) and launch on the copy. The brick path's
hooks ``advance_loop`` and ``fine_loop`` make no copy: ``brick_march`` hands
a march with hooks its own copy of those fields once, at its start (primary
and shadow), and every later state of the march is either written in place
by the kernels or made fresh by the glue (``material_step`` and
``dda_step`` return new tensors), so nothing else holds what they write.

``fine_loop`` launches kernel B over all N lanes at the start of a round,
then each glue pass over the event lanes of the pass before only: the
launch appends them to an int32 list and counts them on the card, and the
loop reads that count back instead of ``evt.any()``.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties
from ..render import bricks
from ..render.camera import Camera, ray_directions
from ..render.fast import crosshair
from ..render.renderer import _March, classify, material_step

LAUNCHES_ADVANCE = 0  # brick_advance launches in this process (never the plain path)
LAUNCHES_FINE = 0  # brick_fine launches in this process (never the plain path)

_GLUE_CAP = 64  # material glue passes per fine phase (make_pallas_loops :552)

brick_advance_plain = bricks._brick_loop


def _prop_luts(scene: Scene, shadow: bool, enable_materials: bool) -> torch.Tensor:
    """i32[8] on the scene's device: the hit mask in words [0:4), the
    material-event mask in [4:8), over material ids (bit i of word i >> 5 is
    the property of id i; the words are uint32 bit patterns)."""
    fl = scene.flags[:128]
    if fl.shape[0] < 128:
        fl = torch.cat([fl, torch.zeros(128 - fl.shape[0], dtype=fl.dtype, device=fl.device)])
    ids = torch.arange(128, device=fl.device)
    liquid = (fl & int(Properties.LIQUID)) > 0
    f7 = fl & 0x7
    solid = ids > 0
    if shadow:
        hit = solid & ~liquid
        event = torch.zeros_like(hit)
    elif enable_materials:
        event = solid & ((f7 == 0x3) | (f7 == 0x5))
        hit = solid & ~event
    else:
        hit = solid
        event = torch.zeros_like(hit)

    def words(mask):
        sh = torch.arange(32, dtype=torch.int64, device=fl.device)[None, :]
        w = (mask.to(torch.int64).reshape(4, 32) << sh).sum(dim=1)
        return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)

    return torch.cat([words(hit), words(event)])


def _mask_bit(words, m):
    """Bit m (a material id) of the 4-word mask ``words`` (i32 bit patterns)."""
    w = words[torch.clamp(m >> 5, max=3).long()].to(torch.int64) & 0xFFFFFFFF
    return ((w >> (m & 31).to(torch.int64)) & 1) != 0


def brick_fine_plain(scene: Scene, s: _March, blin, luts, budget: int):
    """Kernel B's plain version -> (state, evt bool[N])."""
    evt = torch.zeros_like(s.done)
    for _ in range(bricks._FINE_CAP):
        wc, in_w = bricks._wrap_window(scene, s.cell)
        active = ~s.done & ~evt & in_w & (bricks.brick_lin(scene, wc) == blin) & (blin >= 0)
        if not bool(active.any()):
            break
        m = torch.where(active, bricks.voxel_mat(scene, blin, s.cell), torch.zeros_like(blin))
        solid = active & (m != 0)
        is_hit = solid & _mask_bit(luts[:4], m)
        is_evt = solid & _mask_bit(luts[4:], m)
        s = s._replace(mat=torch.where(active, m, s.mat), done=s.done | is_hit)
        evt = evt | is_evt
        s = bricks.dda_step(s, active & ~is_hit & ~is_evt, budget)
    return s, evt


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"brick_kernels: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


def _state_args(s: _March, dev) -> list:
    """The state tensors in the kernels' order (cell, tmax, step, abs_delta,
    mat, done, last_t, last_axis, steps), checked and contiguous."""
    N = s.cell.shape[0]
    i32, f32 = torch.int32, torch.float32
    return [
        _check(s.cell, "cell", i32, (N, 3), dev),
        _check(s.tmax, "tmax", f32, (N, 3), dev),
        _check(s.step, "step", f32, (N, 3), dev),
        _check(s.abs_delta, "abs_delta", f32, (N, 3), dev),
        _check(s.mat, "mat", i32, (N,), dev),
        _check(s.done, "done", torch.bool, (N,), dev),
        _check(s.last_t, "last_t", f32, (N,), dev),
        _check(s.last_axis, "last_axis", i32, (N,), dev),
        _check(s.steps, "steps", i32, (N,), dev),
    ]


def _device(scene: Scene, s: _March, what: str):
    dev = s.cell.device
    if scene.device != dev:
        raise ValueError(f"{what}: scene on {scene.device}, rays on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.kernel_error_string(err).decode()}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _advance_args(scene: Scene, table: torch.Tensor, s: _March, budget: int):
    """(arguments of brick_advance_launch, inputs to keep alive) for kernel A
    in place on ``s``."""
    dev = s.cell.device
    N = s.cell.shape[0]
    Sx, Sy, Sz = scene.shape3
    sh = scene.brick_shift
    table = _check(table, "brick distance table", torch.uint8, (Sx >> sh, Sy >> sh, Sz >> sh), dev)
    _written_in_place(s, "brick_advance")
    ins = [table] + _state_args(s, dev)
    args = ([table.data_ptr(), Sx, Sy, Sz, sh, int(scene.y_max), int(budget)]
            + [t.data_ptr() for t in ins[1:]] + [N, _stream(dev)])
    return args, ins


def _written_in_place(s: _March, what: str) -> None:
    """The fields in bricks.HOOK_WRITES are written in place, so they must be
    contiguous already (a copy would take the writes)."""
    for f in bricks.HOOK_WRITES:
        if not getattr(s, f).is_contiguous():
            raise ValueError(f"{what}: {f} must be contiguous, it is written in place")


def _fine_args(scene: Scene, s: _March, blin: torch.Tensor, luts: torch.Tensor, budget: int,
               evt: torch.Tensor, lanes=None, k: int = 0, list_out=None, counts=None, w: int = 0):
    """(arguments of brick_fine_launch, inputs to keep alive) for kernel B
    in place on ``s`` and ``evt``: over all N lanes, or over the first ``k``
    entries of ``lanes``. With ``list_out`` the launch appends its event
    lanes there, counts them in ``counts[w]`` and zeroes ``counts[1 - w]``."""
    dev = s.cell.device
    N = s.cell.shape[0]
    Sx, Sy, Sz = scene.shape3
    sh = scene.brick_shift
    nb = (Sx >> sh) * (Sy >> sh) * (Sz >> sh)
    bmat = _check(scene.brick_mat, "brick_mat", torch.uint8, (nb, 1 << (3 * sh)), dev)
    luts = _check(luts, "luts", torch.int32, (8,), dev)
    blin = _check(blin, "blin", torch.int32, (N,), dev)
    _written_in_place(s, "brick_fine")
    if evt.dtype != torch.bool or tuple(evt.shape) != (N,) or not evt.is_contiguous():
        raise ValueError("brick_fine: evt must be a contiguous bool [N], it is written in place")
    ins = [bmat, luts, blin, evt] + _state_args(s, dev)
    n, lanes_ptr = N, None
    if lanes is not None:
        lanes = _check(lanes, "lanes", torch.int32, (lanes.shape[0],), dev)
        if not 0 <= k <= lanes.shape[0]:
            raise ValueError(f"brick_fine: {k} lanes launched from a list of {lanes.shape[0]}")
        n, lanes_ptr = k, lanes.data_ptr()
        ins.append(lanes)
    lists = [None, None, None]
    if list_out is not None:
        list_out = _check(list_out, "list_out", torch.int32, (list_out.shape[0],), dev)
        counts = _check(counts, "counts", torch.int32, (2,), dev)
        if list_out.shape[0] < n:
            raise ValueError(f"brick_fine: list_out holds {list_out.shape[0]} lanes, {n} launched")
        lists = [list_out.data_ptr(), counts[w].data_ptr(), counts[1 - w].data_ptr()]
        ins += [list_out, counts]
    args = ([bmat.data_ptr(), luts.data_ptr(), Sx, Sy, Sz, sh, int(budget)]
            + [t.data_ptr() for t in ins[4:13]]
            + [blin.data_ptr(), evt.data_ptr(), lanes_ptr, n] + lists + [_stream(dev)])
    return args, ins


def _launch_advance(scene: Scene, table: torch.Tensor, s: _March, budget: int) -> _March:
    global LAUNCHES_ADVANCE
    from . import build

    lib = build.library("brick_march")
    args, _ = _advance_args(scene, table, s, budget)
    _raise_on(lib.brick_advance_launch(*args), lib, "brick_advance")
    LAUNCHES_ADVANCE += 1
    return s


def brick_advance(scene: Scene, table: torch.Tensor, s: _March, budget: int) -> _March:
    """Kernel A on a march state -> the advanced state; ``s`` is left as it
    is. CPU tensors run ``brick_advance_plain``; CUDA tensors launch the
    kernel in place on a copy of the fields it writes (or raise)."""
    if _device(scene, s, "brick_advance").type == "cpu":
        return brick_advance_plain(scene, table, s, budget)
    return _launch_advance(scene, table, bricks.writable(s), budget)


def advance_loop(scene: Scene, table: torch.Tensor, s: _March, budget: int) -> _March:
    """``brick_march``'s brick hook on kernel A, in place on ``s``, which the
    march owns (``brick_march`` copied its fields once at the start of the
    march; ``fine_loop`` writes the same tensors in place or hands on the
    glue's fresh ones), so the round makes no copy. CPU tensors run
    ``brick_advance_plain``."""
    if _device(scene, s, "brick_advance").type == "cpu":
        return brick_advance_plain(scene, table, s, budget)
    return _launch_advance(scene, table, s, budget)


def occupancy():
    """Blocks per SM and block size of brick_advance and brick_fine, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    import ctypes

    from . import build

    lib = build.library("brick_march")
    out = {}
    for which, name in ((0, "brick_advance"), (1, "brick_fine")):
        threads = ctypes.c_int(0)
        out[name] = lib.brick_blocks_per_sm(which, ctypes.byref(threads))
        out[f"{name} threads"] = threads.value
    return out


def _launch_fine(scene: Scene, s: _March, blin, luts, budget: int, evt, lanes=None, k: int = 0,
                 list_out=None, counts=None, w: int = 0) -> None:
    """Kernel B in place on ``s`` and ``evt`` (``_fine_args``); raises on a
    failed launch."""
    global LAUNCHES_FINE
    from . import build

    lib = build.library("brick_march")
    args, _ = _fine_args(scene, s, blin, luts, budget, evt, lanes, k, list_out, counts, w)
    _raise_on(lib.brick_fine_launch(*args), lib, "brick_fine")
    LAUNCHES_FINE += 1


def brick_fine(scene: Scene, s: _March, blin: torch.Tensor, luts: torch.Tensor, budget: int):
    """Kernel B on a march state -> (state, evt bool[N]); ``s`` is left as it
    is. CPU tensors run ``brick_fine_plain``; CUDA tensors launch the kernel
    over all lanes in place on a copy of the fields it writes (or raise)."""
    if _device(scene, s, "brick_fine").type == "cpu":
        return brick_fine_plain(scene, s, blin, luts, budget)
    out = bricks.writable(s)
    evt = torch.empty(s.cell.shape[0], dtype=torch.bool, device=s.cell.device)
    _launch_fine(scene, out, blin, luts, budget, evt)
    return out, evt


def material_glue(scene: Scene, s: _March, evt, cfg: RenderConfig, budget: int, time_s) -> _March:
    """The glue between two ``brick_fine`` launches (make_pallas_loops
    :503-559): ``material_step`` on the event lanes, then one DDA step for
    them."""
    fl = scene.flags[s.mat.long()]
    is_refl, is_refr, _ = classify(fl, s.mat, evt, cfg)
    (dirx, stepx, absx, tmaxx, segx, last_t, cmod, ior, refl) = material_step(
        s, is_refl, is_refr, fl, cfg, time_s
    )
    s = s._replace(
        dir=dirx, step=stepx, abs_delta=absx, tmax=tmaxx, seg_origin=segx,
        last_t=last_t, color_mod=cmod, ior=ior, reflected=refl,
    )
    return bricks.dda_step(s, evt, budget)


def fine_loop(scene: Scene, s: _March, blin, cfg: RenderConfig, budget: int, shadow: bool,
              time_s):
    """``brick_march``'s fine hook on kernel B: run it, then (primary path,
    materials on) apply ``material_glue`` to the event lanes and run it again
    until no event is left: the marching sequence of the plain
    ``_fine_loop``, which handles events inside its loop.

    CUDA tensors: in place on ``s``, which the march owns (``brick_march``);
    the first launch runs all N lanes, each glue pass only the event lanes
    of the launch before, from the list that launch wrote on the card (two
    lists in turn; their counts are read back, one 4-byte read a pass).
    CPU tensors run ``brick_fine_plain`` on all lanes for every pass."""
    luts = _prop_luts(scene, shadow, cfg.enable_materials)
    glue = not shadow and cfg.enable_materials
    if _device(scene, s, "brick_fine").type == "cpu":
        s, evt = brick_fine_plain(scene, s, blin, luts, budget)
        for _ in range(_GLUE_CAP if glue else 0):
            if not bool(evt.any()):
                break
            s, evt = brick_fine_plain(scene, material_glue(scene, s, evt, cfg, budget, time_s),
                                      blin, luts, budget)
        return s

    dev = s.cell.device
    N = s.cell.shape[0]
    evt = torch.empty(N, dtype=torch.bool, device=dev)
    if not glue:
        _launch_fine(scene, s, blin, luts, budget, evt)
        return s
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    lanes = torch.empty(N, dtype=torch.int32, device=dev)
    _launch_fine(scene, s, blin, luts, budget, evt, list_out=lanes, counts=counts, w=0)
    w = 0
    for _ in range(_GLUE_CAP):
        k = int(counts[w])
        if k == 0:
            break
        s = material_glue(scene, s, evt, cfg, budget, time_s)
        nxt = torch.empty(k, dtype=torch.int32, device=dev)
        _launch_fine(scene, s, blin, luts, budget, evt, lanes, k, nxt, counts, 1 - w)
        lanes, w = nxt, 1 - w
    return s


def render_rays_bricks_pallas(scene: Scene, origin, dirs, cfg: RenderConfig, start_t=None,
                              time_s=None):
    """The brick path with both inner loops on the kernels -> (rgb [N,3], aux)."""
    return bricks.render_rays_bricks(scene, origin, dirs, cfg, start_t=start_t, time_s=time_s,
                                     fine_loop=fine_loop, brick_loop=advance_loop)


def render_image_bricks_pallas(scene: Scene, camera: Camera, cfg: RenderConfig, time_s=None):
    """Full frame [H, W, 3] through the brick kernels, crosshair included."""
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, _ = render_rays_bricks_pallas(scene, camera.pos, dirs, cfg, time_s=time_s)
    return crosshair(col.reshape(cfg.height, cfg.width, 3), cfg)
