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

Kernel A works in place on a writable march state. ``brick_advance`` leaves
its caller's state as it is: it copies the fields kernel A writes and
launches on the copy. ``advance_loop``, the brick hook of the brick path,
makes no copy: the state it gets comes from the round's last ``brick_fine``
launch, whose fresh outputs nothing else holds.
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
# the fields of the march state that kernel A writes in place
ADVANCE_WRITES = ("cell", "tmax", "mat", "done", "last_t", "last_axis", "steps")


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


def _outputs(N: int, dev) -> dict:
    i32, f32 = torch.int32, torch.float32
    return {
        "mat": torch.empty(N, dtype=i32, device=dev),
        "cell": torch.empty((N, 3), dtype=i32, device=dev),
        "tmax": torch.empty((N, 3), dtype=f32, device=dev),
        "last_t": torch.empty(N, dtype=f32, device=dev),
        "last_axis": torch.empty(N, dtype=i32, device=dev),
        "steps": torch.empty(N, dtype=i32, device=dev),
        "done": torch.empty(N, dtype=torch.bool, device=dev),
    }


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
    in place on ``s``: the fields in ADVANCE_WRITES are written, so they must
    be contiguous already (a copy would take the writes)."""
    dev = s.cell.device
    N = s.cell.shape[0]
    Sx, Sy, Sz = scene.shape3
    sh = scene.brick_shift
    table = _check(table, "brick distance table", torch.uint8, (Sx >> sh, Sy >> sh, Sz >> sh), dev)
    for f in ADVANCE_WRITES:
        if not getattr(s, f).is_contiguous():
            raise ValueError(f"brick_advance: {f} must be contiguous, it is written in place")
    ins = [table] + _state_args(s, dev)
    args = ([table.data_ptr(), Sx, Sy, Sz, sh, int(scene.y_max), int(budget)]
            + [t.data_ptr() for t in ins[1:]] + [N, _stream(dev)])
    return args, ins


def _fine_args(scene: Scene, s: _March, blin: torch.Tensor, luts: torch.Tensor, budget: int):
    """(arguments of brick_fine_launch, outputs, evt, inputs to keep alive)."""
    dev = s.cell.device
    N = s.cell.shape[0]
    Sx, Sy, Sz = scene.shape3
    sh = scene.brick_shift
    nb = (Sx >> sh) * (Sy >> sh) * (Sz >> sh)
    bmat = _check(scene.brick_mat, "brick_mat", torch.uint8, (nb, 1 << (3 * sh)), dev)
    luts = _check(luts, "luts", torch.int32, (8,), dev)
    blin = _check(blin, "blin", torch.int32, (N,), dev)
    ins = [bmat, luts, blin] + _state_args(s, dev)
    out = _outputs(N, dev)
    evt = torch.empty(N, dtype=torch.bool, device=dev)
    args = ([bmat.data_ptr(), luts.data_ptr(), Sx, Sy, Sz, sh, int(budget)]
            + [t.data_ptr() for t in ins[3:]] + [blin.data_ptr(), N]
            + [t.data_ptr() for t in out.values()]
            + [evt.data_ptr(), _stream(dev)])
    return args, out, evt, ins


def writable(s: _March) -> _March:
    """``s`` with fresh contiguous copies of the fields kernel A writes."""
    return s._replace(**{f: getattr(s, f).clone(memory_format=torch.contiguous_format)
                         for f in ADVANCE_WRITES})


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
    return _launch_advance(scene, table, writable(s), budget)


def advance_loop(scene: Scene, table: torch.Tensor, s: _March, budget: int) -> _March:
    """``brick_march``'s brick hook on kernel A, in place on ``s``: the
    fields it writes come from the round's last ``brick_fine`` launch
    (``fine_loop`` ends with one), fresh tensors that nothing else holds, so
    the round makes no copy. CPU tensors run ``brick_advance_plain``."""
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


def brick_fine(scene: Scene, s: _March, blin: torch.Tensor, luts: torch.Tensor, budget: int):
    """Kernel B on a march state -> (state, evt bool[N]): CPU tensors run
    ``brick_fine_plain``, CUDA tensors launch the kernel (or raise)."""
    global LAUNCHES_FINE
    if _device(scene, s, "brick_fine").type == "cpu":
        return brick_fine_plain(scene, s, blin, luts, budget)
    from . import build

    lib = build.library("brick_march")
    args, out, evt, _ = _fine_args(scene, s, blin, luts, budget)
    _raise_on(lib.brick_fine_launch(*args), lib, "brick_fine")
    LAUNCHES_FINE += 1
    return s._replace(**out), evt


def fine_loop(scene: Scene, s: _March, blin, cfg: RenderConfig, budget: int, shadow: bool,
              time_s):
    """``brick_march``'s fine hook on kernel B: run it, then (primary path,
    materials on) apply ``material_step`` and one DDA step to the event lanes
    and run it again until no event is left: the marching sequence of the
    plain ``_fine_loop``, which handles events inside its loop."""
    luts = _prop_luts(scene, shadow, cfg.enable_materials)
    s, evt = brick_fine(scene, s, blin, luts, budget)
    if shadow or not cfg.enable_materials:
        return s
    for _ in range(_GLUE_CAP):
        if not bool(evt.any()):
            break
        fl = scene.flags[s.mat.long()]
        is_refl, is_refr, _ = classify(fl, s.mat, evt, cfg)
        (dirx, stepx, absx, tmaxx, segx, last_t, cmod, ior, refl) = material_step(
            s, is_refl, is_refr, fl, cfg, time_s
        )
        s = s._replace(
            dir=dirx, step=stepx, abs_delta=absx, tmax=tmaxx, seg_origin=segx,
            last_t=last_t, color_mod=cmod, ior=ior, reflected=refl,
        )
        s = bricks.dda_step(s, evt, budget)
        s, evt = brick_fine(scene, s, blin, luts, budget)
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
