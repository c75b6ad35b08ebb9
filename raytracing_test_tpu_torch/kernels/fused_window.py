"""Fused window render: the guided S-step volumetric window, forward and
backward, as one CUDA kernel each (csrc/fused_window.cu).

Port of ``raytracing_test_tpu/kernels/fused_window.py``: ``render_window_fused``
(:769) with the reference preamble (slab fast-forward, detached seeds, miss
seeds parked at cell 1023), the soft sun shadow and the sky term in PyTorch,
and the window itself in ``window_fwd`` / ``window_bwd`` behind a
``torch.autograd.Function``. The gradient reaches the fields through the
``_pack_fields`` concatenation and the ray origins and directions through the
preamble (the kernel returns the ``tmax`` / ``abs_delta`` cotangents).

Dispatch is by the device of the tensors: CPU tensors run ``window_plain``
(the kernels' plain PyTorch version, differentiated by autograd); CUDA
tensors launch the kernels or raise. ``LAUNCHES_FWD`` / ``LAUNCHES_BWD``
count the launches.

The reference's box/strip machinery, escape fallback (``overflow``,
``escape_div``), ``window_supported`` shape limits and transmittance
early-out are TPU workarounds and are not carried: every shape runs on the
kernels, all S steps, exactly. ``aux`` keeps the reference keys, with
``n_escaped`` a constant 0 and ``grads_dropped`` False.

``render_window_fused_dp`` splits the rays over a mesh's data axis
(parallel/mesh.py): one launch pair per rank on its block, the field
gradients summed over the axis in the backward.
"""

from __future__ import annotations

import torch

from ..render.diff import DiffScene, _pack_fields, _ray_start, _window_lin, transmittance
from ..render.fast import sun_unit
from ..render.renderer import _argmin_axis, skybox

LAUNCHES_FWD = 0  # window_fwd launches in this process (the plain path never counts)
LAUNCHES_BWD = 0  # window_bwd launches


def _axis_intensity(sun: torch.Tensor, istep: torch.Tensor) -> torch.Tensor:
    """Face intensity per entry axis, [N, 3] (calcLightIntensity + the
    back-face rule, low_res.frag:242-252,368): the entry face normal is -step."""
    lam = sun[None, :] * -istep.to(torch.float32)
    return torch.where(lam > 0, torch.clamp(lam + 0.55, max=1.0), torch.full_like(lam, 0.3))


def window_plain(field, cell, tmax, istep, abs_delta, shape3, sun, S: int, shading: bool):
    """The kernels' plain PyTorch version: the same S-step recurrence and
    operation order, differentiable in ``field``, ``tmax`` and ``abs_delta``
    by autograd. Returns (surf [N,3], t_end, w_sum, t_exp).

    Rows are gathered from a float64 copy of the field and rounded back, so
    the values are the float32 ones while autograd sums the field gradient
    in float64: thousands of samples land on one surface cell, and the plain
    version is the yardstick the kernel's atomics are held to."""
    f32 = torch.float32
    dev = cell.device
    sun = torch.as_tensor(sun, dtype=f32, device=dev)
    field64 = field.double()
    tx, ty, tz = tmax.unbind(1)
    ax, ay, az = abs_delta.unbind(1)
    c = cell
    inten = _axis_intensity(sun, istep)
    entry = _argmin_axis(tmax - abs_delta).long()
    T = torch.ones_like(tx)
    acc = torch.zeros_like(tmax)
    ws = torch.zeros_like(tx)
    te = torch.zeros_like(tx)
    tc = torch.zeros_like(tx)
    t_cur = torch.zeros_like(tx)
    for _ in range(S):
        mx = (tx < ty) & (tx < tz)
        my = ~mx & (ty < tz)
        mz = ~(mx | my)
        tn = torch.where(mx, tx, torch.where(my, ty, tz))
        d = tn - t_cur
        # value max(d, 0); the gradient passes whole, as in the kernel
        dt = d + (torch.clamp(d, min=0.0) - d).detach()
        lin, inside = _window_lin(shape3, c)
        row = field64[lin].to(f32) * inside[:, None].to(f32)
        e = torch.exp(-row[:, 0] * dt)
        w = T * (1.0 - e)
        wi = w * torch.gather(inten, 1, entry[:, None])[:, 0] if shading else w
        acc = acc + wi[:, None] * row[:, 1:]
        ws = ws + w
        te = te + w * (tc + 0.5 * dt)
        tc = tc + dt
        T = T * e
        m3 = torch.stack([mx, my, mz], dim=1)
        entry = torch.where(mx, 0, torch.where(my, 1, 2)).long()
        c = torch.where(m3, c + istep, c)
        tx = torch.where(mx, tx + ax, tx)
        ty = torch.where(my, ty + ay, ty)
        tz = torch.where(mz, tz + az, tz)
        t_cur = tn
    return acc, T, ws, te


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"fused_window: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_window: {name} must be contiguous")


def _ray_args(field, cell, tmax, istep, abs_delta, shape3, sun, S, shading):
    """The launch arguments both kernels share, after checking every tensor."""
    dev = cell.device
    N = cell.shape[0]
    Sx, Sy, Sz = shape3
    i32, f32 = torch.int32, torch.float32
    _check(field, "field", f32, (Sx * Sy * Sz, 4), dev)
    for t, name in ((cell, "cell"), (tmax, "tmax"), (istep, "istep"), (abs_delta, "abs_delta")):
        _check(t, name, i32 if name in ("cell", "istep") else f32, (N, 3), dev)
    if N >= 2**31:
        raise ValueError(f"fused_window: {N} rays exceed the kernel's int32 ray index")
    return [field.data_ptr(), Sx, Sy, Sz, cell.data_ptr(), tmax.data_ptr(), istep.data_ptr(),
            abs_delta.data_ptr(), N, int(S), int(bool(shading)),
            float(sun[0]), float(sun[1]), float(sun[2])]


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.kernel_error_string(err).decode()}")


def _fwd_args(field, cell, tmax, istep, abs_delta, shape3, sun, S, shading):
    """(launch function, its arguments, (surf, t_end, w_sum, t_exp)) for one
    window_fwd launch on checked inputs."""
    from . import build

    args = _ray_args(field, cell, tmax, istep, abs_delta, shape3, sun, S, shading)
    lib = build.library("fused_window")
    N, dev = cell.shape[0], cell.device
    surf = torch.empty((N, 3), dtype=torch.float32, device=dev)
    t_end, w_sum, t_exp = (torch.empty(N, dtype=torch.float32, device=dev) for _ in range(3))
    outs = (surf, t_end, w_sum, t_exp)
    args += [t.data_ptr() for t in outs] + [_stream(dev)]
    return lib.window_fwd_launch, args, outs


def _launch_fwd(field, cell, tmax, istep, abs_delta, shape3, sun, S, shading):
    global LAUNCHES_FWD
    from . import build

    fn, args, outs = _fwd_args(field, cell, tmax, istep, abs_delta, shape3, sun, S, shading)
    _raise_on(build.library("fused_window"), fn(*args), "window_fwd")
    LAUNCHES_FWD += 1
    return outs


def _bwd_args(field, cell, tmax, istep, abs_delta, shape3, sun, S, shading,
              g_surf, g_tend, surf, t_end):
    """(launch function, its arguments, field gradient [V, 4], tmax cotangent
    [N, 3], abs_delta cotangent [N, 3], kept inputs) for one window_bwd
    launch on checked inputs, the gradient field zero-filled."""
    from . import build

    args = _ray_args(field, cell, tmax, istep, abs_delta, shape3, sun, S, shading)
    lib = build.library("fused_window")
    N, dev = cell.shape[0], cell.device
    _check(g_surf, "g_surf", torch.float32, (N, 3), dev)
    _check(surf, "surf", torch.float32, (N, 3), dev)
    for t, name in ((g_tend, "g_tend"), (t_end, "t_end")):
        _check(t, name, torch.float32, (N,), dev)
    grad = torch.zeros_like(field)  # Adam takes the dense gradient
    g_tmax = torch.empty((N, 3), dtype=torch.float32, device=dev)
    g_abs = torch.empty((N, 3), dtype=torch.float32, device=dev)
    args += [g_surf.data_ptr(), g_tend.data_ptr(), surf.data_ptr(), t_end.data_ptr(),
             grad.data_ptr(), g_tmax.data_ptr(), g_abs.data_ptr(), _stream(dev)]
    return lib.window_bwd_launch, args, grad, g_tmax, g_abs, (g_surf, g_tend, surf, t_end)


def _launch_bwd(field, cell, tmax, istep, abs_delta, shape3, sun, S, shading,
                g_surf, g_tend, surf, t_end):
    """-> (field gradient [V, 4], tmax cotangent [N, 3], abs_delta cotangent
    [N, 3]). The gradient field is zero-filled here on every call."""
    global LAUNCHES_BWD
    from . import build

    fn, args, grad, g_tmax, g_abs, _ = _bwd_args(field, cell, tmax, istep, abs_delta, shape3,
                                                 sun, S, shading, g_surf, g_tend, surf, t_end)
    _raise_on(build.library("fused_window"), fn(*args), "window_bwd")
    LAUNCHES_BWD += 1
    return grad, g_tmax, g_abs


def occupancy():
    """Blocks per SM and block size of window_fwd (its unrolled one-lane
    kernel, its split kernel below a wave, its generic loop) and window_bwd,
    from cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    import ctypes

    from . import build

    lib = build.library("fused_window")
    out = {}
    for which, name in ((0, "window_fwd"), (3, "window_fwd below a wave"),
                        (4, "window_fwd generic S"), (1, "window_bwd"),
                        (2, "window_bwd above a wave")):
        threads = ctypes.c_int(0)
        out[name] = lib.window_blocks_per_sm(which, ctypes.byref(threads))
        out[f"{name} threads"] = threads.value
    return out


class _WindowFn(torch.autograd.Function):
    """window_fwd forward, window_bwd backward. Gradients go to the packed
    field and to ``tmax`` / ``abs_delta``; ``cell`` and ``istep`` are integral,
    and ``w_sum`` / ``t_exp`` only feed the detached shadow hit point."""

    @staticmethod
    def forward(ctx, field, cell, tmax, istep, abs_delta, shape3, sun, S, shading):
        surf, t_end, w_sum, t_exp = _launch_fwd(field, cell, tmax, istep, abs_delta, shape3,
                                                sun, S, shading)
        ctx.save_for_backward(field, cell, tmax, istep, abs_delta, surf, t_end)
        ctx.cfg = (shape3, sun, S, shading)
        ctx.mark_non_differentiable(w_sum, t_exp)
        return surf, t_end, w_sum, t_exp

    @staticmethod
    def backward(ctx, g_surf, g_tend, _g_wsum, _g_texp):
        field, cell, tmax, istep, abs_delta, surf, t_end = ctx.saved_tensors
        g_surf = torch.zeros_like(surf) if g_surf is None else g_surf.contiguous()
        g_tend = torch.zeros_like(t_end) if g_tend is None else g_tend.contiguous()
        grad, g_tmax, g_abs = _launch_bwd(field, cell, tmax, istep, abs_delta, *ctx.cfg,
                                          g_surf, g_tend, surf, t_end)
        return grad, None, g_tmax, None, g_abs, None, None, None, None


def window_call(field, cell, tmax, istep, abs_delta, shape3, sun, S: int, shading: bool):
    """The window on a ray batch -> (surf [N,3], t_end, w_sum, t_exp). CPU
    tensors run ``window_plain``; CUDA tensors launch the kernels (or raise)."""
    dev = cell.device
    if field.device != dev:
        raise ValueError(f"fused_window: field on {field.device}, rays on {dev}")
    if dev.type == "cpu":
        return window_plain(field, cell, tmax, istep, abs_delta, shape3, sun, S, shading)
    if dev.type != "cuda":
        raise ValueError(f"fused_window: unsupported device {dev}")
    return _WindowFn.apply(field, cell, tmax, istep, abs_delta, tuple(shape3),
                           tuple(float(v) for v in sun), int(S), bool(shading))


def window_inputs(shape3, origin, dirs, start_t=None):
    """The reference preamble (:871-893): slab fast-forward to the grid, then
    the detached seed; miss seeds are parked at wrapped cell 1023, so every
    sample of their window lies outside the grid. Returns (origin_b, d, cell,
    tmax, istep, abs_delta), differentiable in ``origin`` and ``dirs``
    through origin_b, d, tmax and abs_delta."""
    origin_b, d, cell, tmax, step, abs_delta = _ray_start(shape3, origin, dirs, start_t,
                                                          park_misses=True)
    return (origin_b, d, cell.contiguous(), tmax.contiguous(), step.to(torch.int32).contiguous(),
            abs_delta.contiguous())


def _render_window(window, scene: DiffScene, origin, dirs, num_steps, sun_dir, sky, start_t,
                   shading, shadow_steps, return_aux):
    f32 = torch.float32
    dev = scene.device
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    N = dirs.shape[0]
    origin_b, d, cell, tmax, istep, abs_delta = window_inputs(scene.shape3, origin, dirs, start_t)
    sun_np = sun_unit(sun_dir)
    sun = torch.from_numpy(sun_np).to(dev)
    surf, t_end, w_sum, t_exp = window(_pack_fields(scene), cell, tmax, istep, abs_delta,
                                       scene.shape3, sun_np, int(num_steps), bool(shading))

    if shadow_steps:
        # soft sun shadow from the expected hit point, detached as in the
        # reference (:934-944)
        t_hit = t_exp / torch.clamp(w_sum, min=1e-8)
        ph = origin_b + t_hit.detach()[:, None] * d
        t_sun = transmittance(scene, ph.detach() + sun[None, :] * 0.75,
                              sun[None, :].expand(N, 3), num_steps=shadow_steps)
        surf = surf * (0.3 + 0.7 * t_sun)[:, None]

    rgb = surf
    if sky:
        rgb = rgb + t_end[:, None] * skybox(d, sun)
    if return_aux:
        return rgb, {
            "escaped": torch.zeros(N, dtype=torch.bool, device=dev), "n_escaped": 0,
            "t_end": t_end.detach(), "w_sum": w_sum.detach(), "grads_dropped": False,
        }
    return rgb


def render_window_fused(scene: DiffScene, origin, dirs, num_steps: int = 24,
                        sun_dir=(2.0, 1.0, 4.0), sky: bool = True, start_t=None,
                        shading: bool = False, shadow_steps: int = 0, return_aux: bool = False):
    """Volumetric S-step window render of arbitrary rays -> rgb [N, 3] (and aux
    with ``return_aux``). Differentiable w.r.t. ``scene.density``,
    ``scene.albedo``, ``origin`` and ``dirs``.

    ``start_t`` (f32[N], detached) seeds each ray's window; seeds at or above
    ``MISS_SEED_MIN`` render pure sky. ``shading`` applies the face intensity
    of each sample's entry axis in the kernel; ``shadow_steps > 0`` scales the
    surface term by 0.3 + 0.7 T_sun (soft shadow from the expected hit point).
    """
    return _render_window(window_call, scene, origin, dirs, num_steps, sun_dir, sky, start_t,
                          shading, shadow_steps, return_aux)


def render_window_plain(scene: DiffScene, origin, dirs, num_steps: int = 24,
                        sun_dir=(2.0, 1.0, 4.0), sky: bool = True, start_t=None,
                        shading: bool = False, shadow_steps: int = 0, return_aux: bool = False):
    """``render_window_fused`` with ``window_plain`` on any device: the plain
    version the kernels are held against on the card (chip_smoke.py)."""
    return _render_window(window_plain, scene, origin, dirs, num_steps, sun_dir, sky, start_t,
                          shading, shadow_steps, return_aux)



class _SumGradOverData(torch.autograd.Function):
    """The fields as they are forward; their gradients summed over the mesh's
    data axis backward (one all-reduce of both): the transpose of the
    reference's unmapped ``shard_map`` operand."""

    @staticmethod
    def forward(ctx, mesh, density, albedo):
        ctx.mesh = mesh
        return density.view_as(density), albedo.view_as(albedo)

    @staticmethod
    def backward(ctx, g_d, g_a):
        from ..parallel.mesh import DATA_AXIS

        g_d = torch.zeros_like(g_d) if g_d is None else g_d
        g_a = torch.zeros_like(g_a) if g_a is None else g_a
        flat = ctx.mesh.psum_(torch.cat([g_d.reshape(-1), g_a.reshape(-1)]), DATA_AXIS)
        n = g_d.numel()
        return None, flat[:n].view_as(g_d), flat[n:].view_as(g_a)


def render_window_fused_dp(scene: DiffScene, origin, dirs, mesh, num_steps: int = 24,
                           sun_dir=(2.0, 1.0, 4.0), sky: bool = True, start_t=None,
                           shading: bool = False, shadow_steps: int = 0):
    """Data-parallel window render (``render_window_fused_dp``, reference
    :1045): this rank's contiguous block of the rays (and of ``start_t``)
    through ``render_window_fused`` on the replicated fields. Returns the
    block's rgb [N / n_data, 3]. The field gradients are summed over the data
    axis in the backward (``_SumGradOverData``), as the reference's
    ``shard_map`` transpose sums them; a loss that is a mean divides by the
    rays itself. Raises when N does not split evenly over the data axis."""
    f32 = torch.float32
    dev = scene.device
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    dirs = mesh.block(torch.as_tensor(dirs, dtype=f32, device=dev))
    if origin.ndim == 2:
        origin = mesh.block(origin)
    if start_t is not None:
        start_t = mesh.block(torch.as_tensor(start_t, dtype=f32, device=dev))
    density, albedo = _SumGradOverData.apply(mesh, scene.density, scene.albedo)
    return render_window_fused(DiffScene(density, albedo), origin, dirs, num_steps=num_steps,
                               sun_dir=sun_dir, sky=sky, start_t=start_t, shading=shading,
                               shadow_steps=shadow_steps)
