"""Continuous voxel fields and the differentiable renders, in PyTorch.

Port of ``raytracing_test_tpu/render/diff.py``: the field container
(``DiffScene``, :49), its construction from a hard grid (:56), the field
gathers (:67, :80), the blind volumetric scan ``render_rays_diff`` (:105),
the window render ``render_rays_diff_window`` (:322) with its two crossing
enumerators (:190, :225), the surface-guided render
``render_rays_diff_guided`` (:455), the prox-seeded render with its exact
patch-up ``render_rays_guided_prox`` (:553), the soft sun-shadow primitive
``transmittance`` (:666), differentiable hemisphere AO ``ao_diff`` (:693) and
``render_image_diff`` (:713). The window on the window kernel pair is
``kernels/fused_window.py:render_window_fused``.

The blind scan, ``render_rays_diff_window`` and ``ao_diff`` are PyTorch
operations on the device of the scene, as they are XLA operations in the
reference. The scan keeps the reference's arithmetic step by step; each of
its steps gathers one packed [V, 4] row per ray, and the gradients of all
the steps' gathers land in one [V, 4] buffer (``_ScanField``) rather than in
a zero [V, 4] tensor per step that autograd then sums. ``remat`` recomputes
each step in the backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does.

``render_rays_diff_window``'s ``accum`` engines ``"dedup"`` and ``"scatter"``
are the same plain row gather here, differentiated by autograd, and give the
same values: the reference's sort-based dedup VJP is a TPU workaround. The
gather reads a float64 copy of the fields, so the field gradient is summed
in float64 while every value stays the float32 one. The guided render routes
every ``accum`` to the window kernel pair; ``render_rays_diff_window`` is the
XLA-style anchor that pair is held to.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import RenderConfig
from .camera import Camera, ray_directions
from .fast import sun_unit
from .hemisphere import sample_hemisphere
from .renderer import _argmin_axis, _build_ray, _get, _init_tmax, _onehot, skybox

# Guided seeds at/above this value are the "no surface" sentinel (the guided
# path seeds misses with 1e6): window renders treat such rays as pure sky.
MISS_SEED_MIN = 9.9e5
WINDOW_ACCUMS = ("dedup", "scatter")
ENUMERATE_MODES = ("scan", "vec")


@dataclass(frozen=True)
class DiffScene:
    """Continuous voxel fields over the grid window (origin-anchored)."""

    density: torch.Tensor  # f32 [Sx, Sy, Sz] >= 0
    albedo: torch.Tensor  # f32 [Sx, Sy, Sz, 3]

    @property
    def shape3(self):
        return tuple(self.density.shape)

    @property
    def device(self) -> torch.device:
        return self.density.device


def diff_scene_from_grid(grid, albedo_table, device, solid_density: float = 1e4) -> DiffScene:
    """Hard material grid -> continuous fields (solid voxels get a large
    density so the volumetric render matches the hard first-hit limit)."""
    g = np.asarray(grid)
    density = np.where(g > 0, solid_density, 0.0).astype(np.float32)
    albedo = np.asarray(albedo_table)[g]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return DiffScene(put(density), put(albedo))


def _window_lin(shape3, cell):
    """(row index, inside) of integer cells in the flattened field. Cells wrap
    &1023; outside the window a sample reads row 0, masked by ``inside``."""
    Sx, Sy, Sz = shape3
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    return torch.where(inside, lin, torch.zeros_like(lin)).long(), inside


def _gather_fields(scene: DiffScene, cell):
    """Density and albedo at integer cells; air outside the window/wrap."""
    lin, inside = _window_lin(scene.shape3, cell)
    sigma = scene.density.reshape(-1)[lin]
    alb = scene.albedo.reshape(-1, 3)[lin]
    z = inside.to(sigma.dtype)
    return sigma * z, alb * z[:, None]


def _pack_fields(scene: DiffScene):
    """[V, 4] rows of (sigma, r, g, b): one 16-byte row per sample."""
    return torch.cat([scene.density.reshape(-1, 1), scene.albedo.reshape(-1, 3)], dim=1)


def _ray_start(shape3, origin, dirs, start_t=None, park_misses: bool = False):
    """The preamble of the scan and the windows (reference :123-145,
    :385-406): slab fast-forward to the grid box, then the detached seed.
    With ``park_misses`` (the windows) rays seeded at or above
    ``MISS_SEED_MIN`` start at wrapped cell 1023, outside the grid, so they
    render pure sky; the blind scan starts them where the seed puts them, as
    the reference does. Returns (origin_b, d, cell, tmax, step, abs_delta),
    differentiable in ``origin`` and ``dirs`` through origin_b, d, tmax and
    abs_delta."""
    f32 = torch.float32
    dev = dirs.device
    N = dirs.shape[0]
    Sx, Sy, Sz = shape3
    if origin.ndim == 1:
        origin = origin[None, :].expand(N, 3)
    d, step, delta, abs_delta = _build_ray(dirs)
    hi = torch.tensor([Sx, Sy, Sz], dtype=f32, device=dev)
    t1 = (0.0 - origin) * delta
    t2 = (hi[None, :] - origin) * delta
    t_entry = torch.amax(torch.minimum(t1, t2), dim=1)
    t0 = torch.clamp(t_entry - 1e-3, min=0.0)
    dead = None
    if start_t is not None:
        st = torch.as_tensor(start_t, dtype=f32, device=dev).detach()
        t0 = torch.maximum(t0, st)
        if park_misses:
            dead = st >= MISS_SEED_MIN
    origin_b = origin + t0[:, None] * d
    cell = torch.floor(origin_b).to(torch.int32)
    if dead is not None:
        cell = torch.where(dead[:, None], torch.full_like(cell, 1023), cell)
    tmax = _init_tmax(origin_b, cell, step, delta, abs_delta)
    return origin_b, d, cell, tmax, step, abs_delta


class _ScanField:
    """The packed field's gradient for one blind scan. Each step's row gather
    (``_TakeRows``) adds its rows' cotangents into one [V, 4] buffer, made at
    the first backward step; ``_FieldToken`` hands that buffer to the packed
    field once every step's gather is done. Autograd's own gather would give
    each step a zero [V, 4] gradient and add it into the total: a 134 MB fill
    and read-modify-write per step on the default world."""

    def __init__(self, packed: torch.Tensor):
        self.field = packed.detach()
        self.grad = None

    def add(self, lin, g):
        if self.grad is None:
            self.grad = torch.zeros_like(self.field)
        self.grad.index_add_(0, lin, g)

    def take(self):
        grad, self.grad = self.grad, None
        return torch.zeros_like(self.field) if grad is None else grad


class _FieldToken(torch.autograd.Function):
    """packed -> a scalar the scan's gathers depend on. Its backward runs
    after all of theirs and returns the buffer they filled."""

    @staticmethod
    def forward(ctx, packed, acc):
        ctx.acc = acc
        return packed.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        return ctx.acc.take(), None


class _TakeRows(torch.autograd.Function):
    """One step's row gather; its backward adds into the scan's buffer."""

    @staticmethod
    def forward(ctx, token, lin, acc):
        ctx.save_for_backward(lin)
        ctx.acc = acc
        return acc.field.index_select(0, lin)

    @staticmethod
    def backward(ctx, g):
        (lin,) = ctx.saved_tensors
        ctx.acc.add(lin, g)
        return g.new_zeros(()), None, None


def _row_taker(packed):
    """The scan's per-step row gather ``take(lin) -> packed[lin]``: through
    ``_TakeRows`` (one gradient buffer for the whole scan) when ``packed``
    is differentiated, else a plain ``index_select``."""
    if not (packed.requires_grad and torch.is_grad_enabled()):
        return partial(packed.index_select, 0)
    acc = _ScanField(packed)
    token = _FieldToken.apply(packed, acc)
    return lambda lin: _TakeRows.apply(token, lin, acc)


def _gather_packed(take, shape3, cell):
    """(sigma [N], albedo [N, 3]) at integer cells through the row gather
    ``take(lin)``; air outside the window/wrap."""
    lin, inside = _window_lin(shape3, cell)
    row = take(lin)
    z = inside.to(row.dtype)[:, None]
    row = row * z
    return row[:, 0], row[:, 1:]


def _scan_step(take, shape3, istep, abs_delta, cell, tmax, t_cur, trans, rgb):
    """One step of the blind scan (reference :157-169)."""
    ax = _argmin_axis(tmax)
    oh = _onehot(ax, tmax.dtype)
    t_next = _get(tmax, ax)
    # jnp.maximum's gradient: split in half at a tie, as torch.maximum's
    dt = torch.maximum(t_next - t_cur, t_next.new_zeros(()))
    sigma, alb = _gather_packed(take, shape3, cell)
    alpha = 1.0 - torch.exp(-sigma * dt)
    rgb = rgb + (trans * alpha)[:, None] * alb
    trans = trans * (1.0 - alpha)
    return cell + oh.to(torch.int32) * istep, tmax + oh * abs_delta, t_next, trans, rgb


def render_rays_diff(scene: DiffScene, origin, dirs, num_steps: int = 192,
                     sun_dir=(2.0, 1.0, 4.0), sky: bool = True, start_t=None, remat=None):
    """Volumetric render of arbitrary rays -> rgb f32[N, 3]: ``num_steps``
    DDA crossings from the grid box (the blind scan). Differentiable w.r.t.
    ``scene.density``, ``scene.albedo``, ``origin`` and ``dirs``.

    ``start_t`` (f32[N], no gradient) fast-forwards rays before the scan —
    surface-guided sampling; cells skipped that way get no gradient.
    ``remat`` (default: ``num_steps > 48``) recomputes each step in the
    backward instead of keeping its intermediates, as the reference's
    ``jax.checkpoint`` over the scan body does; the values are the same.
    """
    f32 = torch.float32
    dev = scene.device
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    N = dirs.shape[0]
    shape3 = scene.shape3
    _, d, cell, tmax, step, abs_delta = _ray_start(shape3, origin, dirs, start_t)
    istep = step.to(torch.int32)

    body = partial(_scan_step, _row_taker(_pack_fields(scene)), shape3, istep, abs_delta)
    if remat is None:
        remat = num_steps > 48
    remat = remat and torch.is_grad_enabled()
    carry = (cell, tmax, torch.zeros(N, dtype=f32, device=dev),
             torch.ones(N, dtype=f32, device=dev), torch.zeros((N, 3), dtype=f32, device=dev))
    for _ in range(num_steps):
        if remat:
            carry = checkpoint(body, *carry, use_reentrant=False, preserve_rng_state=False)
        else:
            carry = body(*carry)
    trans, rgb = carry[3], carry[4]

    if sky:
        sun = torch.from_numpy(sun_unit(sun_dir)).to(dev)
        rgb = rgb + trans[:, None] * skybox(d, sun)
    return rgb


def _enumerate_window(shape3, origin_b, d, step, abs_delta, cell, tmax, num_steps):
    """The next ``num_steps`` DDA crossings without any field access (reference
    :190): (lin [N, S], inside [N, S], dt [N, S], ax_in [N, S]) — the visited
    cell's row, its window membership, the in-cell segment length and the
    axis the ray entered the cell through. ``dt`` carries the ``tmax`` /
    ``abs_delta`` gradients; the cells are integral."""
    istep = step.to(torch.int32)
    # entry axis of the first cell: the most recent crossing before the seed
    ax_in = _argmin_axis(tmax - abs_delta)
    t_cur = torch.zeros_like(tmax[:, 0])
    lins, insides, dts, axes = [], [], [], []
    for _ in range(num_steps):
        ax = _argmin_axis(tmax)
        oh = _onehot(ax, tmax.dtype)
        t_next = _get(tmax, ax)
        dt = torch.maximum(t_next - t_cur, t_next.new_zeros(()))
        lin, inside = _window_lin(shape3, cell)
        lins.append(lin)
        insides.append(inside)
        dts.append(dt)
        axes.append(ax_in)
        cell = cell + oh.to(torch.int32) * istep
        tmax = tmax + oh * abs_delta
        t_cur, ax_in = t_next, ax
    stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
    return stack(lins), stack(insides), stack(dts), stack(axes)


def _enumerate_window_vec(shape3, origin_b, d, step, abs_delta, cell, tmax, num_steps):
    """Scan-free twin of ``_enumerate_window`` (reference :225): the crossing
    sequence is the merge of three arithmetic progressions t0_ax + n * a_ax,
    so every step's (cell, dt, entry axis) has a closed form, found by
    ranking the merged order over [N, S] at once.

    Ranks compare the closed-form values exactly (division candidates are
    corrected by direct comparison) with the reference's tie priority
    z > y > x (``renderer._argmin_axis``). A closed-form value t0 + n * a
    can differ by ulps from the scan's accumulated one, so near-tie rays may
    enumerate another valid order; forward and backward use one enumeration.
    """
    f32, i32 = d.dtype, torch.int32
    dev = cell.device
    N = cell.shape[0]
    S = num_steps
    Sx, Sy, Sz = shape3
    istep = step.to(i32)
    ax0 = _argmin_axis(tmax - abs_delta)

    ns = torch.arange(S, dtype=f32, device=dev)[None, None, :]  # [1, 1, S]
    vals = tmax.T[:, :, None] + ns * abs_delta.T[:, :, None]  # [3, N, S]

    def count_before(tA, A, B):
        """#{m >= 0 : t0_B + m * a_B strictly before key (tA, axis A)}; tA [N, S]."""
        t0b = tmax[:, B][:, None]
        ab = abs_delta[:, B][:, None]
        # clamped before the conversion: XLA's float -> int32 saturates
        q = torch.clamp(torch.floor((tA - t0b) / ab), -1, S + 1).to(i32)
        qf = q.to(f32)
        q = torch.where(t0b + qf * ab >= tA, q - 1, q)
        qf = q.to(f32)
        q = torch.where(t0b + qf * ab >= tA, q - 1, q)
        qf = q.to(f32)
        q = torch.where(t0b + (qf + 1.0) * ab < tA, q + 1, q)
        cnt = torch.clamp(q + 1, 0, S)
        if B > A:  # equal keys: the higher axis steps first (the reference's tie-break)
            tie = t0b + cnt.to(f32) * ab == tA
            cnt = torch.where(tie & (cnt < S), cnt + 1, cnt)
        return cnt

    ss = torch.arange(S, dtype=i32, device=dev)[None, None, :]  # [1, 1, S_out]
    nA = []  # crossings of each axis taken before step s, [N, S_out]
    for A in range(3):
        r = torch.arange(S, dtype=i32, device=dev)[None, :].expand(N, S)
        for B in range(3):
            if B != A:
                r = r + count_before(vals[A], A, B)
        nA.append((r[:, :, None] < ss).sum(dim=1).to(i32))
    c = [cell[:, k][:, None] + nA[k] * istep[:, k][:, None] for k in range(3)]
    wx, wy, wz = (ck & 1023 for ck in c)
    inside = (wx < Sx) & (wy < Sy) & (wz < Sz)
    lin = torch.where(inside, (wx * Sy + wy) * Sz + wz, torch.zeros_like(wx)).long()

    # value and axis of the s-th crossing (s >= 1): the latest taken per axis
    def last_t(A):
        n = nA[A]
        return torch.where(n > 0, tmax[:, A][:, None] + (n - 1).to(f32) * abs_delta[:, A][:, None],
                           torch.full_like(ns[0], -3e38))

    lx, ly, lz = last_t(0), last_t(1), last_t(2)
    t_s = torch.maximum(lx, torch.maximum(ly, lz))  # [N, S_out]; s = 0 -> -3e38
    # tie priority z > y > x: the highest axis reaching the maximum
    ax_s = torch.where(lz == t_s, 2, torch.where(ly == t_s, 1, 0)).to(i32)
    ax_in = torch.where(ss[0] == 0, ax0[:, None], ax_s)

    # t(s+1): the next crossing, the least of each axis's next value
    nxt = [tmax[:, k][:, None] + nA[k].to(f32) * abs_delta[:, k][:, None] for k in range(3)]
    nxt = torch.minimum(torch.minimum(nxt[0], nxt[1]), nxt[2])
    t_prev = torch.where(ss[0] == 0, torch.zeros_like(t_s), t_s)
    dt = torch.maximum(nxt - t_prev, nxt.new_zeros(()))
    return lin, inside, dt, ax_in


def render_rays_diff_window(scene: DiffScene, origin, dirs, num_steps: int = 24,
                            sun_dir=(2.0, 1.0, 4.0), sky: bool = True, start_t=None,
                            accum: str = "dedup", shading: bool = False, shadow_steps: int = 0,
                            enumerate_mode: str = "scan"):
    """The window render as PyTorch operations (reference :322): the
    ``num_steps`` crossings from each ray's seed are enumerated without field
    access (``enumerate_mode`` ``"scan"``: the DDA loop; ``"vec"``: closed-form
    ranks), all window cells are fetched in one row gather, and the composite
    is exp-of-cumsum over [N, S]. Differentiable w.r.t. the fields, ``origin``
    and ``dirs``. Seeds at or above ``MISS_SEED_MIN`` render pure sky.

    ``accum`` ``"dedup"`` and ``"scatter"`` run the same plain row gather,
    differentiated by autograd (the field gradient summed in float64), and
    give the same values. ``shading``
    multiplies each segment's albedo by the face intensity of its entry axis;
    ``shadow_steps > 0`` scales the surface term by 0.3 + 0.7 T_sun, the
    transmittance toward the sun from the expected hit point."""
    if accum not in WINDOW_ACCUMS:
        raise ValueError(f"unknown accum {accum!r} (choose from {', '.join(WINDOW_ACCUMS)})")
    if enumerate_mode not in ENUMERATE_MODES:
        raise ValueError(f"unknown enumerate_mode {enumerate_mode!r} "
                         f"(choose from {', '.join(ENUMERATE_MODES)})")
    f32 = torch.float32
    dev = scene.device
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    N, S = dirs.shape[0], int(num_steps)
    origin_b, d, cell, tmax, step, abs_delta = _ray_start(scene.shape3, origin, dirs, start_t,
                                                          park_misses=True)
    enum = _enumerate_window_vec if enumerate_mode == "vec" else _enumerate_window
    lin, inside, dt, ax_in = enum(scene.shape3, origin_b, d, step, abs_delta, cell, tmax, S)

    # rows gathered from a float64 copy and rounded back: the values are the
    # float32 ones, while autograd sums the field gradient in float64 (a
    # surface cell takes thousands of samples at 1024^2; float32 atomics
    # there drift by 1e-5 of the largest gradient)
    rows = (_pack_fields(scene).double().index_select(0, lin.reshape(-1)).to(f32)
            .reshape(N, S, 4))
    z = inside.to(f32)
    sigma = rows[:, :, 0] * z
    alb = rows[:, :, 1:] * z[:, :, None]

    sun = torch.from_numpy(sun_unit(sun_dir)).to(dev)
    if shading:
        # the entry face's normal is -step on ax_in; lam = sun . normal
        ax_l = ax_in.long()
        lam = sun[ax_l] * -torch.gather(step, 1, ax_l)
        intensity = torch.where(lam > 0, torch.clamp(lam + 0.55, max=1.0),
                                torch.full_like(lam, 0.3))
        alb = alb * intensity[:, :, None]

    od = sigma * dt  # per-segment optical depth
    tau = torch.cat([torch.zeros((N, 1), dtype=f32, device=dev), torch.cumsum(od[:, :-1], dim=1)],
                    dim=1)
    T = torch.exp(-tau)
    w = T * (1.0 - torch.exp(-od))
    surf = (w[:, :, None] * alb).sum(dim=1)

    if shadow_steps > 0:
        # expected hit point: weight-averaged segment midpoints, detached
        t_mid = torch.cumsum(dt, dim=1) - 0.5 * dt
        t_hit = (w * t_mid).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1e-8)
        p = origin_b + t_hit.detach()[:, None] * d
        t_sun = transmittance(scene, p.detach() + sun[None, :] * 0.75, sun[None, :].expand(N, 3),
                              num_steps=shadow_steps)
        surf = surf * (0.3 + 0.7 * t_sun)[:, None]

    rgb = surf
    if sky:
        T_end = torch.exp(-(tau[:, -1] + od[:, -1]))
        rgb = rgb + T_end[:, None] * skybox(d, sun)
    return rgb


def transmittance(scene: DiffScene, origins, dirs, num_steps: int = 8):
    """Volumetric transmittance along short rays — the differentiable
    occlusion primitive (no colour accumulation). origins/dirs: f32[N,3]."""
    d, step, delta, abs_delta = _build_ray(dirs)
    cell = torch.floor(origins).to(torch.int32)
    tmax = _init_tmax(origins, cell, step, delta, abs_delta)
    istep = step.to(torch.int32)
    t_cur = torch.zeros_like(tmax[:, 0])
    trans = torch.ones_like(t_cur)
    for _ in range(num_steps):
        ax = _argmin_axis(tmax)
        oh = _onehot(ax, tmax.dtype)
        t_next = _get(tmax, ax)
        dt = torch.clamp(t_next - t_cur, min=0.0)
        sigma, _ = _gather_fields(scene, cell)
        trans = trans * torch.exp(-sigma * dt)
        cell = cell + oh.to(torch.int32) * istep
        tmax = tmax + oh * abs_delta
        t_cur = t_next
    return trans


def ao_diff(scene: DiffScene, points, normals, generator: torch.Generator, n_rays: int = 20,
            num_steps: int = 5):
    """Differentiable hemisphere ambient occlusion in [0, 1], shape [N]
    (reference :693): ``n_rays`` cosine-weighted directions a point, drawn
    from ``generator`` (on the points' device), and soft transmittance over
    ``num_steps`` crossings instead of binary hits, so occlusion
    differentiates w.r.t. the density field."""
    N = points.shape[0]
    dirs = sample_hemisphere(generator, normals, n_rays).reshape(N * n_rays, 3)
    starts = torch.repeat_interleave(points + normals * 1e-2, n_rays, dim=0)
    trans = transmittance(scene, starts, dirs, num_steps=num_steps)
    return 1.0 - trans.reshape(N, n_rays).mean(dim=1)


def render_image_diff(scene: DiffScene, camera: Camera, cfg: RenderConfig, num_steps: int = 192):
    """The blind scan of a camera's image -> rgb [H, W, 3] (reference :713)."""
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    rgb = render_rays_diff(scene, camera.pos, dirs, num_steps=num_steps, sun_dir=cfg.sun_dir)
    return rgb.reshape(cfg.height, cfg.width, 3)


GUIDED_ACCUMS = ("dedup", "scatter", "fused")


def render_rays_diff_guided(scene: DiffScene, hard_scene, origin, dirs, num_steps: int = 24,
                            margin: float = 3.0, sun_dir=(2.0, 1.0, 4.0), sky: bool = True,
                            image_hw=None, coarse_factor: int = 4, window: bool = True,
                            accum: str = "dedup", engine: str = "fast", shading: bool = False,
                            shadow_steps: int = 0):
    """Surface-guided differentiable render (reference :455): a lean hard
    march on ``hard_scene`` (not differentiated) finds each ray's first solid
    depth, then the ``num_steps`` window starts ``margin`` cells before it.

    ``engine``: ``"fast"`` marches with the fused march (its kernel on the
    card, ``render/fast.py`` on the CPU), ``"bricks"`` / ``"bricks-pallas"``
    with the brick engine. Every ``accum`` renders the window on the window
    kernel pair; ``window=False`` runs the blind scan (``render_rays_diff``)
    from the seeds instead, without shading. ``image_hw=(H, W)`` seeds the
    hard march from a 1/coarse_factor depth pass, as the reference does.
    """
    from ..kernels import brick_kernels, fused_march
    from ..kernels.fused_window import render_window_fused
    from .progressive import guided_seeds

    if engine == "fast":
        hard_render = fused_march.render_rays_fused
    elif engine in ("bricks", "bricks-pallas"):
        hard_render = brick_kernels.render_rays_bricks_pallas
    else:
        raise ValueError(f"unknown engine {engine!r}")
    if accum not in GUIDED_ACCUMS:
        raise ValueError(f"unknown accum {accum!r} (choose from {', '.join(GUIDED_ACCUMS)})")
    if not window and (shading or shadow_steps):
        raise ValueError("shading requires the window path")
    seed = guided_seeds(hard_render, hard_scene, origin, dirs, margin, image_hw, coarse_factor)
    if not window:
        return render_rays_diff(scene, origin, dirs, num_steps=num_steps, sun_dir=sun_dir,
                                sky=sky, start_t=seed)
    return render_window_fused(scene, origin, dirs, num_steps=num_steps, sun_dir=sun_dir,
                               sky=sky, start_t=seed, shading=shading,
                               shadow_steps=shadow_steps)


def render_rays_guided_prox(scene: DiffScene, hard_scene, origin, dirs, image_hw,
                            num_steps: int = 24, margin: float = 0.5, sun_dir=(2.0, 1.0, 4.0),
                            coarse_factor: int = 4, patch_div: int = 64, sat_eps: float = 1e-3,
                            shading: bool = False, shadow_steps: int = 0,
                            return_aux: bool = False):
    """Prox-seeded window render with an exact, compacted patch-up
    (reference :553; its ``tables`` and ``interpret`` arguments are TPU
    matters and are dropped). ``sky=False``.

    The seed march stops at the first entry into an occupied 8^3 brick
    (``seed_depth_fused(prox=True)``). Rays whose window then ends
    unsaturated (transmittance > ``sat_eps``) and is not sky are patched:
    taken in 8-ray groups, the first ``max((N // patch_div) // 8, 16)``
    groups in ray order, re-marched exactly from the prox seed (margin 3)
    and re-windowed. The patched rows replace the first window's out of
    place, so the first window gets no cotangent there. Rays beyond the
    budget keep the first window's values and gradients; aux says so:
    ``n_need``, ``n_escaped`` (0: the window has no escapes),
    ``patch_capacity`` and ``grads_dropped``.
    """
    from ..kernels.fused_march import hit_seeds, seed_depth_fused
    from ..kernels.fused_window import render_window_fused

    f32 = torch.float32
    dev = scene.device
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    N = dirs.shape[0]
    if N % 8:
        raise ValueError(f"render_rays_guided_prox: {N} rays are not 8-ray groups")
    seed = seed_depth_fused(hard_scene, origin, dirs, image_hw, coarse_factor=coarse_factor,
                            margin=margin, prox=True)
    rgb, waux = render_window_fused(scene, origin, dirs, num_steps=num_steps, sun_dir=sun_dir,
                                    sky=False, start_t=seed, shading=shading,
                                    shadow_steps=shadow_steps, return_aux=True)

    need = (waux["t_end"] > sat_eps) & (seed < MISS_SEED_MIN)
    need8 = need.reshape(-1, 8).any(dim=1)
    n_need, n_need8 = int(need.sum()), int(need8.sum())
    K8 = max((N // patch_div) // 8, 16)
    idx8 = torch.nonzero(need8)[:K8, 0]
    idx = (idx8[:, None] * 8 + torch.arange(8, device=dev)[None, :]).reshape(-1)
    kept = idx[need[idx]]
    if kept.numel():
        ob = origin if origin.ndim == 2 else origin[None, :].expand(N, 3)
        sub_o, sub_d = ob[kept], dirs[kept]
        lean = RenderConfig(width=1, height=kept.numel(), enable_materials=False,
                            enable_shadows=False)
        seed2 = hit_seeds(hard_scene, sub_o, sub_d, lean, margin=3.0, start_t=seed[kept])
        rgb2 = render_window_fused(scene, sub_o, sub_d, num_steps=num_steps, sun_dir=sun_dir,
                                   sky=False, start_t=seed2, shading=shading,
                                   shadow_steps=shadow_steps)
        rgb = rgb.index_put((kept,), rgb2)
    if return_aux:
        return rgb, {"n_need": n_need, "n_escaped": 0, "patch_capacity": K8 * 8,
                     "grads_dropped": n_need8 > K8}
    return rgb
