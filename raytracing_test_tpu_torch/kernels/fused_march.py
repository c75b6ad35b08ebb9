"""Fused march: one CUDA launch runs the whole primary march and the sun
shadow of every ray (csrc/fused_march.cu).

Port of ``raytracing_test_tpu/kernels/fused_march.py``. ``fused_march_call``
returns the same per-ray dict as the reference's; ``render_rays_fused`` and
``render_image_fused`` feed it to the shared ``renderer.shade`` exactly as
the reference does (:869-902).

Dispatch is by the device of the tensors: CPU tensors run the plain PyTorch
version (render/fast.py), CUDA tensors launch the kernel or raise. There is
no fallback from one to the other. ``LAUNCHES`` counts kernel launches, so a
caller can show that a run went through the kernel; launches in the prox mode
(``prox=True``: the seed march that stops at the first entry into an
occupied 8^3 brick, the reference's ``prox_stop``) count in ``LAUNCHES_PROX``
instead. ``render_rays_fused_dp`` splits the rays over a mesh's data axis
(parallel/mesh.py): one launch per rank on its block.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties
from ..render import fast
from ..render.camera import Camera, ray_directions
from ..render.renderer import _build_ray, _get, _March, shade

LAUNCHES = 0  # kernel launches in this process (never incremented by the plain path)
LAUNCHES_PROX = 0  # kernel launches in the prox mode

_KMAX_MAT = 128


TILE_W, TILE_H = 8, 4  # pixels of one warp's tile when the rays form an image


def tile_order(width: int, height: int) -> torch.Tensor:
    """The ray that each thread of a tiled launch marches, -1 for none: warp
    w covers the TILE_W x TILE_H pixel tile (w % tiles_x, w // tiles_x) of
    the row-major ``width`` x ``height`` image, lane l its pixel
    (l % TILE_W, l // TILE_W). Tiles past the image's right and bottom edges
    hold no rays. The kernel computes the same map (csrc/fused_march.cu:
    ray_of)."""
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)
    j = torch.arange(tiles_x * tiles_y * 32)
    w, lane = j // 32, j % 32
    x = (w % tiles_x) * TILE_W + lane % TILE_W
    y = (w // tiles_x) * TILE_H + lane // TILE_W
    return torch.where((x < width) & (y < height), y * width + x, torch.full_like(j, -1))


def fused_march_plain(scene: Scene, s: _March, cfg: RenderConfig, time_s,
                      prox: bool = False) -> Dict[str, torch.Tensor]:
    """The kernel's plain PyTorch version: fast_march, then the shadow march
    on the lanes that ``shade`` reads it on. ``mat0`` is the start cell's
    real material in the prox mode too."""
    _check_prox(cfg, prox)
    s, raw0, mat0 = fast.start_cell(scene, s)
    s, _ = fast.fast_march(scene, s, cfg, cfg.max_steps, shadow=False, time_s=time_s, prox=prox)
    shad = torch.zeros_like(raw0)
    if cfg.enable_shadows:
        sun = torch.from_numpy(fast.sun_unit(cfg.sun_dir)).to(s.dir.device)
        facing = sun[s.last_axis.long()] * -_get(s.step, s.last_axis) > 0
        active = (s.mat != 0) & facing & ~s.reflected & ~raw0
        p = s.seg_origin + s.last_t[:, None] * s.dir
        shad = fast._shadow_march_fast(scene, p, s.cell, s.last_axis, s.step, cfg, sun, active)
    return {
        "mat0": mat0, "mat": s.mat, "cell": s.cell, "la": s.last_axis,
        "refl": s.reflected, "shad": shad, "steps": s.steps, "dir": s.dir,
        "step": s.step, "seg_origin": s.seg_origin, "lt": s.last_t,
        "color_mod": s.color_mod,
    }


def _check_prox(cfg: RenderConfig, prox: bool):
    if prox and (cfg.enable_materials or cfg.enable_shadows):
        raise ValueError("fused_march: prox is a seed mode of the lean march "
                         "(materials and shadows off)")


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"fused_march: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_march: {name} must be contiguous")


_MODES = {"lean": 0, "materials": 1, "shadows": 2, "full": 3, "prox": 4}


def occupancy() -> Dict[str, int]:
    """Blocks per SM of the kernel each mode launches (and its block size),
    from cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    from . import build

    lib = build.library("fused_march")
    out = {f"march {k}": lib.fused_march_blocks_per_sm(v) for k, v in _MODES.items()}
    out["march threads"] = lib.fused_march_threads()
    return out


def _launch_args(scene: Scene, s: _March, cfg: RenderConfig, time_s: float, prox: bool,
                 image_w: int):
    """(launch function, its arguments, outputs, inputs kept alive) for one
    launch on checked inputs."""
    from . import build

    lib = build.library("fused_march")
    dev = s.cell.device
    N = s.cell.shape[0]
    i32, f32 = torch.int32, torch.float32
    Sx, Sy, Sz = scene.shape3
    _check(scene.grid_enc, "grid_enc", torch.uint8, (Sx, Sy, Sz), dev)
    march_grid = scene.grid_enc
    if prox:
        march_grid = scene.prox_enc
        _check(march_grid, "prox_enc", torch.uint8, (Sx, Sy, Sz), dev)
    _check(scene.flags, "flags", i32, scene.flags.shape, dev)
    if scene.flags.ndim != 1 or scene.flags.shape[0] > _KMAX_MAT:
        raise ValueError(f"fused_march: flags must be 1-D with <= {_KMAX_MAT} entries")
    ins = [s.cell, s.tmax, s.dir, s.step, s.abs_delta, s.seg_origin]
    names = ["cell", "tmax", "dir", "step", "abs_delta", "seg_origin"]
    for t, name in zip(ins, names):
        _check(t, name, i32 if name == "cell" else f32, (N, 3), dev)
    if image_w < 0 or (image_w and N % image_w):
        raise ValueError(f"fused_march: {N} rays are no image {image_w} wide")

    out = {
        "mat0": torch.empty(N, dtype=i32, device=dev),
        "mat": torch.empty(N, dtype=i32, device=dev),
        "cell": torch.empty((N, 3), dtype=i32, device=dev),
        "la": torch.empty(N, dtype=i32, device=dev),
        "refl": torch.empty(N, dtype=i32, device=dev),
        "shad": torch.empty(N, dtype=i32, device=dev),
        "steps": torch.empty(N, dtype=i32, device=dev),
        "dir": torch.empty((N, 3), dtype=f32, device=dev),
        "step": torch.empty((N, 3), dtype=f32, device=dev),
        "seg_origin": torch.empty((N, 3), dtype=f32, device=dev),
        "lt": torch.empty(N, dtype=f32, device=dev),
        "color_mod": torch.empty((N, 3), dtype=f32, device=dev),
    }
    sun = fast.sun_unit(cfg.sun_dir)
    args = [
        scene.grid_enc.data_ptr(), march_grid.data_ptr(), int(prox),
        scene.flags.data_ptr(), scene.flags.shape[0],
        Sx, Sy, Sz, int(scene.y_max),
        int(cfg.max_steps), int(cfg.shadow_steps),
        int(cfg.enable_materials), int(cfg.enable_shadows),
        float(time_s), float(sun[0]), float(sun[1]), float(sun[2]),
        *[t.data_ptr() for t in ins],
        N, int(image_w),
        *[t.data_ptr() for t in out.values()],
        torch.cuda.current_stream(dev).cuda_stream,
    ]
    return lib.fused_march_launch, args, out, (ins, march_grid)


def _launch(scene: Scene, s: _March, cfg: RenderConfig, time_s, prox: bool,
            image_w: int) -> Dict[str, torch.Tensor]:
    global LAUNCHES, LAUNCHES_PROX
    from . import build

    fn, args, out, _ = _launch_args(scene, s, cfg, time_s, prox, image_w)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"fused_march kernel launch failed: "
            f"{build.library('fused_march').kernel_error_string(err).decode()}"
        )
    if prox:
        LAUNCHES_PROX += 1
    else:
        LAUNCHES += 1
    out["refl"] = out["refl"] != 0
    out["shad"] = out["shad"] != 0
    return out


def fused_march_call(scene: Scene, s: _March, cfg: RenderConfig, time_s=None,
                     prox: bool = False, image_w: int = 0) -> Dict[str, torch.Tensor]:
    """Run the fused march on a ``fast._init_state`` state ``s``.

    Returns the per-ray dict of the reference ``fused_march_call`` (:793-804):
    mat0, mat, cell, la, refl, shad, steps, dir, step, seg_origin, lt,
    color_mod. CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise). ``prox`` is the reference's ``prox_stop`` (lean
    configs only): each ray stops at its first entry into an occupied 8^3
    brick, with ``mat`` 1 where that cell is air. ``image_w`` > 0 says the
    rays are a row-major image that wide: the kernel then marches them in
    8x4 pixel tiles per warp (the outputs are the same).
    """
    _check_prox(cfg, prox)
    if time_s is None:
        time_s = cfg.time
    dev = s.cell.device
    if scene.device != dev:
        raise ValueError(f"fused_march: scene on {scene.device}, rays on {dev}")
    if dev.type == "cpu":
        return fused_march_plain(scene, s, cfg, time_s, prox)
    if dev.type != "cuda":
        raise ValueError(f"fused_march: unsupported device {dev}")
    return _launch(scene, s, cfg, float(time_s), prox, image_w)


def render_rays_fused(scene: Scene, origin, dirs, cfg: RenderConfig, start_t=None, time_s=None,
                      prox: bool = False, image_w: int = 0):
    """Fused-march render of arbitrary rays -> (rgb [N,3], aux), shaded by the
    shared ``renderer.shade`` on the kernel's outputs (``prox``, ``image_w``:
    see ``fused_march_call``)."""
    f32 = torch.float32
    dev = scene.device
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    N = dirs.shape[0]
    if time_s is None:
        time_s = cfg.time

    s = fast._init_state(origin, dirs, torch.ones(N, dtype=f32, device=dev), start_t=start_t)
    return shade_outputs(scene, fused_march_call(scene, s, cfg, time_s, prox, image_w), cfg)


def shade_outputs(scene: Scene, o: Dict[str, torch.Tensor], cfg: RenderConfig):
    """``renderer.shade`` on a ``fused_march_call`` dict -> (rgb [N,3], aux)."""
    f32 = torch.float32
    dev = scene.device
    N = o["mat"].shape[0]
    mat0 = o["mat0"]
    raw0 = (mat0 != 0) & ((scene.flags[mat0.long()] & int(Properties.REFRACTIVE)) == 0)
    _, _, _, abs_delta = _build_ray(o["dir"])
    state = _March(
        mat=o["mat"],
        cell=o["cell"],
        dir=o["dir"],
        step=o["step"],
        abs_delta=abs_delta,
        tmax=torch.zeros((N, 3), dtype=f32, device=dev),
        seg_origin=o["seg_origin"],
        last_t=o["lt"],
        last_axis=o["la"],
        color_mod=o["color_mod"],
        ior=torch.ones(N, dtype=f32, device=dev),
        reflected=o["refl"],
        done=torch.ones(N, dtype=torch.bool, device=dev),
        steps=o["steps"],
    )
    sun = torch.from_numpy(fast.sun_unit(cfg.sun_dir)).to(dev)
    shad = o["shad"]
    return shade(scene, state, raw0, mat0, sun, cfg,
                 lambda p, cell, la, step, active: shad & active)


def render_image_fused(scene: Scene, camera: Camera, cfg: RenderConfig, time_s=None):
    """Full frame [H, W, 3] through the fused march, crosshair included."""
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, _ = render_rays_fused(scene, camera.pos, dirs, cfg, time_s=time_s, image_w=cfg.width)
    return fast.crosshair(col.reshape(cfg.height, cfg.width, 3), cfg)


@torch.no_grad()
def render_rays_fused_dp(scene: Scene, origin, dirs, cfg: RenderConfig, mesh, time_s=None,
                         image_hw=None):
    """Data-parallel fused render (``render_rays_fused_dp``, reference :967):
    each rank marches its contiguous block of the rays through
    ``render_rays_fused`` on its own device, then ``col``, ``hit`` and
    ``hit_pos`` are gathered over the mesh's data axis, in natural ray order,
    on every rank. Returns (col [N, 3], {"hit", "hit_pos"}), equal to the
    single-device render: the rays are independent.

    ``image_hw`` (H, W): the rays are a row-major image, and a rank whose
    block is whole rows launches it in the kernel's 8x4 warp tiles
    (``image_w``), as ``render_image_fused`` does. The reference's 64x64
    block permutation is a TPU layout the port leaves out (ROADMAP.md,
    item 12). Raises when N does not split evenly over the data axis."""
    from ..parallel.mesh import DATA_AXIS

    f32 = torch.float32
    dev = mesh.device
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    N = dirs.shape[0]
    block = mesh.block(dirs)
    image_w = 0
    if image_hw is not None:
        H, W = image_hw
        if H * W != N:
            raise ValueError(f"render_rays_fused_dp: {N} rays are no {H}x{W} image")
        image_w = W if block.shape[0] % W == 0 else 0
    o = origin if origin.ndim == 1 else mesh.block(origin)
    col, aux = render_rays_fused(scene, o, block, cfg, time_s=time_s, image_w=image_w)
    return mesh.all_gather(col, DATA_AXIS), {
        "hit": mesh.all_gather(aux["hit"], DATA_AXIS),
        "hit_pos": mesh.all_gather(aux["hit_pos"], DATA_AXIS),
    }


@torch.no_grad()
def hit_seeds(scene: Scene, origin, dirs, cfg: RenderConfig, margin: float, start_t=None,
              prox: bool = False):
    """Window seeds from one lean march: ``margin`` cells before each ray's
    first solid hit (with ``prox``, its first occupied 8^3 brick), or the 1e6
    sky sentinel (``render/diff.py`` MISS_SEED_MIN)."""
    from ..render.progressive import seeds_from_hits

    _, aux = render_rays_fused(scene, origin, dirs, cfg, start_t=start_t, prox=prox)
    o = torch.as_tensor(origin, dtype=torch.float32, device=scene.device)
    return seeds_from_hits(aux, o, margin, start_t)


def seed_depth_fused(scene: Scene, origin, dirs, image_hw, coarse_factor: int = 4,
                     margin: float = 3.0, prox: bool = False, max_steps: int = None):
    """Window-seed depths from the fused march (``seed_depth_fused``,
    ``raytracing_test_tpu/kernels/fused_march.py:905``): a 1/coarse_factor
    resolution lean march seeds a full-resolution lean march whose
    first-solid depths, less ``margin``, become the window seeds (1e6 = sky;
    ``progressive.guided_seeds``).

    ``prox``: both passes stop at the first entry into an occupied 8^3 brick
    (the march's prox mode), so a seed may lie short of the surface; the
    caller patches the rays whose window then ends unsaturated
    (``render/diff.py:render_rays_guided_prox``). Use a small ``margin``
    (0.5) with it.
    """
    from ..render import progressive

    def march(sc, o, d, cfg, start_t=None):
        # with image_hw, each pass marches one row-major image cfg.width wide,
        # in warp tiles; a prox pass (about 3 trips a ray) is set by its
        # stores, which natural order keeps whole
        tiled = image_hw is not None and not prox
        return render_rays_fused(sc, o, d, cfg, start_t=start_t, prox=prox,
                                 image_w=cfg.width if tiled else 0)

    return progressive.guided_seeds(march, scene, origin, dirs, margin, image_hw, coarse_factor,
                                    max_steps)
