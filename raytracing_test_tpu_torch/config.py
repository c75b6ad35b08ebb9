"""Configuration dataclasses.

The reference keeps every knob as a compile-time constant (world size/seeds in
world_gen.cpp:8-17, step limits in low_res.frag:310/382, FOV in main.cpp:94,
maxDepth in tetrahexa_tree.hpp:6). Here they are first-class runtime config.

This port's own copy of ``raytracing_test_tpu/config.py``: the port imports nothing of
the JAX package. The arithmetic is unchanged, so worlds and palettes
come out bit for bit the same (tests/test_torch_host.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class WorldConfig:
    """Terrain generation parameters (ref: src/world_gen.cpp)."""

    width: int = 200  # columns along x (ref WIDTH)
    length: int = 200  # columns along z (ref LENGTH)
    seeds: Tuple[int, int, int] = (42, 64, 100)  # three noise octaves
    octave_freqs: Tuple[float, float, float] = (0.005, 0.05, 0.1)
    octave_amps: Tuple[float, float, float] = (30.0, 5.0, 3.0)
    base_height: int = 32
    water_level: int = 20
    include_init_blocks: bool = True  # the 8 smoke-test blocks from
    # initTetraHexaTree (tetrahexa_tree.cpp:20-27) are part of the reference's
    # startup world; keep them for parity.
    # Dense device-grid window over the 1024^3 address space, anchored at the
    # origin. Content outside the window exists in the sparse tree but is not
    # renderable (the only reference content out of a 256-wide window is the
    # (1000,1000,1000)^3 smoke block, unreachable within the 300-step march
    # budget from any camera near the terrain).
    grid_shape: Tuple[int, int, int] = (256, 128, 256)  # y=128 keeps the
    # floating smoke block at (10,100,10) renderable


@dataclass(frozen=True)
class CameraConfig:
    """Camera state (ref: src/globals.cpp:20-21 defaults)."""

    pos: Tuple[float, float, float] = (35.0, 50.0, 35.0)
    # The reference's initial dir (1,0,1) is unnormalized; input.cpp rebuilds it
    # normalized from yaw/pitch on the first mouse move. We store it as given and
    # normalize at use, matching the shader's arithmetic.
    dir: Tuple[float, float, float] = (1.0, 0.0, 1.0)


@dataclass(frozen=True)
class RenderConfig:
    """Render kernel parameters (ref: src/shaders/low_res.frag)."""

    width: int = 1024
    height: int = 1024
    max_steps: int = 300  # primary+material march budget (low_res.frag:310)
    shadow_steps: int = 75  # shadow ray budget (low_res.frag:382)
    fov_degrees: float = 90.0  # projPlaneSize = tan(fov/2) (main.cpp:94)
    sun_dir: Tuple[float, float, float] = (2.0, 1.0, 4.0)  # normalized at use
    # (ref: globals.cpp:23)
    time: float = 0.0  # animation clock for the water surface (deltaTime uniform)
    enable_shadows: bool = True
    enable_materials: bool = True  # reflection/refraction state machine
    ao_rays: int = 20  # hemisphere AO budget (light_scattering.frag:226)
    ao_steps: int = 5
    enable_ao: bool = False  # the reference pass is compiled but never drawn
    # interactive overlays (ref: low_res.frag:259-262, 347-350)
    looking_at: Tuple[int, int, int] = (-(1 << 30),) * 3  # disabled sentinel
    mouse_px: Tuple[float, float] = (-1e9, -1e9)
    crosshair: bool = False
    dtype: str = "float32"


@dataclass(frozen=True)
class FitConfig:
    """Inverse-rendering (gradient fit) parameters."""

    views: int = 32
    steps: int = 200
    lr: float = 0.05
    resolution: int = 256
    # surface-guided sampling against a periodically re-thresholded occupancy
    # guide built from the evolving density (parallel/sharding.py)
    guided: bool = False
    rethreshold_every: int = 50
    guide_tau: float = 1.0
    guided_steps: int = 24  # volumetric window length when guided
    # training engine: "" = the annotation-sharded XLA steps (guided flag
    # picks windowed vs blind), "fused" = the Pallas engine pair (fused
    # march seeds + fused window renders/accumulates — the headline step,
    # parallel/sharding.make_train_step_fused)
    engine: str = ""
    shading: bool = False  # fit face-shaded targets (the hard renderer's
    # output IS face-shaded; shading=True matches the volumetric model to it)


def world_for_size(n: int, height: int = 128) -> WorldConfig:
    """WorldConfig for an n x n column world with a fitting grid window
    (BASELINE configs 1-4 scale: 64..512). The window is padded to the next
    multiple of 64 up to the 1024 address-space limit."""
    ext = min(((max(n, 16) + 63) // 64) * 64, 1024)
    return WorldConfig(width=n, length=n, grid_shape=(ext, height, ext))


DEFAULT_WORLD = WorldConfig()
DEFAULT_CAMERA = CameraConfig()
DEFAULT_RENDER = RenderConfig()

__all__ = [
    "WorldConfig",
    "CameraConfig",
    "RenderConfig",
    "FitConfig",
    "replace",
    "DEFAULT_WORLD",
    "DEFAULT_CAMERA",
    "DEFAULT_RENDER",
]
