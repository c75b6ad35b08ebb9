"""PyTorch port: the fused-march wrapper against the Pallas kernel, and its
dispatch rules (no silent fallback, launch counting, no JAX import).

The CUDA kernel itself only runs on a card (``python3 chip_smoke.py`` holds it
against the plain version there). Here the wrapper's CPU path is held
against the TPU kernel run in Pallas interpret mode, as tests/test_fused.py
runs it.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_test_tpu.config import RenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.kernels import fused_march as jfm
from raytracing_test_tpu.render.camera import Camera as JCamera, ray_directions as jrays
from raytracing_test_tpu.worldgen import terrain
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.kernels import build, fused_march as tfm
from raytracing_test_tpu_torch.render import fast as tfast
from tests.test_render_parity import assert_images_close

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def terrain_world():
    grid, pal = terrain.gen_world_grid(WorldConfig(width=48, length=48, grid_shape=(64, 64, 64)))
    return grid, pal


def test_fused_cpu_matches_pallas_kernel_interpret(terrain_world):
    grid, pal = terrain_world
    js = jflat.scene_from_grid(grid, pal)
    ft = jfm.tables_for_scene(js)
    ts = tflat.scene_from_grid(grid, pal, "cpu")
    rcfg = RenderConfig(width=16, height=16, max_steps=150, shadow_steps=40)
    jc = JCamera(pos=jnp.asarray([24.0, 45.0, -8.0], jnp.float32),
                 dir=jnp.asarray([0.25, -0.65, 0.9], jnp.float32))
    dirs = jrays(jc, rcfg.width, rcfg.height)
    want, jaux = jax.jit(lambda t: jfm.render_rays_fused(
        js, ft, jc.pos, dirs, rcfg, time_s=t, interpret=True))(jnp.float32(0.4))

    launches = tfm.LAUNCHES
    got, taux = tfm.render_rays_fused(ts, torch.tensor([24.0, 45.0, -8.0]),
                                      torch.from_numpy(np.array(dirs)), rcfg, time_s=0.4)
    assert tfm.LAUNCHES == launches  # CPU tensors never launch the kernel
    hw = (rcfg.height, rcfg.width, 3)
    assert_images_close(got.numpy().reshape(hw), np.asarray(want).reshape(hw))
    np.testing.assert_array_equal(taux["mat"].numpy(), np.asarray(jaux["mat"]))
    hit = np.asarray(jaux["hit"])
    assert hit.any()
    np.testing.assert_array_equal(taux["cell"].numpy()[hit], np.asarray(jaux["cell"])[hit])


def test_fused_call_returns_reference_keys(terrain_world):
    grid, pal = terrain_world
    ts = tflat.scene_from_grid(grid, pal, "cpu")
    dirs = torch.nn.functional.normalize(torch.tensor([[0.3, -0.5, 0.8]] * 4), dim=1)
    s = tfast._init_state(torch.tensor([24.0, 45.0, -8.0]), dirs, torch.ones(4))
    o = tfm.fused_march_call(ts, s, RenderConfig(), 0.0)
    assert set(o) == {"mat0", "mat", "cell", "la", "refl", "shad", "steps", "dir", "step",
                      "seg_origin", "lt", "color_mod"}
    assert o["refl"].dtype == o["shad"].dtype == torch.bool
    assert o["cell"].shape == (4, 3) and o["cell"].dtype == torch.int32


def test_no_silent_fallback_off_cpu(terrain_world):
    """A tensor that is not on the CPU launches the kernel or raises; it is
    never routed to the plain version."""
    grid, pal = terrain_world
    meta = torch.device("meta")
    ts = tflat.scene_from_grid(grid, pal, "cpu")
    ms = tflat.Scene(*(t.to(meta) for t in (ts.grid_enc, ts.macro, ts.albedo, ts.flags,
                                             ts.metadata)), y_max=ts.y_max)
    s = tfast._init_state(torch.zeros(3, device=meta), torch.ones((4, 3), device=meta),
                          torch.ones(4, device=meta))
    launches = tfm.LAUNCHES
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.fused_march_call(ms, s, RenderConfig(), 0.0)
    with pytest.raises(ValueError, match="scene on"):
        tfm.fused_march_call(ts, s, RenderConfig(), 0.0)
    assert tfm.LAUNCHES == launches


def test_cuda_device_raises_without_a_card(terrain_world):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; chip_smoke.py covers the launch")
    from raytracing_test_tpu_torch.app import cli

    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["--device", "cuda", "--world", "16", "--width", "8", "--height", "8",
                  "render", "--out", os.devnull])
    assert tfm.LAUNCHES == 0


def test_build_raises_without_nvcc_and_caches_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    for name in ("fused_march", "fused_window", "brick_march"):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.library(name)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()
    assert build._LIBS == {}
    assert not (tmp_path / "build").exists()


def test_port_never_imports_jax(tmp_path):
    """Importing every port module and chip_smoke.py, then rendering and
    editing through the CLI, loads neither JAX nor any module of the JAX
    package."""
    script = tmp_path / "edit.txt"
    script.write_text(f"look 55 -25; place; delete; render {tmp_path / 'e.png'}; "
                      f"save {tmp_path / 'w.npz'}\n")
    code = (
        "import importlib, os, pkgutil, sys\n"
        "import raytracing_test_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from raytracing_test_tpu_torch.app import cli\n"
        "cli.main(['--device', 'cpu', '--world', '16', '--width', '8', '--height', '8',\n"
        "          'render', '--out', os.devnull])\n"
        "cli.main(['--device', 'cpu', '--world', '16', '--width', '8', '--height', '8',\n"
        f"          'edit', {str(script)!r}])\n"
        f"assert os.path.exists({str(tmp_path / 'w.npz')!r})\n"
        "assert len(mods) >= 20, mods\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'raytracing_test_tpu')\n"
        "             or k.startswith(('jax.', 'raytracing_test_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_never_name_the_jax_package():
    """A static scan: no import of ``raytracing_test_tpu`` in the port's sources or
    chip_smoke.py, function-local imports included."""
    pat = re.compile(r"raytracing_test_tpu\.|from raytracing_test_tpu import|import raytracing_test_tpu\b(?!_)")
    pkg = os.path.join(REPO, "raytracing_test_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith((".py", ".cu"))
    ]
    assert len(paths) >= 20
    found = [(p, i + 1, line.strip()) for p in paths
             for i, line in enumerate(open(p).read().splitlines()) if pat.search(line)]
    assert not found, found
