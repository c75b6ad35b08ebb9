"""raytracing_test_tpu_torch — the voxel raytracer's render path in PyTorch + CUDA.

A port of ``raytracing_test_tpu`` (JAX/XLA/Pallas, the reference package) to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper. Module names mirror
the reference package so each counterpart is easy to find:

    core/flatten.py        Scene of tensors, scene_from_grid, scene_from_jax
    render/camera.py       Camera, ray_directions
    render/renderer.py     DDA helpers, material_step, shade
    render/fast.py         the plain (pure PyTorch) march: the kernel's twin
    kernels/fused_march.py wrapper around csrc/fused_march.cu
    kernels/build.py       builds csrc/*.cu with nvcc at first use
    app/cli.py             render / animate verbs

Host-only modules with no JAX dependency (config, worldgen, core.tree,
core.color, core.types, app.picking) are imported from the reference package.
This package never imports ``jax``.
"""

__version__ = "0.1.0"
