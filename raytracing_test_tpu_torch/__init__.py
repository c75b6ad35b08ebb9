"""raytracing_test_tpu_torch — the voxel raytracer in PyTorch + CUDA.

A port of ``raytracing_test_tpu`` (JAX/XLA/Pallas, the reference package) to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper. Module names mirror
the reference package so each counterpart is easy to find:

    config.py, core/types.py, core/color.py, core/tree.py, worldgen/,
    app/picking.py         copies of the reference's JAX-free host modules
    core/flatten.py        Scene of tensors (prox_enc built at first use),
                           scene_from_grid, scene_from_jax
    render/camera.py       Camera, ray_directions
    render/renderer.py     DDA helpers, material_step, shade
    render/fast.py         the plain (pure PyTorch) march: the march kernel's twin
    render/diff.py         DiffScene, field gathers, transmittance,
                           render_rays_diff_guided, render_rays_guided_prox
    render/progressive.py  seed_from_depth, guided_seeds
    kernels/fused_march.py wrapper around csrc/fused_march.cu (full, lean and
                           prox modes); seed_depth_fused
    kernels/fused_window.py wrapper around csrc/fused_window.cu (window
                           forward/backward), render_window_fused, window_plain
    kernels/build.py       builds csrc/*.cu with nvcc at first use
    parallel/sharding.py   FitParams, guide, make_train_step_fused (through
                           render_rays_diff_guided; make_train_step_guided
                           is its other name), one device
    app/fit.py, app/checkpoint.py  fit_world (fused, guided), npz checkpoints
    app/cli.py             render / animate / fit verbs

This package imports nothing of ``raytracing_test_tpu`` and never imports
``jax``.
"""

__version__ = "0.2.0"
