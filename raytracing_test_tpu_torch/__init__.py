"""raytracing_test_tpu_torch — the voxel raytracer in PyTorch + CUDA.

A port of ``raytracing_test_tpu`` (JAX/XLA/Pallas, the reference package) to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper. Module names mirror
the reference package so each counterpart is easy to find:

    config.py, core/types.py, core/color.py, core/tree.py, worldgen/,
    app/picking.py, utils/log.py   copies of the reference's JAX-free host modules
    native/                C++ tree + worldgen (a copy of the reference's),
                           built with g++ into _build/ at first use
    core/flatten.py        Scene of tensors (prox_enc built at first use),
                           scene_from_grid, scene_from_jax
    core/mirror.py         SceneMirror: dirty 8^3 bricks -> local boxes built
                           and written on the Scene's device
    render/camera.py       Camera, ray_directions
    render/hemisphere.py   the Fibonacci AO table, tangent frames, sampling
    render/renderer.py     DDA helpers, material_step, shade (AO included),
                           the reference march render_rays / render_jit
    render/fast.py         the plain (pure PyTorch) march: the march kernel's twin
    render/diff.py         DiffScene, field gathers, transmittance,
                           render_rays_diff_guided, render_rays_guided_prox
    render/progressive.py  coarse_depth, render_image_progressive,
                           seed_from_depth, guided_seeds
    render/bricks.py       the brick path's plain version
    kernels/fused_march.py wrapper around csrc/fused_march.cu (full, lean and
                           prox modes); seed_depth_fused
    kernels/fused_window.py wrapper around csrc/fused_window.cu (window
                           forward/backward), render_window_fused, window_plain
    kernels/brick_kernels.py wrapper around csrc/brick_march.cu
    kernels/build.py       builds csrc/*.cu with nvcc at first use
    parallel/sharding.py   FitParams, guide, make_train_step_fused (through
                           render_rays_diff_guided; make_train_step_guided
                           is its other name), one device
    utils/profiling.py     FrameStats, phase, trace (torch.profiler)
    app/session.py         WorldSession: tree, grid, mirror, camera, edits,
                           render modes
    app/debug.py           debug channels, probe_pixel
    app/fit.py, app/checkpoint.py  fit_world (fused, guided), npz worlds and
                           fit checkpoints
    app/cli.py             render / animate / edit / fit / probe verbs

This package imports nothing of ``raytracing_test_tpu`` and never imports
``jax``.
"""

__version__ = "0.2.0"
