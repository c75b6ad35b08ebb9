"""The capped Chebyshev distance of a u8 grid on its own device
(csrc/chebyshev.cu), for building a Scene where its grid lives.

``distance(grid, cap)`` gives, for each cell of each [X, Y, Z] volume of
``grid`` (u8 [..., X, Y, Z]; leading dimensions are a batch of volumes),
min(cap, the L-inf distance to the nearest nonzero cell of its volume), with
cells outside the volume counted as empty: what
``core/flatten.py:chebyshev_distance_field`` computes for the brick fields
(cap 8). With ``licence=True`` (one volume, cap 32) it gives ``grid_enc``
instead: a nonzero cell keeps its value, a zero cell holds 128 + 2^j, 2^j the
largest power of two at most its distance, as ``build_grid_enc`` does.

It takes three passes, one along each axis (z, then y, then x), each u8 in
and u8 out: D_a(p) = min over |k| <= cap of max(|k|, D(p + k e_a)). The
licence is fused into the last pass. CPU tensors run the plain version
``distance_plain``, the same passes in PyTorch; CUDA tensors launch the
kernel, once a pass, or raise. ``LAUNCHES`` counts kernel launches (never the
plain path).
"""

from __future__ import annotations

import math

import torch

from . import build

LAUNCHES = 0  # cheb_pass launches in this process (never the plain path)
MAX_CAP = 32  # grid_enc's cap: its largest licence is 32 (_air_licences)


def _views(shape):
    """(O, L, I) of the z, y and x passes over a contiguous [..., X, Y, Z]."""
    *batch, X, Y, Z = shape
    n = math.prod(batch)
    return ((n * X * Y, Z, 1), (n * X, Y, Z), (n, X, Y * Z))


def _licence_of(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """grid_enc from the distance ``d`` (cap 32) and the id grid ``ids``."""
    pow2 = torch.ones_like(d)
    for j in range(1, 6):
        pow2 = torch.where(d >= (1 << j), torch.full_like(d, 1 << j), pow2)
    return torch.where(ids != 0, ids, pow2 + 128)


def distance_plain(grid: torch.Tensor, cap: int, licence: bool = False) -> torch.Tensor:
    """The kernel's passes in PyTorch (see the module docstring)."""
    d = torch.where(grid != 0, torch.zeros_like(grid), torch.full_like(grid, cap))
    for axis in (-1, -2, -3):
        n = d.shape[axis]
        out = d.clone()
        for r in range(1, min(cap, n)):
            # out[l] = min(out[l], max(r, d[l + r])), and the same with d[l - r]
            near, far = out.narrow(axis, 0, n - r), d.narrow(axis, r, n - r)
            near.copy_(torch.minimum(near, far.clamp(min=r)))
            near, far = out.narrow(axis, r, n - r), d.narrow(axis, 0, n - r)
            near.copy_(torch.minimum(near, far.clamp(min=r)))
        d = out
    return _licence_of(d, grid) if licence else d


def _check(grid: torch.Tensor, cap: int, licence: bool) -> None:
    if grid.dtype != torch.uint8 or grid.dim() < 3:
        raise ValueError(f"chebyshev: grid must be u8 [..., X, Y, Z], got {grid.dtype} "
                         f"{tuple(grid.shape)}")
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"chebyshev: cap must be in [1, {MAX_CAP}], got {cap}")
    if licence and (cap != MAX_CAP or grid.dim() != 3):
        raise ValueError("chebyshev: the licence pass takes one volume at cap 32")


def distance(grid: torch.Tensor, cap: int, licence: bool = False) -> torch.Tensor:
    """u8 [..., X, Y, Z] -> u8 of the same shape (module docstring)."""
    global LAUNCHES
    _check(grid, cap, licence)
    if grid.device.type == "cpu":
        return distance_plain(grid, cap, licence)
    if grid.device.type != "cuda":
        raise ValueError(f"chebyshev: unsupported device {grid.device}")
    lib = build.library("chebyshev")
    grid = grid.contiguous()
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    a, b = torch.empty_like(grid), torch.empty_like(grid)
    # z: grid -> a, y: a -> b, x: b -> a (with the ids in licence mode)
    passes = zip(_views(grid.shape), (grid, a, b), (a, b, a))
    for k, ((O, L, I), src, dst) in enumerate(passes):
        last = k == 2
        err = lib.cheb_pass_launch(src.data_ptr(), dst.data_ptr(),
                                   grid.data_ptr() if licence and last else None,
                                   O, L, I, cap, int(k == 0), int(licence and last), stream)
        if err != 0:
            raise RuntimeError(f"cheb_pass kernel launch failed: "
                               f"{lib.kernel_error_string(err).decode()}")
        LAUNCHES += 1
    return a
