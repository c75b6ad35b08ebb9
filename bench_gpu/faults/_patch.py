"""What the drivers' fault files share: a patch that holds while its
context is open, and a frame with one tile altered."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name`` is ``value`` while the context is open."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def altered(img: torch.Tensor) -> torch.Tensor:
    """The frame with a top-left tile of side max(8, width / 32) brightened."""
    side = max(8, img.shape[1] // 32)
    img = img.clone()
    img[:side, :side] += 0.5
    return img


def altered_frames():
    """Every fused frame altered where it is produced
    (``fused_march.render_image_fused``)."""
    from raytracing_test_tpu_torch.kernels import fused_march

    render = fused_march.render_image_fused
    return patched(fused_march, "render_image_fused", lambda *a, **kw: altered(render(*a, **kw)))
