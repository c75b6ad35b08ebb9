"""Faults planted under the timed path, for the tests that show a run then
reads ``correct`` false (``tests/test_bench_faults.py``) and for the
readings that set the limits (``calibrate.py``). Each is a context manager
that patches the program while it is open.

    unchanged_state   fit: Adam's step does nothing; edits: an edit call
                      changes nothing in the world; frames: every frame is
                      the loop's first frame again
    half_batch        fit: each step renders the first half of its batch and
                      takes the mean over it
    stale_guide       fit: every guide rebuild returns the fit's first guide
    altered_answer    fit: the seed march's answer for the first 1/32 of each
                      batch lies 2 cells further on; frames and edits: a
                      tile of each frame is altered where the frame is
                      produced
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = {
    "fit": ("unchanged_state", "half_batch", "stale_guide", "altered_answer"),
    "frames": ("unchanged_state", "altered_answer"),
    "edits": ("unchanged_state", "altered_answer"),
}


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _alter(img: torch.Tensor) -> torch.Tensor:
    """The frame with a top-left tile of side max(8, width / 32) brightened."""
    side = max(8, img.shape[1] // 32)
    img = img.clone()
    img[:side, :side] += 0.5
    return img


def plant(driver: str, fault: str):
    """The context manager that plants ``fault`` for ``driver``'s path."""
    from raytracing_test_tpu_torch.app.session import WorldSession
    from raytracing_test_tpu_torch.kernels import fused_march
    from raytracing_test_tpu_torch.parallel import sharding
    from raytracing_test_tpu_torch.render import progressive

    if fault not in FAULTS[driver]:
        raise ValueError(f"{driver} has no fault {fault!r}")
    if driver == "fit" and fault == "unchanged_state":
        return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)
    if driver == "fit" and fault == "stale_guide":
        rebuild = sharding.guide_scene_from_params
        first = []

        def stale(*a, **kw):
            if not first:
                first.append(rebuild(*a, **kw))
            return first[0]
        return _patched(sharding, "guide_scene_from_params", stale)
    if driver == "fit" and fault == "altered_answer":
        seeds = progressive.guided_seeds

        def altered(*a, **kw):
            out = seeds(*a, **kw).clone()
            n = max(1, out.shape[0] // 32)
            out[:n] = torch.where(out[:n] < 9.9e5, out[:n] + 2.0, out[:n])
            return out
        return _patched(progressive, "guided_seeds", altered)
    if driver == "fit":
        make = sharding.make_train_step_fused

        def make_half(*a, **kw):
            step = make(*a, **kw)

            def half(origins, dirs, targets, guide=None):
                n = origins.shape[0] // 2
                return step(origins[:n], dirs[:n], targets[:n], guide=guide)
            return half
        return _patched(sharding, "make_train_step_fused", make_half)
    if fault == "altered_answer":
        render = fused_march.render_image_fused
        return _patched(fused_march, "render_image_fused", lambda *a, **kw: _alter(render(*a, **kw)))
    if driver == "edits":
        stack = contextlib.ExitStack()
        stack.enter_context(_patched(WorldSession, "delete", lambda self: self.pick().pos))
        stack.enter_context(_patched(WorldSession, "place",
                                     lambda self, slot=None: self.pick().last_pos))
        return stack
    render = WorldSession.render
    first = {}

    def stale(self, *a, **kw):
        img = render(self, *a, **kw)
        return first.setdefault(id(self), img)
    return _patched(WorldSession, "render", stale)
