"""Faults planted under the viewer's timed path (``drivers/frames.py``);
see ``faults/fit.py`` for what they serve.

    unchanged_state   every frame is the loop's first frame again
    altered_answer    a tile of each frame is altered where the frame is
                      produced
"""

from __future__ import annotations

from faults._patch import altered_frames, patched

FAULTS = ("unchanged_state", "altered_answer")


def plant(fault: str):
    from raytracing_test_tpu_torch.app.session import WorldSession

    if fault == "altered_answer":
        return altered_frames()
    if fault == "unchanged_state":
        render = WorldSession.render
        first = {}

        def stale(self, *a, **kw):
            img = render(self, *a, **kw)
            return first.setdefault(id(self), img)
        return patched(WorldSession, "render", stale)
    raise ValueError(f"the viewer has no fault {fault!r}")
