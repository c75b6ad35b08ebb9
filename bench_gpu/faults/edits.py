"""Faults planted under the edit loop's timed path (``drivers/edits.py``);
see ``faults/fit.py`` for what they serve.

    unchanged_state   an edit call changes nothing in the world
    altered_answer    a tile of each frame is altered where the frame is
                      produced
"""

from __future__ import annotations

import contextlib

from faults._patch import altered_frames, patched

FAULTS = ("unchanged_state", "altered_answer")


def plant(fault: str):
    from raytracing_test_tpu_torch.app.session import WorldSession

    if fault == "altered_answer":
        return altered_frames()
    if fault == "unchanged_state":
        stack = contextlib.ExitStack()
        stack.enter_context(patched(WorldSession, "delete", lambda self: self.pick().pos))
        stack.enter_context(patched(WorldSession, "place",
                                    lambda self, slot=None: self.pick().last_pos))
        return stack
    raise ValueError(f"the edit loop has no fault {fault!r}")
