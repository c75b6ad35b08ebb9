"""Faults planted under the fit's timed path (``drivers/fit.py``), for the
tests that show a run then reads ``correct`` false
(``tests/test_bench_faults.py``) and for the readings that set the limits
(``calibrate.py``). ``plant(fault)`` is a context manager that patches the
program while it is open.

    unchanged_state   Adam's step does nothing
    half_batch        each step renders the first half of its batch and
                      takes the mean over it
    stale_guide       every guide rebuild returns the fit's first guide
    altered_answer    the seed march's answer for the first 1/32 of each
                      batch lies 2 cells further on
"""

from __future__ import annotations

import torch

from faults._patch import patched

FAULTS = ("unchanged_state", "half_batch", "stale_guide", "altered_answer")


def plant(fault: str):
    from raytracing_test_tpu_torch.parallel import sharding
    from raytracing_test_tpu_torch.render import progressive

    if fault == "unchanged_state":
        return patched(torch.optim.Adam, "step", lambda self, closure=None: None)
    if fault == "stale_guide":
        rebuild = sharding.guide_scene_from_params
        first = []

        def stale(*a, **kw):
            if not first:
                first.append(rebuild(*a, **kw))
            return first[0]
        return patched(sharding, "guide_scene_from_params", stale)
    if fault == "altered_answer":
        seeds = progressive.guided_seeds

        def altered(*a, **kw):
            out = seeds(*a, **kw).clone()
            n = max(1, out.shape[0] // 32)
            out[:n] = torch.where(out[:n] < 9.9e5, out[:n] + 2.0, out[:n])
            return out
        return patched(progressive, "guided_seeds", altered)
    if fault == "half_batch":
        make = sharding.make_train_step_fused

        def make_half(*a, **kw):
            step = make(*a, **kw)

            def half(origins, dirs, targets, guide=None):
                n = origins.shape[0] // 2
                return step(origins[:n], dirs[:n], targets[:n], guide=guide)
            return half
        return patched(sharding, "make_train_step_fused", make_half)
    raise ValueError(f"the fit has no fault {fault!r}")
