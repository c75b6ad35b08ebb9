"""Share of the window launch pair's roofline: the summed bound of the
counted steps' ``window_fwd`` + ``window_bwd`` launches
(``roofline/window.py``) over their summed device time in the trace. The
window launches of the first steps of the traced window are the counted
steps' (one pair a step)."""

import harness


def read(run):
    bounds = run.records.get("window_bound_s")
    n_fwd, n_bwd = run.records.get("window_launches", (0, 0))
    if not bounds or n_fwd != run.records["steps"] or n_bwd != run.records["steps"]:
        return None
    fwd = harness.kernel_times(run, "window_fwd")[:len(bounds)]
    bwd = harness.kernel_times(run, "window_bwd")[:len(bounds)]
    if len(fwd) < len(bounds) or len(bwd) < len(bounds):
        return None
    return 100.0 * sum(bounds) / (sum(fwd) + sum(bwd))
