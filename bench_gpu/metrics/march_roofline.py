"""Share of the fused march's roofline in the viewer: the summed bound of
the traced window's first frames' march launches (``roofline/march.py``)
over their summed device time (one launch a frame)."""

import harness


def read(run):
    bounds = run.records.get("march_bound_s")
    if not bounds or run.records.get("march_launches") != run.records["frames"]:
        return None
    t = harness.kernel_times(run, "fused_march")[:len(bounds)]
    if len(t) < len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(t)
