"""The data-parallel fit's step time, read as ``step_ms.train`` reads the
one-card fit's: the window's summed ``step`` spans over their number."""

import harness


def read(run):
    return harness.load_metric("step_ms.train").read(run)
