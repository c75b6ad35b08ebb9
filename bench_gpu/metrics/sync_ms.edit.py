"""Median of the summed ``WorldSession.sync_ms`` parts (rasterize, boxes,
apply: the program's own host times of the sync) over the window's
edits."""

import statistics


def read(run):
    t = run.records.get("sync_ms")
    return statistics.median(t) if t else None
