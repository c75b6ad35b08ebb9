"""95th percentile of every frame's host time in the window (each ended
when the card finished it)."""

import harness


def read(run):
    t = run.spans.get("frame", [])
    return 1e3 * harness.percentile(t, 95) if t else None
