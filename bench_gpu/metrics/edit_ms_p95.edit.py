"""95th percentile of every edit's host time in the window, from the edit
call until the card finished its frame."""

import harness


def read(run):
    t = run.spans.get("edit", [])
    return 1e3 * harness.percentile(t, 95) if t else None
