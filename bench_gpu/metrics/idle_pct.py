"""Share of the traced window with no operation running on the card (read
for ``idle_pct.train``, ``idle_pct.serve`` and ``idle_pct.edit``)."""

import harness


def read(run):
    return harness.idle_pct(run)
