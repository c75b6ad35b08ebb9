"""The check of the fixture driver ``lockstep``: every rank's outputs at
rank 0, the same closing step on each, and each total against the plain
sum of every rank's block.

    ranks_missing   ranks whose outputs did not reach the check
    steps_apart     the most and the fewest steps taken, apart
    sum_gap         the worst rank's |total - reference| / reference
"""

from __future__ import annotations

import torch


def check(run, out) -> dict:
    size = int(run.traffic["size"])
    s = 0.0
    for r in range(run.world):
        g = torch.Generator().manual_seed(run.seed * 1009 + r)
        s += float(torch.rand(size, generator=g, dtype=torch.float64).sum())
    steps = [o["steps"] for o in out]
    gaps = [abs(o["total"] - s * o["steps"] * (o["steps"] + 1) / 2)
            / (s * o["steps"] * (o["steps"] + 1) / 2) for o in out]
    return {"ranks_missing": run.world - len({o["rank"] for o in out}),
            "steps_apart": max(steps) - min(steps), "sum_gap": max(gaps)}
