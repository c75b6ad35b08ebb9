"""The data-parallel fit's check. Its plain reference is the single-device
guided fit on the whole batch of each step (``reference/train.py``, as the
fit's check ``checks/fit.py`` runs it): with blocks of equal size, the mean
of the ranks' block losses is the loss of the whole batch, and the mean of
their gradients is its gradient. So rank 0's checked steps, and the seeds
of the window's last batch gathered from the ranks' blocks, are held to the
numbers the fit's check reads (``loss_gap``, ``grad_gap``, ``change_gap``,
``seed_off``), and one more:

    replica_off  the number of ranks whose fields after the window differ,
                 in any bit, from rank 0's (by the digests of their bytes):
                 data parallelism keeps the same weights on every replica

``control(run, out)`` is the reference at the precision below the
configuration's float32 where the data-parallel path adds arithmetic: each
step's gradient, as the all-reduce hands it to Adam, rounded to bfloat16.
"""

from __future__ import annotations

import torch

import harness
from faults._patch import patched
from reference import train as rt

fit = harness.load_module("checks", "fit")


def replica_off(digests) -> int:
    """Ranks whose digest is not rank 0's."""
    return sum(d != digests[0] for d in digests[1:])


def control(run, out) -> dict:
    loss_and_grads = rt.Fit.loss_and_grads

    def bf16_grads(self, *a, **kw):
        loss, grads = loss_and_grads(self, *a, **kw)
        return loss, tuple(g.to(torch.bfloat16).to(g.dtype) for g in grads)

    with patched(rt.Fit, "loss_and_grads", bf16_grads):
        losses, grads, change = fit.reference_fit(run, out)
    return dict(out, losses=losses, grad_norms=grads, change_norms=change)


def check(run, out) -> dict:
    return dict(fit.check(run, out), replica_off=replica_off(out["digests"]))
