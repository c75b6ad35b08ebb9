"""The fixture driver's one fault: the exchange between ranks left out
(``torch.distributed.all_reduce`` does nothing). Planted on rank 0 alone, it
would leave the followers waiting in their exchange; planted on every rank,
each total holds its own block only and the check reads the gap."""

from __future__ import annotations

import torch.distributed as dist

from faults._patch import patched

FAULTS = ("exchange_left_out",)


def plant(fault: str):
    if fault == "exchange_left_out":
        return patched(dist, "all_reduce", lambda *a, **kw: None)
    raise ValueError(f"the fixture has no fault {fault!r}")
