"""A driver for the tests of the harness's ranks (``ranks.py``); no cell of
the benchmark runs it. Every rank makes a block of numbers from the seed and
its rank; each step of the window all-reduces the block times the step's
number and adds the sum to the rank's total. The window closes after the
step at which rank 0's clock says so (``Run.agree``), and ``outputs`` brings
every rank's closing step and total to rank 0 (``Run.gather``).

Traffic keys: ``size`` (numbers a rank), ``pad_mb`` (rank r holds r + 1
times that many MB on its device through the window), ``pid_dir`` (each rank
writes its process id there), and a misbehaviour ``mode`` of rank
``mode_rank`` at the window's third step: ``raise``, ``hang``, ``die``
(killed), or ``jax`` (a module named ``jax`` appears).
"""

from __future__ import annotations

import os
import signal
import sys
import time
import types
from pathlib import Path

import torch
import torch.distributed as dist


def block(seed: int, rank: int, size: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed * 1009 + rank)
    return torch.rand(size, generator=g, dtype=torch.float64)


def _misbehave(mode: str, rank: int) -> None:
    if mode == "raise":
        raise RuntimeError(f"fixture: rank {rank} raises")
    if mode == "hang":
        while True:
            time.sleep(1.0)
    if mode == "die":
        os.kill(os.getpid(), signal.SIGKILL)
    if mode == "jax":
        sys.modules["jax"] = types.ModuleType("jax")


class LockstepState:
    pass


def drive(run):
    tr = run.traffic
    if "pid_dir" in tr:
        Path(tr["pid_dir"], f"rank{run.rank}.pid").write_text(str(os.getpid()))
    x = block(run.seed, run.rank, int(tr["size"])).to(run.device)
    pad = torch.ones(int((run.rank + 1) * tr.get("pad_mb", 0) * 2 ** 20), dtype=torch.uint8,
                     device=run.device)
    total = torch.zeros((), dtype=torch.float64, device=run.device)
    y = x.clone()
    dist.all_reduce(y)  # warm-up: the group's first exchange
    run.open_window()
    k = 0
    while True:
        if k == 2 and tr.get("mode_rank") == run.rank:
            _misbehave(tr["mode"], run.rank)
        y = x * (k + 1)
        dist.all_reduce(y)
        total += y.sum()
        k += 1
        if run.agree(run.elapsed() >= run.window_seconds()):
            break
    run.close_window()
    del pad
    run.records.update(steps=k, attempted=k, failed=0)
    st = LockstepState()
    st.steps, st.total = k, float(total)
    return st


def outputs(run, st):
    return run.gather({"rank": run.rank, "steps": st.steps, "total": st.total})
