"""Start ranks as processes of one ``torch.distributed`` world.

``run_ranks(target, n, ...)`` starts ``n`` processes with the ``spawn``
context (a forked child would inherit its parent's threads), joins them in
one process group through a ``FileStore`` in a temporary directory (no TCP
port, so concurrent runs never collide), calls ``target(*args)`` in each and
returns the ranks' results in rank order. It waits at most ``timeout``
seconds: on a timeout, or as soon as one rank fails, it kills every rank
that is still running and raises, with the failing rank's traceback. The
tests, ``chip_smoke.py`` and the scaling harness all start their ranks here;
``torchrun`` starts them for the CLI.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.distributed as dist


def rank_device(device: str, backend: str, rank: int) -> str:
    """The device a rank runs on: with NCCL, ``cuda`` means one card a rank
    (``cuda:<rank>``); otherwise every rank takes ``device`` as given (two
    gloo ranks on ``cuda:0`` share the card)."""
    if device == "cuda" and backend == "nccl":
        return f"cuda:{rank}"
    return device


def _rank_main(target, rank: int, n: int, backend: str, device: str, tmp: str, args) -> None:
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        os.environ["RANK"] = str(rank)
        os.environ["WORLD_SIZE"] = str(n)
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
        store = dist.FileStore(os.path.join(tmp, "store"), n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n)
        result = target(*args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _traceback(tmp: str, rank: int, exitcode) -> str:
    try:
        with open(os.path.join(tmp, f"rank{rank}.err")) as f:
            return f.read()
    except FileNotFoundError:
        return f"exit code {exitcode}, no traceback"


def run_ranks(target, n: int, backend: str = "gloo", device: str = "cpu",
              timeout: float = 120.0, args=()):
    """Run ``target(*args)`` on ``n`` ranks; returns their results in rank
    order. ``target`` must be importable by name (a module-level function),
    and each rank finds its device with ``rank_device(device, backend,
    rank)`` (``LOCAL_RANK``, ``RANK`` and ``WORLD_SIZE`` are set as
    ``torchrun`` sets them). Raises ``RuntimeError`` with the traceback of
    the first rank that fails and ``TimeoutError`` after ``timeout``
    seconds; either way no rank is left running."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(target, r, n, backend, rank_device(device, backend, r), tmp,
                                   tuple(args)))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(f"rank {bad[0]} of {n} failed:\n"
                                       + _traceback(tmp, bad[0], procs[bad[0]].exitcode))
                live = [p.sentinel for p in procs if p.exitcode is None]
                if not live:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{len(live)} of {n} ranks still running after "
                                       f"{timeout:.0f} s")
                wait(live, timeout=min(left, 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
