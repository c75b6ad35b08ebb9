"""A cell on ``chips`` > 1: one process a card, joined in one process group.

``started(spec, seed, seconds, device, fault)`` is the context inside which
rank 0, the harness's own process, runs its part of a cell. For n =
``spec["chips"]`` > 1 it starts n - 1 followers (``spawn`` context), rank r
on ``cuda:r`` (every rank on the CPU in the tests), and joins the n ranks in
one process group through a ``FileStore`` in a temporary directory: NCCL on
cards, gloo on the CPU, every collective limited to ``GROUP_TIMEOUT_S``.
``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE`` are set as ``torchrun`` sets
them, so the program's ``make_mesh`` takes the group that exists. Nothing
here imports the program: no program change can change how a cell starts.

A follower runs the cell's driver with a ``Run`` of its own, which never
traces (``harness.drive``, with the same fault planted), then sends rank 0
its peak memory and the forbidden modules it holds (``Run.gather``), and
exits. Its standard output goes to standard error: the result line is rank
0's alone. For one chip ``started`` starts no process and makes no group.

Failure is bounded:

- a follower that raises prints its traceback on standard error and exits
  1. Rank 0's watcher then kills the other followers at once, so rank 0's
  next collective fails and the context raises ``RankFailed`` naming the
  follower and its error. Where rank 0 cannot leave a collective (NCCL need
  not see a peer die), the watcher ends the process ``GRACE_S`` seconds
  after the failure;
- when rank 0 raises, the context kills every follower before the error
  leaves it; a follower that outlives rank 0 is killed by the kernel
  (``PR_SET_PDEATHSIG``);
- a collective that never completes raises after ``GROUP_TIMEOUT_S``
  seconds; with NCCL, the watchdog of the program's library ends the
  process then (it waits about a minute more for the ranks' debug dumps).
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import multiprocessing as mp
import os
import signal
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import wait

import harness

GROUP_TIMEOUT_S = 120.0  # every collective of a multi-rank cell, its join included
GRACE_S = 30.0  # rank 0's time to end by itself after a follower failed
_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE")


class RankFailed(RuntimeError):
    """A follower raised or ended before its report (it printed its
    traceback on standard error)."""


class ForbiddenModules(RuntimeError):
    """A follower held JAX or the JAX package once its window had closed."""


def rank_device(device, rank: int):
    """Rank ``rank``'s device: ``cuda:<rank>`` for a card, else ``device``."""
    import torch

    device = torch.device(device)
    return torch.device("cuda", rank) if device.type == "cuda" else device


def _join(device, rank: int, n: int, tmp: str, timeout: float) -> None:
    import torch
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout))


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when ``parent`` ends (Linux's
    PR_SET_PDEATHSIG); end now if it already has."""
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(1)


def _follower(spec, seed, seconds, device, fault, rank, tmp, parent, timeout) -> None:
    os.dup2(2, 1)
    try:
        _die_with(parent)
        n = spec["chips"]
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n))
        import torch
        import torch.distributed as dist

        if device.type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        _join(device, rank, n, tmp, timeout)
        run = harness.Run(spec=spec, seed=seed, seconds=seconds, trace=False, device=device,
                          t_start=time.perf_counter(), rank=rank, world=n)
        _, peak = harness.drive(run, fault)
        run.gather({"peak": peak, "forbidden": harness.forbidden_modules()})
        dist.destroy_process_group()
    except BaseException:
        tb = traceback.format_exc()
        print(f"bench: rank {rank} of {spec['chips']} failed:\n{tb}", file=sys.stderr, flush=True)
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(tb)
        os._exit(1)


class _Followers:
    """Rank 0's view of its followers, and the thread that watches them."""

    def __init__(self, procs: dict, tmp: str, n: int):
        self.procs, self.tmp, self.n = procs, tmp, n
        self.failed = None  # what the first follower that failed died of
        self._stop = threading.Event()
        self._timer = None
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._watcher.start()

    def _failure(self, rank: int) -> str:
        """What follower ``rank`` died of: its error (the last line of the
        traceback it printed), or its exit code."""
        try:
            with open(os.path.join(self.tmp, f"rank{rank}.err")) as f:
                why = f.read().strip().splitlines()[-1]
        except (FileNotFoundError, IndexError):
            why = f"exit code {self.procs[rank].exitcode}"
        return f"rank {rank} of {self.n} failed: {why}"

    def _bad(self):
        """The lowest rank of a follower that ended with a non-zero code."""
        return next((r for r, p in self.procs.items() if p.exitcode not in (None, 0)), None)

    def _watch(self) -> None:
        while not self._stop.is_set():
            bad = self._bad()
            if bad is not None:
                self.failed = self._failure(bad)
                self.kill()
                self._timer = threading.Timer(GRACE_S, self._exit_now)
                self._timer.daemon = True
                self._timer.start()
                return
            live = [p.sentinel for p in self.procs.values() if p.exitcode is None]
            if not live:
                return
            wait(live, timeout=0.5)

    def _exit_now(self) -> None:
        print(f"bench: {self.failed}; rank 0 did not end within {GRACE_S:.0f} s of it",
              file=sys.stderr, flush=True)
        os._exit(1)

    def first_failure(self):
        """What the first follower that failed died of, after up to a second
        for one that is ending; None if none did."""
        live = [p.sentinel for p in self.procs.values() if p.exitcode is None]
        if live and self.failed is None:
            wait(live, timeout=1.0)
        if self.failed is None and self._bad() is not None:
            return self._failure(self._bad())
        return self.failed

    def kill(self) -> None:
        for p in self.procs.values():
            if p.exitcode is None:
                p.kill()

    def close(self, ended: bool) -> None:
        """Stop watching and reap the followers: after a run that ended, each
        once it has ended too (killed after 30 s); else killed at once."""
        self._stop.set()
        self._watcher.join()
        if self._timer is not None:
            self._timer.cancel()
        if not ended:
            self.kill()
        for p in self.procs.values():
            p.join(30)
            if p.exitcode is None:
                p.kill()
                p.join()


@contextlib.contextmanager
def started(spec: dict, seed: int, seconds: float, device, fault=None):
    """Rank 0's context for a cell: followers started and the group joined
    for ``chips`` > 1, nothing at all for one chip (see the module's
    docstring)."""
    n = spec["chips"]
    if n == 1:
        yield
        return
    import torch.distributed as dist

    saved = {k: os.environ.get(k) for k in _ENV}
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        procs = {r: ctx.Process(target=_follower, daemon=True,
                                args=(spec, seed, seconds, rank_device(device, r), fault, r,
                                      tmp, os.getpid(), GROUP_TIMEOUT_S))
                 for r in range(1, n)}
        for p in procs.values():
            p.start()
        followers = _Followers(procs, tmp, n)
        ended = False
        try:
            os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(n))
            _join(rank_device(device, 0), 0, n, tmp, GROUP_TIMEOUT_S)
            yield
            ended = True
        except BaseException as e:
            failed = followers.first_failure()
            if failed is not None:
                raise RankFailed(failed) from e
            raise
        finally:
            if ended:  # every rank leaves the group at once (NCCL waits for all)
                dist.destroy_process_group()
            followers.close(ended)
            # NCCL may wait on the peers that are gone: a failed run leaves
            # its group to the process's end
            if dist.is_initialized() and dist.get_backend() == "gloo":
                dist.destroy_process_group()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
