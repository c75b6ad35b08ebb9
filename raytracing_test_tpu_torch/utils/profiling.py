"""Tracing / profiling utilities: the reference's wall-clock instrumentation
(SURVEY.md §5.1) on PyTorch.

Port of ``raytracing_test_tpu/utils/profiling.py``. The reference times world
gen once (main.cpp:187-193) and prints a rolling 40-frame average of frame
time / FPS every frame (main.cpp:204-225). Here:

  - ``FrameStats``: the same 40-sample rolling frame-time/FPS counter, plus
    a rays/s rate.
  - ``phase``: a wall-clock context manager for one-off phases (world gen,
    upload); callers ``sync`` the tensors the phase produced before it ends,
    since CUDA work returns before the card has finished it.
  - ``trace``: a ``torch.profiler`` scope (the reference's ``jax.profiler``
    trace) that writes a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import torch

from .log import debug


def sync(*tensors) -> None:
    """Wait for the card to finish the work behind these tensors."""
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def phase(name: str, *, level: int = 1):
    """Time a host-visible phase; prints via the leveled debug logger."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        debug(level, f"{name}: {(time.perf_counter() - t0) * 1e3:.1f} ms")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` scope over the body (CPU, and CUDA where there is a
    card); writes ``log_dir/trace.json`` (open it in chrome://tracing or
    Perfetto). No-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    debug(1, f"trace written to {path}")


class FrameStats:
    """Rolling frame statistics (the reference's 40-frame average,
    main.cpp:221-225), extended with a rays/s rate."""

    def __init__(self, window: int = 40):
        self.times = collections.deque(maxlen=window)
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self, rays: int = 0) -> float:
        """Record one frame; returns the frame time in seconds."""
        if self._last is None:
            raise RuntimeError("FrameStats.stop: call start() first")
        dt = time.perf_counter() - self._last
        self._last = None
        self.times.append((dt, rays))
        return dt

    @property
    def avg_ms(self) -> float:
        if not self.times:
            return 0.0
        return 1e3 * sum(t for t, _ in self.times) / len(self.times)

    @property
    def fps(self) -> float:
        return 1e3 / self.avg_ms if self.avg_ms else 0.0

    @property
    def rays_per_s(self) -> float:
        tot_t = sum(t for t, _ in self.times)
        tot_r = sum(r for _, r in self.times)
        return tot_r / tot_t if tot_t else 0.0

    def status(self) -> str:
        return (
            f"avg frame {self.avg_ms:.1f} ms  {self.fps:.1f} fps"
            + (f"  {self.rays_per_s:.3e} rays/s" if self.rays_per_s else "")
        )
