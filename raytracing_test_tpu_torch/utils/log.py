"""Leveled debug logging — the analog of the reference's DEBUG(x) macro
(src/globals.hpp:10-12) with its global DEBUG_LEVEL, as a tiny logger.

This port's own copy of ``raytracing_test_tpu/utils/log.py``: the port imports
nothing of the JAX package."""

from __future__ import annotations

import os
import sys
import time

DEBUG_LEVEL = int(os.environ.get("RTT_DEBUG_LEVEL", "1"))


def set_debug_level(level: int) -> None:
    global DEBUG_LEVEL
    DEBUG_LEVEL = level


def debug(level: int, msg: str, *args) -> None:
    """Print when DEBUG_LEVEL >= level (ref: DEBUG(x) gating)."""
    if DEBUG_LEVEL >= level:
        print(msg % args if args else msg, file=sys.stderr)


def status(msg: str) -> None:
    """Overwriting status line (ref: main.cpp:225's '\\r' FPS line)."""
    sys.stderr.write("\r" + msg + "   ")
    sys.stderr.flush()


class Timer:
    """Wall-clock phase timer (ref: glfwGetTime() spans, main.cpp:187-193)."""

    def __init__(self, name: str, level: int = 1):
        self.name = name
        self.level = level

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.t0
        debug(self.level, f"{self.name}: {self.dt * 1e3:.1f} ms")
