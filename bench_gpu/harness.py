"""The benchmark's shared machinery: finding a cell's files by name, host
spans, the profiler window and its reduction to device busy time, kernel
times and idle gaps, and the checks' bookkeeping.

Everything that belongs to one configuration, traffic mix, driver, check or
metric lives in a file of its own under ``bench_gpu/`` and is found here by
the name ``BENCHMARK.json`` gives it:

    configs/<config>.json       a configuration (world, render and fit settings)
    traffic/<traffic>.json      a traffic mix's parameters; its "driver" key
                                names the user path that runs it
    drivers/<driver>.py         one user path: drive(run) sets it up, opens
                                the timed window, closes it; outputs(run, state)
    checks/<driver>.py          the comparison with the plain reference
    faults/<driver>.py          FAULTS (names) and plant(fault): the faults
                                the driver's path can have, for the tests and
                                the limits' readings (``calibrate.py``)
    limits/<workload>.json      the limit of each number a cell's check compares
    metrics/<metric>.py         one metric's reader: read(run) -> value or None;
                                a metric ``<base>.<part>`` without a file of its
                                own is read by ``metrics/<base>.py``
    tests/tiny/<driver>.json    the driver's sizes for the CPU tests

A cell on ``chips`` > 1 runs as that many ranks (``ranks.py``): every rank
runs the same driver with a ``Run`` of its own (``rank``, ``world``), and
``Run.agree`` / ``Run.gather`` give it rank 0's decisions and bring every
rank's outputs to rank 0's check.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracing_test_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = BENCH_DIR):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"bench_gpu_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_module(spec: dict, kind: str):
    """The cell's ``drivers``, ``checks`` or ``faults`` module, found by the
    name of its traffic's driver under the spec's ``root`` (the benchmark's
    own directory unless a test gives another)."""
    return load_module(kind, spec["traffic"]["driver"], spec.get("root", BENCH_DIR))


def plant(spec: dict, fault: Optional[str]):
    """The context that plants ``fault`` (one of ``faults/<driver>.py``'s
    ``FAULTS``) under the cell's timed path while it is open; nothing for
    None."""
    if fault is None:
        return contextlib.nullcontext()
    faults = cell_module(spec, "faults")
    if fault not in faults.FAULTS:
        raise ValueError(f"driver {spec['traffic']['driver']!r} has no fault {fault!r}")
    return faults.plant(fault)


def drive(run: "Run", fault: Optional[str] = None):
    """This rank's part of a run: the driver's set-up and timed window, with
    ``fault`` planted, then its outputs. Returns (outputs, the device's peak
    memory in bytes after the window; 0 off the card)."""
    import torch

    driver = cell_module(run.spec, "drivers")
    with plant(run.spec, fault):
        state = driver.drive(run)
        if "window_s" not in run.records:
            raise RuntimeError(f"driver {run.traffic['driver']!r} closed no window")
        peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
        out = driver.outputs(run, state)
    del state
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return out, peak


def load_metric(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a name
    ``<base>.<part>`` without a file of its own, ``metrics/<base>.py``."""
    if not (BENCH_DIR / "metrics" / f"{name}.py").is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
    return load_module("metrics", name)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_spec(workload: str) -> dict:
    """A cell's whole description, from ``BENCHMARK.json`` and the files its
    entry names: the workload entry, the configuration, the traffic mix, the
    limits and the metrics the cell reports with and without a trace."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    return {
        "workload": workload,
        "chips": cell["chips"],
        "config": config,
        "traffic": load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(BENCH_DIR / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, workload)],
    }


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the two nearest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclass
class Run:
    """One run of one cell: its settings, and what the driver, the spans and
    the profiler recorded. Metric readers read only this."""

    spec: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float = 0.0  # the process's start on the host clock: set-up runs from it
    rank: int = 0
    world: int = 1  # the cell's ranks: its chips
    records: Dict[str, object] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    device_trace: Optional[dict] = None
    _t_window: Optional[float] = None
    _profiler: object = None

    @property
    def config(self) -> dict:
        return self.spec["config"]

    @property
    def traffic(self) -> dict:
        return self.spec["traffic"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def agree(self, flag) -> bool:
        """Rank 0's ``flag`` on every rank (a broadcast from rank 0), so that
        every rank takes rank 0's decision, such as closing the window after
        the same step; on one rank, the flag itself."""
        if self.world == 1:
            return bool(flag)
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(bool(flag))], device=self.device)
        dist.broadcast(t, src=0)
        return bool(t.item())

    def gather(self, obj):
        """Every rank's ``obj`` (picklable, tensors on the host) in rank
        order on rank 0, None on the other ranks; ``[obj]`` on one rank."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out

    def _barrier(self) -> None:
        """Wait on the host until every rank has come here (a one-element
        all-reduce); nothing on one rank."""
        if self.world == 1:
            return
        import torch
        import torch.distributed as dist

        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t)
        t.item()

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Host time of the body (seconds, in ``spans[name]``); ``sync``
        waits for the card before the span ends. In a traced run the body
        is also a named range of the profiler's trace."""
        rf = contextlib.nullcontext()
        if self.trace:
            import torch

            rf = torch.profiler.record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rf:
            yield
            if sync:
                self.sync()
        t1 = time.perf_counter()
        self.spans.setdefault(name, []).append(t1 - t0)

    def open_window(self) -> None:
        """End set-up and open the timed window: waits for the card (and on
        several ranks for every rank's set-up), records ``setup_s``, clears
        the spans, and in a traced run starts the profiler."""
        self.sync()
        self._barrier()
        self.records["setup_s"] = time.perf_counter() - self.t_start
        self.spans.clear()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        self._t_window = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since the window opened."""
        return time.perf_counter() - self._t_window

    def close_window(self) -> None:
        """Close the window once the card (on several ranks, every rank) has
        finished its work: records ``window_s``, and in a traced run stops
        the profiler and reduces its events into ``device_trace``."""
        self.sync()
        self._barrier()
        wall = self.elapsed()
        self.records["window_s"] = wall
        if self._profiler is not None:
            self._profiler.stop()
            self.device_trace = reduce_trace(self._profiler.events(), wall)
            self._profiler = None
            if self.device.type == "cuda":
                import torch

                torch.cuda.empty_cache()

    def window_seconds(self) -> float:
        """The timed window's length: the cell's run length, or in a traced
        run the traffic's ``trace_seconds`` where that is shorter."""
        if self.trace:
            return min(self.seconds, float(self.traffic.get("trace_seconds", self.seconds)))
        return self.seconds


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_trace(events, window_s: float) -> dict:
    """Device intervals, busy seconds, seconds and count per device
    operation, the device kernels in start order, and the idle gaps labelled
    by what the host was in at the gap's middle: the harness span and the
    innermost operator ("python" where none). Times in the trace are in
    us."""
    from torch.autograd import DeviceType

    dev, spans, ops, marks = [], [], [], set()
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((tr.start, tr.end, e.name))
        elif getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
            marks.add(e.name)
            if e.name.startswith("bench."):
                spans.append((tr.start, tr.end, e.name[len("bench."):]))
        else:
            ops.append((tr.start, tr.end, e.name))
    # a named range (record_function) shows on the device's timeline too:
    # it is no device operation
    dev = sorted(d for d in dev if d[2] not in marks and not d[2].startswith("bench."))
    busy = _merge([(s, e) for s, e, _ in dev])
    per_op: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for s, e, name in dev:
        per_op[name] = per_op.get(name, 0.0) + (e - s) * 1e-6
        count[name] = count.get(name, 0) + 1
    gaps: Dict[str, float] = {}
    spans.sort()
    ops.sort()
    span_starts = [s for s, _, _ in spans]
    op_starts = [s for s, _, _ in ops]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        label = (_innermost(spans, span_starts, mid, 8) or "harness") + "/" + \
            (_innermost(ops, op_starts, mid, 256) or "python")
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) * 1e-6
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": window_s,
        "per_op_s": per_op,
        "op_count": count,
        "kernels": dev,
        "gaps_s": gaps,
    }


def _innermost(intervals, starts, t, depth: int):
    """Name of the latest-starting interval that holds ``t`` among the
    ``depth`` latest that started before it (intervals sorted by start)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - depth, -1), -1):
        if intervals[j][1] >= t:
            return intervals[j][2]
    return None


def breakdown(trace: dict) -> dict:
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(trace["per_op_s"]), "idle_gaps": top(trace["gaps_s"])}


def kernel_times(run: Run, needle: str) -> List[float]:
    """Seconds of each launch whose kernel name holds ``needle``, in launch
    order, from the traced window (empty without a device trace)."""
    if not run.device_trace:
        return []
    return [(e - s) * 1e-6 for s, e, name in run.device_trace["kernels"] if needle in name]


def idle_pct(run: Run):
    """Share of the traced window (%) in which no operation ran on the
    device; none without a trace that saw one."""
    t = run.device_trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
