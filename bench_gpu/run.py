"""Run one cell of the port's benchmark and print its result line.

    python3 bench_gpu/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell's
configuration, traffic mix, driver, check, limits and metrics are found by
name (``harness.py``). The run builds the program's kernels (cached in the
program's ``_build/``), and the driver sets the cell up from the seed, then
opens the timed window and closes it after ``--seconds`` (a traced run: the
traffic's ``trace_seconds``, under the profiler). The run then checks what
the timed path produced against the plain reference (``reference/``), and
prints the numbers it compared beside their limits on standard error, then
one JSON line on standard output. A cell on several chips runs as that many
ranks, one process a card (``ranks.py``); this process is rank 0 and alone
prints. Without enough CUDA devices the run exits with 2 and prints no
result; with JAX or the JAX package loaded on any rank it exits with 3; a
rank that raises or ends early ends the run with 1 and that rank's
traceback.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402
import ranks  # noqa: E402


def collect(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
            fault=None):
    """Set the cell up, run its window and take its outputs, on every rank of
    the cell (``ranks.py``), with ``fault`` planted (``faults/<driver>.py``)
    where one is named. Returns rank 0's ``Run``, its outputs, and the peak
    memory of the fullest device. ``t_start`` is the process's start on the
    host clock: set-up runs from it to the window, and on several chips
    includes starting and joining the followers."""
    import torch

    with ranks.started(spec, seed, seconds, device, fault):
        run = harness.Run(spec=spec, seed=seed, seconds=seconds, trace=trace,
                          device=torch.device(device), t_start=t_start, world=spec["chips"])
        if run.device.type == "cuda":
            torch.cuda.init()
        t_device = time.perf_counter()
        out, peak = harness.drive(run, fault)
        reports = run.gather({"peak": peak, "forbidden": []})
    print(f"bench: set-up: {t_device - t_start:.3f} s to the device (imports, CUDA), "
          f"{run.records['setup_s'] - (t_device - t_start):.3f} s the cell's own", file=sys.stderr)
    held = sorted({m for r in reports for m in r["forbidden"]})
    if held:
        raise ranks.ForbiddenModules(", ".join(held))
    return run, out, max(r["peak"] for r in reports)


def execute(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
            fault=None) -> dict:
    """Run the cell (``collect``), check it, and return the result dict (its
    ``checks`` key last)."""
    import torch

    run, out, peak = collect(spec, seed, seconds, trace, device, t_start, fault)
    check = harness.cell_module(spec, "checks")
    t_check = time.perf_counter()
    numbers = check.check(run, out)
    print(f"bench: set-up {run.records['setup_s']:.3f} s, window {run.records['window_s']:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    for name, t in run.spans.items():
        print(f"bench: span {name}: {len(t)} x, median {1e3 * statistics.median(t):.3f} ms, "
              f"p95 {1e3 * harness.percentile(t, 95):.3f} ms, sum {sum(t):.3f} s", file=sys.stderr)
    limits = spec["limits"]
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing} in limits/{spec['workload']}.json")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = harness.load_metric(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
           "count": spec["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.records["attempted"],
              "failed": run.records["failed"], "metrics": metrics, "device": dev}
    if trace and run.device_trace:
        dev["busy_s"] = run.device_trace["busy_s"]
        dev["window_s"] = run.device_trace["window_s"]
        result["breakdown"] = harness.breakdown(run.device_trace)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = harness.load_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"bench: needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return report(spec, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)


def report(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> int:
    """Run the cell and print its checks on standard error and its result
    line on standard output; returns the exit code (3, and no result, where
    a rank holds JAX or the JAX package once the window has closed)."""
    try:
        result = execute(spec, seed, seconds, trace, device, t_start)
        bad = harness.forbidden_modules()
        if bad:
            raise ranks.ForbiddenModules(", ".join(bad))
    except ranks.ForbiddenModules as e:
        print(f"bench: forbidden modules loaded: {e}", file=sys.stderr)
        return 3
    print(f"bench: {result['attempted']} attempted, {result['failed']} failed", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
