"""The readings the checks' limits are set from, for one cell, in one
process on the card: the program's compared numbers on each of
``--seeds``, the control's (the reference at the precision below the
configuration's, in the program's place) on ``--control-seeds``, and each
planted fault's (``faults/<driver>.py``) on ``--fault-seeds``. A cell on
several chips runs each reading on all its ranks, started as ``run.py``
starts them. Each reading is one JSON line on standard output and in
``--out``.

    python3 bench_gpu/calibrate.py --workload fit-ref-1024 --seeds 1,2,3 \\
        --control-seeds 1,2,3 --fault-seeds 4,5,6 [--faults stale_guide] \\
        --seconds 2 --out cal.jsonl

The program's runs use a window of ``--seconds`` (long enough to finish
as many answers as a check compares).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402
import run  # noqa: E402


def reading(spec, seed, seconds, device, fault=None, control=False):
    """The compared numbers of one run (on every rank of the cell, as
    ``run.py`` runs it), and of the control in the program's place."""
    t0 = time.perf_counter()
    r, out, _ = run.collect(spec, seed, seconds, False, device, t0, fault)
    check = harness.cell_module(spec, "checks")
    rows = [("program" if fault is None else fault, check.check(r, out))]
    if control:
        rows.append(("control", check.check(r, check.control(r, out))))
    return [{"workload": spec["workload"], "kind": k, "seed": seed, "numbers": n,
             "seconds": time.perf_counter() - t0} for k, n in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default=None,
                    help="comma-separated faults to read (default: every fault of the driver)")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = harness.load_spec(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    seeds, ctrl = ints(args.seeds), set(ints(args.control_seeds))
    jobs = [(s, None, s in ctrl) for s in seeds + sorted(ctrl - set(seeds))]
    names = harness.cell_module(spec, "faults").FAULTS
    for fault in (args.faults.split(",") if args.faults else names):
        jobs += [(s, fault, False) for s in ints(args.fault_seeds)]
    sink = open(args.out, "a") if args.out else None
    try:
        for seed, fault, control in jobs:
            for row in reading(spec, seed, args.seconds, args.device, fault, control):
                line = json.dumps(row)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
