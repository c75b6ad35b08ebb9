"""The harness's ranks (``ranks.py``): the fixture driver ``lockstep``
(``tests/fixture/``, no cell of the benchmark) run as 4 ranks, each run in a
process of its own as ``run.py`` runs a cell: gloo on the CPU, NCCL over four
cards in the ``card`` test. A sound run prints one result line with every
rank's outputs checked; a rank that raises, hangs or dies ends the run
within its limit and leaves no process behind. A one-chip cell starts no
process and makes no group."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import harness

FIXTURE = Path(__file__).resolve().parent / "fixture"
LIMITS = {"ranks_missing": 0, "steps_apart": 0, "sum_gap": 1e-9}
RUN = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
import ranks, run
spec, fault, limit, device = json.loads(sys.argv[1])
if limit:
    ranks.GROUP_TIMEOUT_S = limit
if fault:
    print(json.dumps(run.execute(spec, 5, 1.0, False, device, run.T_START, fault)))
    sys.exit(0)
sys.exit(run.report(spec, 5, 1.0, False, device, run.T_START))
""".format(root=str(harness.ROOT), bench=str(harness.BENCH_DIR))


def lockstep_spec(pid_dir: Path, chips=4, **traffic) -> dict:
    pid_dir.mkdir(parents=True, exist_ok=True)
    return {"workload": "lockstep", "chips": chips, "root": str(FIXTURE), "config": {},
            "traffic": {"driver": "lockstep", "size": 4096, "pid_dir": str(pid_dir), **traffic},
            "limits": LIMITS, "end_to_end": [{"name": "setup_s", "unit": "s"}],
            "per_layer": []}


def _gone(pid: int) -> bool:
    """The process has ended (a zombie awaiting its reaper has too)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return True
    return stat.rsplit(")", 1)[1].split()[0] in ("Z", "X")


def run_alone(spec, fault=None, limit=None, device="cpu", timeout=300):
    """The spec run by ``run.report`` (by ``run.execute`` with a fault) in a
    process of its own. Returns (exit code, stdout lines, stderr, seconds,
    the ranks' process ids); asserts that no rank outlives it by more than
    10 s."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", RUN, json.dumps([spec, fault, limit, device])],
                       capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    pids = {int(f.stem[4:]): int(f.read_text())
            for f in Path(spec["traffic"]["pid_dir"]).glob("rank*.pid")}
    deadline = time.monotonic() + 10
    while not all(_gone(pid) for pid in pids.values()) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert all(_gone(pid) for pid in pids.values()), (pids, p.stderr[-3000:])
    return p.returncode, p.stdout.splitlines(), p.stderr, seconds, pids


def _results(lines):
    return [ln for ln in lines if ln.startswith("{")]


def test_ranks_run_as_one(tmp_path):
    rc, out, err, seconds, pids = run_alone(lockstep_spec(tmp_path))
    assert rc == 0, err[-3000:]
    assert seconds < 120  # the followers leave with rank 0, none is waited out
    assert len(_results(out)) == 1 and out[-1] == _results(out)[0]
    res = json.loads(out[-1])
    assert res["correct"], res["checks"]
    # every rank's outputs at the check, each closing after the same step
    assert res["checks"]["ranks_missing"]["value"] == 0
    assert res["checks"]["steps_apart"]["value"] == 0
    assert res["attempted"] >= 3 and res["device"]["count"] == 4
    assert set(res["metrics"]) == {"setup_s"} and list(res)[-1] == "checks"
    assert sorted(pids) == [0, 1, 2, 3] and len(set(pids.values())) == 4


def test_fault_is_planted_on_every_rank(tmp_path):
    rc, out, err, _, _ = run_alone(lockstep_spec(tmp_path), fault="exchange_left_out")
    assert rc == 0, err[-3000:]
    res = json.loads(out[-1])
    assert not res["correct"] and res["checks"]["sum_gap"]["value"] > 0.1, res["checks"]
    assert res["checks"]["steps_apart"]["value"] == 0


@pytest.mark.parametrize("rank", [2, 0])
def test_raising_rank_ends_the_run(tmp_path, rank):
    rc, out, err, seconds, pids = run_alone(lockstep_spec(tmp_path, mode="raise", mode_rank=rank))
    assert rc == 1 and not _results(out)
    assert f"fixture: rank {rank} raises" in err and "Traceback" in err
    if rank:
        assert f"rank {rank} of 4 failed" in err
    assert seconds < 120 and len(pids) == 4


def test_hanging_follower_ends_at_the_limit(tmp_path):
    rc, out, err, seconds, _ = run_alone(lockstep_spec(tmp_path, mode="hang", mode_rank=1),
                                         limit=8.0)
    assert rc != 0 and not _results(out)
    assert 8.0 < seconds < 8.0 + 90, err[-3000:]


def test_dying_rank_0_leaves_no_follower(tmp_path):
    rc, out, _, _, pids = run_alone(lockstep_spec(tmp_path, mode="die", mode_rank=0))
    assert rc == -9 and not _results(out) and len(pids) == 4


def test_follower_holding_jax_exits_3(tmp_path):
    rc, out, err, _, _ = run_alone(lockstep_spec(tmp_path, mode="jax", mode_rank=3))
    assert rc == 3 and not _results(out)
    assert "forbidden modules loaded: jax" in err


def test_one_chip_cell_starts_no_process(monkeypatch):
    """A one-chip cell runs in the harness's process alone: no process
    started, no process group made, the environment untouched."""
    import multiprocessing

    import torch.distributed as dist

    import run
    from tiny import tiny_seconds, tiny_spec

    def refuse(*a, **kw):
        raise AssertionError("a one-chip cell started a process or made a group")

    monkeypatch.setattr(multiprocessing, "get_context", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    env = dict(os.environ)
    spec = tiny_spec("serve-ref-1024")
    res = run.execute(spec, 7, tiny_seconds(spec), False, "cpu", 0.0)
    assert res["correct"] and res["device"]["count"] == 1
    assert not dist.is_initialized() and dict(os.environ) == env


@pytest.mark.card
@pytest.mark.parametrize("mode,rank", [(None, None), ("raise", 2), ("hang", 1), ("die", 0)])
def test_ranks_on_the_cards(card, tmp_path, mode, rank):
    """Four ranks over NCCL, one a card: a sound run reports the peak of the
    fullest card (rank 3 holds 4 x 256 MB of padding); a raising follower,
    a hanging one (the group's limit set to 20 s) and a dying rank 0 end
    the run, and no rank outlives it."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards, found {torch.cuda.device_count()}")
    traffic = {"pad_mb": 256} if mode is None else {"mode": mode, "mode_rank": rank}
    rc, out, err, seconds, pids = run_alone(lockstep_spec(tmp_path, **traffic),
                                            limit=20.0 if mode == "hang" else None,
                                            device="cuda:0")
    print(f"{mode}: exit {rc} after {seconds:.1f} s, ranks {sorted(pids)}", err[:1500], "...",
          err[-2500:], sep="\n")
    if mode is None:
        assert rc == 0, err[-3000:]
        res = json.loads(out[-1])
        assert res["correct"], res["checks"]
        assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 4
        assert res["device"]["memory_peak_bytes"] >= 4 * 256 * 2 ** 20
        assert seconds < 90  # the followers leave with rank 0, none is waited out
        print(json.dumps(res))
        return
    assert rc != 0 and not _results(out) and len(pids) == 4
    if mode == "raise":
        assert "fixture: rank 2 raises" in err
