"""Whole runs of each cell at a tiny size on the CPU (the look for a card
skipped): a sound run reads ``correct`` true; the control (the reference at
the precision below the configuration's, in the program's place) and each
fault the cell can have (``faults/<driver>.py``), planted under the timed
path, read it false. A cell whose driver lacks a file of faults or of tiny
sizes fails its own cases, naming the file, and no other cell's."""

import pytest
import torch

import harness
import run
from tiny import tiny_seconds, tiny_spec

WORKLOADS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def _fault_cases(workload: str) -> list:
    """(workload, fault) for each fault of the cell's driver; where they
    cannot be read, one case (fault None) that fails saying why."""
    try:
        names = harness.cell_module(harness.load_spec(workload), "faults").FAULTS
    except Exception:  # the case raises it again, in this cell's test alone
        return [pytest.param(workload, None, id=f"{workload}-faults")]
    return [(workload, f) for f in names]


CASES = [c for w in WORKLOADS for c in _fault_cases(w)]


def _run(workload, seed=7, trace=False, fault=None):
    spec = tiny_spec(workload)
    return run.execute(spec, seed, tiny_seconds(spec), trace, "cpu", 0.0, fault)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    spec = tiny_spec(workload)
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_reads_incorrect(workload, fault):
    if fault is None:
        harness.cell_module(harness.load_spec(workload), "faults")  # raises, naming the file
        pytest.fail(f"{workload}: the faults of its driver could not be read")
    res = _run(workload, seed=9, fault=fault)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_reads_incorrect(workload):
    spec = tiny_spec(workload)
    r, out, _ = run.collect(spec, 5, tiny_seconds(spec), False, "cpu", 0.0)
    check = harness.cell_module(spec, "checks")
    numbers = check.check(r, check.control(r, out))
    assert any(v > spec["limits"][k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reads_layers(workload):
    res = _run(workload, trace=True)
    assert res["correct"]
    # the CPU trace has no device operations: device metrics read nothing
    spec = tiny_spec(workload)
    host = {m["name"] for m in spec["per_layer"] if m["source"] != "device_trace"}
    assert host <= set(res["metrics"]) <= {m["name"] for m in spec["per_layer"]}


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(card, workload):
    spec = harness.load_spec(workload)
    if torch.cuda.device_count() < spec["chips"]:
        pytest.skip(f"{workload} needs {spec['chips']} cards")
    res = run.execute(spec, 11, 2.0, False, str(card), 0.0)
    assert res["correct"], res["checks"]


def test_fit_window_holds_whole_periods():
    """The fit's window is ``fit_world``'s own loop after the checked steps:
    whole re-threshold periods, one guide rebuild and its steps each."""
    spec = tiny_spec("fit-ref-1024")
    r = harness.Run(spec=spec, seed=3, seconds=0.5, trace=False, device=torch.device("cpu"))
    driver = harness.load_module("drivers", "fit")
    st = driver.drive(r)
    period = spec["config"]["fit"]["rethreshold_every"]
    steps = r.records["steps"]
    assert steps > 0 and steps % period == 0
    assert len(r.spans["step"]) == steps
    assert len(r.spans["guide_rebuild"]) == steps // period
    assert st.step == steps + spec["traffic"]["checked_steps"]
    assert len(st.losses) == spec["traffic"]["checked_steps"]
    assert st.seeds.shape[0] == spec["traffic"]["batch"] == len(st.rng.last)
