"""The harness finds every cell's configuration, traffic, driver, check,
limits and metrics by name, ``BENCHMARK.json`` keeps to the benchmark's
contract, and nothing the benchmark loads is JAX or the JAX package."""

import json
import re
import subprocess
import sys

import pytest

import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_spec_found_by_name(workload):
    spec = harness.load_spec(workload)
    driver = spec["traffic"]["driver"]
    for kind in ("drivers", "checks"):
        assert (harness.BENCH_DIR / kind / f"{driver}.py").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_gpu"] and BENCH["command"][1].startswith("bench_gpu/")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 2 * (rs + 60) + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_gpu/configs/")
        assert harness.load_json(harness.ROOT / c["file"])["name"] == c["name"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and "\n" not in m["layer"]
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", WORKLOADS))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_nothing_loaded_is_jax():
    """A fresh process that loads the harness, every driver, check, file of
    faults, metric and the reference, and imports the port's modules the
    drivers and faults use, holds
    no module whose top-level name is jax, jaxlib, flax or
    raytracing_test_tpu (the port's own name only begins with that)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness, calibrate, ranks, run\n"
        "import reference.march, reference.train, reference.scene, reference.world\n"
        "import roofline.march, roofline.window\n"
        "for k in ('drivers', 'checks', 'faults', 'metrics'):\n"
        "    for p in sorted((harness.BENCH_DIR / k).glob('*.py')):\n"
        "        harness.load_module(k, p.stem)\n"
        "import raytracing_test_tpu_torch.app.session, raytracing_test_tpu_torch.app.fit\n"
        "import raytracing_test_tpu_torch.parallel.sharding, raytracing_test_tpu_torch.worldgen.terrain\n"
        "print(harness.forbidden_modules())\n"
    ) % (str(harness.ROOT), str(harness.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    fake = dict(sys.modules)
    fake["raytracing_test_tpu_torch.app"] = sys
    monkeypatch.setattr(sys, "modules", fake)
    assert "raytracing_test_tpu" not in harness.forbidden_modules()
    fake["raytracing_test_tpu.render"] = sys
    assert "raytracing_test_tpu" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    for p in (harness.BENCH_DIR / "reference").glob("*.py"):
        src = p.read_text()
        assert not re.search(r"^\s*(from|import)\s+raytracing_test_tpu", src, re.M), p


def test_exits_without_a_card(monkeypatch, capsys):
    import torch

    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
