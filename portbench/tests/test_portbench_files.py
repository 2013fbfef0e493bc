"""BENCHMARK.json against the benchmark's contract, and every file it
names: each configuration, traffic mix, cell and metric loads."""

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_every_cell_reports_what_it_must():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mine = [m["name"] for m in e2e
                if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in mine and len(mine) >= 2
        assert any("workloads" not in m or w["name"] in m["workloads"]
                   for m in per)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in per:
        assert m["moves"] in {x["name"] for x in e2e}
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    path = ROOT / cfg["file"]
    body = json.loads(path.read_text())
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"]
    assert set(cfg["reduced"]) <= set(body["assumed"])
    assert body["render"]["width"] == 1920 and body["render"]["height"] == 1080
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(w):
    from portbench import harness

    cell = harness.load_cell(w["name"], ROOT / "BENCHMARK.json")
    assert cell.params["limits"] and cell.params["check"]["frames"] >= 1
    period = int(cell.traffic.get("period", 1))
    assert all(0 <= p < period for p in cell.params["trace"]["phases"])
    calls = (cell.config.get("setup", []) + cell.traffic.get("setup", [])
             + cell.traffic.get("calls", []))
    for c in calls:
        mod = harness._call(c["call"])
        assert callable(mod.program) and callable(mod.reference)
    for name in cell.end_to_end:
        assert callable(harness._module(
            harness.ROOT / "end_to_end" / f"{name}.py").read)
    for name in cell.per_layer:
        mod = harness._module(harness.ROOT / "metrics" / f"{name}.py")
        assert callable(mod.read)
        assert not hasattr(mod, "TAP") or callable(mod.record)


def test_files_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("portbench/.cache"):
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
