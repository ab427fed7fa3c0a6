"""Discovery by name, and the form BENCHMARK.json must keep (keys, names,
units, bounds, which cells report which metrics)."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = spec.cell(BENCH, cell)
    assert NAME.match(cell) and NAME.match(entry["traffic"])
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    cfg = spec.config(entry["config"])
    traffic = spec.traffic(entry["traffic"])
    limits = spec.limits(cell)
    driver = spec.driver(traffic["driver"])
    for fn in ("setup", "unit", "bounds", "release", "failed", "check"):
        assert callable(getattr(driver, fn))
    assert cfg["name"] == entry["config"] and limits
    assert all(v > 0 for v in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, False)}
    layers = spec.metrics_of(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    assert all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    keys = {"name", "unit", "better", "source"}
    extra = set(metric) - keys
    if metric in BENCH["end_to_end"]:
        assert extra <= {"bound", "workloads"} and "bound" in metric
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert extra <= {"layer", "moves", "workloads"}
        assert {"layer", "moves"} <= set(metric)
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    assert callable(spec.reader(metric["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((spec.ROOT / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert data.get("reduced", []) == config["reduced"]
    assert all(k in data for k in config["reduced"])
    assert any(c["config"] == config["name"] for c in BENCH["workloads"])


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_of_filters_by_workloads():
    pre = {m["name"] for m in
           spec.metrics_of(BENCH, "fbms_pc.pretrain_480x640", True)}
    joint = {m["name"] for m in
             spec.metrics_of(BENCH, "fbms_pc.joint_2x480x640", True)}
    assert "flagship.roofline" in pre and "mfu.train" not in pre
    assert joint == {"mfu.train", "device_idle.train"}
