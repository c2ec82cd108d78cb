"""BENCHMARK.json and the files the harness finds by name."""

import json
import os
import re

import pytest

from benchmark import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    bench, c, config, traffic = harness.load_cell(harness.ROOT, cell["name"])
    assert c["chips"] == 1
    assert config["name"] == c["config"]
    assert traffic["kind"] in ("paired_end", "long")
    assert os.path.exists(os.path.join(harness.ROOT, "benchmark", "references",
                                       config["reference"] + ".py"))
    assert len(c["why"]) <= 200
    names = [m["name"] for m in harness.metrics_of(bench, c["name"], False)]
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_of(bench, c["name"], True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(harness.ROOT, metric["name"]))
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        assert 1 <= len(metric["layer"]) <= 200
        assert set(metric["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_roofline_names_and_units():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell(harness.ROOT, "no_such.cell")
