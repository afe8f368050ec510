"""BENCHMARK.json and the files it names: found by name, within the
contract's limits."""

import json
import os
import re

import pytest

from benchmark import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", CELLS):
            assert m["moves"] in [x["name"] for x in
                                  harness.cell_spec(c, BENCH)["end_to_end"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    s = harness.cell_spec(cell, BENCH)
    assert s["cell"]["chips"] == 1
    assert {m["name"] for m in s["end_to_end"]} >= {"setup_s"}
    assert len(s["end_to_end"]) >= 2 and s["per_layer"]
    drv = harness.load_module("drivers", s["workload"]["driver"])
    for method in ("setup", "window", "profile_steps", "release", "judge",
                   "control"):
        assert callable(getattr(drv.Cell, method))
    limits = s["workload"]["limits"]
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    path = os.path.join(harness.ROOT, config["file"])
    assert config["file"].startswith("benchmark/configs/")
    data = json.load(open(path))
    assert data["name"] == config["name"]
    assert config["reduced"] == data["reduced"]
    assert len(config["source"]) <= 200 and len(config["why"]) <= 200


READERS = sorted(f[:-3] for f in os.listdir(
    os.path.join(harness.HERE, "layer_metrics"))
    if f.endswith(".py") and not f.startswith("_"))


def test_every_layer_metric_has_its_reader():
    assert set(LAYER) <= set(READERS)


@pytest.mark.parametrize("metric", READERS)
def test_layer_metric_reader_found_by_name(metric):
    reader = harness.load_module("layer_metrics", metric)
    assert reader.read({}) is None


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.cell_spec("no_such.cell", BENCH)
    with pytest.raises(FileNotFoundError):
        harness.load_module("drivers", "no_such_driver")
