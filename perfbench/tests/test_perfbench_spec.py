"""BENCHMARK.json, the configurations, traffic mixes, limits and metric
readers load, and agree with each other; so do the parked cells'
entries."""
import json
import os
import re

import pytest

from perfbench.harness import spec
from perfbench.tests import cells

BENCH = spec.load_benchmark()
ALL = cells.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", ALL["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(w):
    cell = spec.load_cell(w["name"], ALL)
    assert NAME.match(cell.name) and cell.chips == 1
    cfg = spec.sim_config(cell.config)
    assert cfg.dtype == "f32"
    assert cell.traffic["kind"] in ("steps", "ensemble", "cli")
    assert cell.limits, "every cell states the limits of its comparison"
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len(w["why"]) <= 200


@pytest.mark.parametrize("m", ALL["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_match(m):
    mod = spec.load_metric(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.WORKLOADS) == (
        m["unit"], m["layer"], m["moves"], m["workloads"])
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    e2e = {e["name"]: e for e in ALL["end_to_end"]}
    for w in m["workloads"]:
        assert w in e2e[m["moves"]].get("workloads", [w])


def test_configs_and_metrics_named_once():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    names = [x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert spec.read_json(os.path.join(spec.ROOT, c["file"]))[
            "reduced"] == c["reduced"]


@pytest.mark.parametrize("path", cells.PARKED, ids=os.path.basename)
def test_parked_cells_left_the_benchmark(path):
    """A parked file holds a cell's own entries, none of them still in
    BENCHMARK.json, and names no cell of BENCHMARK.json."""
    parked = spec.read_json(path)
    assert set(parked) == {"why", "workloads", "end_to_end", "per_layer"}
    names = {w["name"] for w in parked["workloads"]}
    assert not names & {w["name"] for w in BENCH["workloads"]}
    for key in ("end_to_end", "per_layer"):
        assert not ({m["name"] for m in parked[key]}
                    & {m["name"] for m in BENCH[key]})
        for m in parked[key]:
            assert set(m.get("workloads", names)) <= names
    assert {c["name"] for c in BENCH["configs"]} >= {
        w["config"] for w in parked["workloads"]}
