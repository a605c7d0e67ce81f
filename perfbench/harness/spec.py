"""Cells, configurations, traffic mixes, limits and per-layer metric readers,
found by name.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration is
`perfbench/configs/<config>.json` (the SimConfig fields under "sim"), its
traffic mix `perfbench/traffic/<traffic>.json` (the parameters the one
generator of harness/traffic.py reads), the limits of its comparison
`perfbench/limits/<cell>.json`, each per-layer metric a reader
`perfbench/metrics/<metric>.py`, and the reference's force law of a
configuration whose force_impl is not a direct sum a module
`perfbench/reference/force_<force_impl>.py` (reference/forcelaw.py). A
later cell or metric is new files and new entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    bench = load_benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    limits_path = os.path.join(bench_dir, "limits", f"{name}.json")
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=read_json(os.path.join(bench_dir, "configs",
                                      f"{w['config']}.json")),
        traffic=read_json(os.path.join(bench_dir, "traffic",
                                       f"{w['traffic']}.json")),
        limits=read_json(limits_path) if os.path.exists(limits_path) else {},
        end_to_end=e2e, per_layer=per_layer)


def sim_config(config: dict, **overrides):
    """The program's SimConfig from a configuration file's "sim" group."""
    from al26_tpu_torch.config import SimConfig

    return SimConfig(**{**config["sim"], **overrides})


def load_metric(name: str, bench_dir: str = BENCH_DIR):
    """The reader module perfbench/metrics/<name>.py (names may hold dots,
    so it is loaded by path)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
