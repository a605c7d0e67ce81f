"""The reference's force law found by name (reference/forcelaw.py): the
benchmark's configurations resolve to the direct sum; a tree configuration
takes its reference from a force_<name>.py module with no edit to the
harness or the reference; a configuration whose law has no module fails in
set-up, before any window; and the reference and control of each cell give
the numbers recorded before the lookup existed (reference_numbers.json:
every compared and read number as float.hex, and a SHA-256 of one whole
reference step's outputs, recorded with torch 2.13 on an x86-64 CPU)."""
import copy
import hashlib
import json
import os
import time

import pytest
import torch

from perfbench import control
from perfbench.harness import check, main, spec
from perfbench.harness.traffic import make_cell
from perfbench.reference import forcelaw, gravity, physics
from perfbench.tests import cells

SEED = 2**31 + 7
SIZES = {
    "n1k-ensemble64": ({"n": 64}, {"realizations": 4, "warmup_steps": 2}),
    "n100k-block": ({"n": 256, "k_fast": 32}, {"warmup_steps": 2}),
    "n1k-cli": ({"n": 48}, {}),
}
UNITS = {"n1k-ensemble64": 3, "n100k-block": 3, "n1k-cli": 1}
RECORDED = os.path.join(os.path.dirname(__file__), "reference_numbers.json")

# a force law that sweeps by the direct sum, reading the configuration's
# "sim" group, which every function of a law receives whole, and noting
# each call in the file NOTES
TREE_LAW = '''
from perfbench.reference import gravity

NOTES = {notes!r}


def _note(sim, what):
    if (sim["force_impl"], sim["tree_theta"]) != ("tree", 0.75):
        raise ValueError(f"not the tree configuration's sim group: {{sim}}")
    with open(NOTES, "a") as f:
        f.write(what + "\\n")


def full(sim, pos, vel, mass, eps2, with_jerk=True, pot_eps2=None):
    _note(sim, "full")
    return gravity.full(pos, vel, mass, eps2, with_jerk, pot_eps2)


def virial_radius(sim, pos, mass):
    _note(sim, "virial_radius")
    return gravity.virial_radius(pos, mass)
'''


def _tree_cell(name="n100k-block"):
    """The n100k-block cell with a fractal tree configuration (the program
    runs its tree tier with the plain near field on the CPU)."""
    cs = copy.deepcopy(cells.load(name))
    cs.config["sim"].update({"model": "fractal", "force_impl": "tree",
                             "tree_theta": 0.75, "tree_leaf": 64})
    cs.traffic.update(SIZES[name][1])
    return cs


@pytest.mark.parametrize("c", spec.load_benchmark()["configs"],
                         ids=lambda c: c["name"])
def test_benchmark_configs_take_the_direct_sum(c):
    sim = spec.read_json(os.path.join(spec.ROOT, c["file"]))["sim"]
    assert forcelaw.resolve(sim) is forcelaw.DIRECT
    rp = physics.resolve(sim, sim["n"], float(sim["n"]), False)
    assert rp["law"] is forcelaw.DIRECT
    assert rp["law"].full is gravity.full


@pytest.mark.parametrize("name", ["auto", "pallas", "default"])
def test_direct_names(name):
    assert forcelaw.resolve({"force_impl": name}) is forcelaw.DIRECT


def test_tree_law_found_by_name(tmp_path, monkeypatch):
    """A run of a tree configuration takes its full sweeps and its virial
    radius from force_tree.py, and its subcycle's sweeps from the direct
    sum, since the module defines no `forces`."""
    notes = tmp_path / "notes.txt"
    (tmp_path / "force_tree.py").write_text(TREE_LAW.format(notes=str(notes)))
    monkeypatch.setattr(forcelaw, "LAW_DIR", str(tmp_path))
    cs = _tree_cell()
    law = forcelaw.resolve(cs.config["sim"])
    assert law.name == "tree" and law.forces is gravity.forces
    r = main.run_cell(cs, SEED, 0.5, 0, "cpu", time.perf_counter(),
                      overrides={"n": 512, "k_fast": 32})
    assert r["compared"] and r["attempted"] > 0
    # each compared step: its virial radius, then the step-start and the
    # closing sweep of hermite4_block
    calls = notes.read_text().split()
    n_vir = calls.count("virial_radius")
    assert n_vir > 0 and calls.count("full") == 2 * n_vir


def test_missing_law_fails_in_setup(tmp_path, monkeypatch):
    """No force_tree.py: run_cell and the control's readings raise, naming
    the file, before the program's cell is made or set up."""
    monkeypatch.setattr(forcelaw, "LAW_DIR", str(tmp_path))
    made = []
    monkeypatch.setattr(main, "make_cell", lambda *a, **k: made.append(a))
    monkeypatch.setattr(control, "make_cell", lambda *a, **k: made.append(a))
    cs = _tree_cell()
    want = str(tmp_path / "force_tree.py")
    with pytest.raises(FileNotFoundError, match="force_tree.py") as err:
        main.run_cell(cs, SEED, 0.5, 0, "cpu", time.perf_counter())
    assert want in str(err.value)
    with pytest.raises(FileNotFoundError, match="force_tree.py"):
        control.readings(cs, SEED, 0.5, True, "cpu")
    with pytest.raises(FileNotFoundError, match="force_tree.py"):
        physics.resolve(cs.config["sim"], 64, 64.0, False)
    assert made == []


def _digest(d: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(d):
        t = d[k] if torch.is_tensor(d[k]) else torch.as_tensor(d[k])
        h.update(k.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _numbers(name: str) -> dict:
    """The cell's compared and read numbers, from the reference and from
    the control, over a few units of its program at the CPU size, and the
    digest of one whole reference step from the last sample's start."""
    ov, tov = SIZES[name]
    cs = cells.load(name)
    cs.traffic.update(tov)
    cell = make_cell(cs.config, cs.traffic, SEED, "cpu", ov)
    try:
        cell.setup()
        cell.begin_window()
        for _ in range(UNITS[name]):
            cell.unit()
        out = {}
        for side, ctl in (("reference", False), ("control", True)):
            comp, info, _ = check.compare(cs, cell, "cpu", control=ctl)
            out[side] = {**{k: float(v["value"]).hex()
                            for k, v in comp.items()},
                         **{k: float(v).hex() for k, v in info.items()}}
            if cs.traffic["kind"] != "cli":
                ens = cs.traffic["kind"] == "ensemble"
                _, before, _ = cell.samples()[-1]
                c0, sc = check._cluster(before, 0 if ens else None, "cpu")
                rp = physics.resolve(cs.config["sim"], c0["pos"].shape[0],
                                     float(c0["m0"].sum()), ens)
                out[side]["step_digest"] = _digest(
                    check._ref_steps(c0, rp, sc, 1, ctl))
    finally:
        cell.close()
    return out


@pytest.mark.parametrize("name", sorted(SIZES))
def test_reference_numbers_unchanged(name):
    with open(RECORDED) as f:
        want = json.load(f)[name]
    assert _numbers(name) == want
