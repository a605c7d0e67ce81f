"""A run of each cell, at a tiny size on the CPU with the harness's look for
a card skipped, comes out correct; with the timed path broken underneath it
comes out not correct, once for each fault the cell can have: a step that
returns its state unchanged, half of the ensemble left out, and an answer
altered where it is produced."""
import importlib
import time

import pytest
import torch

from perfbench.harness import main
from perfbench.tests import cells

SIZES = {
    "n1k-ensemble64": ({"n": 64}, {"realizations": 4, "warmup_steps": 2}),
    "n100k-block": ({"n": 256, "k_fast": 32}, {"warmup_steps": 2}),
    "n1k-cli": ({"n": 48}, {}),
}
SECONDS = {"n1k-ensemble64": 1.0, "n100k-block": 1.0, "n1k-cli": 0.1}


def _run(name):
    ov, tov = SIZES[name]
    cs = cells.load(name)
    cs.traffic.update(tov)
    return main.run_cell(cs, 2**31 + 99, SECONDS[name], 0, "cpu",
                         time.perf_counter(), overrides=ov)


def _unchanged_steps(monkeypatch):
    step = importlib.import_module("al26_tpu_torch.sim.step")

    monkeypatch.setattr(step, "run_steps_cached",
                        lambda s, c, *a, **k: (s, c))


def _unchanged_ensemble(monkeypatch):
    from al26_tpu_torch.parallel import ensemble

    monkeypatch.setattr(ensemble, "ensemble_run_steps",
                        lambda s, *a, **k: s)


def _half_ensemble(monkeypatch):
    from al26_tpu_torch.parallel import ensemble
    from al26_tpu_torch.state import map_tensors

    real = ensemble.ensemble_run_steps

    def half(s, aux, cfg, n, flat=None):
        new = real(s, aux, cfg, n, flat)
        b = s.cluster.mass.shape[0] // 2
        return map_tensors(lambda a, o: torch.cat([a[:b], o[b:]]), new, s)

    monkeypatch.setattr(ensemble, "ensemble_run_steps", half)


def _altered_steps(monkeypatch):
    step = importlib.import_module("al26_tpu_torch.sim.step")

    real = step.run_steps_cached

    def altered(*a, **k):
        s, c = real(*a, **k)
        vel = s.cluster.vel.clone()
        vel[7] *= 1.01
        return s.replace(cluster=s.cluster.replace(vel=vel)), c

    monkeypatch.setattr(step, "run_steps_cached", altered)


def _unchanged_cli(monkeypatch):
    step = importlib.import_module("al26_tpu_torch.sim.step")
    monkeypatch.setattr(step, "run_steps_cached",
                        lambda s, c, *a, **k: (s, c))
    monkeypatch.setattr(step, "run_steps", lambda s, *a, **k: s)


def _altered_cli(monkeypatch):
    step = importlib.import_module("al26_tpu_torch.sim.step")
    cached, plain = step.run_steps_cached, step.run_steps

    def alter(s):
        vel = s.cluster.vel.clone()
        vel[7] *= 1.01
        return s.replace(cluster=s.cluster.replace(vel=vel))

    monkeypatch.setattr(step, "run_steps_cached",
                        lambda *a, **k: (lambda s, c: (alter(s), c))(
                            *cached(*a, **k)))
    monkeypatch.setattr(step, "run_steps",
                        lambda *a, **k: alter(plain(*a, **k)))


@pytest.mark.parametrize("name", list(SIZES))
def test_sound_run_is_correct(name):
    r = _run(name)
    bad = {k: v for k, v in r["compared"].items() if v["value"] > v["limit"]}
    assert r["correct"], bad


@pytest.mark.parametrize("name,fault", [
    ("n100k-block", _unchanged_steps),
    ("n100k-block", _altered_steps),
    ("n1k-ensemble64", _unchanged_ensemble),
    ("n1k-ensemble64", _half_ensemble),
    ("n1k-cli", _unchanged_cli),
    ("n1k-cli", _altered_cli),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_caught(name, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(name)
    assert r["compared"] and not r["correct"]
