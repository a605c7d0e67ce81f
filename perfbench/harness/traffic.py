"""The one generator of work: a traffic file's parameters, driven through the
program's own entry points.

A traffic mix is `perfbench/traffic/<name>.json`; its "kind" picks how the
work reaches the program, and every other key is a parameter of that kind:

  "steps"     one cluster stepped through sim.step.run_steps_cached, one
              step a unit, no saves ("warmup_steps");
  "ensemble"  "realizations" clusters stepped as one flattened system
              through parallel.ensemble.ensemble_run_steps_cached, one step
              of the whole ensemble a unit ("warmup_steps");
  "cli"       whole campaign runs through al26_tpu_torch.cli.main in this
              process, each into a new directory under TMPDIR with a new
              seed, one run a unit ("warmup_final_time": the simulated Myr
              of the warm-up run).

Each kind also reads "span_units" and "trace_units" (the units of a traced
run's span stretch and profiled stretch) and "check" (which units the
comparison samples: "sample_units" drawn from the seed among the window's
first "within" units, plus the window's last; for "cli", "runs" and
"intervals"). Everything is drawn from the seed, so the same seed gives the
same inputs. A unit returns the simulated Myr it completed.
"""
from __future__ import annotations

import importlib
import os
import shutil
import tempfile

import numpy as np


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of draws from the run's seed."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


class _Stepper:
    """What the two stepping kinds share: the window's unit count, the
    sampled (before, after) pairs and the spans a traced run opens."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 overrides: dict | None = None):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.overrides = overrides or {}
        chk = traffic.get("check", {})
        rng = seed_rng(seed, 1)
        within = int(chk.get("within", 64))
        k = min(int(chk.get("sample_units", 2)), within)
        self.keep = set(int(i) for i in
                        rng.choice(np.arange(1, within + 1), k,
                                   replace=False))
        self.units = 0
        self.pairs = []          # sampled (unit, before, after)
        self.last = None

    def begin_window(self) -> None:
        self.units = 0
        self.pairs = []
        self.last = None

    def _record(self, before, after) -> None:
        self.units += 1
        self.last = (self.units, before, after)
        if self.units in self.keep:
            self.pairs.append(self.last)

    def samples(self) -> list:
        """The sampled steps of the window, its last one included."""
        out = list(self.pairs)
        if self.last is not None and (not out or out[-1][0]
                                      != self.last[0]):
            out.append(self.last)
        return out

    def warm_up(self) -> None:
        for _ in range(int(self.traffic.get("warmup_steps", 0))):
            self.unit()

    def close(self) -> None:
        self.pairs, self.last = [], None


class StepsCell(_Stepper):
    """kind "steps": one cluster through sim.step.run_steps_cached."""

    def setup(self) -> None:
        from al26_tpu_torch.sim.init import init_cluster
        from al26_tpu_torch.sim.step import fresh_cache

        from .spec import sim_config

        cfg = sim_config(self.config, seed=self.seed, **self.overrides)
        self.state, self.aux, self.cfg = init_cluster(cfg,
                                                      device=self.device)
        self.cache = fresh_cache(self.state, self.cfg, self.cfg.integrator)
        self.dt = self.cfg.dt
        self.warm_up()

    def unit(self) -> float:
        from al26_tpu_torch.sim.step import run_steps_cached

        before = self.state
        self.state, self.cache = run_steps_cached(self.state, self.cache,
                                                  self.aux, self.cfg, 1)
        self._record(before, self.state)
        return self.dt

    def span_targets(self):
        step = importlib.import_module("al26_tpu_torch.sim.step")
        return [(step, "physics_after_advance", "physics.single")]


class EnsembleCell(_Stepper):
    """kind "ensemble": `realizations` clusters (seeds seed, seed + 1, ...)
    as one flattened system through ensemble_run_steps_cached."""

    def setup(self) -> None:
        from al26_tpu_torch.parallel import ensemble as ens

        from .spec import sim_config

        cfg = sim_config(self.config, seed=self.seed, **self.overrides)
        b = int(self.traffic["realizations"])
        self.state, self.aux, cfgs = ens.init_ensemble(cfg, b,
                                                       device=self.device)
        self.cfg = cfgs[0]
        self.cache = (ens.ensemble_fresh_cache(self.state, self.cfg)
                      if ens.ensemble_cacheable(self.state, self.cfg)
                      else None)
        self.dt = self.cfg.dt
        self.warm_up()

    def unit(self) -> float:
        from al26_tpu_torch.parallel import ensemble as ens

        before = self.state
        if self.cache is not None:
            self.state, self.cache = ens.ensemble_run_steps_cached(
                self.state, self.cache, self.aux, self.cfg, 1)
        else:
            self.state = ens.ensemble_run_steps(self.state, self.aux,
                                                self.cfg, 1)
        self._record(before, self.state)
        return self.dt

    def span_targets(self):
        from al26_tpu_torch.parallel import ensemble

        return [(ensemble, "ensemble_physics_after_advance",
                 "physics.ensemble")]


class CliCell:
    """kind "cli": whole campaign runs through cli.main, back to back."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 overrides: dict | None = None):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.overrides = overrides or {}
        self.root = os.path.join(tempfile.gettempdir(), "perfbench-cli")
        chk = traffic.get("check", {})
        self.check_runs = int(chk.get("runs", 2))
        self.check_intervals = int(chk.get("intervals", 2))
        self.units = 0
        self.dirs = []

    def argv(self, seed: int, base: str, final_time=None) -> list:
        """The command line of one run: the configuration's values under
        the CLI's flags (the others must be the CLI's defaults)."""
        from al26_tpu_torch.cli import build_parser, config_from_args

        from .spec import sim_config

        cfg = sim_config(self.config, **self.overrides)
        t_f = cfg.final_time if final_time is None else final_time
        argv = ["-n", str(cfg.n), "-rc", repr(cfg.rc), "-t_f", repr(t_f),
                "--dtype", cfg.dtype, "--integrator", cfg.integrator,
                "--seed", str(seed), "-f", base, "--device",
                str(self.device)]
        got = config_from_args(build_parser().parse_args(argv))
        want = cfg.replace(seed=seed, filename=base, final_time=t_f)
        if got.to_dict() != want.to_dict():
            diff = {k: (v, want.to_dict()[k]) for k, v in
                    got.to_dict().items() if want.to_dict()[k] != v}
            raise ValueError(f"the CLI cannot state this configuration: "
                             f"{diff}")
        return argv

    def _run(self, seed: int, path: str, final_time=None):
        from al26_tpu_torch import cli

        os.makedirs(path)
        cli.main(self.argv(seed, os.path.join(path, "run"), final_time))

    def setup(self) -> None:
        from .spec import sim_config

        self.cfg = sim_config(self.config, **self.overrides)
        shutil.rmtree(self.root, ignore_errors=True)
        warm = os.path.join(self.root, "warm-up")
        self._run(self.seed, warm,
                  float(self.traffic.get("warmup_final_time", 0.2)))
        shutil.rmtree(warm)

    def begin_window(self) -> None:
        self.units = 0

    def unit(self) -> float:
        self.units += 1
        path = os.path.join(self.root, f"run-{self.units}")
        self.dirs.append((self.seed + self.units, path))
        self._run(self.seed + self.units, path)
        return self.cfg.final_time

    def samples(self) -> list:
        """(seed, directory) of the runs the comparison reads: drawn from
        the seed among the window's runs, the last one included."""
        rng = seed_rng(self.seed, 1)
        runs = [d for d in self.dirs if os.path.isdir(d[1])]
        if not runs:
            return []
        k = min(self.check_runs, len(runs))
        picked = set(int(i) for i in rng.choice(len(runs) - 1, k - 1,
                                                replace=False)) \
            if k > 1 else set()
        picked.add(len(runs) - 1)
        return [runs[i] for i in sorted(picked)]

    def span_targets(self):
        driver = importlib.import_module("al26_tpu_torch.sim.driver")
        return [(driver, "run", "driver.run")]

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


KINDS = {"steps": StepsCell, "ensemble": EnsembleCell, "cli": CliCell}


def make_cell(config: dict, traffic: dict, seed: int, device,
              overrides: dict | None = None):
    return KINDS[traffic["kind"]](config, traffic, seed, device, overrides)
