"""The reference's force law, found by name from a configuration's "sim"
group.

force_impl "auto", "pallas" and "default" (the program's direct-sum paths)
resolve to the softened direct sum of gravity.py. Any other name resolves to
a module perfbench/reference/force_<name>.py, loaded by path; a name with no
such module raises FileNotFoundError naming the file to add, and never falls
back to the direct sum. A law module defines these functions, each taking
the configuration's whole "sim" group first (a tree law reads tree_theta,
tree_leaf, tree_kavg and tree_mac there):

  full(sim, pos, vel, mass, eps2, with_jerk=True, pot_eps2=None)
      (acc, jerk | None, pot | None) of every star: what the program
      computes by that law in a full sweep (the step-start and closing
      sweeps of hermite4_block, every sweep of hermite4 and leapfrog);
  virial_radius(sim, pos, mass)
      -G M^2 / (2 U) from the potential the program computes by that law;
  forces(sim, pos_rows, vel_rows, ids, pos, vel, mass, eps2,
         with_jerk=True, pot_eps2=None)            (optional)
      rows against every column, as gravity.forces: hermite4_block's
      subcycle of the fast rows against the predicted columns. Without it
      the direct sum, which the program's subcycle (kernel 2c) computes in
      every force law.
"""
from __future__ import annotations

import functools
import importlib.util
import os
from typing import Callable, NamedTuple

from . import gravity

DIRECT_NAMES = ("auto", "pallas", "default")
LAW_DIR = os.path.dirname(os.path.abspath(__file__))


class Law(NamedTuple):
    name: str
    full: Callable
    forces: Callable
    virial_radius: Callable


DIRECT = Law("direct", gravity.full, gravity.forces, gravity.virial_radius)


def resolve(sim: dict) -> Law:
    """The force law of a configuration's "sim" group (module docstring),
    looked up in LAW_DIR."""
    name = sim.get("force_impl", "auto")
    if name in DIRECT_NAMES:
        return DIRECT
    path = os.path.join(LAW_DIR, f"force_{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"force_impl {name!r} has no reference force law: add {path} "
            f"(perfbench/reference/forcelaw.py says what it defines)")
    spec = importlib.util.spec_from_file_location(f"perfbench_force_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bind = lambda fn: functools.partial(fn, sim)
    forces = bind(mod.forces) if hasattr(mod, "forces") else gravity.forces
    return Law(name, bind(mod.full), forces, bind(mod.virial_radius))
