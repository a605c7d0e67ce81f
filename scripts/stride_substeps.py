#!/usr/bin/env python3
"""Substeps of the hermite4_block subcycle, step by step, with and without
the gravity stride, from the same initial state.

    python3 scripts/stride_substeps.py [--n 409600] [--model fractal]
        [--force-impl tree] [--steps 8] [--stride 4] [--device cuda]

init_cluster (rc = 1, seed 42, f32, the default knobs of the force
backend), then `--steps` cached steps one at a time (run_steps_cached)
and the same span as strides one at a time (run_strides_cached), each
from a fresh cache of the initial state. For every advance one JSON line:
the substeps it took (the subcycle's timestep criterion is read once a
substep, so the count is exact), the first substep's natural step, the
median and the smallest, all in units of dt (before the clamp to the
span's end), and the kernel-2c launches where the kernels run. The
natural step is eta * sqrt(min |a|^2 / |j|^2) over the fast rows.
Prints the card's name and power limit first where there is one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=409600)
    ap.add_argument("--model", default="fractal")
    ap.add_argument("--force-impl", default="tree")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    import al26_tpu_torch.ops.integrators as integ
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody
    from al26_tpu_torch.sim import init_cluster
    from al26_tpu_torch.sim.step import (
        fresh_cache, run_steps_cached, run_strides_cached,
    )

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    cfg = SimConfig(n=args.n, model=args.model, rc=1.0, seed=42,
                    dtype="f32", force_impl=args.force_impl,
                    integrator="hermite4_block")
    state0, aux, cfg = init_cluster(cfg, device=dev)
    m, fi = args.stride, args.force_impl

    crits = []
    min_crit = integ._min_crit

    def recorded(a, j):
        c = min_crit(a, j)
        crits.append(c)
        return c

    integ._min_crit = recorded

    def advance(label, k, fn):
        crits.clear()
        before = cuda_nbody.LAUNCHES["nbody_predcols_mma"]
        out = fn()
        h = cfg.eta_hermite * np.sqrt(torch.stack(crits).double().cpu()
                                      .numpy()) / cfg.dt
        print(json.dumps({
            "run": label, "advance": k, "span_dt": 1 if label == "step"
            else m, "substeps": len(h),
            "substeps_per_dt": len(h) / (1 if label == "step" else m),
            "first_h_dt": float(h[0]), "median_h_dt": float(np.median(h)),
            "min_h_dt": float(h.min()),
            "predcols_mma": cuda_nbody.LAUNCHES["nbody_predcols_mma"]
            - before}), flush=True)
        return out

    s = state0
    cache = fresh_cache(s, cfg, cfg.integrator, None, fi)
    for k in range(args.steps):
        s, cache = advance("step", k, lambda: run_steps_cached(
            s, cache, aux, cfg, 1, None, fi))
    scfg = cfg.replace(gravity_stride=m)
    s = state0
    cache = fresh_cache(s, scfg, scfg.integrator, None, fi)
    for k in range(args.steps // m):
        s, cache = advance("stride", k, lambda: run_strides_cached(
            s, cache, aux, scfg, 1, m, None, fi))
    return 0


if __name__ == "__main__":
    sys.exit(main())
