#!/usr/bin/env python3
"""Phase 6e of chip_smoke.py (the analysis layer on the card) alone, with
the inputs it needs, on one CUDA card:

    python3 scripts/chip_analysis.py

Phases 1 and 2 (the card, the build), phase 5b's tree state (fractal
N = 409600, rc = 1, seed 42, f32, force_impl="tree", 5 cached steps),
phase 6b (the driver at N = 32768) and 6c (run_ensemble, 64 x 1000), then
6e on their files and that state. One JSON line a phase, as chip_smoke.py
prints them, then the phase's seconds (`phase_6e_s`). About 90 s of
command on an H100.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import al26_tpu_torch  # noqa: E402,F401  (TF32 off before phase 1 checks it)
import chip_smoke as cs  # noqa: E402


def main():
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.sim import init_cluster
    from al26_tpu_torch.sim.step import fresh_cache, run_steps_cached

    cs.phase_device()
    cs.phase_build()
    cfg = SimConfig(n=cs.N_TREE, model="fractal", rc=1.0, seed=42,
                    dtype="f32", force_impl="tree")
    state, aux, cfg = init_cluster(cfg, device=torch.device("cuda"))
    cache = fresh_cache(state, cfg, cfg.integrator, None, "tree")
    state, cache = run_steps_cached(state, cache, aux, cfg, 5, None, "tree")
    torch.cuda.synchronize()
    del cache
    drv = cs.phase_driver(0.0)
    grid = cs.phase_ensemble_driver()
    t0 = time.perf_counter()
    cs.phase_analysis(grid, drv, {"state5": state, "cfg": cfg})
    print("phase_6e_s", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
