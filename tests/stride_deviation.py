"""How far a gravity-strided run lands from the unstrided one, in the JAX
package and in the port, on the CPU from the same initial bits.

    JAX_PLATFORMS=cpu python tests/stride_deviation.py [--n 32768]
        [--stride 4] [--threads 4]

Plummer rc = 1, seed 42, f32, force_impl="pallas", hermite4_block with
k_fast = 256 (the configuration of chip_smoke.py's phases 5 and 5s):
20 steps as two cached chunks of 10, unstrided (run_steps_cached) and
strided (run_steps_cached_strided). The JAX package runs its Pallas
kernels in interpret mode, the port its kernels' plain versions. Prints
one JSON line per package: the pos RMS difference strided against
unstrided (pc), the largest single-star distances, the total SLR's
relative difference and each channel's totals, and each run's relative
change in total energy (kinetic + eps2-softened potential, f64); then one
line with the port against the JAX package, run for run. chip_smoke.py's
phase 5s holds the card's strided run to the JAX package's numbers here.
The JAX package's state is built by its own init_cluster and carried over
with state_from_numpy / aux_from_numpy, as tests/test_torch_step.py does.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

_AUX = ("hm_idx", "hm_slot_valid", "msrc_idx", "msrc_valid", "agb_grid_t",
        "agb_grid_rates", "kick_vel")


def _energy(c, eps2: float) -> float:
    import numpy as np
    import torch

    from al26_tpu_torch.ops.nbody import total_energy

    t = lambda k: torch.as_tensor(np.asarray(c[k], np.float64))
    return float(total_energy(t("pos"), t("vel"), t("mass"), eps2))


def _deviation(u: dict, s: dict, e0: float, eps2: float) -> dict:
    import numpy as np

    d2 = ((s["pos"].astype(np.float64) - u["pos"]) ** 2).sum(1)
    su, ss = u["slr"].astype(np.float64), s["slr"].astype(np.float64)
    return {"pos_rms_pc": float(np.sqrt(d2.mean())),
            "largest_pc": np.sort(np.sqrt(d2))[::-1][:5].tolist(),
            "slr_total_rel": float(abs(ss.sum() - su.sum()) / su.sum()),
            "slr_channels": {"strided": ss.sum((0, 1)).tolist(),
                             "unstrided": su.sum((0, 1)).tolist()},
            "mass_equal": bool(np.array_equal(s["mass"], u["mass"])),
            "energy_rel_change": {
                "strided": (_energy(s, eps2) - e0) / abs(e0),
                "unstrided": (_energy(u, eps2) - e0) / abs(e0)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from al26_tpu.config import SimConfig as JaxConfig
    from al26_tpu.sim import init_cluster as jax_init
    from al26_tpu.state import cluster_to_numpy as jax_to_numpy
    from al26_tpu_torch.config import SimConfig
    from al26_tpu_torch.state import (
        aux_from_numpy, cluster_to_numpy, state_from_numpy,
    )

    torch.set_num_threads(args.threads)
    jax_step = importlib.import_module("al26_tpu.sim.step")
    port_step = importlib.import_module("al26_tpu_torch.sim.step")

    kw = dict(n=args.n, rc=1.0, seed=42, dtype="f32", force_impl="pallas",
              integrator="hermite4_block", k_fast=256)
    js, ja, jcfg = jax_init(JaxConfig(**kw))
    c0 = jax_to_numpy(js.cluster)
    ts = state_from_numpy(c0, np.asarray(js.time), np.asarray(js.step_count),
                          dtype=torch.float32, device="cpu")
    aux_np = {f: np.asarray(getattr(ja, f)) for f in _AUX}
    aux_np["stellar_tbl"] = [np.asarray(a) for a in ja.stellar_tbl]
    ta = aux_from_numpy(aux_np, device="cpu")
    tcfg = SimConfig.from_dict(jcfg.to_dict())
    e0 = _energy(c0, jcfg.eps2)

    def run(pkg, s, a, cfg, strided):
        cache = pkg.fresh_cache(s, cfg, "hermite4_block", None, "pallas")
        runner = pkg.run_steps_cached_strided if strided \
            else pkg.run_steps_cached
        for _ in range(2):
            s, cache = runner(s, cache, a, cfg, 10, None, "pallas")
        return s

    out = {}
    for name, pkg, s, a, cfg, conv in (
            ("jax", jax_step, js, ja, jcfg, jax_to_numpy),
            ("port", port_step, ts, ta, tcfg, cluster_to_numpy)):
        t0 = time.perf_counter()
        u = conv(run(pkg, s, a, cfg, False).cluster)
        st = conv(run(pkg, s, a, cfg.replace(gravity_stride=args.stride),
                      True).cluster)
        out[name] = (u, st)
        print(json.dumps({"package": name, "n": args.n,
                          "stride": args.stride,
                          "seconds": time.perf_counter() - t0,
                          **_deviation(u, st, e0, jcfg.eps2)}), flush=True)
    agree = {}
    for i, run_name in enumerate(("unstrided", "strided")):
        j, p = out["jax"][i], out["port"][i]
        agree[run_name] = {
            "pos_max_rel": float(np.abs(p["pos"].astype(np.float64)
                                        - j["pos"]).max()
                                 / np.abs(j["pos"]).max()),
            "slr_total_rel": float(abs(p["slr"].astype(np.float64).sum()
                                       - j["slr"].astype(np.float64).sum())
                                   / j["slr"].astype(np.float64).sum()),
            "mass_equal": bool(np.array_equal(p["mass"], j["mass"]))}
    print(json.dumps({"port_against_jax": agree}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
