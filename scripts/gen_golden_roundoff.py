"""Generate tests/golden/n1k_roundoff.json: how far the JAX package's own
golden N = 1k statistics move when its initial positions move by one ulp.

For each golden mode (default, sn_parity, sn_parity_seba) this runs P = 3
copies of the golden configuration (tests/golden_stats.py: N = 1000,
rc = 1 pc, t_f = 10 Myr, f64 on the CPU). Copy p starts from the golden
seed's initial state with every position component moved by one ulp
(np.nextafter toward +inf or -inf, the signs drawn from
np.random.default_rng(p)). Each run is summarised with
golden_stats.summarize, and the file holds, per mode and key, the largest
|v_p - golden| over the P runs, the golden taken from n1k_stats.json.

The file is the yardstick for a second implementation of the same physics
(one that differs by reduction order only): a float key passes if
|v - golden| <= max(10 * d_k, 1e-12 * |golden|), an integer key equals the
golden where d_k = 0 and lies within golden +- d_k otherwise, and `time`
is exact (tests/test_torch_golden_stats.py).

    python scripts/gen_golden_roundoff.py [--jobs 3]

P, the modes and the output path are fixed: they define the bar. About
90 s a run on one CPU core; nine runs in all, --jobs of them at once (each
in a process of its own).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time

os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from golden_stats import N_GOLDEN, SEED_GOLDEN, summarize  # noqa: E402

MODES = {
    "default": (False, "lc18"),
    "sn_parity": (True, "lc18"),
    "sn_parity_seba": (True, "seba"),
}
RUNS = 3  # P
GOLDEN_PATH = os.path.join(ROOT, "tests", "golden", "n1k_stats.json")
OUT_PATH = os.path.join(ROOT, "tests", "golden", "n1k_roundoff.json")


def nudge(pos: np.ndarray, p: int) -> np.ndarray:
    """Every component of pos moved by one ulp, toward +inf or -inf by a
    sign drawn from default_rng(p)."""
    sign = np.random.default_rng(p).choice([-1.0, 1.0], size=pos.shape)
    return np.nextafter(pos, sign * np.inf)


def run_nudged(mode: str, p: int):
    from al26_tpu.config import SimConfig
    from al26_tpu.sim import init_cluster, run_steps

    parity, tracks = MODES[mode]
    t0 = time.perf_counter()
    cfg = SimConfig(n=N_GOLDEN, rc=1.0, final_time=10.0, seed=SEED_GOLDEN,
                    dtype="f64", sn_parity_mode=parity, mass_tracks=tracks)
    state, aux, cfg = init_cluster(cfg)
    pos = nudge(np.asarray(state.cluster.pos, np.float64), p)
    state = state.replace(cluster=state.cluster.replace(
        pos=jax.numpy.asarray(pos)))
    state = run_steps(state, aux, cfg, cfg.n_steps)
    got = summarize(state, cfg)
    print(f"{mode} p={p}: {time.perf_counter() - t0:.1f} s, "
          f"n_kicked={got['n_kicked']} "
          f"n_enriched_26al={got['n_enriched_26al']}", flush=True)
    return got


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args()
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    runs = [(mode, p) for mode in MODES for p in range(RUNS)]
    with concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
        got = dict(zip(runs, ex.map(run_nudged, *zip(*runs))))
    out = {}
    for mode in MODES:
        want = golden[mode]
        dev = {k: 0 if isinstance(v, int) else 0.0 for k, v in want.items()}
        for p in range(RUNS):
            g = got[mode, p]
            assert set(g) == set(want), (mode, set(g) ^ set(want))
            for k, v in want.items():
                dev[k] = max(dev[k], abs(g[k] - v))
        out[mode] = dev
    with open(OUT_PATH, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print("wrote", os.path.abspath(OUT_PATH))


if __name__ == "__main__":
    main()
