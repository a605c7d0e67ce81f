"""The port's side of the golden N = 1k end-to-end statistics: the JAX
package's pinned configuration (tests/golden_stats.py) run by
al26_tpu_torch, summarised into the same keys, and the bar that holds it
to the JAX package's golden file (tests/golden/n1k_stats.json).

The port runs the same f64 arithmetic as the JAX package in another
reduction order, so a full 1000-step run cannot reproduce the golden
bits. The bar is the JAX package's own sensitivity to round-off
(tests/golden/n1k_roundoff.json, scripts/gen_golden_roundoff.py): d_k,
the largest distance of key k from the golden over runs whose initial
positions moved by one ulp. A float key passes if |v - golden| <=
max(10 d_k, 1e-12 |golden|); an integer key equals the golden where
d_k = 0 and lies within golden +- d_k otherwise; `time` is exact.

Imports only the port, numpy and torch (chip_smoke.py uses it on the
card). Used by tests/test_torch_golden_stats.py.
"""
from __future__ import annotations

import json
import os

import numpy as np

N_GOLDEN = 1000
SEED_GOLDEN = 20260816
MODES = {
    "default": (False, "lc18"),
    "sn_parity": (True, "lc18"),
    "sn_parity_seba": (True, "seba"),
}
INT_KEYS = ("n_kicked", "n_disk_alive", "n_enriched_26al",
            "n_enriched_60fe")
ROUNDOFF_FACTOR = 10.0
REL_FLOOR = 1e-12
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")


def run_golden(mode: str, device="cuda", dtype: str = "f64",
               n_steps: int | None = None):
    """The pinned configuration of `mode` on `device` (N = 1000,
    rc = 1.0 pc, t_f = 10 Myr: the reference's dt = t_f / 1000,
    al26_nbody.py:786; the golden seed, the mode's SN gate and mass
    tracks), run for n_steps (default: the whole 1000); returns
    (state, cfg)."""
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.sim import init_cluster, run_steps

    parity, tracks = MODES[mode]
    cfg = SimConfig(n=N_GOLDEN, rc=1.0, final_time=10.0, seed=SEED_GOLDEN,
                    dtype=dtype, sn_parity_mode=parity, mass_tracks=tracks)
    state, aux, cfg = init_cluster(cfg, device=device)
    state = run_steps(state, aux, cfg,
                      cfg.n_steps if n_steps is None else n_steps)
    return state, cfg


def summarize(state, cfg) -> dict:
    """tests/golden_stats.py:summarize on a port state: the per-channel
    cluster sums the CSV rows carry (al26_nbody.py:221-241) and the
    final-enrichment ratio percentiles postprocess.py derives, over the
    enriched discs (the same numpy reductions on the host copy)."""
    from al26_tpu_torch.state import CHANNEL_NAMES, ISO_NAMES

    c = state.cluster
    host = lambda t: t.detach().cpu().numpy()
    slr = host(c.slr).astype(np.float64)
    slr_final = host(c.slr_final).astype(np.float64)
    out = {
        "time": float(state.time),
        "n_kicked": int(host(c.kicked).sum()),
        "n_disk_alive": int(host(c.disk_alive).sum()),
    }
    for s, iso in enumerate(ISO_NAMES):
        for ci, ch in enumerate(CHANNEL_NAMES[:3]):   # local, global, sne
            out[f"sum_{ch}_{iso}"] = float(slr[:, s, ci].sum())
            out[f"sum_{ch}_{iso}_final"] = float(slr_final[:, s, ci].sum())
    mass = host(c.mass)
    lm = ((mass >= cfg.low_mass_min) & (mass <= cfg.low_mass_max)
          & ~host(c.is_interloper))
    stable = {"26al": host(c.mass_27al).astype(np.float64),
              "60fe": host(c.mass_56fe).astype(np.float64)}
    for s, iso in enumerate(ISO_NAMES):
        tot = slr_final[:, s, 0] + slr_final[:, s, 2]   # local + sne
        ratio = tot[lm] / stable[iso][lm]
        nz = ratio[ratio > 0.0]
        out[f"n_enriched_{iso}"] = int(nz.size)
        out[f"ratio_{iso}_max"] = float(nz.max()) if nz.size else 0.0
        for q in (10, 50, 90):
            out[f"ratio_{iso}_p{q}"] = (
                float(np.percentile(nz, q)) if nz.size else 0.0
            )
    return out


def load(name: str) -> dict:
    """tests/golden/<name>.json (n1k_stats, n1k_roundoff)."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


def bar(key: str, golden: float, d: float) -> float:
    """The largest distance from the golden that key may take."""
    if key == "time":
        return 0.0
    if key in INT_KEYS:
        return d
    return max(ROUNDOFF_FACTOR * d, REL_FLOOR * abs(golden))


def against_golden(got: dict, golden: dict, roundoff: dict) -> dict:
    """{key: (distance, bar)} of a summary against the golden of its
    mode, every key of the golden; a key passes if distance <= bar."""
    if set(got) != set(golden):
        raise KeyError(f"summary keys differ: {sorted(set(got) ^ set(golden))}")
    return {k: (abs(got[k] - golden[k]), bar(k, golden[k], roundoff[k]))
            for k in sorted(golden)}


def worst(dist: dict) -> tuple[str, float]:
    """The key with the largest distance over bar, and that ratio (a
    distance of 0 against a bar of 0 counts 0; any other distance against
    a bar of 0 counts inf)."""
    def ratio(db):
        d, b = db
        return 0.0 if d == 0 else (d / b if b > 0 else float("inf"))
    k = max(dist, key=lambda k: ratio(dist[k]))
    return k, ratio(dist[k])
