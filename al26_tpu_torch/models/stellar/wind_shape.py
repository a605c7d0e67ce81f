"""SeBa MS-wind timing calibration (data/seba/wind-shape.csv).

Derived by scripts/gen_wind_shape.py from the reference repository's own
committed SeBa figures (`limongi-2006.tar.gz::cumulative_yield.pdf` —
vector plot polylines of the cumulative 26Al wind release SeBa produced
on the [20..60] Msun grid, i.e. the actual per-step
`wind_mass_loss_rate(t)` history the reference consumed,
al26_nbody.py:886-895, integrated). Three shape quantities per grid
mass (see the generator's docstring for the extraction/validation):

  tau_knee — MS/post-MS release boundary as a fraction of the collapse
      time (0.85-0.90 across the grid; Hurley's MS fraction 1/1.11 =
      0.9009 sits at its upper edge, validating evolution.py's t_ms);
  ms_frac  — fraction of the LIFETIME wind release shed on the MS
      (0.032 at 20 Msun -> 0.100 at 60: SeBa's MS sheds a few percent,
      NOT the 50% budget cap the round-4 model allowed);
  ramp_c   — the within-MS rate rise, rate(tau) ∝ 1 + c*tau/tau_ms
      (c = 2.9 -> 1.5: the rate roughly triples over the MS at 20 Msun,
      2.5x at 60 — SeBa's L(t) growth through its NJ90-style
      prescription; monotone, not flat);
  q25/q50/q75 — within-MS cumulative release quantiles (positions in
      tau/tau_ms), pinned against the model in tests.

Consumed by evolution._phase_rates: the MS wind rate becomes the
linearly rising ramp r(t) = r0 (1 + c t/t_ms), budget-preserving by
construction (integral = r0 t_ms (1 + c/2) = the family's MS budget
exactly). ramp_c applies to every track family (it is the only
time-resolved stellar-wind evidence in the reference's data); ms_frac
sets the MS budget share for the "seba" family specifically (the same
dumps calibrated its mass tracks — seba_anchors).
"""
from __future__ import annotations

import csv
import os
from functools import lru_cache

import numpy as np

from . import common

_DATA = os.path.join(common.DATA_ROOT, "seba", "wind-shape.csv")

FIELDS = ("t_end_myr", "tau_knee", "ms_frac", "ramp_c", "q25", "q50", "q75")


@lru_cache(maxsize=None)
def table() -> dict:
    rows = []
    with open(_DATA) as fh:
        for r in csv.DictReader(fh):
            rows.append([float(r["m0"])] + [float(r[f]) for f in FIELDS])
    arr = np.asarray(sorted(rows))
    out = {"m0": arr[:, 0], "log_m": np.log(arr[:, 0])}
    for i, f in enumerate(FIELDS):
        out[f] = arr[:, i + 1]
        out["log_" + f] = np.log(arr[:, i + 1])
    return out


def interp(field: str, m0):
    """Log-log interpolation of a calibration field at initial mass m0,
    clamped outside the [20, 60] Msun grid (all fields positive and
    smooth in log-log; clamping errs toward the nearest measured star)."""
    t = table()
    return common.loglog_interp(m0, t["log_m"], t["log_" + field])
