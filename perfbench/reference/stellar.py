"""The stellar model of the step in plain numpy (f64): mass and wind rate of
a star of initial mass m0 at age t.

Massive stars (m0 >= 8 Msun) lose the mass between m0 and their pre-supernova
mass as a wind that rises linearly through the main sequence (a ramp
r(t) = r0 (1 + c t / t_ms)) and is constant after it, then collapse at t_cc
to their remnant mass with the wind rate exactly 0. Stars below 8 Msun keep
m0 and have no wind. The pieces, each from its published source:

  * t_cc: Hurley, Pols & Tout (2000) eqs. (4)-(7), t_MS x (1 + 0.11)
    (He burning); t_ms = t_cc / 1.11;
  * pre-supernova and remnant masses: Limongi & Chieffi (2018) set R by
    mass conservation (m_ini minus the summed yields of tables 8 and 9),
    log-log interpolated in m0 and clamped to the grid, anchored at
    (8, 8) and (8, 1.4 Msun);
  * the main-sequence budget: Nieuwenhuijzen & de Jager (1990) at the Tout
    et al. (1996) ZAMS luminosity and radius, times sqrt(Z / 0.02), on a
    192-point log grid of 0.5-160 Msun, log-log interpolated, times
    t_ms (1 + c/2), at most half of the wind budget;
  * the ramp c(m0): the SeBa calibration table (data/seba/wind-shape.csv),
    log-log interpolated and clamped.

Only the configuration the benchmark runs is written: Z = 0.02 ([Fe/H] 0),
the LC18 300 km/s tracks ("lc18"). The raw data files are read from
al26_tpu/data as files.
"""
from __future__ import annotations

import csv
import math
import os
import re
from functools import lru_cache

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "al26_tpu", "data")
LC18_MASSES = np.array([13.0, 15.0, 20.0, 25.0, 30.0, 40.0, 60.0, 80.0,
                        120.0])
SN_MIN = 8.0
HE_BURN = 0.11


def _hurley_a(z: float) -> dict:
    zeta = math.log10(z / 0.02)
    poly = {1: (1.593890e3, 2.053038e3, 1.231226e3, 2.327785e2),
            2: (2.706708e3, 1.483131e3, 5.772723e2, 7.411230e1),
            3: (1.466143e2, -1.048442e2, -6.795374e1, -1.391127e1),
            4: (4.141960e-2, 4.564888e-2, 2.958542e-2, 5.571483e-3),
            5: (3.426349e-1, 0.0, 0.0, 0.0),
            6: (1.949814e1, 1.758178e0, -6.008212e0, -4.470533e0),
            7: (4.903830e0, 0.0, 0.0, 0.0),
            8: (5.212154e-2, 3.166411e-2, -2.750074e-3, -2.271549e-3),
            9: (1.312179e0, -3.294936e-1, 9.231860e-2, 2.610989e-2),
            10: (8.073972e-1, 0.0, 0.0, 0.0)}
    a = {k: c[0] + c[1] * zeta + c[2] * zeta ** 2 + c[3] * zeta ** 3
         for k, c in poly.items()}
    a["x"] = max(0.95, min(0.95 - 0.03 * (zeta + 0.30103), 0.99))
    return a


def t_bgb(m, z=0.02):
    a = _hurley_a(z)
    return ((a[1] + a[2] * m ** 4 + a[3] * m ** 5.5 + m ** 7)
            / (a[4] * m ** 2 + a[5] * m ** 7))


def t_core_collapse(m, z=0.02):
    """End of nuclear burning: the supernova for m >= 8, 1.1 t_BGB below."""
    a = _hurley_a(z)
    tb = t_bgb(m, z)
    mu = np.maximum(1.0 - 0.01 * np.maximum(a[6] / m ** a[7],
                                            a[8] + a[9] / m ** a[10]), 0.5)
    t_ms = np.maximum(mu * tb, a["x"] * tb)
    low = 1.1 * t_bgb(np.clip(m, 0.1, SN_MIN), z)
    return np.where(m >= SN_MIN, t_ms * (1.0 + HE_BURN), low)


def _loglog(m, xs, ys):
    lx = np.log(np.asarray(xs, float))
    x = np.log(np.clip(m, xs[0], xs[-1]))
    return np.exp(np.interp(x, lx, np.log(np.asarray(ys, float))))


@lru_cache(maxsize=None)
def _lc18_sums(name: str, n_mass: int):
    """Summed isotope yields of each (vel, [Fe/H]) model set of a raw LC18
    table."""
    sums = {}
    row = re.compile(r"^\s*(\d+)\s+(-?\d+)\s+\S+\s+(.*)$")
    with open(os.path.join(DATA, "limongi_chieffi_2018", "raw", name)) as f:
        for line in f:
            m = row.match(line)
            if not m:
                continue
            vals = m.group(3).split()
            if len(vals) != n_mass:
                continue
            key = (int(m.group(1)), int(m.group(2)))
            sums[key] = sums.get(key, 0.0) + np.array(vals, float)
    return sums


@lru_cache(maxsize=None)
def lc18_masses(vel: int = 300, feh: int = 0):
    """(pre-supernova, remnant) masses on LC18_MASSES."""
    total = _lc18_sums("limongi-table-8.txt", 9)[(vel, feh)]
    wind = _lc18_sums("limongi-table-9.txt", 4)[(vel, feh)]
    rem = LC18_MASSES - total
    presn = np.concatenate([LC18_MASSES[:4] - wind, rem[4:]])
    return presn, rem


@lru_cache(maxsize=None)
def ramp_table():
    with open(os.path.join(DATA, "seba", "wind-shape.csv")) as f:
        rows = sorted((float(r["m0"]), float(r["ramp_c"]))
                      for r in csv.DictReader(f))
    return np.array([r[0] for r in rows]), np.array([r[1] for r in rows])


def _zams_wind(m, z=0.02):
    """NJ90 at the Tout+96 ZAMS L and R, Msun/Myr."""
    m2, m3 = m * m, m ** 3
    m5, m7 = m3 * m2, m3 * m2 * m2
    sq = np.sqrt(m)
    lum = ((0.39704170 * m5 * sq + 8.52762600 * m7 * m3 * m)
           / (0.00025546 + m3 + 5.43288900 * m5 + 5.56357900 * m7
              + 0.78866060 * m7 * m + 0.00586685 * m7 * m2 * sq))
    m6 = m2 * m2 * m2
    m11 = m6 * m2 * m2 * m
    m19 = m11 * m6 * m2
    rad = ((1.71535900 * m2 * sq + 6.59778800 * m6 * sq + 10.08855000 * m11
            + 1.01249500 * m19 + 0.07490166 * m19 * sq)
           / (0.01077422 + 3.08223400 * m2 + 17.84778000 * m6 * m2 * sq
              + m19 / sq + 0.00022582 * m19 * sq))
    return 1e6 * math.sqrt(z / 0.02) * 9.5499e-15 * lum ** 1.24 \
        * m ** 0.16 * rad ** 0.81


def phases(m0, z: float = 0.02, tracks: str = "lc18"):
    """Per-star (t_ms, r0, slope, mdot_post, t_cc, m_rem, is_sn)."""
    if tracks != "lc18" or z != 0.02:
        raise ValueError("the reference models mass_tracks lc18 at Z 0.02")
    m0 = np.asarray(m0, np.float64)
    presn_grid, rem_grid = lc18_masses()
    xs = np.concatenate([[SN_MIN], LC18_MASSES])
    is_sn = m0 >= SN_MIN
    wd = np.minimum(0.394 + 0.109 * m0, m0)
    presn = np.where(is_sn, np.minimum(
        _loglog(m0, xs, np.concatenate([[SN_MIN], presn_grid])), m0), wd)
    m_rem = np.where(is_sn, np.minimum(
        _loglog(m0, xs, np.concatenate([[1.4], rem_grid])), m0), wd)
    t_cc = t_core_collapse(m0, z)
    t_ms = t_cc / (1.0 + HE_BURN)
    dm = np.maximum(m0 - presn, 1e-30)
    c = _loglog(m0, *ramp_table())
    grid = np.geomspace(0.5, 160.0, 192)
    zams = _loglog(m0, grid, _zams_wind(grid, z))
    dm_ms = np.minimum(zams * t_ms * (1.0 + 0.5 * c), 0.5 * dm)
    r0 = dm_ms / (t_ms * (1.0 + 0.5 * c))
    slope = c * r0 / t_ms
    post = (dm - dm_ms) / np.maximum(t_cc - t_ms, 1e-12)
    return t_ms, r0, slope, post, t_cc, m_rem, is_sn


def mass_and_wind(m0, t: float, z: float = 0.02, tracks: str = "lc18"):
    """(mass, wind rate in Msun/Myr) at age t."""
    t_ms, r0, slope, post, t_cc, m_rem, is_sn = phases(m0, z, tracks)
    m0 = np.asarray(m0, np.float64)
    lost = np.where(t < t_ms, (r0 + 0.5 * slope * t) * t,
                    (r0 + 0.5 * slope * t_ms) * t_ms
                    + post * (np.minimum(t, t_cc) - t_ms))
    mass = np.where(is_sn, np.where(t >= t_cc, m_rem, m0 - lost), m0)
    rate = np.where(t < t_cc, np.where(t < t_ms, r0 + slope * t, post), 0.0)
    return mass, np.where(is_sn, rate, 0.0)


def remnant_mass(m0, z: float = 0.02, tracks: str = "lc18"):
    return phases(m0, z, tracks)[5]
