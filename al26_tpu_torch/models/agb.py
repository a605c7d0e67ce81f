"""AGB interloper wind tables.

Host-side port of `read_AGBs` (al26_nbody.py:501-568): loads the
`agb_wind/agb_slr_*_msol.csv` tables (1024 time samples of AGB 26Al/60Fe
mass-loss rates generated from SeBa + Karakas & Lugaro 2016 fractions by
agb_wind/agb-wind-calc.py; regenerable with scripts/gen_agb_tables.py).

For the tensor step, each rate curve is resampled once at init onto a
dense uniform time grid via the same Akima interpolation the reference
applies per step (al26_nbody.py:535-562), after which in-step lookups are a
single linear interpolation (models.stellar.common.interp). Outside the table's time range the rate is 0, as in
the reference.
"""
from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass

import numpy as np
from scipy.interpolate import Akima1DInterpolator

from .yields import DATA_DIR
from ..units import MSUNYR_TO_MSUNMYR


@dataclass
class AGBTable:
    mass_msun: float
    t_myr: np.ndarray                 # original sample times
    rate_26al: np.ndarray             # Msun/Myr (internal units)
    rate_60fe: np.ndarray             # Msun/Myr
    # dense uniform resampling for in-step interpolation
    grid_t: np.ndarray
    grid_26al: np.ndarray
    grid_60fe: np.ndarray

    def interp_rate_host(self, iso: str, t_myr: float) -> float:
        """Exact reference semantics (Akima, 0 outside range;
        al26_nbody.py:535-562). Host-side only."""
        y = self.rate_26al if iso == "26al" else self.rate_60fe
        if t_myr < self.t_myr[0] or t_myr > self.t_myr[-1]:
            return 0.0
        return float(Akima1DInterpolator(self.t_myr, y)(t_myr))


def _dense_resample(t, y, n_grid):
    interp = Akima1DInterpolator(t, y)
    grid_t = np.linspace(t[0], t[-1], n_grid)
    return grid_t, np.nan_to_num(interp(grid_t))


def read_agbs(data_dir: str | None = None, n_grid: int = 4096) -> list[AGBTable]:
    data_dir = data_dir or DATA_DIR
    tables = []
    for path in sorted(glob.glob(os.path.join(data_dir, "agb_wind", "agb_slr*.csv"))):
        cols: dict[str, list[float]] = {}
        with open(path) as f:
            header = f.readline().strip().split(",")
            for h in header:
                cols[h] = []
            for line in f:
                for h, v in zip(header, line.strip().split(",")):
                    cols[h].append(float(v))
        # AGB mass parsed from the filename (al26_nbody.py:526-533) —
        # anchored to the _<M>_msol suffix: a bare first-number match
        # would read 26.0 from a name like agb_slr_26al_5_msol.csv
        m = re.search(r"_(\d+(?:\.\d+)?)_msol\.csv$", os.path.basename(path))
        if m is None:
            continue  # not an AGB wind table of the expected pattern
        mass = float(m.group(1))
        t = np.asarray(cols["t"])
        r_al = np.asarray(cols["26al_mass_loss_rate"]) * MSUNYR_TO_MSUNMYR
        r_fe = np.asarray(cols["60fe_mass_loss_rate"]) * MSUNYR_TO_MSUNMYR
        gt, g_al = _dense_resample(t, r_al, n_grid)
        _, g_fe = _dense_resample(t, r_fe, n_grid)
        tables.append(AGBTable(mass, t, r_al, r_fe, gt, g_al, g_fe))
    return tables


def find_agb(tables: list[AGBTable], mass_msun: float) -> AGBTable:
    """Match the interloper mass to a table (al26_nbody.py:1690-1698)."""
    for t in tables:
        if t.mass_msun == mass_msun:
            return t
    valid = [t.mass_msun for t in tables]
    raise ValueError(f"NO VALID INTERLOPER MASS, MUST BE {valid} MSOL")
