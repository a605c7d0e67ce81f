"""SLR database and Limongi-Chieffi yield tables.

Host-side (init-time) port of `read_SLRs` (al26_nbody.py:572-640) and the
per-star yield calculators (`calc_slr_yield`, `calc_wind_ratio`,
al26_nbody.py:441-499). Yield lookups use Akima interpolation of log10
yields over the table mass grid and return 0 outside the grid, exactly as
the reference does. Nothing here touches tensors — the result is a handful
of per-star floats baked into the Cluster state at init. (A numpy copy of
al26_tpu.models.yields.)

Data files are the published tables the reference ships (reduced from the
Limongi & Chieffi 2018 machine-readable tables by
limongi-chieffi-2018/fit-data.py; regenerable with
scripts/gen_yield_tables.py). They stay in one place: the JAX package's
al26_tpu/data, read by path from here.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
from scipy.interpolate import Akima1DInterpolator

# <repo>/al26_tpu/data — this file lives at <repo>/al26_tpu_torch/models/
DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "al26_tpu", "data",
)


@dataclass
class SLR:
    """One short-lived radioisotope's data (al26_nbody.py:576-592)."""

    name: str
    daughter: str
    stable: str
    half_life_myr: float
    tau_myr: float
    zss: float
    zss_err: float
    wind_mass: np.ndarray = field(default_factory=lambda: np.array([]))
    wind_yield: np.ndarray = field(default_factory=lambda: np.array([]))
    sne_mass: np.ndarray = field(default_factory=lambda: np.array([]))
    sne_yield: np.ndarray = field(default_factory=lambda: np.array([]))


def _read_yield_table(path: str, wanted: set[str]) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Parse a wind-/sne-yields.csv: header `vel,fe/h,isotope,13m,...,120m`;
    rows give per-initial-mass yields in Msun (al26_nbody.py:606-638)."""
    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    with open(path) as f:
        header = f.readline().strip().split(",")[3:]
        masses = np.array([float(h[:-1]) for h in header])  # strip trailing 'm'
        for line in f:
            cells = line.strip().split(",")
            iso = cells[2]
            if iso in wanted:
                out[iso] = (masses, np.array([float(v) for v in cells[3:]]))
    return out


Z_SUN = 0.02          # LC18 solar metallicity reference (cfg.metallicity)
_FEH_GRID = (0, -1, -2, -3)   # [Fe/H] values the LC18 tables ship
LC18_VELS = (300, 150, 0)     # rotation velocities (km/s) in the raw tables


def lc18_suffix(vel: int, feh: int) -> str:
    """File-name suffix of a reduced LC18 table: '' for the reference's
    (vel=300, [Fe/H]=0) set (fit-data.py's only output), else -vel<V> and/or
    -feh<N>. Shared with scripts/gen_yield_tables.py so the generator and
    this reader cannot drift apart on the naming convention."""
    return ("" if vel == 300 else f"-vel{vel}") + (
        "" if feh == 0 else f"-feh{feh}")


def feh_for_z(z: float) -> int:
    """Nearest LC18 [Fe/H] grid point for a metallicity Z:
    [Fe/H] = log10(Z / Zsun) snapped to {0, -1, -2, -3}. The reference is
    pinned to the solar set (fit-data.py selects feh=0 only); the sub-solar
    sets are a superset using the same published tables."""
    import math

    feh = math.log10(max(z, 1e-12) / Z_SUN)
    return min(_FEH_GRID, key=lambda g: abs(g - feh))


def read_slrs(data_dir: str | None = None, feh: int = 0,
              vel: int = 300) -> dict[str, SLR]:
    """Load slr-abundances.csv plus the LC18 wind/SNe yield curves for any
    isotope present in both (reference behaviour: al26_nbody.py:594-640).

    `feh` selects the LC18 metallicity set: 0 (solar, the reference's
    choice and the default) reads the reference-named wind-/sne-yields.csv;
    -1/-2/-3 read the -feh<N> suffixed tables. `vel` selects the rotation
    velocity of the yield reduction: 300 km/s is the reference's fixed
    fit-data.py choice (and what ALL mass-track families pair with by
    default, like the reference pairs vel=300 yields with SeBa tracks);
    0/150 read -vel<V> suffixed tables for self-consistent pairing with
    the lc18_vel0/150 track families (cfg.yields_vel). The vel=0 and
    vel=150 solar sets ship; scripts/gen_yield_tables.py regenerates every
    combination from the shipped machine-readable originals (non-solar
    non-300 sets on demand)."""
    data_dir = data_dir or DATA_DIR
    if feh not in _FEH_GRID:
        raise ValueError(f"[Fe/H]={feh} not in the LC18 grid {_FEH_GRID}")
    if vel not in LC18_VELS:
        raise ValueError(f"vel={vel} not in the LC18 grid {LC18_VELS}")
    slrs: dict[str, SLR] = {}
    with open(os.path.join(data_dir, "slr-abundances.csv"), encoding="utf-8-sig") as f:
        next(f)
        for line in f:
            c = line.strip().split(",")
            slrs[c[0]] = SLR(
                name=c[0], daughter=c[1], stable=c[2],
                half_life_myr=float(c[3]), tau_myr=float(c[4]),
                zss=float(c[5]), zss_err=float(c[6]),
            )
    lc_dir = os.path.join(data_dir, "limongi_chieffi_2018")
    suffix = lc18_suffix(vel, feh)
    wanted = set(slrs)
    for stem, mass_attr, yield_attr in (
            ("wind-yields", "wind_mass", "wind_yield"),
            ("sne-yields", "sne_mass", "sne_yield")):
        path = os.path.join(lc_dir, f"{stem}{suffix}.csv")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not shipped — regenerate it with "
                "`python scripts/gen_yield_tables.py` (extend its vel/feh "
                "loop for this combination)"
            )
        for iso, (m, y) in _read_yield_table(path, wanted).items():
            setattr(slrs[iso], mass_attr, m)
            setattr(slrs[iso], yield_attr, y)
    return slrs


def calc_slr_yield(mass_msun: float, masses: np.ndarray, yields: np.ndarray) -> float:
    """Akima interpolation of log10(yield) at the star's initial mass;
    0 outside the table range (al26_nbody.py:444-465).

    The SNe table holds exact zeros for masses that collapse directly
    (>= 30 Msun rows in sne-yields.csv); log10 of those is -inf, which the
    reference feeds to Akima unchecked. We floor at 1e-300 so the
    interpolation stays finite and the returned yield for such stars
    underflows to 0, preserving behaviour without the NaNs."""
    if len(masses) == 0 or mass_msun < masses.min() or mass_msun > masses.max():
        return 0.0
    safe = np.maximum(yields, 1e-300)
    interp = Akima1DInterpolator(masses, np.log10(safe))
    out = float(10.0 ** interp(mass_msun))
    return 0.0 if out < 1e-250 else out


def calc_wind_ratio(total_wind_loss_msun: float, slr_wind_yield_msun: float) -> float:
    """wind_ratio = SLR wind yield / lifetime-integrated mass loss
    (al26_nbody.py:441-442)."""
    if total_wind_loss_msun <= 0.0:
        return 0.0
    return slr_wind_yield_msun / total_wind_loss_msun


def massive_star_yields(
    m0: np.ndarray, slrs: dict[str, SLR], total_wind_loss: np.ndarray,
    threshold: float = 13.0,
) -> dict[str, np.ndarray]:
    """Per-star wind ratios and SN yields for both isotopes, zero below the
    high-mass threshold (init loop al26_nbody.py:1581-1601)."""
    n = len(m0)
    out = {
        "wind_ratio_26al": np.zeros(n), "wind_ratio_60fe": np.zeros(n),
        "sn_yield_26al": np.zeros(n), "sn_yield_60fe": np.zeros(n),
        "wind_yield_26al": np.zeros(n), "wind_yield_60fe": np.zeros(n),
    }
    al, fe = slrs["Al26"], slrs["Fe60"]
    for i in np.flatnonzero(m0 >= threshold):
        m = float(m0[i])
        wy_al = calc_slr_yield(m, al.wind_mass, al.wind_yield)
        wy_fe = calc_slr_yield(m, fe.wind_mass, fe.wind_yield)
        out["wind_yield_26al"][i] = wy_al
        out["wind_yield_60fe"][i] = wy_fe
        out["wind_ratio_26al"][i] = calc_wind_ratio(total_wind_loss[i], wy_al)
        out["wind_ratio_60fe"][i] = calc_wind_ratio(total_wind_loss[i], wy_fe)
        out["sn_yield_26al"][i] = calc_slr_yield(m, al.sne_mass, al.sne_yield)
        out["sn_yield_60fe"][i] = calc_slr_yield(m, fe.sne_mass, fe.sne_yield)
    return out
