"""Vectorised stellar evolution: the SeBa replacement (torch port of
al26_tpu.models.stellar.evolution — the model, its anchors and its
published sources are documented there and in docs/stellar_model.md).

  * `t_sn(m0, z)`       — time of core collapse (Myr)
  * `m_presn(m0, z)`    — pre-supernova mass (Msun)
  * `m_remnant(m0, z)`  — remnant mass (Msun)
  * `wind_mdot(m0,t,z)` — wind mass-loss rate (Msun/Myr), EXACTLY zero past t_sn
  * `mass_at(m0,t,z)`   — current mass (Msun), dropping to m_remnant at t_sn
  * `total_wind_loss(m0, z)` — m0 - m_remnant (al26_nbody.py:1583-1594)
  * `phase_table` / `evolve_from_table` — the per-star (m0, z)-only
    constants precomputed once, and the per-step evaluation from them.

Every function takes the metallicity `z` and the mass-track family
`tracks` (TRACKS) as Python values from the frozen SimConfig.

Dtype promotion follows the JAX package under x64, where an f32 `m0`
meets f64 anchors: the log-log anchor interpolation is f64 (see
common.loglog_interp), and `t_end`'s numpy-f64 scale factor promotes the
low-mass branch to f64. Torch does not promote an f32 tensor by a 0-dim
or scalar f64 operand, so that promotion is written out (`.double()`);
with it the phase table of an f32 state holds the same f64 values as the
JAX package's, and the step casts the per-step result to the state dtype
(sim/step.py) exactly as the JAX step does.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import common, hurley2000, lc18_anchors, seba_anchors, wind_shape

# Mass-track families (cfg.mass_tracks): the LC18 rotating (300 km/s, the
# yield tables' reduction), 150 km/s and non-rotating sets, and the SeBa
# tracks calibrated on the reference's own event dumps (solar Z only).
TRACKS = ("lc18", "lc18_vel150", "lc18_vel0", "seba")
_LC18_VEL = {"lc18": 300, "lc18_vel150": 150, "lc18_vel0": 0}


def check_tracks(tracks: str, z: float) -> None:
    if tracks is None:
        raise ValueError(
            "mass_tracks is unresolved (None): pass the config through "
            "sim.init.init_cluster (which resolves it against "
            "sn_parity_mode) or set it explicitly"
        )
    if tracks not in TRACKS:
        raise ValueError(f"mass_tracks={tracks!r} not one of {TRACKS}")
    if tracks == "seba" and z != seba_anchors.Z_SEBA:
        raise ValueError(
            "mass_tracks='seba' is calibrated on the reference's Z=0.02 "
            f"SeBa dumps only (got z={z}); use an lc18 track family for "
            "non-solar metallicity"
        )


# sub-8-Msun end of nuclear burning: t_end = t_bgb x (1 + F_POST_BGB),
# continuous with the massive-star branch at the 8 Msun cut
F_POST_BGB = 0.10

# canonical neutron-star remnant mass (Msun) for the 8-13 Msun band
M_NS = 1.4

# at most this fraction of the lifetime wind budget is shed on the MS
# (lc18 families), keeping the post-MS rate strictly positive (the SN
# signal is mdot == 0, al26_nbody.py:946-948)
_MS_BUDGET_CAP = 0.5

# strictly positive floor on the lifetime wind budget (Msun): a zero
# budget would make the ALIVE wind rate exactly 0 — the reserved
# post-supernova signal
_DM_WIND_FLOOR = 1e-30

# minimum initial mass that undergoes core collapse (SN)
SN_MIN_MASS = 8.0


@lru_cache(maxsize=None)
def _sn_anchor_grid(z: float, tracks: str = "lc18"):
    """(log m, log m_presn, log m_rem) anchors for the m0 >= SN_MIN_MASS
    branch of the selected mass-track family (numpy, f64)."""
    check_tracks(tracks, z)
    if tracks == "seba":
        g = seba_anchors.track_grids()
        return g["log_m"], g["log_presn"], g["log_rem"]
    from ..yields import feh_for_z

    m_presn, m_rem = lc18_anchors.anchors(feh_for_z(z), _LC18_VEL[tracks])
    m = np.concatenate([[SN_MIN_MASS], lc18_anchors.M_GRID])
    presn = np.concatenate([[SN_MIN_MASS], m_presn])
    rem = np.concatenate([[M_NS], m_rem])
    return np.log(m), np.log(presn), np.log(rem)


def _seba_lifetime_factor(m0: torch.Tensor) -> torch.Tensor:
    """SeBa/Hurley core-collapse time ratio c(m0), clamped outside the
    20-80 Msun calibration grid."""
    g = seba_anchors.track_grids()
    return _sn_branch_interp(m0, g["log_mc"], g["log_c"])


@lru_cache(maxsize=None)
def _ms_mdot_table(z: float):
    """(log m, log mdot_MS) table: hurley2000.ms_wind_mdot evaluated
    host-side in f64 on a dense mass grid (the Tout+96 rational fits
    overflow f32 above ~100 Msun)."""
    mgrid = np.geomspace(0.5, 160.0, 192)
    rate = hurley2000.ms_wind_mdot(mgrid, z)
    return np.log(mgrid), np.log(rate)


def t_end(m0: torch.Tensor, z: float = 0.02,
          tracks: str = "lc18") -> torch.Tensor:
    """End of nuclear burning (Myr); equals the SN time for m0 >= 8 Msun.

    Massive stars: the Hurley+2000 closed-form lifetime (t_sn), rescaled
    by the SeBa/Hurley ratio for tracks="seba"; below the SN cut,
    t_bgb x (1 + F_POST_BGB)."""
    check_tracks(tracks, z)
    m0 = torch.as_tensor(m0)
    m_lo = torch.clamp(m0, 0.1, SN_MIN_MASS)  # the fits blow up toward 0
    # the JAX package multiplies by a strongly typed numpy f64 scalar,
    # which promotes an f32 state to f64 under x64: promote explicitly
    lo = (1.0 + F_POST_BGB) * hurley2000.t_bgb(m_lo, z).double()
    hi = hurley2000.t_sn(m0, z)
    if tracks == "seba":
        hi = hi * _seba_lifetime_factor(m0)
    return torch.where(m0 >= SN_MIN_MASS, hi, lo)


def t_sn(m0: torch.Tensor, z: float = 0.02,
         tracks: str = "lc18") -> torch.Tensor:
    """Core-collapse time (Myr); +inf for stars below SN_MIN_MASS."""
    m0 = torch.as_tensor(m0)
    return torch.where(m0 >= SN_MIN_MASS, t_end(m0, z, tracks), math.inf)


# the shared log-log-clamped anchor interpolation (common.loglog_interp),
# kept under its historical name — the SN-branch convention here
_sn_branch_interp = common.loglog_interp


def m_presn(m0: torch.Tensor, z: float = 0.02,
            tracks: str = "lc18") -> torch.Tensor:
    """Pre-supernova mass (Msun): the track family's anchors on the SN
    branch, the Kalirai+2008 IFMR (post-AGB) below the SN cut."""
    m0 = torch.as_tensor(m0)
    lm, lp, _ = _sn_anchor_grid(z, tracks)
    sn = torch.minimum(_sn_branch_interp(m0, lm, lp), m0)
    return torch.where(m0 >= SN_MIN_MASS, sn, torch.minimum(m_wd(m0), m0))


def m_remnant(m0: torch.Tensor, z: float = 0.02,
              tracks: str = "lc18") -> torch.Tensor:
    """Remnant mass (Msun): NS/BH from the track family's anchors on the
    SN branch, the Kalirai+2008 white dwarf below the cut."""
    m0 = torch.as_tensor(m0)
    lm, _, lr = _sn_anchor_grid(z, tracks)
    sn = torch.minimum(_sn_branch_interp(m0, lm, lr), m0)
    return torch.where(m0 >= SN_MIN_MASS, sn, torch.minimum(m_wd(m0), m0))


def total_wind_loss(m0: torch.Tensor, z: float = 0.02,
                    tracks: str = "lc18") -> torch.Tensor:
    """m0 - m_remnant: the reference's calc_total_mass_loss evolves SeBa
    past the SN, so its 'wind loss' includes the SN ejecta
    (al26_nbody.py:467-493)."""
    m0 = torch.as_tensor(m0)
    return m0 - m_remnant(m0, z, tracks)


def _phase_rates(m0, z: float = 0.02, tracks: str = "lc18"):
    """(t_ms, mdot_ms0, mdot_ms_slope, mdot_post, t_cc): a linearly rising
    main-sequence wind rate(t) = mdot_ms0 + mdot_ms_slope * t for t < t_ms,
    then the rest of the m0 - m_presn budget as a constant post-MS wind.
    The MS budget is the NJ90 ZAMS rate times the calibrated ramp (capped
    at _MS_BUDGET_CAP of the budget) for the lc18 families, and the
    dump-calibrated MS share for "seba"."""
    m0 = torch.as_tensor(m0)
    t_cc = t_end(m0, z, tracks)
    dm_wind = torch.clamp(m0 - m_presn(m0, z, tracks), min=_DM_WIND_FLOOR)
    t_ms = t_cc / (1.0 + hurley2000.F_HE_BURN)
    c = wind_shape.interp("ramp_c", m0)
    if tracks == "seba":
        dm_ms = wind_shape.interp("ms_frac", m0) * dm_wind
    else:
        log_mg, log_rate = _ms_mdot_table(z)
        mdot_zams = _sn_branch_interp(m0, log_mg, log_rate)
        dm_ms = torch.minimum(mdot_zams * t_ms * (1.0 + 0.5 * c),
                              _MS_BUDGET_CAP * dm_wind)
    # ramp with exact budget: r0 * t_ms * (1 + c/2) == dm_ms
    mdot_ms0 = dm_ms / (t_ms * (1.0 + 0.5 * c))
    mdot_ms_slope = c * mdot_ms0 / t_ms
    mdot_post = (dm_wind - dm_ms) / torch.clamp(t_cc - t_ms, min=1e-12)
    return t_ms, mdot_ms0, mdot_ms_slope, mdot_post, t_cc


def wind_mdot(m0: torch.Tensor, t, z: float = 0.02,
              tracks: str = "lc18") -> torch.Tensor:
    """Wind mass-loss rate (Msun/Myr, >= 0) at age t; EXACTLY zero for
    t >= t_sn (the reference's SN signal, al26_nbody.py:946-948), and 0
    for m0 < 8 by design."""
    m0 = torch.as_tensor(m0)
    t_ms, r0, r1, mdot_post, t_cc = _phase_rates(m0, z, tracks)
    sn_mass = m0 >= SN_MIN_MASS
    alive_rate = torch.where(t < t_ms, r0 + r1 * t, mdot_post)
    rate = torch.where(t < t_cc, alive_rate, 0.0)
    return torch.where(sn_mass, rate, 0.0)


def _min_t(t, t_cc):
    """min(t, t_cc) for a scalar or tensor t, with JAX's promotion."""
    if torch.is_tensor(t):
        return torch.minimum(t, t_cc)
    return torch.clamp(t_cc, max=t)


def mass_at(m0: torch.Tensor, t, z: float = 0.02,
            tracks: str = "lc18") -> torch.Tensor:
    """Current mass at age t: wind losses accumulate piecewise (the MS
    ramp integrates quadratically), then the star drops to its remnant
    mass at t_sn (for m0 >= 8)."""
    m0 = torch.as_tensor(m0)
    t_ms, r0, r1, mdot_post, t_cc = _phase_rates(m0, z, tracks)
    # expression shape matches evolve_from_table exactly
    lost = torch.where(
        t < t_ms,
        (r0 + 0.5 * r1 * t) * t,
        (r0 + 0.5 * r1 * t_ms) * t_ms + mdot_post * (_min_t(t, t_cc) - t_ms),
    )
    m_alive = m0 - lost
    sn_mass = m0 >= SN_MIN_MASS
    m_dead = m_remnant(m0, z, tracks)
    out = torch.where((t >= t_cc) & sn_mass, m_dead, m_alive)
    return torch.where(sn_mass, out, m0)


# --------------------------------------------------------------------------
# AGB phase model (for the interloper table generator), calibrated at
# import on the shipped SeBa-derived tables (agb_calibration)
# --------------------------------------------------------------------------
from . import agb_calibration  # noqa: E402


def m_wd(m0: torch.Tensor) -> torch.Tensor:
    """White-dwarf remnant mass, Kalirai et al. (2008) IFMR
    (m_wd = 0.394 + 0.109 m)."""
    return 0.394 + 0.109 * m0


def agb_duration(m0: torch.Tensor) -> torch.Tensor:
    """AGB phase length (Myr), calibrated on the shipped tables."""
    return agb_calibration.interp("duration", m0)


def agb_m_enter(m0: torch.Tensor) -> torch.Tensor:
    """Stellar mass entering the AGB phase."""
    return agb_calibration.interp("m_enter", m0)


def agb_m_final(m0: torch.Tensor) -> torch.Tensor:
    """Post-AGB (white dwarf) mass from the calibrated tables."""
    return agb_calibration.interp("m_final", m0)


def agb_t_end(m0: torch.Tensor, z: float = 0.02) -> torch.Tensor:
    """End of the AGB phase = end of nuclear burning for m0 < 8."""
    return t_end(m0, z)


def agb_t_start(m0: torch.Tensor, z: float = 0.02) -> torch.Tensor:
    return agb_t_end(m0, z) - agb_duration(m0)


def agb_mdot(m0: torch.Tensor, t, z: float = 0.02) -> torch.Tensor:
    """AGB wind mass-loss rate (Msun/Myr): an exponentially ramping
    superwind through the phase with the calibrated steepness, normalised
    to the calibrated envelope loss; zero outside [agb_t_start,
    agb_t_end]."""
    m0 = torch.as_tensor(m0)
    t0 = agb_t_start(m0, z)
    t1 = agb_t_end(m0, z)
    dur = t1 - t0
    s = (t - t0) / dur
    k = agb_calibration.interp("k", m0)
    dm = torch.clamp(agb_m_enter(m0) - agb_m_final(m0), min=0.0)
    norm = dm * k / (torch.exp(k) - 1.0) / dur
    rate = norm * torch.exp(k * s)
    return torch.where((s >= 0.0) & (s <= 1.0), rate, 0.0)


class PhaseTable(NamedTuple):
    """Per-star phase constants — every (m0, z)-only quantity `evolve`
    needs, precomputed once (init) instead of per step. The arrays keep
    the precision they were computed in (f64, see the module docstring)."""

    t_ms: torch.Tensor       # [N] Myr: end of the MS wind phase
    mdot_ms: torch.Tensor    # [N] Msun/Myr: MS wind rate AT ZAMS (ramp r0)
    mdot_slope: torch.Tensor  # [N] Msun/Myr^2: MS ramp slope (wind_shape)
    mdot_post: torch.Tensor  # [N] Msun/Myr: post-MS (RSG/WR) wind rate
    t_cc: torch.Tensor       # [N] Myr: core collapse (= t_end)
    m_rem: torch.Tensor      # [N] Msun: remnant mass
    is_sn: torch.Tensor      # [N] bool: m0 >= SN_MIN_MASS

    def to(self, device) -> "PhaseTable":
        return PhaseTable(*(a.to(device) for a in self))


def phase_table(m0: torch.Tensor, z: float = 0.02,
                tracks: str = "lc18") -> PhaseTable:
    """Precompute the (m0, z, tracks)-only inputs of `evolve`."""
    m0 = torch.as_tensor(m0)
    t_ms, r0, r1, mdot_post, t_cc = _phase_rates(m0, z, tracks)
    return PhaseTable(t_ms, r0, r1, mdot_post, t_cc,
                      m_remnant(m0, z, tracks), m0 >= SN_MIN_MASS)


def evolve_from_table(tbl: PhaseTable, m0: torch.Tensor, t):
    """(mass, wind_mdot) at age t from the precomputed PhaseTable — the
    same where-structure as `mass_at` + `wind_mdot`."""
    lost = torch.where(
        t < tbl.t_ms,
        (tbl.mdot_ms + 0.5 * tbl.mdot_slope * t) * t,
        (tbl.mdot_ms + 0.5 * tbl.mdot_slope * tbl.t_ms) * tbl.t_ms
        + tbl.mdot_post * (_min_t(t, tbl.t_cc) - tbl.t_ms),
    )
    mass = torch.where((t >= tbl.t_cc) & tbl.is_sn, tbl.m_rem, m0 - lost)
    mass = torch.where(tbl.is_sn, mass, m0)
    rate = torch.where(t < tbl.t_ms, tbl.mdot_ms + tbl.mdot_slope * t,
                       tbl.mdot_post)
    rate = torch.where(t < tbl.t_cc, rate, 0.0)
    mdot = torch.where(tbl.is_sn, rate, 0.0)
    return mass, mdot


def evolve(m0: torch.Tensor, t, z: float = 0.02, tracks: str = "lc18"):
    """One-call stellar-evolution step: (mass, wind_mdot) at age t. Equals
    evolve_from_table(phase_table(m0, z, tracks), m0, t); the step uses
    the table form."""
    return mass_at(m0, t, z, tracks), wind_mdot(m0, t, z, tracks)
