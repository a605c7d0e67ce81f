"""Plummer-sphere initial conditions.

The reference builds its default cluster with AMUSE's `new_plummer_model`
(al26_nbody.py:1519-1520), the classic Aarseth, Henon & Wielen (1974)
sampler in standard N-body units (G = M_tot = 1, E = -1/4), then scales to
SI with `nbody_system.nbody_to_si(Rc, Mcluster)` (al26_nbody.py:1516) so the
length unit is the cluster radius Rc. We implement the same construction
directly in our internal (Msun, pc, Myr) units:

  * stratified inverse-CDF radii  r = (u^{-2/3} - 1)^{-1/2} (scale-a units)
  * isotropic positions, velocity modulus from the distribution function by
    von Neumann rejection with g(q) = q^2 (1 - q^2)^{7/2}
  * scale-a -> virial units via a = 3 pi / 16, then to physical units with
    length unit Rc and velocity unit sqrt(G M / Rc)
  * barycentre correction
"""
from __future__ import annotations

import numpy as np

from ..units import G_INTERNAL

# Plummer structural radius in standard N-body (virial) units
PLUMMER_A_NBODY = 3.0 * np.pi / 16.0
# AMUSE MakePlummerModel defaults
MASS_CUTOFF = 0.999


def _sample_velocity_q(rng: np.random.Generator, n: int) -> np.ndarray:
    """q = v / v_esc by rejection against g(q) = q^2 (1-q^2)^3.5."""
    out = np.empty(n)
    filled = 0
    g_max = 0.1  # max of g on [0,1] is ~0.092; AMUSE uses 0.1
    while filled < n:
        k = max(2 * (n - filled), 1024)
        q = rng.uniform(0.0, 1.0, size=k)
        y = rng.uniform(0.0, g_max, size=k)
        keep = q[y < q * q * (1.0 - q * q) ** 3.5]
        take = min(len(keep), n - filled)
        out[filled:filled + take] = keep[:take]
        filled += take
    return out


def _isotropic_unit_vectors(rng: np.random.Generator, n: int) -> np.ndarray:
    z = rng.uniform(-1.0, 1.0, size=n)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=n)
    s = np.sqrt(1.0 - z * z)
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=-1)


def plummer_positions_velocities(
    rng: np.random.Generator,
    n: int,
    rc_pc: float,
    total_mass_msun: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Sample a Plummer sphere; returns (pos [N,3] pc, vel [N,3] pc/Myr)."""
    # stratified cumulative-mass fractions (one star per equal-mass shell,
    # as in AMUSE MakePlummerModel.calculate_radius)
    i = np.arange(n)
    u = rng.uniform(i * MASS_CUTOFF / n, (i + 1) * MASS_CUTOFF / n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)        # scale-a units

    pos_a = r[:, None] * _isotropic_unit_vectors(rng, n)

    q = _sample_velocity_q(rng, n)
    v_esc = np.sqrt(2.0) * (1.0 + r * r) ** (-0.25)   # scale-a units (GM=a=1)
    vel_a = (q * v_esc)[:, None] * _isotropic_unit_vectors(rng, n)

    # scale-a -> standard N-body units
    pos_nb = pos_a * PLUMMER_A_NBODY
    vel_nb = vel_a / np.sqrt(PLUMMER_A_NBODY)

    # N-body -> physical units: length unit Rc, velocity unit sqrt(G M / Rc)
    v_unit = np.sqrt(G_INTERNAL * total_mass_msun / rc_pc)   # pc/Myr
    pos = pos_nb * rc_pc
    vel = vel_nb * v_unit

    # barycentre correction (equal-mass model; the IMF masses are assigned
    # afterwards exactly as the reference does, al26_nbody.py:1530)
    pos -= pos.mean(axis=0)
    vel -= vel.mean(axis=0)
    return pos, vel
