"""Protoplanetary disc initialisation.

Reference: al26_nbody.py:1218-1236 (disk_lifetime) and 1540-1548 (per-star
disc attributes). Disc lifetimes are pre-drawn from an exponential
distribution with mean 2.885 Myr (t_1/2 = 2 Myr; Richert et al. 2018), and
every disc starts with radius `disk_radius` AU, gas mass 0.1 m_star and dust
mass 0.01 m_gas.
"""
from __future__ import annotations

import numpy as np

from ..units import AU_TO_PC

DISK_LIFETIME_MEAN_MYR = 2.885  # al26_nbody.py:1233


def draw_disk_lifetimes(
    rng: np.random.Generator, n: int, mean_myr: float = DISK_LIFETIME_MEAN_MYR
) -> np.ndarray:
    """Exponential disc lifetimes in Myr (al26_nbody.py:1218-1236)."""
    return rng.exponential(mean_myr, size=n)


def disk_radius_pc(disk_radius_au: float = 100.0) -> float:
    return disk_radius_au * AU_TO_PC
