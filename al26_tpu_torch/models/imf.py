"""Maschberger (2013) initial mass function sampling.

The reference samples the Maschberger IMF (mu=0.2, alpha=2.3, beta=1.4) by
uniform rejection in a numba kernel and re-rolls the entire cluster until at
least one star exceeds 13 Msun (al26_nbody.py:1375-1446). The distribution
has a closed-form inverse CDF, so the default sampler here draws exactly (no
rejection, fully vectorised); a rejection-mode sampler is kept for
statistical parity checks with the reference.

Functional form (Maschberger 2013, MNRAS 429, 1725):
    p(m)  ∝ (m/mu)^(-alpha) * (1 + (m/mu)^(1-alpha))^(-beta)
    G(m)  = (1 + (m/mu)^(1-alpha))^(1-beta)         (auxiliary CDF kernel)
    m(u)  = mu * ((u*(G_hi-G_lo)+G_lo)^(1/(1-beta)) - 1)^(1/(1-alpha))
"""
from __future__ import annotations

import numpy as np

MU = 0.2      # average star mass scale (al26_nbody.py:1380)
ALPHA = 2.3   # low-mass exponent        (al26_nbody.py:1381)
BETA = 1.4    # high-mass exponent       (al26_nbody.py:1382)


def maschberger_aux(m: np.ndarray, mu: float = MU,
                    alpha: float = ALPHA, beta: float = BETA) -> np.ndarray:
    """G(m): auxiliary function (al26_nbody.py:1387-1394)."""
    return (1.0 + (np.asarray(m) / mu) ** (1.0 - alpha)) ** (1.0 - beta)


def maschberger_pdf(m: np.ndarray, m_lower: float, m_upper: float,
                    mu: float = MU, alpha: float = ALPHA,
                    beta: float = BETA) -> np.ndarray:
    """Normalised pdf on [m_lower, m_upper] (al26_nbody.py:1375-1385)."""
    m = np.asarray(m)
    g_lo = maschberger_aux(m_lower, mu, alpha, beta)
    g_hi = maschberger_aux(m_upper, mu, alpha, beta)
    a = ((1.0 - alpha) * (1.0 - beta) / mu) / (g_hi - g_lo)
    return a * (m / mu) ** (-alpha) * (1.0 + (m / mu) ** (1.0 - alpha)) ** (-beta)


def maschberger_cdf(m: np.ndarray, m_lower: float, m_upper: float) -> np.ndarray:
    g = maschberger_aux(m)
    g_lo = maschberger_aux(m_lower)
    g_hi = maschberger_aux(m_upper)
    return (g - g_lo) / (g_hi - g_lo)


def sample_masses(
    rng: np.random.Generator,
    nstars: int,
    min_mass: float = 0.01,
    max_mass: float = 150.0,
    method: str = "invcdf",
) -> np.ndarray:
    """Draw `nstars` masses from the truncated Maschberger IMF.

    method="invcdf": exact inverse-CDF sampling (default).
    method="rejection": uniform rejection, statistically identical to the
      reference kernel gen_mass_numba (al26_nbody.py:1396-1410).
    """
    if method == "invcdf":
        g_lo = maschberger_aux(min_mass)
        g_hi = maschberger_aux(max_mass)
        u = rng.uniform(0.0, 1.0, size=nstars)
        g = u * (g_hi - g_lo) + g_lo
        return MU * (g ** (1.0 / (1.0 - BETA)) - 1.0) ** (1.0 / (1.0 - ALPHA))
    elif method == "rejection":
        p_hi = maschberger_pdf(min_mass, min_mass, max_mass)
        masses = np.empty(nstars)
        filled = 0
        while filled < nstars:
            k = max(nstars - filled, 1024)
            m = rng.uniform(min_mass, max_mass, size=k)
            p = rng.uniform(0.0, p_hi, size=k)
            keep = m[p < maschberger_pdf(m, min_mass, max_mass)]
            take = min(len(keep), nstars - filled)
            masses[filled:filled + take] = keep[:take]
            filled += take
        return masses
    raise ValueError(f"unknown IMF sampling method: {method}")


def generate_masses(
    rng: np.random.Generator,
    nstars: int,
    min_mass: float = 0.01,
    max_mass: float = 150.0,
    no_massive_star_requirement: bool = False,
    massive_threshold: float = 13.0,
    method: str = "invcdf",
    max_rerolls: int = 10_000,
) -> np.ndarray:
    """Sample a cluster's masses, re-rolling the whole cluster until at
    least one star is above `massive_threshold` (al26_nbody.py:1412-1446),
    unless disabled."""
    if nstars < 1:
        raise ValueError(f"nstars must be >= 1, got {nstars}")
    for _ in range(max_rerolls):
        masses = sample_masses(rng, nstars, min_mass, max_mass, method)
        if no_massive_star_requirement or masses.max() >= massive_threshold:
            return masses
    raise RuntimeError(
        f"no cluster with a >= {massive_threshold} Msun star after "
        f"{max_rerolls} re-rolls; raise max_mass or nstars"
    )
