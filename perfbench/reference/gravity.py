"""Softened direct-sum gravity in plain torch, the reference's one force law.

acc_i  = G sum_j m_j dx_ij / (r_ij^2 + eps2)^(3/2)         dx_ij = x_j - x_i
jerk_i = G sum_j m_j [dv_ij / (r^2+eps2)^(3/2)
                      - 3 (dx_ij . dv_ij) dx_ij / (r^2+eps2)^(5/2)]
pot_i  = -G sum_j m_j / sqrt(r_ij^2 + pot_eps2)            (j != i)

Pairs are formed through matrix products of mean-centred coordinates
(r^2 = |x_i|^2 + |x_j|^2 - 2 x_i . x_j), so a product in a lower precision
(TF32) reaches every pair: that is the lower-precision control of the
comparison. Rows go in blocks so a block's [rows, N] temporaries stay small.
"""
from __future__ import annotations

import torch

# G in pc^3 / (Msun Myr^2): 6.67428e-11 m^3 kg^-1 s^-2 with 1 Msun =
# 1.98892e30 kg, 1 Myr = 3.1556926e13 s, 1 pc = 3.0856775814913673e16 m
G = 6.67428e-11 * 1.98892e30 * 3.1556926e13 ** 2 / 3.0856775814913673e16 ** 3
ROW_BLOCK_ELEMS = 1 << 25


def forces(pos_rows, vel_rows, ids, pos, vel, mass, eps2: float,
           with_jerk: bool = True, pot_eps2: float | None = None):
    """(acc, jerk, pot) on the rows (global ids `ids`) from every column;
    jerk is None without with_jerk, pot None without pot_eps2."""
    centre = pos.mean(0)
    x, xr = pos - centre, pos_rows - centre
    x2 = (x * x).sum(-1)
    n = pos.shape[0]
    cols = torch.arange(n, device=pos.device)
    if with_jerk:
        vcen = vel.mean(0)
        v, vr = vel - vcen, vel_rows - vcen
        xv = (x * v).sum(-1)
    step = max(1, ROW_BLOCK_ELEMS // max(n, 1))
    outs = []
    for lo in range(0, pos_rows.shape[0], step):
        sl = slice(lo, lo + step)
        xb, ib = xr[sl], ids[sl]
        x2b = (xb * xb).sum(-1)
        d2 = (x2b[:, None] + x2[None, :] - 2.0 * (xb @ x.T)).clamp_min(0.0)
        keep = cols[None, :] != ib[:, None]
        inv = torch.where(keep, torch.rsqrt(d2 + eps2), 0.0)
        w = mass[None, :] * inv ** 3
        acc = G * (w @ x - w.sum(1)[:, None] * xb)
        jerk = pot = None
        if with_jerk:
            vb = vr[sl]
            xvb = (xb * vb).sum(-1)
            dxdv = xvb[:, None] + xv[None, :] - vb @ x.T - xb @ v.T
            ws = w * 3.0 * dxdv * inv * inv
            jerk = G * (w @ v - w.sum(1)[:, None] * vb
                        - (ws @ x - ws.sum(1)[:, None] * xb))
        if pot_eps2 is not None:
            ip = torch.where(keep, torch.rsqrt(d2 + pot_eps2), 0.0)
            pot = -G * (ip @ mass)
        outs.append((acc, jerk, pot))
    cat = lambda k: (None if outs[0][k] is None
                     else torch.cat([o[k] for o in outs]))
    return cat(0), cat(1), cat(2)


def full(pos, vel, mass, eps2: float, with_jerk: bool = True,
         pot_eps2: float | None = None):
    """forces() of every star."""
    ids = torch.arange(pos.shape[0], device=pos.device)
    return forces(pos, vel, ids, pos, vel, mass, eps2, with_jerk, pot_eps2)


def virial_radius(pos, mass):
    """-G M^2 / (2 U) from the unsoftened potential."""
    _, _, pot = full(pos, torch.zeros_like(pos), mass, 0.0, False, 1e-30)
    u = 0.5 * (mass * pot).sum()
    mtot = mass.sum()
    return -G * mtot * mtot / (2.0 * u)
