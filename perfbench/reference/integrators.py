"""The three integrators of an outer step dt, written from their definitions:

  leapfrog        kick-drift-kick with n_sub equal substeps;
  hermite4        one shared substep h = eta * min_i |a_i|/|j_i| (clamped to
                  [dt/substeps_max, time left]), predict, evaluate, and the
                  two-stage corrector of Makino & Aarseth (1992);
  hermite4_block  the k_fast stars with the smallest |a|/|j| subcycle with
                  their own shared step against every other star's step-start
                  Hermite prediction; the others take one Hermite step over
                  dt, closed by a full evaluation at the predicted end.

Each evaluation is a fresh call of the configuration's force law (`law`,
forcelaw.resolve): its full sweep, and for hermite4_block's subcycle its
sweep of rows against the predicted columns; nothing is carried between
outer steps.
"""
from __future__ import annotations

import torch


def _crit2(a, j):
    return (a * a).sum(-1) / (j * j).sum(-1).clamp_min(1e-30)


def leapfrog(law, pos, vel, mass, dt: float, eps2: float, n_sub: int):
    h = dt / n_sub
    zeros = torch.zeros_like(pos)

    def acc(p):
        return law.full(p, zeros, mass, eps2, with_jerk=False)[0]

    a = acc(pos)
    for _ in range(n_sub):
        v_half = vel + 0.5 * h * a
        pos = pos + h * v_half
        a = acc(pos)
        vel = v_half + 0.5 * h * a
    return pos, vel


def _hermite_pc(p, v, a, j, h, force):
    """One predict-evaluate-correct step of rows (p, v) over h; `force`
    gives (acc, jerk) at the predicted rows."""
    h2 = h * h
    pp = p + h * v + 0.5 * h2 * a + (h2 * h / 6.0) * j
    vp = v + h * a + 0.5 * h2 * j
    a1, j1 = force(pp, vp)
    v1 = v + 0.5 * h * (a + a1) + (h2 / 12.0) * (j - j1)
    p1 = p + 0.5 * h * (v + v1) + (h2 / 12.0) * (a - a1)
    return p1, v1, a1, j1


def hermite4(law, pos, vel, mass, dt: float, eps2: float, eta: float,
             substeps_max: int):
    def force(p, v):
        a, j, _ = law.full(p, v, mass, eps2)
        return a, j

    a, j = force(pos, vel)
    h_min = dt / substeps_max
    t = 0.0
    while t < dt:
        h = eta * float(torch.sqrt(_crit2(a, j).min()))
        h = min(max(h, h_min), dt - t)
        pos, vel, a, j = _hermite_pc(pos, vel, a, j, h, force)
        t += h
    return pos, vel


def hermite4_block(law, pos, vel, mass, dt: float, eps2: float,
                   eta: float, substeps_max: int, k_fast: int):
    a0, j0, _ = law.full(pos, vel, mass, eps2)
    fast = torch.topk(_crit2(a0, j0), k_fast, largest=False).indices

    def predict(tau):
        t2 = tau * tau
        return (pos + tau * vel + 0.5 * t2 * a0 + (t2 * tau / 6.0) * j0,
                vel + tau * a0 + 0.5 * t2 * j0)

    pf, vf, af, jf = pos[fast], vel[fast], a0[fast], j0[fast]
    h_min = dt / substeps_max
    tau = 0.0
    while tau < dt:
        h = eta * float(torch.sqrt(_crit2(af, jf).min()))
        h = min(max(h, h_min), dt - tau)
        p_cols, v_cols = predict(tau + h)

        def force(pp, vp):
            pc = p_cols.index_copy(0, fast, pp)
            vc = v_cols.index_copy(0, fast, vp)
            a, j, _ = law.forces(pp, vp, fast, pc, vc, mass, eps2)
            return a, j

        pf, vf, af, jf = _hermite_pc(pf, vf, af, jf, h, force)
        tau += h
    p_end, v_end = predict(dt)
    p_end = p_end.index_copy(0, fast, pf)
    v_end = v_end.index_copy(0, fast, vf)
    a1, j1, _ = law.full(p_end, v_end, mass, eps2)
    dt2 = dt * dt
    vel_c = vel + 0.5 * dt * (a0 + a1) + (dt2 / 12.0) * (j0 - j1)
    pos_c = pos + 0.5 * dt * (vel + vel_c) + (dt2 / 12.0) * (a0 - a1)
    return pos_c.index_copy(0, fast, pf), vel_c.index_copy(0, fast, vf)
