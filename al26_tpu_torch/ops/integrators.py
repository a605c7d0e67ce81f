"""Time integrators for the N-body subsystem (torch port of
al26_tpu.ops.integrators).

  * `leapfrog_advance` — KDK leapfrog with a fixed number of substeps per
    outer step (BHTree parity, al26_nbody.py:1709-1722).
  * `hermite4_advance` — shared adaptive-timestep 4th-order Hermite
    (predict / evaluate / correct) until the outer step is consumed.
  * `hermite4_block_advance` — the two-group (optionally three-tier)
    block-timestep Hermite: full evaluations at the step ends, the fast
    group's K x N row sweeps subcycled in between.

The JAX package keeps the data-dependent substep loops on the device
(`lax.while_loop`, `lax.cond`). Here they are Python loops and branches
that read `t < dt` (and the mid tier's advance flag) back to the host once
per substep: one device synchronisation per substep. Each iteration of a
substep loop is the span "integrator.substep" and one count of
`integrator.substeps`; each read-back is the span "integrator.host_read"
and one count of `host_reads.integrator` (utils.timing).

On a CUDA f32 state the two-tier predicted-columns subcycle runs each
substep as two hand-written kernels around kernel 2c (ops.cuda_substep),
one more count of `integrator.fused_substeps` each; the torch loop beside
it is their plain version and runs everywhere else.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..units import G_INTERNAL
from ..utils.timing import count, span
from . import cuda_substep
from .nbody import acc_jerk_pot, acc_pot_dense

_TINY = 1e-30


def _host_bool(flag: torch.Tensor) -> bool:
    """A device flag read back to the host: the host waits here for the
    device's queued work."""
    count("host_reads.integrator")
    with span("integrator.host_read"):
        return bool(flag)


def _substep():
    """One substep of an integrator loop: counted, and a span."""
    count("integrator.substeps")
    return span("integrator.substep")


def leapfrog_advance(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    dt: torch.Tensor,
    n_sub: int = 8,
    eps2: float | torch.Tensor = 0.0,
    g: float = G_INTERNAL,
    acc_fn=None,
    init_acc=None,
    final_eval_fn=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kick-drift-kick leapfrog with `n_sub` fixed substeps.

    `final_eval_fn(pos) -> (acc, pot)`: when given, the LAST substep's
    force evaluation goes through it and the function returns
    (pos, vel, (acc, None, pot)) — the closing evaluation is at the FINAL
    positions exactly, reusable as the next outer step's opening one
    (sim/step.py force cache)."""
    if acc_fn is None:
        def acc_fn(p):
            a, _ = acc_pot_dense(p, mass, eps2, g)
            return a

    h = dt / n_sub
    # init_acc: the caller's step-start evaluation
    a = acc_fn(pos) if init_acc is None else init_acc

    def kdk(p, v, a):
        with _substep():
            v_half = v + 0.5 * h * a
            p_new = p + h * v_half
            a_new = acc_fn(p_new)
            return p_new, v_half + 0.5 * h * a_new, a_new

    if final_eval_fn is None:
        for _ in range(n_sub):
            pos, vel, a = kdk(pos, vel, a)
        return pos, vel
    # all but the last substep in the loop; the last one written out so
    # its evaluation can also produce the potential for the cache
    for _ in range(n_sub - 1):
        pos, vel, a = kdk(pos, vel, a)
    with _substep():
        v_half = vel + 0.5 * h * a
        pos = pos + h * v_half
        a_new, pot = final_eval_fn(pos)
        vel = v_half + 0.5 * h * a_new
    return pos, vel, (a_new, None, pot)


def _min_crit(a, j):
    """min_i |a_i|^2 / |j_i|^2 (the Aarseth criterion, squared)."""
    a2 = torch.sum(a * a, dim=-1)
    j2 = torch.sum(j * j, dim=-1)
    return torch.min(a2 / torch.clamp(j2, min=_TINY))


def hermite4_advance(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    dt: torch.Tensor,
    eta: float = 0.14,
    eps2: float | torch.Tensor = 0.0,
    g: float = G_INTERNAL,
    max_substeps: int = 4096,
    force_block: int | None = None,
    force_fn=None,
    init_eval=None,
    force_pot_fn=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance (pos, vel) by dt with shared adaptive-timestep Hermite4.

    The shared substep is h = eta * min_i |a_i| / |jerk_i| (simple Aarseth
    criterion), clamped below at dt / max_substeps and above by the time
    left. One force evaluation per substep (P(EC)).

    `force_fn(pos, vel) -> (acc, jerk)` overrides the default dense/chunked
    evaluation (the hook for the CUDA kernel, ops.cuda_nbody).

    `force_pot_fn(pos, vel) -> (acc, jerk, pot)`: when given, EVERY substep
    evaluation goes through it and the advance returns
    (pos, vel, (acc, jerk, pot)) — the last substep's evaluation at its
    predicted state, reused by the caller as the next outer step's opening
    evaluation."""
    dtype = pos.dtype
    dt = torch.as_tensor(dt, dtype=dtype, device=pos.device)
    if force_fn is None:
        def force_fn(p, v):
            a, j, _ = acc_jerk_pot(p, v, mass, eps2, g, block=force_block)
            return a, j
    want_cache = force_pot_fn is not None
    if want_cache:
        forces = force_pot_fn
    else:
        def forces(p, v):
            a, j = force_fn(p, v)
            return a, j, None

    if init_eval is None:
        a, j, pot = forces(pos, vel)
    else:
        a, j = init_eval
        pot = None
    if want_cache and pot is None:
        pot = torch.zeros(pos.shape[0], dtype=dtype, device=pos.device)
    h_min = dt / max_substeps

    p, v = pos, vel
    t = torch.zeros((), dtype=dtype, device=pos.device)
    while _host_bool(t < dt):                 # one host read per substep
        with _substep():
            h = eta * torch.sqrt(_min_crit(a, j))
            h = torch.minimum(torch.maximum(h, h_min), dt - t)
            h2 = h * h
            # predict
            pp = p + h * v + 0.5 * h2 * a + (h2 * h / 6.0) * j
            vp = v + h * a + 0.5 * h2 * j
            # evaluate
            a1, j1, pot1 = forces(pp, vp)
            # correct (Makino & Aarseth 1992 two-stage corrector)
            v1 = v + 0.5 * h * (a + a1) + (h2 / 12.0) * (j - j1)
            p1 = p + 0.5 * h * (v + v1) + (h2 / 12.0) * (a - a1)
            if want_cache:
                pot = pot1
            t, p, v, a, j = t + h, p1, v1, a1, j1
    if want_cache:
        return p, v, (a, j, pot)
    return p, v


def _fast_override_delta(pr, vr, pc_s, vc_s, pc_p, vc_p, mc, eps2, g):
    """Exact source-linearity correction for the predicted-columns kernel
    (ops.cuda_nbody.make_pred_force_rows).

    Pair forces sum linearly over SOURCES, so replacing the fast columns'
    step-start-predicted states with their subcycled states equals adding
      sum_{j in fast} [f(x_j^sub) - f(x_j^pred)]
    — two K x K dense pair evaluations (self pairs masked in both terms,
    mirroring the kernel's row-id mask). Returns (delta_acc, delta_jerk)
    on the K rows (pr, vr)."""
    k = pr.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=pr.device)

    def pair(pc, vc):
        dx = pc[None, :, :] - pr[:, None, :]          # [K,K,3]
        dv = vc[None, :, :] - vr[:, None, :]
        r2 = torch.sum(dx * dx, dim=-1) + eps2
        inv_r = torch.where(eye, 0.0, torch.rsqrt(r2))
        inv_r2 = inv_r * inv_r
        w = mc[None, :] * (inv_r * inv_r2)            # m_j / r^3, masked
        acc = torch.einsum("ij,ijc->ic", w, dx)
        s = 3.0 * torch.sum(dx * dv, dim=-1) * inv_r2
        jerk = (torch.einsum("ij,ijc->ic", w, dv)
                - torch.einsum("ij,ijc->ic", w * s, dx))
        return acc, jerk

    a_s, j_s = pair(pc_s, vc_s)
    a_p, j_p = pair(pc_p, vc_p)
    return g * (a_s - a_p), g * (j_s - j_p)


def hermite4_block_advance(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    dt: torch.Tensor,
    k_fast: int,
    eta: float = 0.14,
    eps2: float | torch.Tensor = 0.0,
    g: float = G_INTERNAL,
    max_substeps: int = 4096,
    force_fn=None,
    force_rows_fn=None,
    init_eval=None,
    final_eval_fn=None,
    interior_samples: int = 0,
    k_ultra: int = 0,
    force_rows_at_factory=None,
):
    """Two-group block-timestep Hermite (ph4-style, fixed shapes).

      * full force evaluation at the step start; the `k_fast` particles
        with the smallest |a|/|jerk| timestep criterion form the FAST group
        (smallest first);
      * the slow group takes one Hermite P(EC) step across the whole dt,
        its positions available to the fast group through the Hermite
        predictor polynomial;
      * the fast group subcycles with a shared adaptive step, each substep
        evaluating forces only on the K fast rows against all N columns,
        with fast columns overwritten by their current subcycled state;
      * a final full evaluation at t+dt closes the slow corrector.

    `0 < k_ultra < k_fast` enables the THREE-level variant: the k_ultra
    rows with the smallest criterion subcycle at the shared minimum, the
    remaining mid tier advances only when the gap since its last update
    reaches its own shared-minimum step (synchronised to ultra substep
    boundaries, forced to land at dt).

    `force_rows_fn(pos_rows, vel_rows, row_ids, pos_all, vel_all) ->
    (acc, jerk)` overrides the row-subset force; defaults to the dense
    torch row block. `force_rows_at_factory(pos, vel, a0, j0) -> rows_at`
    (two-tier only) gives the predicted-columns subcycle: one kernel
    launch per substep with the columns predicted in-kernel, plus the
    exact fast-column override (_fast_override_delta); on a CUDA f32
    state the rest of each substep is two fused kernels
    (ops.cuda_substep).

    `final_eval_fn(pos, vel) -> (acc, jerk, pot)`: the closing full
    evaluation goes through it (at the PREDICTED end state, P(EC)) and a
    third output (acc, jerk, pot) is returned for reuse as the next step's
    opening evaluation.

    `interior_samples = m-1 > 0` additionally returns the full-cluster
    (pos, vel) at the interior times k*dt/m, k = 1..m-1, as
    (pos_s [m-1,N,3], vel_s [m-1,N,3]): slow stars from the step-start
    predictor, fast stars captured inside the subcycle at the crossing
    substep with that substep's own predictor."""
    dtype = pos.dtype
    device = pos.device
    dt = torch.as_tensor(dt, dtype=dtype, device=device)

    if force_fn is None:
        def force_fn(p, v):
            a, j, _ = acc_jerk_pot(p, v, mass, eps2, g)
            return a, j
    if force_rows_fn is None:
        from .nbody import _row_block_acc_jerk_pot

        def force_rows_fn(pr, vr, ids, p_all, v_all):
            a, j, _ = _row_block_acc_jerk_pot(
                pr, vr, p_all, v_all, mass, eps2, g, ids, with_pot=False
            )
            return a, j

    # -- step-start evaluation + fast-group selection -----------------------
    a0, j0 = force_fn(pos, vel) if init_eval is None else init_eval
    a2 = torch.sum(a0 * a0, dim=-1)
    j2 = torch.sum(j0 * j0, dim=-1)
    crit = torch.sqrt(a2 / torch.clamp(j2, min=_TINY))   # per-particle h/eta
    # smallest criterion first: the k_ultra split below depends on it
    fast_idx = torch.topk(crit, k_fast, largest=False, sorted=True).indices

    dt2 = dt * dt

    def predict_all(tau):
        """Hermite predictor for every particle at step-start + tau."""
        t2 = tau * tau
        p = pos + tau * vel + 0.5 * t2 * a0 + (t2 * tau / 6.0) * j0
        v = vel + tau * a0 + 0.5 * t2 * j0
        return p, v

    # -- fast-group subcycle -------------------------------------------
    pf0 = pos[fast_idx]
    vf0 = vel[fast_idx]
    af0 = a0[fast_idx]
    jf0 = j0[fast_idx]
    h_min = dt / max_substeps
    # predicted-columns path: ONE kernel launch per substep, columns
    # predicted in-kernel from the step-start state, fast-column override
    # restored exactly by the K x K source-linearity delta. Two-tier only.
    three_tier = 0 < k_ultra < k_fast
    rows_at = None
    if force_rows_at_factory is not None and not three_tier:
        rows_at = force_rows_at_factory(pos, vel, a0, j0)
        mass_f = mass[fast_idx]
    m_s = interior_samples
    if m_s:
        # interior sample times k*dt/m, k = 1..m-1 (gravity stride)
        tau_s = (torch.arange(1, m_s + 1, dtype=dtype, device=device)
                 / (m_s + 1)) * dt
        samp_pf = torch.zeros((m_s,) + pf0.shape, dtype=dtype, device=device)
        samp_vf = torch.zeros((m_s,) + vf0.shape, dtype=dtype, device=device)

    def capture(tau, tau_new, pf, vf, af, jf, tau_from):
        """Capture fast-row states at the interior sample times this
        substep crosses, via the predictor from `tau_from`."""
        crossed = ((tau < tau_s) & (tau_new >= tau_s))[:, None, None]
        th = (tau_s - tau_from)[:, None, None]            # [m_s,1,1]
        p_at = pf + th * vf + 0.5 * th**2 * af + (th**3 / 6.0) * jf
        v_at = vf + th * af + 0.5 * th**2 * jf
        return p_at, v_at, crossed

    tau = torch.zeros((), dtype=dtype, device=device)
    if three_tier:
        u_idx = fast_idx[:k_ultra]      # smallest crit first
        m_idx = fast_idx[k_ultra:]
        tau_m = tau
        pu, vu, au, ju = pf0[:k_ultra], vf0[:k_ultra], af0[:k_ultra], \
            jf0[:k_ultra]
        pm, vm, am, jm = pf0[k_ultra:], vf0[k_ultra:], af0[k_ultra:], \
            jf0[k_ultra:]
        while _host_bool(tau < dt):           # one host read per substep
            with _substep():
                h = eta * torch.sqrt(_min_crit(au, ju))
                h = torch.minimum(torch.maximum(h, h_min), dt - tau)
                h2 = h * h
                tau_new = tau + h
                hm_nat = eta * torch.sqrt(_min_crit(am, jm))
                adv_m = ((tau_new - tau_m) >= hm_nat) | (tau_new >= dt)
                # predictions: ultra over its substep, mid from ITS last
                # update
                pup = pu + h * vu + 0.5 * h2 * au + (h2 * h / 6.0) * ju
                vup = vu + h * au + 0.5 * h2 * ju
                thm = tau_new - tau_m
                pmp = pm + thm * vm + 0.5 * thm**2 * am + (thm**3 / 6.0) * jm
                vmp = vm + thm * am + 0.5 * thm**2 * jm
                if m_s:
                    pu_at, vu_at, crossed = capture(tau, tau_new, pu, vu,
                                                    au, ju, tau)
                    pm_at, vm_at, _ = capture(tau, tau_new, pm, vm, am, jm,
                                              tau_m)
                    samp_pf = torch.where(
                        crossed, torch.cat([pu_at, pm_at], 1), samp_pf)
                    samp_vf = torch.where(
                        crossed, torch.cat([vu_at, vm_at], 1), samp_vf)
                p_cols, v_cols = predict_all(tau_new)
                p_cols = p_cols.index_copy(0, u_idx, pup).index_copy(0, m_idx,
                                                                     pmp)
                v_cols = v_cols.index_copy(0, u_idx, vup).index_copy(0, m_idx,
                                                                     vmp)
                au1, ju1 = force_rows_fn(pup, vup, u_idx, p_cols, v_cols)
                vu1 = vu + 0.5 * h * (au + au1) + (h2 / 12.0) * (ju - ju1)
                pu1 = pu + 0.5 * h * (vu + vu1) + (h2 / 12.0) * (au - au1)
                if _host_bool(adv_m):             # one more host read
                    am1, jm1 = force_rows_fn(pmp, vmp, m_idx, p_cols, v_cols)
                    vm1 = (vm + 0.5 * thm * (am + am1)
                           + (thm**2 / 12.0) * (jm - jm1))
                    pm1 = (pm + 0.5 * thm * (vm + vm1)
                           + (thm**2 / 12.0) * (am - am1))
                    pm, vm, am, jm, tau_m = pm1, vm1, am1, jm1, tau_new
                tau, pu, vu, au, ju = tau_new, pu1, vu1, au1, ju1
        pf = torch.cat([pu, pm], dim=0)   # fast_idx order
        vf = torch.cat([vu, vm], dim=0)
    elif rows_at is not None and cuda_substep.engages(pf0):
        # the same substep in two hand-written kernels around kernel 2c
        # (ops.cuda_substep): predict, 2c, correct; the torch loop below
        # is its plain version
        sub = cuda_substep.FusedSubstep(pf0, vf0, af0, jf0, mass_f, dt,
                                        h_min, eta, eps2, g)
        ids = fast_idx.to(torch.int32)
        more = tau < dt
        while _host_bool(more):               # one host read per substep
            with _substep():
                count("integrator.fused_substeps")
                sub.predict()
                if m_s:
                    p_at, v_at, crossed = capture(sub.tau, sub.th, sub.pf,
                                                  sub.vf, sub.af, sub.jf,
                                                  sub.tau)
                    samp_pf = torch.where(crossed, p_at, samp_pf)
                    samp_vf = torch.where(crossed, v_at, samp_vf)
                a1, j1 = rows_at(sub.pfp, sub.vfp, ids, sub.th)
                more = sub.correct(a1, j1)
        pf, vf = sub.pf, sub.vf
    else:
        pf, vf, af, jf = pf0, vf0, af0, jf0
        while _host_bool(tau < dt):           # one host read per substep
            with _substep():
                h = eta * torch.sqrt(_min_crit(af, jf))
                h = torch.minimum(torch.maximum(h, h_min), dt - tau)
                h2 = h * h
                # predict fast rows
                pfp = pf + h * vf + 0.5 * h2 * af + (h2 * h / 6.0) * jf
                vfp = vf + h * af + 0.5 * h2 * jf
                if m_s:
                    p_at, v_at, crossed = capture(tau, tau + h, pf, vf, af, jf,
                                                  tau)
                    samp_pf = torch.where(crossed, p_at, samp_pf)
                    samp_vf = torch.where(crossed, v_at, samp_vf)
                if rows_at is not None:
                    # columns predicted in-kernel at tau+h; add the exact
                    # subcycled-fast-column override via source linearity
                    th = tau + h
                    a1, j1 = rows_at(pfp, vfp, fast_idx, th)
                    th2 = th * th
                    pf_pred = (pf0 + th * vf0 + 0.5 * th2 * af0
                               + (th2 * th / 6.0) * jf0)
                    vf_pred = vf0 + th * af0 + 0.5 * th2 * jf0
                    da, dj = _fast_override_delta(
                        pfp, vfp, pfp, vfp, pf_pred, vf_pred, mass_f, eps2, g
                    )
                    a1 = a1 + da
                    j1 = j1 + dj
                else:
                    # columns at tau+h: everyone predicted, fast rows replaced
                    # by their subcycled prediction
                    p_cols, v_cols = predict_all(tau + h)
                    p_cols = p_cols.index_copy(0, fast_idx, pfp)
                    v_cols = v_cols.index_copy(0, fast_idx, vfp)
                    a1, j1 = force_rows_fn(pfp, vfp, fast_idx, p_cols, v_cols)
                vf1 = vf + 0.5 * h * (af + a1) + (h2 / 12.0) * (jf - j1)
                pf1 = pf + 0.5 * h * (vf + vf1) + (h2 / 12.0) * (af - a1)
                tau, pf, vf, af, jf = tau + h, pf1, vf1, a1, j1

    # -- slow-group full step ------------------------------------------
    pos_p, vel_p = predict_all(dt)
    pos_p = pos_p.index_copy(0, fast_idx, pf)
    vel_p = vel_p.index_copy(0, fast_idx, vf)
    pot1 = None
    if final_eval_fn is None:
        a1, j1 = force_fn(pos_p, vel_p)
    else:
        a1, j1, pot1 = final_eval_fn(pos_p, vel_p)
    vel_c = vel + 0.5 * dt * (a0 + a1) + (dt2 / 12.0) * (j0 - j1)
    pos_c = pos + 0.5 * dt * (vel + vel_c) + (dt2 / 12.0) * (a0 - a1)
    # fast rows keep their subcycled (more accurate) result
    pos_c = pos_c.index_copy(0, fast_idx, pf)
    vel_c = vel_c.index_copy(0, fast_idx, vf)
    out = (pos_c, vel_c)
    if final_eval_fn is not None:
        out = out + ((a1, j1, pot1),)
    if m_s:
        # full-cluster interior samples: slow stars from the step-start
        # predictor, fast rows overwritten with their captured states
        ps, vs = [], []
        for k in range(m_s):
            p_k, v_k = predict_all(tau_s[k])
            ps.append(p_k.index_copy(0, fast_idx, samp_pf[k]))
            vs.append(v_k.index_copy(0, fast_idx, samp_vf[k]))
        out = out + ((torch.stack(ps), torch.stack(vs)),)
    return out


def advance(
    pos, vel, mass, dt, *, integrator: str = "hermite4",
    eta: float = 0.14, n_sub: int = 8, eps2=0.0, g=G_INTERNAL,
    max_substeps: int = 4096, force_block=None, force_fn=None, acc_fn=None,
    k_fast: int = 0, force_rows_fn=None, init_eval=None, final_eval_fn=None,
    interior_samples: int = 0, k_ultra: int = 0,
    force_rows_at_factory=None,
):
    """Dispatch over the configured integrator.

    `init_eval=(a0, j0)` (or `(a0, None)` for leapfrog) injects the caller's
    step-start force evaluation. `final_eval_fn` makes the advance also
    return its closing (acc, jerk, pot) evaluation for reuse as the NEXT
    step's opening one (hermite4: every substep goes through it)."""
    if integrator == "hermite4":
        return hermite4_advance(
            pos, vel, mass, dt, eta, eps2, g, max_substeps, force_block,
            force_fn, init_eval, force_pot_fn=final_eval_fn,
        )
    if integrator == "hermite4_block":
        k = k_fast or max(128, pos.shape[0] // 16)
        k = min(k, pos.shape[0])  # top-k rejects k > n (tiny clusters)
        return hermite4_block_advance(
            pos, vel, mass, dt, k,
            eta, eps2, g, max_substeps, force_fn, force_rows_fn, init_eval,
            final_eval_fn, interior_samples, k_ultra,
            force_rows_at_factory,
        )
    if integrator == "leapfrog":
        if acc_fn is None and force_fn is not None:
            def acc_fn(p):
                a, _ = force_fn(p, torch.zeros_like(p))
                return a
        init_acc = init_eval[0] if init_eval is not None else None
        final_acc_fn = None
        if final_eval_fn is not None:
            def final_acc_fn(p):
                # final_eval_fn's (pos, vel) contract: leapfrog has no
                # meaningful velocity at the closing kick, so pass zeros
                a, _, pot = final_eval_fn(p, torch.zeros_like(p))
                return a, pot
        return leapfrog_advance(pos, vel, mass, dt, n_sub, eps2, g, acc_fn,
                                init_acc, final_acc_fn)
    raise ValueError(f"unknown integrator: {integrator}")
