"""The simulation step (torch port of al26_tpu.sim.step).

Re-design of `evolve_simulation` (al26_nbody.py:704-1113). Order of
operations follows the reference exactly:

  1. masks + virial radius from the state at step start (:767-770)
  2. N-body advance by the fixed outer dt (:786, :833)
  3. stellar evolution update -> new masses + wind rates (:841, :871-876)
  4. wind deposition, global + local mixing models (:883-941)
  5. supernova detection + disc injection (:943-967)
  6. AGB interloper deposition (:969-1028)
  7. radioactive decay (:1045-1068)
  8. disc condensation / death (:1070-1086)

Data-dependent events (SNe, disc death, interloper proximity) are masks;
shapes never change. The step runs eagerly on the state's device; on the
kernel path (force_impl="pallas", or "auto" on a CUDA device in f32) the
full sweeps and the fast-group row sweeps go through the CUDA kernels of
ops.cuda_nbody, and the closing sweep of each step is carried into the
next as a mass-delta-corrected force cache. force_impl="tree" (the
Barnes-Hut tier, ops.tree) makes the full sweeps tree sweeps (near field:
the kernel of ops.cuda_tree on a CUDA device in f32) while the
hermite4_block fast-group subcycle stays exact, through the direct-sum
kernels wherever they run.

Deliberate difference from the JAX package: with tree_mac="relative" the
relative MAC reaches the integrator only through the force cache, so an
uncached step() raises ValueError (the JAX package's uncached step
silently opens geometrically there).

cfg.gravity_stride = m > 1 (run_steps_cached_strided, engaged by
run_steps and the driver where stride_active says so) makes m physics
steps share one hermite4_block force advance over m*dt (_stride_impl).

Under a device mesh (`mesh`, a DeviceMesh of parallel.sharded.make_mesh)
every rank runs the step on the whole state and the pairwise work splits
over the ranks (parallel.sharded's docstring): the full sweeps through the
all-gather row blocks ("sharded", the default for "auto"), the
ring-streamed column blocks ("ring") or the tree mesh ("tree",
parallel.tree_mesh), and the hermite4_block subcycle's K x N rows by
column slice (parallel.sharded.make_sharded_force_rows; no
predicted-columns factory, so kernel 2 does not run under a mesh, as in
the JAX package).
"""
from __future__ import annotations

import torch

from ..config import SimConfig
from ..models.stellar import evolution as stellar
from ..models.stellar.common import interp
from ..ops import cuda_nbody
from ..ops import deposition as dep
from ..ops.integrators import advance
from ..ops.nbody import (
    acc_jerk_pot_chunked, center_of_mass, mass_delta_correction,
    virial_radius,
)
from ..state import CH_AGB, CH_GLOBAL, CH_LOCAL, CH_SNE, SimState
from ..units import G_INTERNAL
from .init import SimAux

def _check_backend(mesh, force_impl: str) -> None:
    if force_impl in ("sharded", "ring") and mesh is None:
        raise ValueError(
            f"force_impl={force_impl!r} requires a device mesh "
            "(cfg.mesh_shape)")
    if mesh is not None and force_impl not in ("auto", "sharded", "ring",
                                               "tree"):
        # a mesh run's opening/closing sweeps are always the mesh backends
        raise ValueError(
            f"force_impl={force_impl!r} is single-device; with mesh_shape "
            "use 'auto', 'sharded', 'ring' or 'tree'")
    if force_impl not in ("auto", "pallas", "default", "tree", "sharded",
                          "ring"):
        raise ValueError(f"unknown force_impl: {force_impl}")


def _agb_rates(aux: SimAux, t_interloper):
    """Interpolate the AGB wind rate grids at the interloper clock; zero
    outside the tabulated range (al26_nbody.py:535-562)."""
    t = aux.agb_grid_t
    inside = (t_interloper >= t[0]) & (t_interloper <= t[-1])
    x = t_interloper.reshape(1)
    r_al = interp(x, t, aux.agb_grid_rates[0])[0] * inside
    r_fe = interp(x, t, aux.agb_grid_rates[1])[0] * inside
    return r_al, r_fe


def _build_force_fn(mass, eps2, cfg: SimConfig, mesh, force_impl: str):
    """Select the pairwise force backend: (force_fn, acc_fn).

    auto    -> the CUDA kernels on a CUDA device in f32
               (cuda_nbody.use_kernel), else the integrator default
               (dense <= 2048, row-chunked above).
    pallas  -> the direct-sum kernels (ops.cuda_nbody; the name is the
               JAX package's config value, kept interchangeable).
    default -> the integrator default (plain torch).
    tree    -> the Barnes-Hut tier at the geometric MAC (ops.tree); the
               relative MAC never comes through here (_step_impl).
    Under a mesh: "auto" / "sharded" -> the all-gather row blocks
    (parallel.sharded), "ring" -> the ring-streamed column blocks
    (parallel.ring), "tree" -> the tree mesh sweep (parallel.tree_mesh);
    no acc_fn (leapfrog takes the acceleration of force_fn).
    The caller (_step_impl) has checked the backend (_check_backend)."""
    if mesh is not None:
        if force_impl == "tree":
            from ..parallel.tree_mesh import make_tree_mesh_sweep

            sweep = make_tree_mesh_sweep(
                mass, mesh, cfg.eps2, leaf=cfg.tree_leaf,
                theta=cfg.tree_theta, kavg=cfg.tree_kavg or 256,
                pot_eps2=None, with_jerk=True)

            def tree_force_fn(p, v):
                a, j, _ = sweep(p, v)
                return a, j

            return tree_force_fn, None
        if force_impl == "ring":
            from ..parallel.ring import make_ring_force

            return make_ring_force(mesh, mass, eps2), None
        from ..parallel.sharded import make_sharded_force

        return make_sharded_force(mesh, mass, eps2), None
    if force_impl == "tree":
        from ..ops.tree import make_tree_acc, make_tree_force

        kw = dict(leaf=cfg.tree_leaf, theta=cfg.tree_theta,
                  kavg=cfg.tree_kavg or 256)
        return (make_tree_force(mass, cfg.eps2, **kw),
                make_tree_acc(mass, cfg.eps2, **kw))
    if force_impl == "auto":
        force_impl = ("pallas" if cuda_nbody.use_kernel(
            mass.shape[0], mass.dtype, mass.device) else "default")
    if force_impl == "default":
        return None, None
    return (cuda_nbody.make_pallas_force(mass, eps2),
            cuda_nbody.make_pallas_acc(mass, eps2))


def _build_force_rows_fn(mass, eps2, force_impl_resolved):
    if force_impl_resolved == "pallas":
        return cuda_nbody.make_pallas_force_rows(mass, eps2)
    return None


def _build_rows_at_factory(mass, eps2, pallas_here: bool):
    """Predicted-columns subcycle backend (kernel 2): the per-substep
    K x N row sweep predicts its columns in the kernel from the step-start
    state (the fast-column override is restored exactly via
    ops.integrators._fast_override_delta)."""
    if not pallas_here:
        return None

    def factory(pos, vel, a0, j0):
        return cuda_nbody.make_pred_force_rows(pos, vel, a0, j0, mass,
                                               float(eps2))

    return factory


def _mesh_sweep(mesh, force_impl: str):
    """Full-sweep function `(pos, vel, mass, *, eps2, pot_eps2, with_jerk)
    -> (acc, jerk, pot)` for the mesh backends: the ring for
    force_impl="ring", the all-gather row blocks otherwise."""
    if force_impl == "ring":
        from ..parallel.ring import ring_acc_jerk_pot

        return lambda p, v, m, **kw: ring_acc_jerk_pot(p, v, m, mesh, **kw)
    from ..parallel.sharded import sharded_acc_jerk_pot

    return lambda p, v, m, **kw: sharded_acc_jerk_pot(p, v, m, mesh, **kw)


def _sweep_eval_fn(cfg: SimConfig, mesh, force_impl: str, mass,
                   needs_jerk: bool, tree_aref=None):
    """Full fused sweep `(pos, vel) -> (acc, jerk, pot)`: kernel 1, or the
    tree sweep for force_impl="tree", or their mesh counterparts under a
    mesh — the ONE place the sweep conventions (cfg.eps2 force softening,
    _pot_eps2 virial softening, with_jerk) live; _step_impl, _stride_impl
    and fresh_cache build their evaluations here.

    `tree_aref` [N] (tree tier, tree_mac="relative"): per-star reference
    acceleration magnitudes — the opening evaluation, carried by the force
    cache — switching the MAC to the relative criterion at tolerance
    cfg.tree_alpha. In relative mode the cache-seeding sweep (no previous
    acceleration yet, tree_aref None) is the EXACT sweep: kernel 1 where it
    runs, the plain row-block sweep elsewhere (under a mesh: the
    all-gather row blocks). The geometric MAC at cfg.tree_theta serves
    tree_mac="geometric" only."""
    _check_backend(mesh, force_impl)
    if mesh is not None:
        if force_impl == "tree" and not (cfg.tree_mac == "relative"
                                         and tree_aref is None):
            from ..parallel.tree_mesh import make_tree_mesh_sweep

            theta = cfg.tree_theta if tree_aref is None else cfg.tree_alpha
            return make_tree_mesh_sweep(
                mass, mesh, cfg.eps2, leaf=cfg.tree_leaf, theta=theta,
                kavg=cfg.tree_kavg or 256, pot_eps2=_pot_eps2(cfg),
                with_jerk=needs_jerk, aref=tree_aref)
        # relative mode's exact seeding sweep goes through the all-gather
        # row blocks
        sweep = _mesh_sweep(mesh, force_impl)

        def mesh_eval(p, v):
            return sweep(p, v, mass, eps2=cfg.eps2, pot_eps2=_pot_eps2(cfg),
                         with_jerk=needs_jerk)

        return mesh_eval
    if force_impl == "tree":
        if cfg.tree_mac == "relative" and tree_aref is None:
            if not cuda_nbody.use_kernel(mass.shape[0], mass.dtype,
                                         mass.device):
                return lambda p, v: acc_jerk_pot_chunked(
                    p, v, mass, cfg.eps2, pot_eps2=_pot_eps2(cfg),
                    with_jerk=needs_jerk)
            # else: the exact kernel-1 sweep below
        else:
            from ..ops.tree import make_tree_sweep

            theta = cfg.tree_theta if tree_aref is None else cfg.tree_alpha
            return make_tree_sweep(
                mass, cfg.eps2, leaf=cfg.tree_leaf, theta=theta,
                kavg=cfg.tree_kavg or 256, pot_eps2=_pot_eps2(cfg),
                with_jerk=needs_jerk, aref=tree_aref)

    def sweep_eval(p, v):
        return cuda_nbody.kernel_acc_jerk_pot(p, v, mass, cfg.eps2,
                                              with_jerk=needs_jerk,
                                              pot_eps2=_pot_eps2(cfg))

    return sweep_eval


def _corrected_cache(new_cluster, old_cluster, aux: SimAux, cfg: SimConfig,
                     mesh, pos, vel, a1, j1, pot1):
    """Shared cache epilogue: correct the closing (acc, jerk, pot)
    evaluation for this step's source-mass changes (forces are linear in
    source masses — O(N x M) instead of a fresh O(N^2) sweep) and return
    the next step's opening cache."""
    eps2 = torch.as_tensor(cfg.eps2, dtype=pos.dtype, device=pos.device)
    dm = (new_cluster.mass[aux.msrc_idx]
          - old_cluster.mass[aux.msrc_idx]) * aux.msrc_valid
    a1, j1, pot1 = mass_delta_correction(
        a1, j1, pot1, pos, vel, aux.msrc_idx, dm, eps2,
        pot_softened=cfg.softened_virial,
    )
    return a1, torch.zeros_like(a1) if j1 is None else j1, pot1


def _virial_radius_from_pot(mass, pot):
    """Virial radius -G M^2 / (2 U) from a sweep's per-star potential."""
    u = 0.5 * torch.sum(mass * pot)
    mtot = torch.sum(mass)
    return -G_INTERNAL * mtot * mtot / (2.0 * u)


def _pot_eps2(cfg: SimConfig):
    """Potential softening for the per-step sweep: the reference computes
    the virial radius from the RAW potential (AMUSE virial_radius,
    al26_nbody.py:767-770); cfg.softened_virial uses the BHTree-softened
    one instead."""
    return None if cfg.softened_virial else 1e-30


def _resolve_integ(cfg: SimConfig, n: int) -> str:
    """Defensive "auto" resolution for callers that bypass init_cluster's
    resolve_integrator (e.g. a cfg recreated from a dict)."""
    if cfg.integrator == "auto":
        if cfg.force_impl == "tree":
            # relative MAC: hermite4_block at any n (leapfrog cannot
            # thread the reference acceleration)
            if cfg.tree_mac == "relative":
                return "hermite4_block"
            return "leapfrog" if n <= 8192 else "hermite4_block"
        return "hermite4" if n <= 8192 else "hermite4_block"
    return cfg.integrator


def _pallas_here(cfg: SimConfig, n, dtype, device, mesh, force_impl) -> bool:
    """Does this step run on the direct-sum kernel path?"""
    return force_impl == "pallas" or (
        force_impl == "auto" and mesh is None
        and cuda_nbody.use_kernel(n, dtype, device)
    )


def _cacheable(cfg: SimConfig, n, dtype, device, mesh, force_impl) -> bool:
    """Can the closing force evaluation be carried to the next step?
    (leapfrog's closing eval is at the final positions exactly;
    hermite4's and hermite4_block's under P(EC) semantics.)"""
    integ = _resolve_integ(cfg, n)
    if not getattr(cfg, "force_cache", True):
        return False
    # natal kicks change velocities outside the advance: the Hermite
    # integrators' cached JERK is velocity-dependent
    if cfg.natal_kicks and integ in ("hermite4", "hermite4_block"):
        return False
    if integ not in ("leapfrog", "hermite4", "hermite4_block"):
        return False
    if mesh is not None:
        # every mesh sweep returns acc, jerk and pot in one pass
        return force_impl in ("auto", "sharded", "ring", "tree")
    if force_impl == "tree":
        # leapfrog: closing tree sweep at the final positions exactly;
        # hermite4_block: P(EC) semantics as on the kernel path
        return True
    return _pallas_here(cfg, n, dtype, device, mesh, force_impl)


def _step_impl(state: SimState, aux: SimAux, cfg: SimConfig,
               mesh, force_impl: str, cache, want_cache: bool = True):
    """One physics step; `cache` (acc, jerk, pot at the state's positions,
    with the PREVIOUS step's source masses already corrected to the current
    ones) replaces the opening O(N^2) sweep, and when caching is possible a
    new cache is returned with the step's closing evaluation."""
    _check_backend(mesh, force_impl)
    c = state.cluster
    dtype, device = c.pos.dtype, c.pos.device
    dt = torch.as_tensor(cfg.dt, dtype=dtype, device=device)
    eps2 = torch.as_tensor(cfg.eps2, dtype=dtype, device=device)

    integ = _resolve_integ(cfg, c.n)
    tree_here = force_impl == "tree"
    if tree_here and integ not in ("leapfrog", "hermite4_block"):
        # callers of step() can bypass sim.init.resolve_integrator; the
        # shared-adaptive hermite4 would pay a full tree build and sweep
        # per substep
        raise ValueError(
            "force_impl='tree' supports integrator='leapfrog' or "
            f"'hermite4_block'; got integrator={integ!r}")
    pallas_here = _pallas_here(cfg, c.n, dtype, device, mesh, force_impl)
    cache_ok = want_cache and _cacheable(cfg, c.n, dtype, device, mesh,
                                         force_impl)
    if tree_here and cfg.tree_mac == "relative" and not (
            cache_ok and integ == "hermite4_block"):
        # the relative MAC's reference acceleration rides the force cache
        # of the hermite4_block path; anywhere else the integrator's tree
        # forces would open geometrically, so refuse instead
        raise ValueError(
            "force_impl='tree' with tree_mac='relative' runs only through "
            "the force cache on hermite4_block (run_steps / fresh_cache + "
            "run_steps_cached, force_cache=True, natal_kicks=False); an "
            f"uncached step or integrator={integ!r} would silently use "
            "the geometric MAC")

    # -- 1. cluster virial radius from the step-start state (:767-770) ------
    # On the kernel and tree paths the SAME sweep yields the integrator's
    # step-start forces (softened, cfg.eps2) and the UNsoftened potential
    # the virial radius needs; with a cache, that sweep is the previous
    # step's closing evaluation.
    init_eval = None
    needs_jerk = integ in ("hermite4", "hermite4_block")
    sweep_eval = None
    if mesh is not None or pallas_here or tree_here:
        sweep_eval = _sweep_eval_fn(cfg, mesh, force_impl, c.mass,
                                    needs_jerk)
        a0, j0, pot = cache if cache is not None else sweep_eval(c.pos,
                                                                 c.vel)
        init_eval = (a0, j0) if needs_jerk else (a0, None)
        r_vir = _virial_radius_from_pot(c.mass, pot)
    else:
        r_vir = virial_radius(c.pos, c.mass)
    pos_old = c.pos

    # -- 2. N-body advance ---------------------------------------------
    force_fn, acc_fn = _build_force_fn(c.mass, cfg.eps2, cfg, mesh,
                                       force_impl)
    force_rows_fn = None
    rows_at_factory = None
    if integ == "hermite4_block" and mesh is not None:
        # the subcycle's K x N row sweeps split their columns over the mesh
        from ..parallel.sharded import make_sharded_force_rows

        force_rows_fn = make_sharded_force_rows(mesh, c.mass, cfg.eps2)
    elif integ == "hermite4_block":
        # the fast-group subcycle stays EXACT (K x N row sweeps) on every
        # backend, under the tree tier too: close encounters are where
        # monopole truncation must not leak in
        rows_kernel = pallas_here or (tree_here and cuda_nbody.use_kernel(
            c.n, dtype, device))
        force_rows_fn = _build_force_rows_fn(
            c.mass, cfg.eps2, "pallas" if rows_kernel else "default"
        )
        rows_at_factory = _build_rows_at_factory(c.mass, cfg.eps2,
                                                 rows_kernel)
    final_eval_fn = None
    if cache_ok:
        sweep_close = sweep_eval
        if tree_here and cfg.tree_mac == "relative":
            # relative MAC: the closing sweep opens nodes against the
            # OPENING acceleration magnitudes (forces move O(dt) per step,
            # ample for a truncation-error bound)
            sweep_close = _sweep_eval_fn(
                cfg, mesh, force_impl, c.mass, needs_jerk,
                tree_aref=torch.sqrt(torch.sum(a0 * a0, dim=-1)))

        def final_eval_fn(p, v):
            a, j, pot = sweep_close(p, v)
            return a, (j if needs_jerk else None), pot

    out = advance(
        c.pos, c.vel, c.mass, dt,
        integrator=integ, eta=cfg.eta_hermite,
        n_sub=cfg.leapfrog_n_sub or 16,
        eps2=eps2, max_substeps=cfg.substeps_max, force_fn=force_fn,
        acc_fn=acc_fn, k_fast=cfg.k_fast or 0,
        force_rows_fn=force_rows_fn, init_eval=init_eval,
        final_eval_fn=final_eval_fn, k_ultra=cfg.k_ultra,
        force_rows_at_factory=rows_at_factory,
    )
    if cache_ok:
        pos, vel, (a1, j1, pot1) = out
    else:
        pos, vel = out
    new_state = physics_after_advance(state, aux, cfg, pos_old, pos, vel,
                                      r_vir)
    new_cache = None
    if cache_ok:
        # the cached (a1, j1, pot1) was evaluated at the last substep's
        # PREDICTED state (P(EC)) while the correction uses the corrected
        # (pos, vel): exact linear-in-mass up to the P(EC) displacement
        new_cache = _corrected_cache(new_state.cluster, c, aux, cfg, mesh,
                                     pos, vel, a1, j1, pot1)
    return new_state, new_cache


def step(state: SimState, aux: SimAux, cfg: SimConfig,
         mesh=None, force_impl: str = "auto") -> SimState:
    """One physics step without the force cache."""
    new_state, _ = _step_impl(state, aux, cfg, mesh, force_impl, None,
                              want_cache=False)
    return new_state


def fresh_cache(state: SimState, cfg: SimConfig, integ: str, mesh=None,
                force_impl: str = "auto"):
    """Opening (acc, jerk, pot) evaluation to seed the force cache."""
    c = state.cluster
    needs_jerk = integ in ("hermite4", "hermite4_block")
    return _sweep_eval_fn(cfg, mesh, force_impl, c.mass, needs_jerk)(
        c.pos, c.vel
    )


def physics_after_advance(state: SimState, aux: SimAux, cfg: SimConfig,
                          pos_old, pos, vel, r_vir) -> SimState:
    """Steps 3-8 of the physics (everything after the N-body advance):
    stellar evolution, wind/SN/AGB deposition, decay, condensation."""
    c = state.cluster
    dtype, device = c.pos.dtype, c.pos.device
    t = state.time
    dt = torch.as_tensor(cfg.dt, dtype=dtype, device=device)
    t_new = (state.step_count + 1).to(dtype) * dt
    lm_mask = c.low_mass_mask(cfg.low_mass_min, cfg.low_mass_max)

    # -- 3. stellar evolution (the precomputed f64 phase table) -------------
    mass_new, mdot_new = stellar.evolve_from_table(
        aux.stellar_tbl, c.m0, t_new
    )
    # the table is f64: cast the result back to the state dtype
    mass_new = mass_new.to(dtype)
    mdot_new = mdot_new.to(dtype)
    # the interloper's mass is pinned (its track is the AGB table)
    mass_new = torch.where(c.is_interloper, c.mass, mass_new)
    mdot_new = torch.where(c.is_interloper, 0.0, mdot_new)

    # wind/SN source validity: INITIAL-mass based by default;
    # sn_parity_mode restores the reference's step-start current-mass gate
    hm_valid = aux.hm_slot_valid
    if cfg.sn_parity_mode:
        hm_valid = hm_valid & (
            c.mass[aux.hm_idx] >= cfg.high_mass_threshold
        )

    # -- 4. wind deposition (both isotopes, both mixing models) -------------
    slr = c.slr.clone()
    wind_global = dep.wind_deposition(
        pos, vel, c.r_disk, lm_mask, aux.hm_idx, hm_valid,
        mdot_new, c.wind_ratio, r_vir, dt, local=False,
    )
    wind_local = dep.wind_deposition(
        pos, vel, c.r_disk, lm_mask, aux.hm_idx, hm_valid,
        mdot_new, c.wind_ratio,
        torch.as_tensor(cfg.r_bub_local_wind, dtype=dtype, device=device),
        dt, local=True,
    )
    slr[:, :, CH_GLOBAL] += wind_global
    slr[:, :, CH_LOCAL] += wind_local

    # -- 5. supernovae ---------------------------------------------------
    injected, kicked = dep.sn_injection(
        pos, c.r_disk, lm_mask, aux.hm_idx, hm_valid,
        mdot_new, c.kicked, c.sn_yield,
    )
    slr[:, :, CH_SNE] += injected
    if cfg.natal_kicks:
        # one-shot remnant kick at the SN, applied at step end. Padded
        # slots repeat an index with valid=False and must accumulate
        # (add zero), hence index_add.
        newly = kicked[aux.hm_idx] & ~c.kicked[aux.hm_idx] & aux.hm_slot_valid
        vel = vel.index_add(0, aux.hm_idx.long(),
                            aux.kick_vel.to(vel.dtype) * newly[:, None])

    # -- 6. interloper ----------------------------------------------------
    agb_raw = c.agb_raw
    if cfg.interloper:
        # the AGB clock uses the PRE-advance time (al26_nbody.py:984)
        t_int = t - torch.as_tensor(cfg.interloper_offset_time, dtype=dtype,
                                    device=device)
        r_al, r_fe = _agb_rates(aux, t_int)
        active = t_int > 0.0
        agb_abs = dep.interloper_deposition(
            pos_old, pos, c.r_disk, lm_mask,
            interloper_index=-1,
            rate_26al=r_al * active, rate_60fe=r_fe * active,
            proximity_radius=0.1,  # pc, al26_nbody.py:1013
            bubble_radius=torch.as_tensor(cfg.interloper_bubble_radius,
                                          dtype=dtype, device=device),
            dt=dt,
        )
        slr[:, :, CH_AGB] += agb_abs
        agb_raw = agb_raw + agb_abs

    # -- 7. decay ---------------------------------------------------------
    slr = dep.apply_decay(
        slr, dt, cfg.half_life_26al, cfg.half_life_60fe,
        decay_agb=cfg.interloper,
    )

    # -- 8. condensation ----------------------------------------------
    slr_final, disk_alive = dep.condense(
        slr, c.slr_final, cfg.interloper, c.tau_disk, c.disk_alive,
        lm_mask, t_new,
    )

    cluster = c.replace(
        pos=pos, vel=vel, mass=mass_new, mdot=mdot_new, kicked=kicked,
        slr=slr, slr_final=slr_final, agb_raw=agb_raw,
        disk_alive=disk_alive,
    )
    return state.replace(
        cluster=cluster, time=t_new, step_count=state.step_count + 1
    )


def stride_active(cfg: SimConfig, n, dtype, device, mesh,
                  force_impl) -> bool:
    """Does the gravity stride engage here (gravity_stride > 1 on a
    cache-capable hermite4_block path)?"""
    return (
        getattr(cfg, "gravity_stride", 1) > 1
        and _resolve_integ(cfg, n) == "hermite4_block"
        and _cacheable(cfg, n, dtype, device, mesh, force_impl)
    )


def run_steps(state: SimState, aux: SimAux, cfg: SimConfig,
              n_steps: int, mesh=None, force_impl: str = "auto") -> SimState:
    """`n_steps` physics steps (the reference saves every
    `steps_per_plot`=10 steps, al26_nbody.py:1754-1760). On the kernel
    path the closing force evaluation of each step is carried into the
    next (mass-delta-corrected): ONE full O(N^2) sweep per step, or one
    per gravity stride where stride_active."""
    c = state.cluster
    if _cacheable(cfg, c.n, c.pos.dtype, c.pos.device, mesh, force_impl):
        cache = fresh_cache(state, cfg, _resolve_integ(cfg, c.n), mesh,
                            force_impl)
        if stride_active(cfg, c.n, c.pos.dtype, c.pos.device, mesh,
                         force_impl):
            state, _ = run_steps_cached_strided(state, cache, aux, cfg,
                                                n_steps, mesh, force_impl)
            return state
        state, _ = run_steps_cached(state, cache, aux, cfg, n_steps,
                                    mesh, force_impl)
        return state
    for _ in range(n_steps):
        state = step(state, aux, cfg, mesh, force_impl)
    return state


def run_steps_cached(state: SimState, cache, aux: SimAux, cfg: SimConfig,
                     n_steps: int, mesh=None, force_impl: str = "auto"):
    """run_steps carrying the force cache ACROSS calls: a caller threads
    (state, cache) between checkpoint chunks so even the first step of a
    chunk reuses the previous chunk's closing evaluation."""
    for _ in range(n_steps):
        state, cache = _step_impl(state, aux, cfg, mesh, force_impl, cache)
    return state, cache


def _stride_impl(state: SimState, aux: SimAux, cfg: SimConfig, cache,
                 m: int, mesh=None, force_impl: str = "auto"):
    """m physics steps sharing ONE hermite4_block force advance over m*dt
    (the gravity stride, cfg.gravity_stride).

    The advance spans m*dt; the m-1 interior physics steps read the
    cluster at k*dt from the integrator's interior samples (slow stars:
    step-start Hermite predictor; fast stars: captured in the subcycle at
    the crossing substep — ops.integrators.hermite4_block_advance). All
    deposition/SN/decay/condensation physics still runs every dt; only the
    full O(N^2) (or tree) force evaluation is strided. The virial radius
    (global wind bubble) is held at its stride-start value for ALL m
    physics steps of the stride, the closing one included. Stellar mass
    loss feeds back into gravity at stride boundaries through the exact
    mass-delta cache correction: an m*dt lag instead of the unstrided
    scheme's dt lag.

    Under a `mesh` the closing evaluation is the mesh sweep and the
    subcycle's K x N rows split their columns over the mesh
    (parallel.sharded.make_sharded_force_rows), with no predicted-columns
    factory."""
    c = state.cluster
    dtype, device = c.pos.dtype, c.pos.device
    dt = torch.as_tensor(cfg.dt, dtype=dtype, device=device)
    eps2 = torch.as_tensor(cfg.eps2, dtype=dtype, device=device)

    a0, j0, pot = cache
    r_vir = _virial_radius_from_pot(c.mass, pot)

    tree_aref = None
    if force_impl == "tree" and cfg.tree_mac == "relative":
        # the closing sweep opens nodes against the STRIDE-START
        # acceleration magnitudes
        tree_aref = torch.sqrt(torch.sum(a0 * a0, dim=-1))
    final_eval_fn = _sweep_eval_fn(cfg, mesh, force_impl, c.mass,
                                   needs_jerk=True, tree_aref=tree_aref)
    if mesh is not None:
        from ..parallel.sharded import make_sharded_force_rows

        force_rows_fn = make_sharded_force_rows(mesh, c.mass, cfg.eps2)
        rows_at_factory = None
    else:
        # the subcycle's row sweeps: the kernels wherever they run (the
        # tree tier included), the plain row block elsewhere (CPU tensors,
        # f64)
        rows_kernel = cuda_nbody.use_kernel(c.n, dtype, device)
        force_rows_fn = _build_force_rows_fn(
            c.mass, cfg.eps2, "pallas" if rows_kernel else "default")
        rows_at_factory = _build_rows_at_factory(c.mass, cfg.eps2,
                                                 rows_kernel)
    pos_c, vel_c, (a1, j1, pot1), (pos_s, vel_s) = advance(
        c.pos, c.vel, c.mass, m * dt,
        integrator="hermite4_block", eta=cfg.eta_hermite,
        # the advance spans m*dt: scale the substep budget so the minimum
        # substep floor (h_min = span/max_substeps) stays dt/substeps_max
        eps2=eps2, max_substeps=cfg.substeps_max * m,
        force_fn=None, k_fast=cfg.k_fast or 0,
        force_rows_fn=force_rows_fn, init_eval=(a0, j0),
        final_eval_fn=final_eval_fn, interior_samples=m - 1,
        k_ultra=cfg.k_ultra, force_rows_at_factory=rows_at_factory,
    )

    s = state
    pos_prev = c.pos
    for k in range(m - 1):
        s = physics_after_advance(s, aux, cfg, pos_prev, pos_s[k], vel_s[k],
                                  r_vir)
        pos_prev = pos_s[k]
    s = physics_after_advance(s, aux, cfg, pos_prev, pos_c, vel_c, r_vir)
    return s, _corrected_cache(s.cluster, c, aux, cfg, mesh, pos_c, vel_c,
                               a1, j1, pot1)


def run_strides_cached(state: SimState, cache, aux: SimAux, cfg: SimConfig,
                       n_strides: int, m: int, mesh=None,
                       force_impl: str = "auto"):
    """n_strides gravity strides of m physics steps each."""
    for _ in range(n_strides):
        state, cache = _stride_impl(state, aux, cfg, cache, m, mesh,
                                    force_impl)
    return state, cache


def run_steps_cached_strided(state: SimState, cache, aux: SimAux,
                             cfg: SimConfig, n_steps: int, mesh=None,
                             force_impl: str = "auto"):
    """As many full strides as fit, then the remainder as plain cached
    steps (driver checkpoint chunks are not always stride-aligned)."""
    m = cfg.gravity_stride
    n_str, rem = divmod(n_steps, m)
    if n_str:
        state, cache = run_strides_cached(state, cache, aux, cfg, n_str, m,
                                          mesh, force_impl)
    if rem:
        state, cache = run_steps_cached(state, cache, aux, cfg, rem,
                                        mesh, force_impl)
    return state, cache


def _traj_row(s_old: SimState, s_new: SimState, cfg: SimConfig):
    """One interloper-trajectory row (al26_nbody.py:1030-1037):
    (t_sim, t_interloper, x, y, z, barycentre distance), on the device."""
    c = s_new.cluster
    pos_int = c.pos[-1]
    com = center_of_mass(c.pos, c.mass)
    bary_dist = torch.sqrt(torch.sum((pos_int - com) ** 2))
    t_int = s_old.time - torch.as_tensor(cfg.interloper_offset_time,
                                         dtype=c.pos.dtype,
                                         device=c.pos.device)
    return torch.cat([s_old.time[None], t_int[None], pos_int,
                      bary_dist[None]])


def run_steps_traj(state: SimState, aux: SimAux, cfg: SimConfig,
                   n_steps: int, mesh=None, force_impl: str = "auto"):
    """Like run_steps without the force cache, additionally collecting the
    interloper trajectory per step: (t_sim, t_interloper, x, y, z,
    barycentre distance) — the data the reference appends to
    interloper_trajectory.dat each step (al26_nbody.py:1030-1037).
    Returns (state, rows [n_steps, 6]) with the rows on the device."""
    rows = []
    for _ in range(n_steps):
        s_new = step(state, aux, cfg, mesh, force_impl)
        rows.append(_traj_row(state, s_new, cfg))
        state = s_new
    return state, _stack_rows(rows, state)


def run_steps_traj_cached(state: SimState, cache, aux: SimAux,
                          cfg: SimConfig, n_steps: int, mesh=None,
                          force_impl: str = "auto"):
    """run_steps_traj carrying the cross-step force cache, as
    run_steps_cached does. Returns (state, cache, rows)."""
    rows = []
    for _ in range(n_steps):
        s_new, cache = _step_impl(state, aux, cfg, mesh, force_impl, cache)
        rows.append(_traj_row(state, s_new, cfg))
        state = s_new
    return state, cache, _stack_rows(rows, state)


def _stack_rows(rows, state: SimState):
    if rows:
        return torch.stack(rows)
    c = state.cluster
    return torch.zeros((0, 6), dtype=c.pos.dtype, device=c.pos.device)
