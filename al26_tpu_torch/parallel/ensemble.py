"""Ensembles of independent cluster realizations on one device (torch port
of the single-device part of al26_tpu.parallel.ensemble).

The science comes from ensembles of realizations over (N, Rc); the
reference runs each as its own job. Here an ensemble is one batched
(SimState, SimAux) whose tensors carry a leading realization axis [B, ...]
on one device:

  * `init_ensemble` / `stack_ensemble` build it (seeds cfg.seed + k, the
    massive-star slot arrays padded to a common width);
  * `ensemble_step` steps every realization on its own (the JAX package's
    vmapped step: each realization keeps its own substeps);
  * `ensemble_step_flat` flattens the B x N stars into one system whose
    N-body advance sweeps block-diagonal groups of N stars (kernel 1's
    group windows, ops.cuda_nbody with group_size = N), so a realization
    feels only its own stars and the pair work is B N^2, not (B N)^2. The
    substep is shared across realizations (the slowest sets it, as a
    vmapped while_loop would). The steps after the advance
    (`ensemble_physics_after_advance`) run once per realization: the
    physics has no batch dimension yet (ROADMAP queue 1);
  * the force-cache runners carry the closing block-diagonal sweep of a
    step into the next.

N counts an interloper when the config has one (the group size is the
realization's star count, state.cluster.mass.shape[1]).

The device meshes (torch.distributed, one rank per device; see
parallel.sharded's docstring):

  * the 1-D ensemble mesh ("ens", `make_ensemble_mesh`): `shard_ensemble`
    hands each rank its B/D realizations, which it runs as its own
    flattened ensemble (kernel 1b), with no collective inside a step;
  * the 2-D (ens x rows) mesh (`make_ensemble2d_mesh`): each rank holds
    the whole state of its B/E realizations (`shard_ensemble_2d`), and
    each realization's sweep splits its rows over the R ranks of the rows
    axis (`ensemble2d_acc_pot`: kernel 1b on this rank's row ids of every
    local realization, then an all-gather over the rows group);
    `ensemble_step_2d` is leapfrog only, as in the JAX package.

Deliberate difference from the JAX package: its shard_ensemble returns
the whole batch laid out over the mesh; the port's returns this rank's
realizations (`gather_ensemble` collects the whole batch on every rank).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SimConfig
from ..ops import cuda_nbody
from ..ops.integrators import advance, leapfrog_advance
from ..ops.nbody import (
    _row_block_acc_jerk_pot, acc_jerk_pot_dense, acc_pot_dense,
    mass_delta_correction,
)
from ..sim.init import init_cluster, resolve_integrator
from ..sim.step import physics_after_advance, step
from ..state import map_tensors
from ..units import G_INTERNAL
from ..utils.timing import span, spanned
from .sharded import (
    all_gather_cat, axis_rank, device_mesh, kernel_here, mesh_device,
)

ENS_AXIS = "ens"
ROWS_AXIS = "rows"


# ---------------------------------------------------------------------------
# the batched pytree: Cluster / SimState / SimAux dataclasses of tensors and
# the stellar PhaseTable (a NamedTuple)
# ---------------------------------------------------------------------------

def _take(tree, k: int):
    """Realization k of a batched state or aux."""
    return map_tensors(lambda t: t[k], tree)


def _stack(trees):
    return map_tensors(lambda *ts: torch.stack(ts), *trees)


def init_ensemble(cfg: SimConfig, n_realizations: int,
                  data_dir: Optional[str] = None, *, device):
    """`n_realizations` independent clusters (seeds cfg.seed, cfg.seed + 1,
    ...), each initialised on the CPU and then stacked and moved to
    `device` in one step; returns (batch_state, batch_aux, cfgs).

    integrator="auto", and an explicit leapfrog with leapfrog_n_sub unset,
    resolve HERE, at the ensemble boundary, to the BHTree-parity leapfrog
    with ONE substep count from the realizations' mean total mass, recorded
    in every realization's config (per-realization resolution would give
    hermite4 at n <= 8192, which collapses on flattened evolved ensembles,
    and substep counts that straddle a power of 2)."""
    states, auxes, cfgs, m_totals = [], [], [], []
    for k in range(n_realizations):
        s, a, c = init_cluster(cfg.replace(seed=cfg.seed + k), data_dir,
                               device="cpu")
        states.append(s)
        auxes.append(a)
        cfgs.append(c)
        m_totals.append(float(s.cluster.mass.numpy().sum()))
    if cfg.integrator == "auto" or (cfg.integrator == "leapfrog"
                                    and cfg.leapfrog_n_sub is None):
        shared = resolve_integrator(cfg.replace(integrator="leapfrog"),
                                    float(np.mean(m_totals)))
        cfgs = [c.replace(integrator="leapfrog",
                          leapfrog_n_sub=shared.leapfrog_n_sub)
                for c in cfgs]
    batch_state, batch_aux = stack_ensemble(states, auxes, device=device)
    return batch_state, batch_aux, cfgs


def stack_ensemble(states, auxes, *, device):
    """Stack per-realization (SimState, SimAux) lists into one batched pair
    on `device`: the massive-star slot arrays (hm_idx, hm_slot_valid,
    kick_vel) and the mass-source slots (msrc_idx, msrc_valid) are padded to
    a common width with index 0 and validity False, so padded slots never
    contribute; every other tensor, the stellar PhaseTable's included, is
    stacked as it is."""
    width = max(a.hm_idx.shape[0] for a in auxes)
    width_m = max(a.msrc_idx.shape[0] for a in auxes)

    def pad(t, w):
        t = t.cpu()
        return torch.cat([t, t.new_zeros((w - t.shape[0],) + t.shape[1:])])

    auxes = [a.replace(hm_idx=pad(a.hm_idx, width),
                       hm_slot_valid=pad(a.hm_slot_valid, width),
                       kick_vel=pad(a.kick_vel, width),
                       msrc_idx=pad(a.msrc_idx, width_m),
                       msrc_valid=pad(a.msrc_valid, width_m))
             for a in auxes]
    move = lambda *ts: torch.stack([t.cpu() for t in ts]).to(device)
    return map_tensors(move, *states), map_tensors(move, *auxes)


def ensemble_step(batch_state, batch_aux, cfg: SimConfig):
    """One physics step for every realization, each through sim.step on
    its own (the JAX package's vmapped step)."""
    b = batch_state.cluster.mass.shape[0]
    return _stack([step(_take(batch_state, k), _take(batch_aux, k), cfg)
                   for k in range(b)])


@spanned("ensemble.physics")
def ensemble_physics_after_advance(batch_state, batch_aux, cfg: SimConfig,
                                   pos_old, pos, vel, r_vir):
    """Steps 3-8 of the physics (sim.step.physics_after_advance) for every
    realization, one realization at a time; pos_old / pos / vel [B, N, 3],
    r_vir [B]. The span "ensemble.physics"."""
    b = batch_state.cluster.mass.shape[0]
    return _stack([
        physics_after_advance(_take(batch_state, k), _take(batch_aux, k),
                              cfg, pos_old[k], pos[k], vel[k], r_vir[k])
        for k in range(b)])


def _resolve_ens_integ(cfg: SimConfig) -> str:
    """Resolve "auto" for callers that bypass init_ensemble: the fixed-substep
    leapfrog (adaptive Hermite, shared or block, collapses on evolved
    ensembles: one hardened binary anywhere sets everyone's substep)."""
    return "leapfrog" if cfg.integrator == "auto" else cfg.integrator


def _per_realization(fn, b: int, n: int, *arrays):
    """fn on each realization's [N, ...] slices of flattened [B N, ...]
    arrays; the outputs concatenated back to [B N, ...]."""
    outs = [fn(*(x[k * n:(k + 1) * n] for x in arrays)) for k in range(b)]
    return tuple(torch.cat(x, 0) for x in zip(*outs))


def _group_rows_dense(mass_f, eps2, n: int):
    """force_rows_fn of the plain path: the dense K x (B N) row force with
    the same-realization mask (fast rows must not feel other
    realizations)."""
    def force_rows_fn(pr, vr, ids, p_all, v_all):
        dx = p_all[None, :, :] - pr[:, None, :]
        dv = v_all[None, :, :] - vr[:, None, :]
        r2 = torch.sum(dx * dx, dim=-1) + eps2
        inv_r = torch.rsqrt(r2)
        cols = torch.arange(p_all.shape[0], device=pr.device)
        ids = ids.long()
        bad = (cols[None, :] == ids[:, None]) | (
            torch.div(cols, n, rounding_mode="floor")[None, :]
            != torch.div(ids, n, rounding_mode="floor")[:, None])
        inv_r = torch.where(bad, 0.0, inv_r)
        inv_r3 = inv_r * inv_r * inv_r
        r2s = torch.where(bad, 1.0, r2)
        xv = torch.sum(dx * dv, dim=-1)
        mj3 = mass_f[None, :] * inv_r3
        a = G_INTERNAL * torch.einsum("ij,ijk->ik", mj3, dx)
        j = G_INTERNAL * (torch.einsum("ij,ijk->ik", mj3, dv)
                          - 3.0 * torch.einsum("ij,ijk->ik",
                                               mj3 * xv / r2s, dx))
        return a, j

    return force_rows_fn


def ensemble_step_flat(batch_state, batch_aux, cfg: SimConfig,
                       cache=None, want_cache: bool = False):
    """One physics step for the whole ensemble with a FLATTENED,
    block-diagonal N-body advance.

    On the kernel path (cuda_nbody.use_kernel(B N, dtype, device)) every
    sweep is kernel 1 with group_size = N: the opening sweep (softened
    forces plus the raw potential of each realization's virial radius, or
    the cache), the leapfrog substeps (acceleration only), the hermite4
    substeps, and hermite4_block's scattered fast rows and closing sweep.
    Elsewhere (the CPU, f64) each realization's forces come from the dense
    sweep. `cache=(acc, jerk, pot)` over the flattened stars replaces the
    opening sweep; with want_cache (and the cache gates of
    ensemble_cacheable) the step returns (state, new_cache)."""
    c = batch_state.cluster
    b, n = c.mass.shape
    dtype, device = c.pos.dtype, c.pos.device
    flat = lambda x: x.reshape((b * n,) + x.shape[2:])
    pos_f, vel_f, mass_f = flat(c.pos), flat(c.vel), flat(c.mass)
    dt = torch.as_tensor(cfg.dt, dtype=dtype, device=device)
    eps2 = torch.as_tensor(cfg.eps2, dtype=dtype, device=device)

    integ = _resolve_ens_integ(cfg)
    needs_jerk = integ in ("hermite4", "hermite4_block")
    kernel_on = cuda_nbody.use_kernel(b * n, dtype, device)
    cache_ok = want_cache and ensemble_cacheable(batch_state, cfg)

    init_eval = None
    final_eval_fn = None
    if kernel_on:
        kw = dict(eps2=cfg.eps2, group_size=n)

        def force_fn(p, v):
            a, j, _ = cuda_nbody.kernel_acc_jerk_pot(p, v, mass_f,
                                                     with_pot=False, **kw)
            return a, j

        def acc_fn(p):
            a, _, _ = cuda_nbody.kernel_acc_jerk_pot(
                p, torch.zeros_like(p), mass_f, with_jerk=False,
                with_pot=False, **kw)
            return a

        def force_rows_fn(pr, vr, ids, p_all, v_all):
            a, j, _ = cuda_nbody.kernel_acc_jerk_pot_rows(
                pr, vr, ids, p_all, v_all, mass_f, with_pot=False, **kw)
            return a, j

        # ONE block-diagonal sweep: the step-start forces (softened) and
        # the raw potential of each realization's virial radius, or the
        # previous step's closing evaluation
        if cache is not None:
            a0, j0, pot_f = cache
        else:
            a0, j0, pot_f = cuda_nbody.kernel_acc_jerk_pot(
                pos_f, vel_f, mass_f, with_jerk=needs_jerk, pot_eps2=1e-30,
                **kw)
        init_eval = (a0, j0) if needs_jerk else (a0, None)
        if cache_ok:
            closing_jerk = integ == "hermite4_block"

            def final_eval_fn(p, v):
                a, j, pot = cuda_nbody.kernel_acc_jerk_pot(
                    p, v, mass_f, with_jerk=closing_jerk, pot_eps2=1e-30,
                    **kw)
                return a, (j if closing_jerk else None), pot
    else:
        def force_fn(p, v):
            a, j, _ = _per_realization(
                lambda pp, vv, mm: acc_jerk_pot_dense(pp, vv, mm, eps2),
                b, n, p, v, mass_f)
            return a, j

        def acc_fn(p):
            return _per_realization(
                lambda pp, mm: acc_pot_dense(pp, mm, eps2), b, n, p,
                mass_f)[0]

        force_rows_fn = _group_rows_dense(mass_f, eps2, n)
        pot_f = _per_realization(
            lambda pp, mm: acc_pot_dense(pp, mm, 0.0), b, n, pos_f,
            mass_f)[1]

    # per-realization virial radius from the group-masked raw potential
    u = 0.5 * torch.sum((mass_f * pot_f).reshape(b, n), dim=1)     # [B]
    mtot = torch.sum(c.mass, dim=1)                                 # [B]
    r_vir = -G_INTERNAL * mtot * mtot / (2.0 * u)

    with span("step.advance"):
        out = advance(
            pos_f, vel_f, mass_f, dt,
            integrator=integ, eta=cfg.eta_hermite,
            n_sub=cfg.leapfrog_n_sub or 16,
            eps2=eps2, max_substeps=cfg.substeps_max,
            force_fn=force_fn, acc_fn=acc_fn,
            # an explicit cfg.k_fast was resolved for ONE realization: the
            # flattened system needs that capacity per realization, or
            # tight binaries losing the global top-k race stay in the slow
            # group
            k_fast=((cfg.k_fast * b) if cfg.k_fast
                    else max(256, (b * n) // 64)),
            force_rows_fn=(force_rows_fn if integ == "hermite4_block"
                           else None),
            init_eval=init_eval, final_eval_fn=final_eval_fn,
        )
    if cache_ok:
        pos_new, vel_new, (a1, j1, pot1) = out
    else:
        pos_new, vel_new = out
    unflat = lambda x: x.reshape((b, n) + x.shape[1:])
    out_state = ensemble_physics_after_advance(
        batch_state, batch_aux, cfg, c.pos, unflat(pos_new), unflat(vel_new),
        r_vir)
    if not cache_ok:
        return out_state
    # mass-delta correction over the flattened mass-evolving sources (the
    # linearity argument of sim.step, with the same-realization mask)
    offs = torch.arange(b, dtype=batch_aux.msrc_idx.dtype, device=device)
    src = (batch_aux.msrc_idx + (offs * n)[:, None]).reshape(-1)
    valid = batch_aux.msrc_valid.reshape(-1)
    mass_new_f = flat(out_state.cluster.mass)
    dm = (mass_new_f[src] - mass_f[src]) * valid
    a1, j1, pot1 = mass_delta_correction(a1, j1, pot1, pos_new, vel_new,
                                         src, dm, eps2, group_size=n)
    return out_state, (a1, torch.zeros_like(a1) if j1 is None else j1, pot1)


def ensemble_cacheable(batch_state, cfg: SimConfig) -> bool:
    """Can the flat ensemble carry the block-diagonal force cache between
    steps (the gates of sim.step._cacheable): the kernel path, force_cache
    on, leapfrog or hermite4_block, and no natal kicks under
    hermite4_block (they stale the cached jerk)."""
    c = batch_state.cluster
    b, n = c.mass.shape
    integ = _resolve_ens_integ(cfg)
    return bool(cuda_nbody.use_kernel(b * n, c.pos.dtype, c.pos.device)
                and getattr(cfg, "force_cache", True)
                and integ in ("leapfrog", "hermite4_block")
                and not (cfg.natal_kicks and integ == "hermite4_block"))


def ensemble_fresh_cache(batch_state, cfg: SimConfig):
    """Opening block-diagonal (acc, jerk, pot) sweep that seeds the flat
    ensemble's force cache."""
    c = batch_state.cluster
    b, n = c.mass.shape
    flat = lambda x: x.reshape((b * n,) + x.shape[2:])
    return cuda_nbody.kernel_acc_jerk_pot(
        flat(c.pos), flat(c.vel), flat(c.mass), cfg.eps2,
        with_jerk=(_resolve_ens_integ(cfg) == "hermite4_block"),
        group_size=n, pot_eps2=1e-30)


def ensemble_run_steps_cached(batch_state, cache, batch_aux,
                              cfg: SimConfig, n_steps: int):
    """n_steps flat steps carrying the force cache ACROSS calls: a caller
    threads (state, cache) between checkpoint chunks, so the first step of
    a chunk reuses the previous chunk's closing sweep. Returns (state,
    cache)."""
    for _ in range(n_steps):
        batch_state, cache = ensemble_step_flat(batch_state, batch_aux, cfg,
                                                cache, want_cache=True)
    return batch_state, cache


def ensemble_run_steps(batch_state, batch_aux, cfg: SimConfig, n_steps: int,
                       flat: bool | None = None):
    """n_steps steps of the ensemble. `flat=None` takes the flattened
    block-diagonal advance where the kernels run; the flat leapfrog and
    hermite4_block paths carry the force cache between steps (one
    block-diagonal sweep per step)."""
    c = batch_state.cluster
    b, n = c.mass.shape
    if flat is None:
        flat = cuda_nbody.use_kernel(b * n, c.pos.dtype, c.pos.device)
    if flat and ensemble_cacheable(batch_state, cfg):
        cache = ensemble_fresh_cache(batch_state, cfg)
        batch_state, _ = ensemble_run_steps_cached(batch_state, cache,
                                                   batch_aux, cfg, n_steps)
        return batch_state
    for _ in range(n_steps):
        if flat:
            batch_state = ensemble_step_flat(batch_state, batch_aux, cfg)
        else:
            batch_state = ensemble_step(batch_state, batch_aux, cfg)
    return batch_state


# ---------------------------------------------------------------------------
# the device meshes: the 1-D ensemble mesh and the 2-D (ens x rows) mesh
# ---------------------------------------------------------------------------

def make_ensemble_mesh(n_devices: Optional[int] = None, device="cuda"):
    """1-D ensemble mesh ("ens") of `n_devices` ranks (default: the whole
    world, or a world of one in a plain process)."""
    import torch.distributed as dist

    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return device_mesh((n_devices,), (ENS_AXIS,), device)


def make_ensemble2d_mesh(n_ens: int, n_rows: Optional[int] = None,
                         device="cuda"):
    """2-D (ens x rows) mesh: realizations across `n_ens` ranks, EACH
    realization's sweep split by rows across `n_rows` ranks — for
    ensembles with fewer members than devices. n_rows defaults to the
    world size // n_ens."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_ens < 1:
        raise ValueError(f"mesh needs n_ens >= 1 (got {n_ens})")
    if n_rows is None:
        n_rows = world // n_ens
    if n_rows < 1:
        raise ValueError(
            f"mesh ({n_ens} ens x {n_rows} rows) is degenerate: need at "
            f"least 1 device per axis ({world} ranks; with n_ens > the "
            "rank count use the 1-D ensemble mesh instead)")
    return device_mesh((n_ens, n_rows), (ENS_AXIS, ROWS_AXIS), device)


def _ens_share(b: int, mesh):
    """This rank's realizations along the ens axis: slice(e B/E,
    (e+1) B/E)."""
    e, n_ens = axis_rank(mesh, ENS_AXIS)
    if b % n_ens:
        raise ValueError(f"ensemble size {b} must divide across the "
                         f"{n_ens} ranks of the ens axis")
    per = b // n_ens
    return slice(e * per, (e + 1) * per)


def shard_ensemble(batch_state, batch_aux, mesh):
    """This rank's B/D realizations of a stacked ensemble, on its device:
    each rank then runs its share as its own flattened ensemble."""
    sl = _ens_share(batch_state.cluster.mass.shape[0], mesh)
    device = mesh_device(mesh)
    place = lambda t: t[sl].to(device)
    return map_tensors(place, batch_state), map_tensors(place, batch_aux)


def shard_ensemble_2d(batch_state, batch_aux, mesh):
    """This rank's B/E realizations on a 2-D (ens x rows) mesh, whole
    (every rank of a rows group holds the same realizations; only the
    sweep splits over the rows axis), on its device."""
    return shard_ensemble(batch_state, batch_aux, mesh)


def gather_ensemble(batch_state, mesh):
    """The whole batch on every rank: each rank's realizations gathered
    over the ens axis, in realization order."""
    _, n_ens = axis_rank(mesh, ENS_AXIS)
    group = mesh.get_group(ENS_AXIS)
    return map_tensors(lambda t: all_gather_cat(t, group, n_ens), batch_state)


def _ensemble2d_local(rank: int, world: int, pos, vel, mass, eps2,
                      pot_eps2=None, with_pot: bool = True,
                      use_kernel: bool | None = None):
    """Local body of the 2-D mesh's sweep: for each of the b realizations
    (pos/vel [b, N, 3], mass [b, N]) the rows [r N/R, (r+1) N/R) of rank
    `rank` of the rows axis against that realization's N stars. On the
    kernel path one kernel-1b launch: rows b N + r N/R + arange(N/R) of
    the flattened ensemble, group_size = N (the windows keep realizations
    apart); the plain row block per realization elsewhere. Returns
    (acc [b, N/R, 3], pot [b, N/R])."""
    b, n = mass.shape
    if n % world:
        raise ValueError(f"star count {n} must divide across the {world} "
                         "ranks of the rows axis")
    n_l = n // world
    sl = slice(rank * n_l, (rank + 1) * n_l)
    rows = torch.arange(rank * n_l, (rank + 1) * n_l, dtype=torch.int32,
                        device=pos.device)
    if kernel_here(pos.reshape(b * n, 3), use_kernel):
        ids = (rows[None, :] + (torch.arange(b, device=pos.device,
                                             dtype=torch.int32)
                                * n)[:, None]).reshape(-1)
        a, _, p = cuda_nbody.kernel_acc_jerk_pot_rows(
            pos[:, sl].reshape(-1, 3), vel[:, sl].reshape(-1, 3), ids,
            pos.reshape(-1, 3), vel.reshape(-1, 3), mass.reshape(-1),
            float(eps2), with_jerk=False, group_size=n, pot_eps2=pot_eps2,
            with_pot=with_pot)
        return a.reshape(b, n_l, 3), p.reshape(b, n_l)
    outs = [_row_block_acc_jerk_pot(
        pos[k, sl], vel[k, sl], pos[k], vel[k], mass[k], eps2, G_INTERNAL,
        rows, pot_eps2=pot_eps2, with_jerk=False, with_pot=with_pot)
        for k in range(b)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[2] for o in outs]))


def ensemble2d_acc_pot(pos, vel, mass, mesh, eps2, pot_eps2=None,
                       with_pot: bool = True):
    """Per-realization (acc [b, N, 3], pot [b, N]) of this rank's b
    realizations on a 2-D (ens x rows) mesh: this rank's row slice of
    each (_ensemble2d_local), all-gathered over the rows group only —
    realizations never mix."""
    rank, world = axis_rank(mesh, ROWS_AXIS)
    group = mesh.get_group(ROWS_AXIS)
    a, p = _ensemble2d_local(rank, world, pos, vel, mass, eps2, pot_eps2,
                             with_pot)
    return (all_gather_cat(a, group, world, dim=1),
            all_gather_cat(p, group, world, dim=1))


def ensemble_step_2d(batch_state, batch_aux, cfg: SimConfig, mesh,
                     cache=None, want_cache: bool = False):
    """One physics step of this rank's realizations on a 2-D (ens x rows)
    mesh: the leapfrog's force substeps through the row-split sweep
    (ensemble2d_acc_pot), the steps after the advance per realization.
    Leapfrog only, as the ensemble boundary resolves "auto"
    (init_ensemble).

    `cache=(acc [b,N,3], pot [b,N])` replaces the opening sweep with the
    previous step's closing evaluation (exact for leapfrog: the closing
    evaluation is at the final positions, and the mass-delta correction
    covers this step's mass loss). With want_cache the step returns
    (state, new_cache)."""
    integ = _resolve_ens_integ(cfg)
    if integ != "leapfrog":
        raise ValueError(
            f"ensemble_step_2d supports the ensemble-default leapfrog only "
            f"(got integrator={integ!r}); run with integrator='auto' or "
            "'leapfrog'")
    c = batch_state.cluster
    b, n = c.mass.shape
    dtype, device = c.pos.dtype, c.pos.device
    dt = torch.as_tensor(cfg.dt, dtype=dtype, device=device)
    eps2 = torch.as_tensor(cfg.eps2, dtype=dtype, device=device)

    # ONE sweep: the step-start forces and the raw potential of each
    # realization's virial radius, or the previous step's closing one
    if cache is not None:
        a0, pot = cache
    else:
        a0, pot = ensemble2d_acc_pot(c.pos, c.vel, c.mass, mesh, cfg.eps2,
                                     pot_eps2=1e-30)
    u = 0.5 * torch.sum(c.mass * pot, dim=1)                        # [B]
    mtot = torch.sum(c.mass, dim=1)                                 # [B]
    r_vir = -G_INTERNAL * mtot * mtot / (2.0 * u)

    def acc_fn(p):
        a, _ = ensemble2d_acc_pot(p, torch.zeros_like(p), c.mass, mesh,
                                  cfg.eps2, with_pot=False)
        return a

    final_eval_fn = None
    if want_cache:
        def final_eval_fn(p):
            return ensemble2d_acc_pot(p, torch.zeros_like(p), c.mass, mesh,
                                      cfg.eps2, pot_eps2=1e-30)

    out = leapfrog_advance(c.pos, c.vel, c.mass, dt,
                           n_sub=cfg.leapfrog_n_sub or 16, eps2=eps2,
                           acc_fn=acc_fn, init_acc=a0,
                           final_eval_fn=final_eval_fn)
    if want_cache:
        pos_new, vel_new, (a1, _, pot1) = out
    else:
        pos_new, vel_new = out
    out_state = ensemble_physics_after_advance(
        batch_state, batch_aux, cfg, c.pos, pos_new, vel_new, r_vir)
    if not want_cache:
        return out_state
    # mass-delta correction over the flattened mass-evolving sources (the
    # linearity argument of sim.step, with the same-realization mask)
    offs = torch.arange(b, dtype=batch_aux.msrc_idx.dtype, device=device)
    src = (batch_aux.msrc_idx + (offs * n)[:, None]).reshape(-1)
    valid = batch_aux.msrc_valid.reshape(-1)
    mass_f = c.mass.reshape(b * n)
    dm = (out_state.cluster.mass.reshape(b * n)[src] - mass_f[src]) * valid
    a1f, _, pot1f = mass_delta_correction(
        a1.reshape(b * n, 3), None, pot1.reshape(b * n),
        pos_new.reshape(b * n, 3), vel_new.reshape(b * n, 3), src, dm, eps2,
        group_size=n)
    return out_state, (a1f.reshape(b, n, 3), pot1f.reshape(b, n))


def ensemble2d_fresh_cache(batch_state, cfg: SimConfig, mesh):
    """Opening (acc, pot) sweep that seeds the 2-D path's force cache."""
    c = batch_state.cluster
    return ensemble2d_acc_pot(c.pos, c.vel, c.mass, mesh, cfg.eps2,
                              pot_eps2=1e-30)


def ensemble_run_steps_2d_cached(batch_state, cache, batch_aux,
                                 cfg: SimConfig, n_steps: int, mesh):
    """n_steps 2-D steps carrying the force cache ACROSS calls (the driver
    threads (state, cache) between checkpoint chunks). Returns (state,
    cache)."""
    for _ in range(n_steps):
        batch_state, cache = ensemble_step_2d(batch_state, batch_aux, cfg,
                                              mesh, cache, want_cache=True)
    return batch_state, cache


def ensemble_run_steps_2d(batch_state, batch_aux, cfg: SimConfig,
                          n_steps: int, mesh):
    """n_steps 2-D steps without the force cache."""
    for _ in range(n_steps):
        batch_state = ensemble_step_2d(batch_state, batch_aux, cfg, mesh)
    return batch_state
