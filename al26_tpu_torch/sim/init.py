"""Cluster initialisation: the `init_cluster` equivalent
(al26_nbody.py:1492-1610) plus interloper spawning (al26_nbody.py:1448-1490);
torch port of al26_tpu.sim.init.

Everything here runs once: numpy draws from
`np.random.default_rng(cfg.seed)` (so both packages start from the same
bits) and the stellar-table maths in f64 torch on the CPU. The two O(N^2)
pieces, the fractal model's virial scaling and the tree tier's
near-field budget, run on the caller's explicit `device`. The results
are moved to that device as a `SimState` plus a `SimAux` bundle of
fixed-shape auxiliary tensors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..config import SimConfig
from ..models import agb as agb_mod
from ..models import discs, imf
from ..models.fractal import fractal_positions_velocities
from ..models.plummer import plummer_positions_velocities
from ..models.stellar import evolution as stellar
from ..models.yields import feh_for_z, massive_star_yields, read_slrs
from ..state import Cluster, N_CH, N_ISO, SimState
from ..units import G_INTERNAL, KMS_TO_PCMYR


@dataclass
class SimAux:
    """Fixed-shape auxiliary inputs to the step (not part of the evolving
    state)."""

    hm_idx: torch.Tensor        # [H] int32 candidate massive-star indices
    #                             (m0 >= 13)
    hm_slot_valid: torch.Tensor  # [H] bool: False for padding slots (a
    #                             padded slot repeats index 0 and MUST be
    #                             masked or star 0's contribution
    #                             double-counts)
    msrc_idx: torch.Tensor      # [M] int32 indices of every star whose mass
    #                             evolves (m0 >= stellar.SN_MIN_MASS): the
    #                             sources of the force-cache mass-delta
    #                             correction (sim.step)
    msrc_valid: torch.Tensor    # [M] bool: False for padding slots
    agb_grid_t: torch.Tensor    # [G] Myr (zeros when interloper disabled)
    agb_grid_rates: torch.Tensor  # [S,G] Msun/Myr
    kick_vel: torch.Tensor      # [H,3] pc/Myr pre-drawn natal-kick
    #                             velocities, aligned with hm_idx slots
    stellar_tbl: stellar.PhaseTable  # per-star (m0, z)-only phase
    #                             constants, precomputed once, in f64

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _dtype(cfg: SimConfig):
    return torch.float64 if cfg.dtype == "f64" else torch.float32


def _draw_kicks(cfg: SimConfig, n_slots: int) -> np.ndarray:
    """Pre-drawn natal-kick velocity vectors, [n_slots, 3] pc/Myr: three
    iid Gaussian components of dispersion cfg.kick_sigma_kms (Hobbs et al.
    2005), from a dedicated seed stream independent of the IC draws."""
    krng = np.random.default_rng([cfg.seed, 0x6B69636B])  # ascii "kick"
    return krng.normal(0.0, cfg.kick_sigma_kms,
                       (n_slots, 3)) * KMS_TO_PCMYR


def _mass_source_slots(cfg: SimConfig, m0: np.ndarray,
                       is_interloper: np.ndarray | None = None):
    """Indices of stars whose mass evolves in time (m0 >= the SN cut,
    excluding the interloper, whose mass is pinned)."""
    sel = m0 >= stellar.SN_MIN_MASS
    if is_interloper is not None:
        sel = sel & ~is_interloper
    idx = np.flatnonzero(sel)
    if len(idx) == 0:
        return np.array([0]), np.zeros(1, bool)
    return idx, np.ones(len(idx), bool)


def _stellar_table(cfg: SimConfig, m0: np.ndarray,
                   dtype) -> stellar.PhaseTable:
    """stellar.PhaseTable from the initial masses, on the CPU, in f64.

    It is computed from the STATE-dtype m0, as the JAX package does; the
    anchor interpolations and t_end's scale factor make every float field
    f64 (models.stellar.evolution docstring), and the `.double()` below
    states that explicitly. The step casts its per-step result to the
    state dtype."""
    tbl = stellar.phase_table(torch.as_tensor(m0).to(dtype),
                              z=cfg.metallicity, tracks=cfg.mass_tracks)
    return stellar.PhaseTable(*(a if a.dtype == torch.bool else a.double()
                                for a in tbl))


def _hm_candidate_slots(cfg: SimConfig, m0: np.ndarray):
    """Massive-star candidate slots (m0 >= threshold) with an explicit
    validity mask. A cluster with NO candidate gets one MASKED fallback
    slot (a low-mass star's mdot is exactly 0.0 every step, which
    sn_injection would read as a core collapse)."""
    idx = np.flatnonzero(m0 >= cfg.high_mass_threshold)
    if len(idx) == 0:
        return np.array([0]), np.zeros(1, bool)
    return idx, np.ones(len(idx), bool)


def _aux(cfg: SimConfig, m0: np.ndarray, dtype, device, agb_grid_t,
         agb_grid_rates, is_interloper) -> SimAux:
    hm_candidates, hm_valid = _hm_candidate_slots(cfg, m0)
    msrc_idx, msrc_valid = _mass_source_slots(cfg, m0, is_interloper)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                    device=device)
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
    return SimAux(
        hm_idx=i32(hm_candidates),
        hm_slot_valid=b(hm_valid),
        msrc_idx=i32(msrc_idx),
        msrc_valid=b(msrc_valid),
        agb_grid_t=f(agb_grid_t),
        agb_grid_rates=f(agb_grid_rates),
        kick_vel=f(_draw_kicks(cfg, len(hm_candidates))),
        stellar_tbl=_stellar_table(cfg, m0, dtype).to(device),
    )


def _agb_grids(cfg: SimConfig, data_dir: str | None):
    if not cfg.interloper:
        return np.zeros(1), np.zeros((N_ISO, 1))
    table = agb_mod.find_agb(agb_mod.read_agbs(data_dir), cfg.interloper_mass)
    return table.grid_t, np.stack([table.grid_26al, table.grid_60fe])


def build_aux(cfg: SimConfig, m0: np.ndarray, dtype,
              data_dir: str | None = None,
              is_interloper: np.ndarray | None = None, *,
              device) -> SimAux:
    """Fixed-shape aux bundle from the initial masses: massive-star
    candidate slots (m0 >= threshold) and the AGB rate grids."""
    grid_t, grid_rates = _agb_grids(cfg, data_dir)
    return _aux(cfg, np.asarray(m0), dtype, device, grid_t, grid_rates,
                is_interloper)


def _resolve_tree_integrator(cfg: SimConfig) -> str:
    """The tree tier's integrator, with its guards. The tier carries acc
    AND jerk, so hermite4_block runs over tree forces (one tree sweep per
    step through the force cache); auto takes the BHTree-parity leapfrog
    up to 8192 stars and hermite4_block above. The shared-adaptive
    hermite4 stays refused: it would pay a full tree build and sweep per
    substep."""
    if cfg.tree_mac not in ("geometric", "relative"):
        raise ValueError(
            f"tree_mac={cfg.tree_mac!r}: 'geometric' or 'relative'")
    if cfg.mesh_shape is not None:
        raise NotImplementedError(
            "force_impl='tree' under a device mesh is not ported yet "
            "(ROADMAP queue 1, the multi-device axes: parallel/tree_mesh.py)")
    integ = cfg.integrator
    if cfg.tree_mac == "relative":
        # the reference acceleration rides the force cache on the
        # hermite4_block path (sim.step); leapfrog's interior substeps
        # carry no acceleration channel to thread it
        if integ == "auto":
            integ = "hermite4_block"
        elif integ != "hermite4_block":
            raise ValueError(
                "tree_mac='relative' requires "
                f"integrator='hermite4_block'; got {integ!r}")
        if cfg.tree_alpha <= 0.0:
            raise ValueError(f"tree_alpha={cfg.tree_alpha}: must be > 0")
        if not cfg.force_cache or cfg.natal_kicks:
            # without the cache there is no reference acceleration: every
            # step would need the exact O(N^2) sweep, so refuse instead
            raise ValueError(
                "tree_mac='relative' requires the force cache "
                "(force_cache=True and natal_kicks=False — kicks disable "
                "the Hermite cache, sim.step._cacheable)")
    elif integ == "auto":
        integ = "leapfrog" if cfg.n <= 8192 else "hermite4_block"
    elif integ not in ("leapfrog", "hermite4_block"):
        raise ValueError(
            "force_impl='tree' supports integrator='leapfrog' or "
            f"'hermite4_block'; got integrator={integ!r}")
    if not 0.0 < cfg.tree_theta <= 1.0:
        # the geometric MAC's no-self-interaction argument needs theta <= 1
        # (ops.tree._check_theta); checked in relative mode too, where
        # tree_theta still sizes the near-field budget (_auto_tree_kavg)
        raise ValueError(f"tree_theta={cfg.tree_theta}: must be in (0, 1]")
    return integ


def resolve_integrator(cfg: SimConfig, m_total: float) -> SimConfig:
    """Resolve integrator="auto" (hermite4 up to 8192 stars,
    hermite4_block above; for force_impl="tree" see
    _resolve_tree_integrator), the BHTree-parity leapfrog substep count
    (internal dt = 1/64 N-body time unit, al26_nbody.py:59,1712-1714), and
    the block-timestep fast-group size max(256, min(512, n // 128))."""
    integ = cfg.integrator
    if cfg.force_impl == "tree":
        integ = _resolve_tree_integrator(cfg)
    elif integ == "auto":
        integ = "hermite4" if cfg.n <= 8192 else "hermite4_block"
    n_sub = cfg.leapfrog_n_sub
    if integ == "leapfrog" and n_sub is None:
        t_nbody = float(np.sqrt(cfg.rc**3 / (G_INTERNAL * m_total)))
        raw = cfg.dt / (t_nbody / 64.0)
        n_sub = int(max(1, 2 ** int(np.ceil(np.log2(max(raw, 1.0))))))
    elif n_sub is None:
        n_sub = 8
    k_fast = cfg.k_fast
    if integ == "hermite4_block" and k_fast is None:
        k_fast = int(max(256, min(512, cfg.n // 128)))
    return cfg.replace(integrator=integ, leapfrog_n_sub=n_sub, k_fast=k_fast)


def _auto_tree_kavg(cfg: SimConfig, pos: np.ndarray, masses: np.ndarray,
                    dtype, device) -> int:
    """tree_kavg for tree_kavg = 0, measured on the realised initial
    positions on the run's device: twice the mean near-field partner
    count, plus 8, for the drift of a relaxing cluster (runtime overflow
    past the budget NaN-poisons the forces, ops.tree).

    With tree_mac="relative" the counts at tolerance tree_alpha need a
    reference acceleration: one exact sweep (kernel 1 on a CUDA device in
    f32, the plain row-chunked sweep elsewhere). The budget is then the
    larger of those counts and the geometric ones at tree_theta, the
    JAX package's rule, so both packages resolve the same tree_kavg."""
    from ..ops import cuda_nbody
    from ..ops.nbody import acc_jerk_pot_chunked
    from ..ops.tree import p2p_partner_counts

    pos_d = torch.as_tensor(pos, dtype=dtype, device=device)
    mass_d = torch.as_tensor(masses, dtype=dtype, device=device)
    cnt = p2p_partner_counts(pos_d, mass_d, leaf=cfg.tree_leaf,
                             theta=cfg.tree_theta)
    mean = float(cnt.double().mean())
    if cfg.tree_mac == "relative":
        zeros = torch.zeros_like(pos_d)
        if cuda_nbody.use_kernel(len(masses), dtype, device):
            a_ex, _, _ = cuda_nbody.kernel_acc_jerk_pot(
                pos_d, zeros, mass_d, cfg.eps2, with_jerk=False,
                with_pot=False)
        else:
            a_ex, _, _ = acc_jerk_pot_chunked(pos_d, zeros, mass_d,
                                              cfg.eps2, with_jerk=False)
        aref = torch.sqrt(torch.sum(a_ex * a_ex, dim=-1))
        cnt_rel = p2p_partner_counts(pos_d, mass_d, leaf=cfg.tree_leaf,
                                     theta=cfg.tree_alpha, aref=aref)
        mean = max(float(cnt_rel.double().mean()), mean)
    return int(2.0 * mean) + 8


def init_cluster(cfg: SimConfig, data_dir: str | None = None, *, device):
    """Build the initial SimState/SimAux for a fresh run on `device`.

    Returns (state, aux, resolved_cfg): interloper parameters with random
    defaults (closest approach, velocity; al26_nbody.py:1666-1676) are
    resolved into the returned config so they are recorded in
    checkpoints."""
    device = torch.device(device)
    rng = np.random.default_rng(cfg.seed)
    dtype = _dtype(cfg)

    # resolve the mass-track family: None + sn_parity_mode -> the
    # SeBa-calibrated reference-outcome tracks, else lc18
    if cfg.mass_tracks is None:
        cfg = cfg.replace(
            mass_tracks="seba" if cfg.sn_parity_mode else "lc18"
        )
    if not (1e-4 <= cfg.metallicity <= 0.03):
        raise ValueError(
            f"metallicity Z={cfg.metallicity} outside the Hurley et al. "
            "(2000) fit validity range [1e-4, 0.03]"
        )
    stellar.check_tracks(cfg.mass_tracks, cfg.metallicity)

    # -- masses (IMF with >=13 Msun re-roll, al26_nbody.py:1508-1510) ------
    masses = imf.generate_masses(
        rng, cfg.n, cfg.star_min_mass, cfg.star_max_mass,
        no_massive_star_requirement=cfg.no_massive_star_requirement,
        massive_threshold=cfg.high_mass_threshold,
    )
    m_total = float(masses.sum())
    cfg = resolve_integrator(cfg, m_total)

    # -- positions / velocities --------------------------------------------
    if cfg.model == "plummer":
        pos, vel = plummer_positions_velocities(rng, cfg.n, cfg.rc, m_total)
    elif cfg.model == "fractal":
        pos, vel = fractal_positions_velocities(
            rng, cfg.n, cfg.rc, m_total, cfg.fractal_dimension,
            device=device, dtype=dtype)
    else:
        raise ValueError(
            'Invalid choice of cluster model, must be either "plummer" or '
            '"fractal"!'
        )

    # -- discs ---------------------------------------------------------
    lm = (masses >= cfg.low_mass_min) & (masses <= cfg.low_mass_max)
    hm = masses >= cfg.high_mass_threshold
    tau_disk = discs.draw_disk_lifetimes(rng, cfg.n, cfg.disk_lifetime_mean)
    r_disk = np.full(cfg.n, discs.disk_radius_pc(cfg.disk_radius))

    # -- per-star yield data for massive stars (host maths, f64) ------------
    total_wind_loss = np.where(
        hm, stellar.total_wind_loss(
            torch.as_tensor(masses), z=cfg.metallicity,
            tracks=cfg.mass_tracks).numpy(), 0.0
    )
    slrs = read_slrs(data_dir, feh=feh_for_z(cfg.metallicity),
                     vel=cfg.yields_vel)
    ydata = massive_star_yields(masses, slrs, total_wind_loss,
                                cfg.high_mass_threshold)

    # -- optional interloper -------------------------------------------
    n_total = cfg.n + (1 if cfg.interloper else 0)
    resolved = cfg
    if cfg.interloper:
        # resolve randomised defaults (al26_nbody.py:1666-1676)
        ri = cfg.interloper_radius
        if ri is None:
            ri = float(rng.uniform(0.0, cfg.rc))
        di = cfg.interloper_distance
        if di is None:
            di = 2.0 * cfg.rc
        vi = cfg.interloper_velocity
        if vi is None:
            vi = float(rng.uniform(0.0, 100.0))
        resolved = cfg.replace(
            interloper_radius=ri, interloper_distance=di,
            interloper_velocity=vi,
        )
        # spawned at (-distance, closest_approach, 0) moving along +x
        # (al26_nbody.py:1479-1485)
        pos = np.vstack([pos, [-di, ri, 0.0]])
        vel = np.vstack([vel, [vi * KMS_TO_PCMYR, 0.0, 0.0]])
        masses = np.append(masses, cfg.interloper_mass)
        tau_disk = np.append(tau_disk, 0.0)
        r_disk = np.append(r_disk, 0.0)
        lm = np.append(lm, False)
        hm = np.append(hm, False)
        total_wind_loss = np.append(total_wind_loss, 0.0)
        for k in ydata:
            ydata[k] = np.append(ydata[k], 0.0)
    agb_grid_t, agb_grid_rates = _agb_grids(cfg, data_dir)

    is_interloper = np.zeros(n_total, bool)
    if cfg.interloper:
        is_interloper[-1] = True

    # -- tree-tier near-field budget (like resolve_integrator: the
    # resolved literal is what checkpoints record)
    if resolved.force_impl == "tree" and resolved.tree_kavg == 0:
        resolved = resolved.replace(tree_kavg=_auto_tree_kavg(
            resolved, pos, masses, dtype, device))

    mdot0 = stellar.wind_mdot(torch.as_tensor(masses),
                              torch.zeros(len(masses), dtype=torch.float64),
                              z=cfg.metallicity,
                              tracks=cfg.mass_tracks).numpy()

    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    zeros_f = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
    cluster = Cluster(
        pos=f(pos), vel=f(vel), mass=f(masses),
        m0=f(masses), mdot=f(mdot0),
        kicked=b(np.zeros(n_total, bool)),
        r_disk=f(r_disk), tau_disk=f(tau_disk),
        disk_alive=b(lm),
        m_disk_gas=f(0.1 * masses),               # al26_nbody.py:1545
        m_disk_dust=f(0.01 * 0.1 * masses),       # al26_nbody.py:1546
        mass_27al=f(cfg.mass_frac_27al * masses),  # al26_nbody.py:1555
        mass_56fe=f(cfg.mass_frac_56fe * masses),  # al26_nbody.py:1567
        slr=zeros_f(n_total, N_ISO, N_CH),
        slr_final=zeros_f(n_total, N_ISO, N_CH),
        agb_raw=zeros_f(n_total, N_ISO),
        wind_ratio=f(np.stack([ydata["wind_ratio_26al"],
                               ydata["wind_ratio_60fe"]], axis=-1)),
        sn_yield=f(np.stack([ydata["sn_yield_26al"],
                             ydata["sn_yield_60fe"]], axis=-1)),
        total_wind_loss=f(total_wind_loss),
        is_interloper=b(is_interloper),
    )
    state = SimState(
        cluster=cluster,
        time=zeros_f(),
        step_count=torch.zeros((), dtype=torch.int32, device=device),
    )
    aux = _aux(cfg, masses, dtype, device, agb_grid_t, agb_grid_rates,
               is_interloper)
    return state, aux, resolved
