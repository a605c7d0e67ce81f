"""SLR deposition, decay and disc-condensation physics (torch port of
al26_tpu.ops.deposition, which documents the reference lines each
function replaces).

  * `wind_deposition`  — the O(N_lm x N_hm) pairwise wind sweep-up
    (`calc_wind_abs`, al26_nbody.py:642-702), all isotopes at once; the
    global model collapses to O(N) because its per-pair term factorises:

        wind_abs[i,s] = eta_i * dt * sum_j W_ij * (wind_ratio[j,s]*mdot_j)
        eta_i         = 0.75 * r_disk_i^2 * |v_i| * dt / r_bub^3
        W_ij          = 1                      (global: r_bub = virial radius)
        W_ij          = [d_ij < r_bub]         (local:  r_bub = 0.1 pc)

    Massive stars sit in a fixed-width slot array `hm_idx` (candidates
    fixed at init), so the pairwise work is O(N x H) with H << N.
  * `sn_injection`     — supernova detection (wind rate exactly zero and not
    yet kicked) and 1/d^2 disc injection (al26_nbody.py:943-967,
    1291-1334), as masks.
  * `interloper_deposition` — AGB flyby path-intersection deposition with
    the closed-form chord overlap (the sampled variant kept for parity).
  * `apply_decay` / `condense` — exponential decay with the reference's
    hard-coded constants and disc-death snapshotting.

All units internal (Msun/pc/Myr). The einsums run in full f32 on a card
(the package turns TF32 off at import).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..state import CH_AGB
from ..units import LN2_REFERENCE

# Lichtenberg+2016 SN injection constants (al26_nbody.py:1327-1329)
SN_COS60 = 0.5
SN_ETA_COND = 0.5
SN_ETA_INJ = 0.7


def eta_bubble_wind(r_disk, d_trav, r_bub):
    """Disc sweep-up cross-section fraction (al26_nbody.py:1241-1254)."""
    return 0.75 * (r_disk**2) * d_trav / (r_bub**3)


def eta_disk_sne(r_disk, d=None, *, d2=None):
    """SN injection efficiency (al26_nbody.py:1291-1334). Takes the
    distance `d` (reference signature) or its square `d2` directly."""
    if d2 is None:
        d2 = d * d
    eta_geom = (SN_COS60 * r_disk**2) / (4.0 * d2)
    return SN_ETA_COND * SN_ETA_INJ * eta_geom


def wind_deposition(
    pos: torch.Tensor,          # [N,3] pc
    vel: torch.Tensor,          # [N,3] pc/Myr
    r_disk: torch.Tensor,       # [N]   pc
    lm_mask: torch.Tensor,      # [N]   bool (disc-bearing targets)
    hm_idx: torch.Tensor,       # [H]   int  (fixed massive-star candidate slots)
    hm_valid: torch.Tensor,     # [H]   bool (slot currently a >=13 Msun star)
    mdot: torch.Tensor,         # [N]   Msun/Myr (>= 0)
    wind_ratio: torch.Tensor,   # [N,S] dimensionless
    bubble_radius,              # scalar pc (virial radius for the global
    #                             model, 0.1 pc for the local model)
    dt,                         # scalar Myr
    local: bool,                # local mixing model (distance cut)?
) -> torch.Tensor:
    """Absorbed wind SLR mass per star per isotope, [N,S] Msun."""
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1))           # [N]
    eta = eta_bubble_wind(r_disk, speed * dt, bubble_radius)   # [N]
    src = wind_ratio[hm_idx] * (mdot[hm_idx] * hm_valid)[:, None]  # [H,S]
    if local:
        d2 = torch.sum((pos[:, None, :] - pos[hm_idx][None, :, :]) ** 2,
                       dim=-1)
        # deposit strictly when d < bubble_radius (al26_nbody.py:688-690)
        within = d2 < bubble_radius**2                          # [N,H]
        contrib = torch.einsum("nh,hs->ns", within.to(pos.dtype), src)
    else:
        contrib = torch.sum(src, dim=0)[None, :]                # [1,S]
        contrib = contrib.expand(pos.shape[0], src.shape[1])
    return (eta * dt * lm_mask)[:, None] * contrib


def sn_injection(
    pos: torch.Tensor,         # [N,3]
    r_disk: torch.Tensor,      # [N]
    lm_mask: torch.Tensor,     # [N] bool
    hm_idx: torch.Tensor,      # [H] candidate slots (INITIAL mass >= 13)
    hm_slot_valid: torch.Tensor,  # [H] bool: False for padding slots
    mdot: torch.Tensor,        # [N] Msun/Myr AFTER the stellar-evolution update
    kicked: torch.Tensor,      # [N] bool
    sn_yield: torch.Tensor,    # [N,S] Msun
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detect SNe this step and inject yields onto every disc. Returns
    (injected [N,S], kicked' [N]). Candidacy is initial-mass based
    (hm_idx); `kicked` guarantees one injection per star; padded slots
    (repeated indices) are masked so no star injects twice."""
    # scatter-or: a duplicated padding slot (valid=False) must not clobber
    # the real slot's candidacy at the same index
    sn_candidate = torch.zeros(pos.shape[0], dtype=torch.uint8,
                               device=pos.device).scatter_reduce(
        0, hm_idx.long(), hm_slot_valid.to(torch.uint8), reduce="amax"
    ).bool()
    sn_event = sn_candidate & (mdot == 0.0) & ~kicked        # [N]
    ev = sn_event[hm_idx] & hm_slot_valid                    # [H]
    d2 = torch.sum((pos[:, None, :] - pos[hm_idx][None, :, :]) ** 2, dim=-1)
    d2 = torch.clamp(d2, min=1e-30)
    eta = eta_disk_sne(r_disk[:, None], d2=d2)
    w = eta * ev[None, :].to(pos.dtype)                      # [N,H]
    injected = torch.einsum("nh,hs->ns", w, sn_yield[hm_idx])
    injected = injected * lm_mask[:, None]
    return injected, kicked | sn_event


def chord_fraction(p1_old, p1_new, p2_old, p2_new, r) -> torch.Tensor:
    """Fraction of the step two linearly-moving points spend within r:
    the closed-form solution of |(p2-p1)(s)| <= r for s in [0,1], the
    exact limit of the reference's 1024-point sampling
    (al26_nbody.py:1156-1190). Broadcasts over leading axes."""
    d0 = p2_old - p1_old
    dd = (p2_new - p2_old) - (p1_new - p1_old)
    a = torch.sum(dd * dd, dim=-1)
    b = 2.0 * torch.sum(d0 * dd, dim=-1)
    c = torch.sum(d0 * d0, dim=-1) - r * r
    disc = b * b - 4.0 * a * c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    safe_a = torch.where(a > 0.0, a, 1.0)
    s1 = (-b - sqrt_disc) / (2.0 * safe_a)
    s2 = (-b + sqrt_disc) / (2.0 * safe_a)
    lo = torch.clamp(s1, 0.0, 1.0)
    hi = torch.clamp(s2, 0.0, 1.0)
    frac_moving = torch.where(disc > 0.0, hi - lo, 0.0)
    # degenerate case: no relative motion — inside for the whole step or not
    frac_static = torch.where(c <= 0.0, 1.0, 0.0).to(a.dtype)
    return torch.where(a > 0.0, frac_moving, frac_static)


def chord_fraction_sampled(p1_old, p1_new, p2_old, p2_new, r,
                           n: int = 1024):
    """Reference-parity variant: n-point straight-line sampling
    (al26_nbody.py:1156-1190)."""
    s = torch.linspace(0.0, 1.0, n, dtype=p1_old.dtype,
                       device=p1_old.device)
    p1 = p1_old[..., None, :] + s[:, None] * (p1_new - p1_old)[..., None, :]
    p2 = p2_old[..., None, :] + s[:, None] * (p2_new - p2_old)[..., None, :]
    d = torch.sqrt(torch.sum((p1 - p2) ** 2, dim=-1))
    return torch.sum(d <= r, dim=-1) / n


def interloper_deposition(
    pos_old: torch.Tensor,      # [N,3] before the N-body advance
    pos_new: torch.Tensor,      # [N,3] after
    r_disk: torch.Tensor,       # [N]
    lm_mask: torch.Tensor,      # [N] bool (is_interloper already excluded)
    interloper_index: int,
    rate_26al: torch.Tensor,    # scalar Msun/Myr at the interloper's AGB clock
    rate_60fe: torch.Tensor,    # scalar
    proximity_radius: float,    # pc — the 0.1 pc sampling radius (al26:1013)
    bubble_radius,              # pc — interloper wind bubble (al26:1022)
    dt,
    exact_chord: bool = True,
) -> torch.Tensor:
    """AGB interloper deposition, [N,S] Msun (al26_nbody.py:990-1028)."""
    int_old = pos_old[interloper_index].expand_as(pos_old)
    int_new = pos_new[interloper_index].expand_as(pos_new)
    chord = chord_fraction if exact_chord else chord_fraction_sampled
    frac = chord(pos_old, pos_new, int_old, int_new, proximity_radius)
    d_trav = torch.sqrt(torch.sum((pos_new - pos_old) ** 2, dim=-1)) * frac
    eta = eta_bubble_wind(r_disk, d_trav, bubble_radius)     # [N]
    eta = eta * lm_mask
    rates = torch.stack([torch.as_tensor(rate_26al),
                         torch.as_tensor(rate_60fe)])         # [S]
    return eta[:, None] * rates[None, :] * dt


def decay_factors(dt, half_life_26al: float, half_life_60fe: float, dtype):
    """exp(-dt * ln2 / t_half) with the reference's truncated ln2
    (al26_nbody.py:1048-1051). A Python-float dt is taken in f64."""
    dt = torch.as_tensor(dt, dtype=None if torch.is_tensor(dt)
                         else torch.float64)
    f_al = torch.exp(-dt * LN2_REFERENCE / half_life_26al)
    f_fe = torch.exp(-dt * LN2_REFERENCE / half_life_60fe)
    return torch.stack([f_al, f_fe]).to(dtype)


def apply_decay(slr: torch.Tensor, dt, half_life_26al, half_life_60fe,
                decay_agb: bool) -> torch.Tensor:
    """Decay all reservoirs [N,S,C]. The AGB channel only decays when the
    interloper subsystem is active (al26_nbody.py:1062-1064); agb_raw never
    decays by construction (kept outside `slr`)."""
    f = decay_factors(dt, half_life_26al, half_life_60fe, slr.dtype)  # [S]
    if not decay_agb:
        ch_scale = torch.ones(slr.shape[-1], dtype=slr.dtype,
                              device=slr.device)
        ch_scale[CH_AGB] = 0.0
        factors = 1.0 + ch_scale[None, :] * (f[:, None] - 1.0)   # [S,C]
    else:
        factors = f[:, None].expand(slr.shape[-2], slr.shape[-1])
    return slr * factors[None, :, :]


def condense(
    slr: torch.Tensor,        # [N,S,C]
    slr_final: torch.Tensor,  # [N,S,C]
    agb_final_enabled: bool,
    tau_disk: torch.Tensor,   # [N]
    disk_alive: torch.Tensor,  # [N] bool
    lm_mask: torch.Tensor,    # [N] bool
    t_new,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Snapshot reservoirs into *_final while the disc lives; kill expired
    discs (al26_nbody.py:1070-1086). The AGB final channel is only tracked
    when the interloper is enabled, as in the reference (:1080-1082)."""
    live = lm_mask & disk_alive
    snap = live & (tau_disk >= t_new)
    ch_update = torch.ones(slr.shape[-1], dtype=torch.bool, device=slr.device)
    if not agb_final_enabled:
        ch_update[CH_AGB] = False
    upd = snap[:, None, None] & ch_update[None, None, :]
    slr_final = torch.where(upd, slr, slr_final)
    disk_alive = disk_alive & ~(live & (tau_disk < t_new))
    return slr_final, disk_alive
