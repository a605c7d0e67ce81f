"""One step of one cluster in plain torch: the N-body advance, then the step
physics, from the state at the step's start.

The physics after the advance, in the order of al26_nbody.py:704-1113:

  1. masses and wind rates at t + dt (stellar.py);
  2. wind: each disc-bearing star (0.1-3 Msun now, not the interloper)
     sweeps up eta_i dt sum_j ratio_j mdot_j of every massive star
     (m0 >= 13 Msun), eta_i = 0.75 r_disk^2 |v_i| dt / r_bub^3: globally
     with r_bub the cluster's virial radius at the step's start, locally
     with r_bub = 0.1 pc and only the stars closer than that;
  3. supernovae: a massive star whose wind rate is now exactly 0 and that
     has not exploded before injects 0.5 x 0.7 x 0.5 r_disk^2 / (4 d^2) of
     its yield into every such disc, once;
  4. decay of the wind and SN reservoirs by exp(-0.693147 dt / t_half)
     (0.717 Myr for 26Al, 2.6 Myr for 60Fe);
  5. discs whose lifetime has passed die; a living disc's reservoirs are
     copied to its final snapshot.

The interloper, natal kicks and sn_parity_mode are not written: the
benchmark's configurations run without them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import forcelaw, gravity, integrators, stellar

LN2 = 0.693147
# decisions the reference leaves to the program where its own input lies
# within rounding of the threshold: a pair within this share of the local
# bubble's r^2 of its edge, a disc within this share of t of its death, a
# star within this share of t_cc of its supernova (f32 rounding of
# positions, times and the stellar table is ~1e-7 of them)
LOCAL_MARGIN = 1e-3
DEATH_MARGIN = 1e-6
SN_MARGIN = 1e-5
AU_PC = 1.495978707e11 / 3.0856775814913673e16
HALF_LIVES = (0.717, 2.600)
CH_LOCAL, CH_GLOBAL, CH_SNE, CH_AGB = 0, 1, 2, 3


def resolve(sim: dict, n: int, m_total: float, ensemble: bool) -> dict:
    """The integrator and its parameters a configuration states: auto is
    leapfrog for a flattened ensemble (n_sub: dt over 1/64 of the N-body
    time of the realizations' mean initial mass, rounded up to a power of
    two), hermite4 up to 8192 stars, hermite4_block above (k_fast
    max(256, min(512, n // 128))); "law" is the configuration's force law
    (forcelaw.resolve: FileNotFoundError where it has no module)."""
    dt = sim["final_time"] / (sim["n_plot"] * sim["steps_per_plot"])
    rc = sim["rc"]
    integ = sim.get("integrator", "auto")
    if integ == "auto":
        integ = ("leapfrog" if ensemble else
                 "hermite4" if n <= 8192 else "hermite4_block")
    t_nbody = math.sqrt(rc ** 3 / (gravity.G * m_total))
    raw = dt / (t_nbody / 64.0)
    n_sub = sim.get("leapfrog_n_sub") or int(
        2 ** math.ceil(math.log2(max(raw, 1.0))))
    soft = sim.get("softening")
    return {"integrator": integ, "law": forcelaw.resolve(sim),
            "dt": dt, "n_sub": n_sub,
            "eps2": 0.125 * rc * rc if soft is None else soft * soft,
            "eta": sim.get("eta_hermite", 0.14),
            "substeps_max": sim.get("substeps_max", 4096),
            "k_fast": sim.get("k_fast") or max(256, min(512, n // 128)),
            "z": sim.get("metallicity", 0.02),
            "tracks": sim.get("mass_tracks") or "lc18",
            "r_local": sim.get("r_bub_local_wind", 0.1),
            "lm": (sim.get("low_mass_min", 0.1), sim.get("low_mass_max", 3.0)),
            "hm": sim.get("high_mass_threshold", 13.0)}


def advance(c: dict, rp: dict):
    """(pos, vel) after dt."""
    integ = rp["integrator"]
    args = (rp["law"], c["pos"], c["vel"], c["mass"], rp["dt"], rp["eps2"])
    if integ == "leapfrog":
        return integrators.leapfrog(*args, rp["n_sub"])
    if integ == "hermite4":
        return integrators.hermite4(*args, rp["eta"], rp["substeps_max"])
    if integ == "hermite4_block":
        return integrators.hermite4_block(
            *args, rp["eta"], rp["substeps_max"],
            min(rp["k_fast"], c["pos"].shape[0]))
    raise ValueError(f"no reference for integrator {integ!r}")


def after_advance(c: dict, rp: dict, step_count: int, pos, vel, r_vir):
    """The step physics from the step-start cluster `c` and the advanced
    (pos, vel): {mass, mdot, kicked, slr, slr_final, disk_alive}, and the
    stars whose outcome a threshold decides within rounding: "amb_local"
    (a massive star at the local bubble's edge), "amb_death" (the disc dies
    at t + dt within rounding), "amb_sn" (a supernova at t + dt within
    rounding: every disc's SN channel)."""
    dt = rp["dt"]
    t_new = (step_count + 1) * dt
    m0 = c["m0"]
    lm = ((c["mass"] >= rp["lm"][0]) & (c["mass"] <= rp["lm"][1])
          & ~c["is_interloper"])
    mass_np, mdot_np = stellar.mass_and_wind(
        m0.double().cpu().numpy(), t_new, rp["z"], rp["tracks"])
    mass = torch.as_tensor(mass_np, dtype=pos.dtype, device=pos.device)
    mdot = torch.as_tensor(mdot_np, dtype=pos.dtype, device=pos.device)
    inter = c["is_interloper"]
    mass = torch.where(inter, c["mass"], mass)
    mdot = torch.where(inter, 0.0, mdot)
    hm = torch.nonzero(m0 >= rp["hm"]).flatten()

    speed = torch.sqrt((vel * vel).sum(-1))
    src = c["wind_ratio"][hm] * mdot[hm][:, None]                  # [H, S]
    r2 = c["r_disk"] ** 2

    def eta(r_bub):
        return 0.75 * r2 * speed * dt / r_bub ** 3 * dt * lm

    wind_g = eta(r_vir)[:, None] * src.sum(0)[None, :]
    d2 = ((pos[:, None, :] - pos[hm][None, :, :]) ** 2).sum(-1)    # [N, H]
    near = (d2 < rp["r_local"] ** 2).to(pos.dtype)
    wind_l = eta(torch.as_tensor(rp["r_local"], dtype=pos.dtype))[:, None] \
        * (near @ src)
    event = (mdot[hm] == 0.0) & ~c["kicked"][hm]
    w_sn = 0.5 * 0.7 * (0.5 * r2[:, None] / (4.0 * d2.clamp_min(1e-30)))
    sne = (w_sn * event[None, :].to(pos.dtype)) @ c["sn_yield"][hm]
    sne = sne * lm[:, None]
    kicked = c["kicked"].clone()
    kicked[hm[event]] = True
    r2_loc = rp["r_local"] ** 2
    amb_local = ((d2 - r2_loc).abs() <= LOCAL_MARGIN * r2_loc).any(1) & lm
    t_cc = stellar.phases(m0[hm].double().cpu().numpy(), rp["z"],
                          rp["tracks"])[4]
    amb_sn = bool(np.any(np.abs(t_cc - t_new) <= SN_MARGIN * t_cc))

    slr = c["slr"].clone()
    slr[:, :, CH_GLOBAL] += wind_g
    slr[:, :, CH_LOCAL] += wind_l
    slr[:, :, CH_SNE] += sne
    decay = torch.tensor([math.exp(-dt * LN2 / h) for h in HALF_LIVES],
                         dtype=pos.dtype, device=pos.device)
    slr[:, :, :CH_AGB] *= decay[None, :, None]
    live = lm & c["disk_alive"]
    snap = live & (c["tau_disk"] >= t_new)
    slr_final = c["slr_final"].clone()
    upd = snap[:, None, None].expand_as(slr).clone()
    upd[:, :, CH_AGB] = False
    slr_final = torch.where(upd, slr, slr_final)
    disk_alive = c["disk_alive"] & ~(live & (c["tau_disk"] < t_new))
    amb_death = live & ((c["tau_disk"] - t_new).abs()
                        <= DEATH_MARGIN * t_new)
    return {"mass": mass, "mdot": mdot, "kicked": kicked, "slr": slr,
            "slr_final": slr_final, "disk_alive": disk_alive,
            "amb_local": amb_local, "amb_death": amb_death,
            "amb_sn": torch.tensor(amb_sn, device=pos.device)}


def step(c: dict, rp: dict, step_count: int):
    """One whole reference step: (pos, vel, physics dict)."""
    r_vir = rp["law"].virial_radius(c["pos"], c["mass"])
    pos, vel = advance(c, rp)
    return pos, vel, after_advance(c, rp, step_count, pos, vel, r_vir)


def initial(m0, rp: dict, disk_radius_au: float = 100.0):
    """The derived per-star fields of a fresh cluster from its initial
    masses: disc gas 0.1 m0, dust 0.01 of the gas, 27Al 8.5e-6 m0, 56Fe
    1.828e-4 m0, disc radius, the wind rate at age 0, and the lifetime
    wind loss m0 - m_remnant of the massive stars."""
    m = np.asarray(m0, np.float64)
    _, mdot0 = stellar.mass_and_wind(m, 0.0, rp["z"], rp["tracks"])
    twl = np.where(m >= rp["hm"], m - stellar.remnant_mass(
        m, rp["z"], rp["tracks"]), 0.0)
    return {"m_disk_gas": 0.1 * m, "m_disk_dust": 0.001 * m,
            "mass_27al": 8.5e-6 * m, "mass_56fe": 1.828e-4 * m,
            "r_disk": np.full_like(m, disk_radius_au * AU_PC),
            "mdot": mdot0, "total_wind_loss": twl}
