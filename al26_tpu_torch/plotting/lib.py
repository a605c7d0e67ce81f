"""Analysis/plotting library (the port's copy of al26_tpu/plotting/lib.py,
the `plotting/al26_plot.py` equivalent).

Readers for state/yields files (the port's, the JAX package's and the
reference's AMUSE pickles), disc-lifetime enrichment interpolation,
SN-time prediction, energy diagnostics, local densities, half-mass
radius, CDF/heating helpers and the global-model yield recomputation.
The snapshot diagnostics run on torch tensors on `device` ("cuda" by
default, meaning cuda:LOCAL_RANK; without a card they raise and name
device="cpu"), in the dtype of the file's arrays, and return Python
floats or numpy arrays. File parsing stays on the host. matplotlib and
pandas are imported lazily, so headless analysis needs no display stack.
"""
from __future__ import annotations

import numpy as np

from ..io.checkpoint import load_state
from ..io.compat import Particles, State
from ..io.yields_store import Yields
from ..units import msol, myr, pc, pcmyr

__all__ = [
    "read_state", "read_yields", "read_interloper_trajectory",
    "calc_cdf", "calc_current_heating_rate", "calc_disk_final_enrichment",
    "calc_sn_times", "calc_etot", "calc_dE", "calc_local_densities",
    "calc_cluster_half_mass", "get_high_mass_star_indices",
    "calc_global_model_yield", "plot_positions",
]


def use_tex(use_mnras: bool = False) -> None:
    """Enable TeX text rendering for paper figures (al26_plot.py:22-39).
    No-op when no TeX toolchain is installed."""
    import shutil

    import matplotlib.pyplot as plt

    if shutil.which("latex") is None:
        return
    plt.rcParams.update({
        "text.usetex": True,
        "font.family": "Computer Modern",
    })
    if use_mnras:
        for key, size in (("axes", 9), ("xtick", 9), ("ytick", 9),
                          ("legend", 9), ("figure", 9)):
            plt.rc(key, **({"titlesize": size} if key == "figure"
                           else {"labelsize": size} if key in ("xtick", "ytick")
                           else {"fontsize": size} if key == "legend"
                           else {"labelsize": size, "titlesize": size}))


def sphere_wireframe(x, y, z, r):
    """Wireframe sphere coordinates at (x,y,z) (al26_plot.py:100-109)."""
    u, v = np.mgrid[0:2 * np.pi:20j, 0:np.pi:20j]
    return (r * np.cos(u) * np.sin(v) + x,
            r * np.sin(u) * np.sin(v) + y,
            r * np.cos(v) + z)


def check_interaction(xh, yh, zh, xl_arr, yl_arr, zl_arr, r):
    """Disc stars within radius r of a massive star
    (al26_plot.py:71-98, vectorised)."""
    xl = np.asarray(xl_arr)
    yl = np.asarray(yl_arr)
    zl = np.asarray(zl_arr)
    d = np.sqrt((xl - xh) ** 2 + (yl - yh) ** 2 + (zl - zh) ** 2)
    hit = d < r
    return (xl[hit].tolist(), yl[hit].tolist(), zl[hit].tolist(),
            xl_arr, yl_arr, zl_arr)


def get_digit_from_filename(filename: str, length: int = 5) -> str:
    """Trailing digit group of a checkpoint filename (al26_plot.py:205-208)."""
    digits = "".join(filter(str.isdigit, filename))
    return digits[-length:]


def read_state(filename: str) -> State:
    """Load a `<base>-state-NNNNN.pkl.zst` file (al26_plot.py:41-50);
    reference-written AMUSE pickles load too."""
    return load_state(filename)


def read_yields(filename: str) -> Yields:
    """Load a yields file and convert the lists to numpy arrays
    (al26_plot.py:52-64). Accepts both the reference blob format
    (*.ubj.zst) and the appendable framed store (*.ubjf), so plots also
    work on runs that crashed before their final blob write."""
    y = Yields("")
    if filename.endswith(".ubjf"):
        y.plate_frames(filename)
    else:
        y.plate(filename)
    return y.as_arrays()


def read_interloper_trajectory(filename: str):
    """interloper_trajectory.dat reader (al26_plot.py:66-69)."""
    import pandas as pd

    colnames = ["sim_time", "agb_time", "x", "y", "z", "bary_dist"]
    return pd.read_csv(filename, names=colnames, header=None)


def calc_cdf(data):
    """Empirical CDF points (al26_plot.py:200-203)."""
    x = np.sort(np.asarray(data))
    y = 1.0 * np.arange(len(x)) / (len(x) - 1)
    return x, y


def calc_current_heating_rate(z_al, z_fe):
    """Radiogenic heating rate Q(26Al, 60Fe) (al26_plot.py:187-198).
    Constants preserved verbatim from the reference, including its mass
    fractions written as 8500e-6 / 1828e-4."""
    h_al26 = 0.3551
    h_fe60 = 0.0396
    f_al = 8500e-6
    f_fe = 1828e-4
    return z_al * f_al * h_al26 + z_fe * f_fe * h_fe60


def calc_disk_final_enrichment(yields_data: Yields, lifetimes_myr):
    """Interpolate each star's yield history at its disc lifetime and attach
    `<model>_<iso>_final` attributes (al26_plot.py:210-242). Akima in time;
    falls back to the last snapshot when the disc outlives the run (or
    predates the first snapshot / has a non-finite lifetime, where the
    reference's per-star Akima returned NaN).

    One Akima construction per series over the shared time abscissa
    (PPoly coefficients [4, T-1, N]), each star's value read from its own
    interval."""
    from scipy.interpolate import Akima1DInterpolator

    lifetimes = np.asarray(lifetimes_myr, dtype=float)
    t = np.asarray(yields_data.time)
    n = len(lifetimes)
    cols = np.arange(n)
    finite = np.isfinite(lifetimes)
    tau_safe = np.where(finite, lifetimes, t[0])
    k = np.clip(np.searchsorted(t, tau_safe, side="right") - 1,
                0, len(t) - 2)
    dt_loc = tau_safe - t[k]
    for iso in ("26al", "60fe"):
        for model in ("global", "local", "sne"):
            key = f"{model}_{iso}"
            y = np.asarray(getattr(yields_data, key))    # [T, N]
            c = Akima1DInterpolator(t, y, axis=0).c[:, k, cols]  # [4, N]
            vals = ((c[0] * dt_loc + c[1]) * dt_loc + c[2]) * dt_loc + c[3]
            stale = (~np.isfinite(vals) | ~finite
                     | (lifetimes >= t[-1]) | (lifetimes < t[0]))
            vals = np.where(stale, y[-1, :], vals)
            setattr(yields_data, key + "_final", vals.tolist())
    return yields_data


def _run_stellar_params(metadata, z, mass_tracks):
    """Resolve (z, mass_tracks) for a snapshot-recompute helper: an
    explicit kwarg wins, else the run's recorded cfg (metadata.args,
    written into every checkpoint), else the lc18/solar defaults (files
    of the reference record neither)."""
    args = getattr(metadata, "args", None)
    if z is None:
        z = getattr(args, "metallicity", None)
        z = 0.02 if z is None else float(z)
    if mass_tracks is None:
        mass_tracks = getattr(args, "mass_tracks", None) or "lc18"
    return z, mass_tracks


def _device(device):
    """The analysis device through the run driver's rule: "cuda" must
    exist (no CPU fallback)."""
    from ..sim.driver import run_device

    return run_device(device)


def _tensor(a, device):
    import torch

    return torch.as_tensor(np.asarray(a), device=device)


def calc_sn_times(initial_cluster: Particles, return_keys: bool = False,
                  z: float | None = None, mass_tracks: str | None = None,
                  metadata=None, device="cuda"):
    """Supernova times and masses for the cluster's massive stars
    (al26_plot.py:244-279). The reference runs a throwaway SeBa with a
    supernova stopping condition; here the stellar module's lifetime
    function answers directly. Masses/keys come back in descending-mass
    order with times ascending, as the consumers expect. Pass the run's
    state.metadata (or cfg.mass_tracks explicitly): seba-track runs
    collapse 0.7-2.5% later than the lc18/Hurley default."""
    from ..models.stellar.evolution import t_sn

    dev = _device(device)
    z, mass_tracks = _run_stellar_params(metadata, z, mass_tracks)
    mass = np.asarray(initial_cluster.mass.value_in(msol))
    keys = np.asarray(initial_cluster.key)
    hm = np.flatnonzero(mass >= 13.0)
    order = hm[np.argsort(-mass[hm])]
    sn_masses = mass[order].tolist()
    sn_keys = keys[order].tolist()
    sn_times = t_sn(_tensor(mass[order], dev), z,
                    tracks=mass_tracks).cpu().numpy().tolist()
    sn_times.sort()
    if return_keys:
        return sn_times, sn_masses, sn_keys
    return sn_times, sn_masses


def _pos_vel_mass(cluster: Particles, device):
    """[N, 3] positions (pc), velocities (pc/Myr) and [N] masses (Msun) on
    `device`, in the dtype of the file's arrays."""
    pos = np.stack([
        cluster.x.value_in(pc), cluster.y.value_in(pc),
        cluster.z.value_in(pc),
    ], -1)
    vel = np.stack([
        cluster.vx.value_in(pcmyr), cluster.vy.value_in(pcmyr),
        cluster.vz.value_in(pcmyr),
    ], -1)
    mass = cluster.mass.value_in(msol)
    return _tensor(pos, device), _tensor(vel, device), _tensor(mass, device)


def calc_etot(state: State, eps2: float | None = None,
              device="cuda") -> float:
    """Total energy of a snapshot in internal units (Msun pc^2 / Myr^2);
    replaces the reference's throwaway-BHTree evaluation
    (al26_plot.py:281-295). Defaults to the run's own softening (BHTree
    parity: eps^2 = 0.125 rc^2) read from the checkpoint metadata."""
    from ..ops.nbody import total_energy

    dev = _device(device)
    if eps2 is None:
        args = getattr(state.metadata, "args", None)
        soft = getattr(args, "softening", None)
        rc = getattr(args, "rc", None)
        if soft is not None:
            eps2 = float(soft) ** 2
        elif rc is not None:
            eps2 = 0.125 * float(rc) ** 2
        else:
            eps2 = 0.0
    pos, vel, mass = _pos_vel_mass(state.cluster, dev)
    return float(total_energy(pos, vel, mass, eps2))


def calc_dE(eti: float, et: float) -> float:
    """Relative energy drift (al26_plot.py:297-299)."""
    return (eti - et) / et


def calc_local_densities(cluster: Particles, device="cuda") -> np.ndarray:
    """10-nearest-neighbour local densities in Msun/pc^3
    (al26_plot.py:324-371), by row blocks (ops.nbody.local_densities)."""
    from ..ops.nbody import local_densities

    pos, _, mass = _pos_vel_mass(cluster, _device(device))
    return local_densities(pos, mass).cpu().numpy()


def calc_cluster_half_mass(cluster: Particles, device="cuda") -> float:
    """Half-mass radius in pc (al26_plot.py:373-400)."""
    from ..ops.nbody import half_mass_radius

    pos, _, mass = _pos_vel_mass(cluster, _device(device))
    return float(half_mass_radius(pos, mass))


def get_high_mass_star_indices(cluster: Particles):
    """(hm_id, lm_id) index lists (al26_plot.py:402-424)."""
    mass = np.asarray(cluster.mass.value_in(msol))
    hm_id = np.flatnonzero(mass >= 13.0).tolist()
    lm_id = np.flatnonzero((mass >= 0.1) & (mass <= 3.0)).tolist()
    return hm_id, lm_id


def calc_global_model_yield(cluster: Particles, time_myr: float,
                            dt_myr: float, radius_method: str = "halfmass",
                            metallicity: float | None = None,
                            mass_tracks: str | None = None,
                            metadata=None, device="cuda"):
    """Recompute the global-model wind deposition rate for a snapshot
    (al26_plot.py:488-544): stellar wind rates at `time_myr` from the
    stellar-evolution module, bubble radius from the half-mass or virial
    radius. Pass the run's state.metadata (or cfg.mass_tracks and
    metallicity explicitly): a seba-track run's wind rates are orders of
    magnitude below the lc18 default's."""
    import torch

    from ..models.stellar.evolution import wind_mdot
    from ..ops.deposition import wind_deposition
    from ..ops.nbody import virial_radius

    dev = _device(device)
    metallicity, mass_tracks = _run_stellar_params(
        metadata, metallicity, mass_tracks)

    pos, vel, mass = _pos_vel_mass(cluster, dev)
    mass_np = mass.cpu().numpy()
    m0 = np.asarray(
        cluster.initial_mass.value_in(msol)
        if "initial_mass" in cluster.columns() else mass_np
    )
    if radius_method == "halfmass":
        r_bub = 2.0 * calc_cluster_half_mass(cluster, device=dev)
    elif radius_method == "virial":
        r_bub = float(virial_radius(pos, mass))
    else:
        raise ValueError("INVALID RADIUS METHOD")

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float64, device=dev)

    mdot = wind_mdot(_tensor(m0, dev), scalar(time_myr), z=metallicity,
                     tracks=mass_tracks)
    lm_mask = _tensor((mass_np >= 0.1) & (mass_np <= 3.0), dev)
    hm_idx = np.flatnonzero(m0 >= 13.0)
    if len(hm_idx) == 0:
        z = np.zeros(len(mass_np))
        return z, z
    wind_ratio = np.stack([
        np.asarray(cluster.wind_ratio_26al),
        np.asarray(cluster.wind_ratio_60fe),
    ], -1)
    out = wind_deposition(
        pos, vel, _tensor(cluster.r_disk.value_in(pc), dev), lm_mask,
        _tensor(hm_idx, dev), torch.ones(len(hm_idx), dtype=torch.bool,
                                         device=dev),
        mdot, _tensor(wind_ratio, dev), scalar(r_bub), scalar(dt_myr),
        local=False,
    ).cpu().numpy()
    return out[:, 0], out[:, 1]


def plot_positions(particles: Particles, metadata, interaction_radius=0.1,
                   ax=None):
    """3D position plot with interaction spheres (al26_plot.py:111-185)."""
    import matplotlib.pyplot as plt

    x = np.asarray(particles.x.value_in(pc))
    y = np.asarray(particles.y.value_in(pc))
    z = np.asarray(particles.z.value_in(pc))
    masses = np.asarray(particles.mass.value_in(msol))
    disks = np.asarray(particles.disk_alive)
    t = float(metadata.time.value_in(myr))
    half_radius = metadata.args.rc

    hm = masses >= 13.0
    lm = ~hm & disks
    im = ~hm & ~disks

    if ax is None:
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(projection="3d")
    ax.scatter(x[hm], y[hm], z[hm], marker="D", s=4.0, color="tab:orange",
               label=r"$M_\star \geq 13 M_\odot$")
    ax.scatter(x[im], y[im], z[im], marker="o", s=2.0, alpha=0.5,
               color="tab:blue", label=r"$M_\star \leq 3 M_\odot$")
    ax.scatter(x[lm], y[lm], z[lm], marker="o", s=2.0, color="red",
               label="Disk")
    # interaction count: disc stars within the interaction radius of a
    # massive star (one geometry definition — check_interaction)
    interactions = 0
    for i in np.flatnonzero(hm):
        xs, _, _, _, _, _ = check_interaction(
            x[i], y[i], z[i], x[lm], y[lm], z[lm], interaction_radius
        )
        interactions += len(xs)
    ax.set_title(f"t = {t:.2f} Myr, {interactions} interacting stars")
    for lim_set, m in ((ax.set_xlim, x), (ax.set_ylim, y), (ax.set_zlim, z)):
        c = m.mean()
        lim_set((c - 10 * half_radius, c + 10 * half_radius))
    ax.set_xlabel("X (pc)")
    ax.set_ylabel("Y (pc)")
    ax.set_zlabel("Z (pc)")
    ax.legend(loc="upper left", markerscale=2)
    return ax
