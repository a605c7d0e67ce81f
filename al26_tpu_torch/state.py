"""Cluster state as dataclasses of tensors (port of al26_tpu.state).

The whole simulation state is ONE dataclass of fixed-shape tensors (SoA)
on one device. Layout conventions are the JAX package's:
  * isotope axis  (S=2): 0 = 26Al, 1 = 60Fe
  * channel axis  (C=4): 0 = local wind, 1 = global wind, 2 = SNe, 3 = AGB
  * units: Msun / pc / Myr everywhere (see al26_tpu_torch.units)

Dead stars / discs / empty slots are masks — shapes never change.

`state_from_numpy` / `aux_from_numpy` take what al26_tpu's
`cluster_to_numpy` and SimAux fields give as numpy arrays, so both
packages can start from the same bits (the port's counterpart of weight
conversion).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# isotope indices
ISO_26AL = 0
ISO_60FE = 1
N_ISO = 2

# channel indices
CH_LOCAL = 0
CH_GLOBAL = 1
CH_SNE = 2
CH_AGB = 3
N_CH = 4

CHANNEL_NAMES = ("local", "global", "sne", "agb")
ISO_NAMES = ("26al", "60fe")


@dataclass
class Cluster:
    """Per-star state. All tensors have leading dimension N (stars)."""

    # -- dynamics ----------------------------------------------------------
    pos: torch.Tensor            # [N,3] pc
    vel: torch.Tensor            # [N,3] pc/Myr
    mass: torch.Tensor           # [N]   Msun (current — drops with wind loss/SN)
    # -- stellar evolution -------------------------------------------------
    m0: torch.Tensor             # [N]   Msun initial mass (track lookup key)
    mdot: torch.Tensor           # [N]   Msun/Myr wind mass-loss rate (>=0)
    kicked: torch.Tensor         # [N]   bool: SN already processed (al26:1543)
    # -- discs -------------------------------------------------------------
    r_disk: torch.Tensor         # [N]   pc
    tau_disk: torch.Tensor       # [N]   Myr, pre-drawn disc lifetime
    disk_alive: torch.Tensor     # [N]   bool
    m_disk_gas: torch.Tensor     # [N]   Msun (0.1 * m,  al26:1545)
    m_disk_dust: torch.Tensor    # [N]   Msun (0.01 * gas, al26:1546)
    # -- stable isotopes ---------------------------------------------------
    mass_27al: torch.Tensor      # [N]   Msun (8.5e-6 m, al26:1555)
    mass_56fe: torch.Tensor      # [N]   Msun (1.828e-4 m, al26:1567)
    # -- SLR reservoirs ----------------------------------------------------
    slr: torch.Tensor            # [N,S,C]  Msun, decaying accumulators
    slr_final: torch.Tensor      # [N,S,C]  Msun, snapshot at disc death
    agb_raw: torch.Tensor        # [N,S]    Msun, AGB channel without decay
    # -- per-star yield data (set at init for massive stars) ----------------
    wind_ratio: torch.Tensor     # [N,S]  dimensionless SLR fraction of wind
    sn_yield: torch.Tensor       # [N,S]  Msun instantaneous SN SLR yield
    total_wind_loss: torch.Tensor  # [N]  Msun (m0 - m_remnant, al26:467-493)
    # -- flags ---------------------------------------------------------
    is_interloper: torch.Tensor  # [N] bool

    @property
    def n(self) -> int:
        return self.pos.shape[-2]

    # -- mass-class masks (al26_nbody.py:1194-1216) -----------------------
    def high_mass_mask(self, threshold: float = 13.0) -> torch.Tensor:
        """CURRENT-mass classification (the reference's
        get_high_mass_star_indices rule). The step's wind/SN source
        validity is INITIAL-mass based (SimAux.hm_slot_valid)."""
        return self.mass >= threshold

    def low_mass_mask(self, lo: float = 0.1, hi: float = 3.0) -> torch.Tensor:
        return (self.mass >= lo) & (self.mass <= hi) & ~self.is_interloper

    def replace(self, **kw) -> "Cluster":
        return dataclasses.replace(self, **kw)


@dataclass
class SimState:
    """Full simulation state advanced by `step`."""

    cluster: Cluster
    time: torch.Tensor           # scalar, Myr
    step_count: torch.Tensor     # scalar int32

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def empty_cluster(n: int, dtype=torch.float64, *, device) -> Cluster:
    """Allocate a zeroed cluster of n stars on `device`."""
    f = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    b = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=device)
    return Cluster(
        pos=f(n, 3), vel=f(n, 3), mass=f(n),
        m0=f(n), mdot=f(n), kicked=b(n),
        r_disk=f(n), tau_disk=f(n), disk_alive=b(n),
        m_disk_gas=f(n), m_disk_dust=f(n),
        mass_27al=f(n), mass_56fe=f(n),
        slr=f(n, N_ISO, N_CH), slr_final=f(n, N_ISO, N_CH),
        agb_raw=f(n, N_ISO),
        wind_ratio=f(n, N_ISO), sn_yield=f(n, N_ISO),
        total_wind_loss=f(n),
        is_interloper=b(n),
    )


def cluster_to_numpy(c: Cluster) -> dict:
    """Pull a cluster to the host as a dict of numpy arrays."""
    return {
        fld.name: getattr(c, fld.name).detach().cpu().numpy()
        for fld in dataclasses.fields(c)
    }


def cluster_from_numpy(d: dict, dtype=torch.float64, *, device) -> Cluster:
    """Inverse of cluster_to_numpy: bool fields stay bool, every other
    field becomes `dtype` on `device` (always a copy of the array)."""
    kw = {}
    for fld in dataclasses.fields(Cluster):
        a = np.asarray(d[fld.name])
        if a.dtype == np.bool_:
            kw[fld.name] = torch.tensor(a, device=device)
        else:
            kw[fld.name] = torch.tensor(a, dtype=dtype, device=device)
    return Cluster(**kw)


def state_from_numpy(cluster_np: dict, time, step_count, *,
                     dtype=torch.float64, device) -> SimState:
    """SimState from a cluster dict of numpy arrays (al26_tpu's
    `cluster_to_numpy` output or ours), a time (Myr) and a step count."""
    return SimState(
        cluster=cluster_from_numpy(cluster_np, dtype, device=device),
        time=torch.tensor(np.asarray(time), dtype=dtype, device=device),
        step_count=torch.tensor(np.asarray(step_count), dtype=torch.int32,
                                device=device),
    )


def aux_from_numpy(aux_np: dict, *, device):
    """sim.init.SimAux from a dict of numpy arrays keyed by the SimAux
    field names (al26_tpu's SimAux fields pulled to the host, or ours).
    `stellar_tbl` is a sequence of the seven PhaseTable arrays. Every
    array keeps its numpy dtype: index slots int32, the stellar table in
    the precision it was computed in."""
    from .models.stellar.evolution import PhaseTable
    from .sim.init import SimAux

    t = lambda a: torch.tensor(np.asarray(a), device=device)
    kw = {fld.name: t(aux_np[fld.name])
          for fld in dataclasses.fields(SimAux) if fld.name != "stellar_tbl"}
    kw["stellar_tbl"] = PhaseTable(*(t(a) for a in aux_np["stellar_tbl"]))
    return SimAux(**kw)
