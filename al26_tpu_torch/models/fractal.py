"""Fractal cluster initial conditions (Goodwin & Whitworth 2004); port of
al26_tpu.models.fractal.

The reference obtains fractal ICs from the AMUSE `fractalcluster` Fortran
worker (`new_fractal_cluster_model`, al26_nbody.py:1521-1526) with a
`--fractal_dimension` flag. The same box-splitting algorithm runs here on
the host in numpy, from the same `rng` draws as the JAX package, so both
packages build the same cluster from one seed:

  1. A root parent sits at the centre of a cube of side 2.
  2. Each parent spawns 2^3 children at its sub-cube centres (plus noise);
     a child "matures" with probability 2^(D-3) where D is the fractal
     dimension (D=3.0 -> uniform, D<3 -> clumpy).
  3. Recurse until the surviving generation holds >= 2N candidates; the
     cluster is a random N-subset of those INSIDE the unit sphere (the
     inscribed sphere of the construction cube — cube corners are cut).
  4. Velocities: children inherit the parent velocity plus a random
     component that shrinks by 1/2 each generation (GW04 §2.2), giving
     correlated kinematic substructure; finally positions are scaled so
     the VIRIAL radius equals Rc (the AMUSE N-body-units convention the
     reference's nbody_to_si converter assumes) and velocities set
     Q = -T/U = 0.5.

The one O(N^2) piece, the potential energy of the virial scaling, runs on
the caller's torch device (`_potential_energy`); never as host numpy,
which takes minutes at N = 4e5.
"""
from __future__ import annotations

import numpy as np
import torch

from ..units import G_INTERNAL

_CHILD_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-1, 1) for dy in (-1, 1) for dz in (-1, 1)],
    dtype=np.float64,
)


def _grow_generations(
    rng: np.random.Generator, n: int, fractal_dimension: float,
    noise: float = 0.3, max_restarts: int = 200,
):
    """Run box-splitting until a generation holds >= 2n candidates."""
    p_mature = 2.0 ** (fractal_dimension - 3.0)
    for _ in range(max_restarts):
        pos = np.zeros((1, 3))
        vel = np.zeros((1, 3))
        delta = 0.5  # child offset scale for generation 1 (cube side 2)
        vel_scale = 1.0
        generation = 0
        while len(pos) < 2 * n and generation < 40:
            generation += 1
            n_par = len(pos)
            child_pos = (
                pos[:, None, :]
                + delta * _CHILD_OFFSETS[None, :, :]
                + rng.normal(0.0, noise * delta, size=(n_par, 8, 3))
            ).reshape(-1, 3)
            child_vel = (
                vel[:, None, :]
                + vel_scale * rng.normal(0.0, 1.0, size=(n_par, 8, 3))
            ).reshape(-1, 3)
            survive = rng.uniform(size=len(child_pos)) < p_mature
            if not np.any(survive):
                break  # lineage died out; restart
            pos, vel = child_pos[survive], child_vel[survive]
            delta *= 0.5
            vel_scale *= 0.5
        if len(pos) >= 2 * n:
            return pos, vel
        # lineage died out below the 2n candidate pool: restart
    raise RuntimeError(
        "fractal generator failed to reach the requested star count; "
        "check fractal_dimension"
    )


def fractal_positions_velocities(
    rng: np.random.Generator,
    n: int,
    rc_pc: float,
    total_mass_msun: float,
    fractal_dimension: float = 2.0,
    *,
    device,
    dtype=torch.float64,
) -> tuple[np.ndarray, np.ndarray]:
    """Sample a fractal cluster; returns (pos [N,3] pc, vel [N,3] pc/Myr)
    as f64 numpy, virialised (Q = 0.5) with VIRIAL radius Rc — the AMUSE
    N-body-units convention the reference's nbody_to_si(Rc, M) converter
    assumes (al26_nbody.py:1516-1526), same as the Plummer model.
    `device` and `dtype` (the run's) run the potential-energy sweep of
    the virial scaling."""
    for _ in range(200):
        pos, vel = _grow_generations(rng, n, fractal_dimension)
        inside = np.linalg.norm(pos, axis=1) <= 1.0
        if int(inside.sum()) >= n:
            pos, vel = pos[inside], vel[inside]
            break
    else:
        raise RuntimeError(
            "fractal generator: unit-sphere cut repeatedly left fewer "
            "than n stars; check fractal_dimension"
        )

    # random subset of exactly n
    sel = rng.permutation(len(pos))[:n]
    pos, vel = pos[sel], vel[sel]

    # barycentre frame
    pos -= pos.mean(axis=0)
    vel -= vel.mean(axis=0)

    # scale so the VIRIAL radius equals Rc (U scales exactly as 1/s), then
    # set Q = -T/U = 0.5, with equal masses m = M/n (IMF masses assigned
    # afterwards, mirroring the reference flow al26_nbody.py:1521-1530)
    m = np.full(n, total_mass_msun / n)
    u = _potential_energy(pos, m, device=device, dtype=dtype)
    r_vir_now = -G_INTERNAL * total_mass_msun**2 / (2.0 * u)
    s = rc_pc / r_vir_now
    pos = pos * s
    u = u / s
    t_kin = 0.5 * np.sum(m * np.sum(vel * vel, axis=1))
    target_t = -0.5 * u  # Q = 0.5
    if t_kin > 0:
        vel = vel * np.sqrt(target_t / t_kin)
    return pos, vel


def _potential_energy(pos: np.ndarray, mass: np.ndarray, *, device,
                      dtype) -> float:
    """U = 1/2 sum_i m_i pot_i (eps2 = 1e-30) for the virial scaling, in
    the run's dtype (as the JAX package's follows its ambient precision).

    On a CUDA device in f32 the per-star potentials come from one sweep of
    the direct-sum kernel (ops.cuda_nbody, about a third of a second at
    N = 4e5 on an H100); elsewhere from the row-chunked plain sweep on
    `device`. The sum over stars is taken in f64 either way."""
    from ..ops import cuda_nbody

    device = torch.device(device)
    p = torch.as_tensor(pos, dtype=dtype, device=device)
    m = torch.as_tensor(mass, dtype=dtype, device=device)
    if cuda_nbody.use_kernel(len(p), dtype, device):
        # the FMA body: only the potential is wanted, and at eps2 = 1e-30
        # the matmul body's unsoftened weights would only cost
        _, _, pot = cuda_nbody.kernel_acc_jerk_pot(
            p, torch.zeros_like(p), m, 1e-30, with_jerk=False,
            use_mxu=False)
    else:
        from ..ops.nbody import potential_chunked

        # rows per chunk so the [rows, N, 3] temporaries stay small
        pot = potential_chunked(p, m, 1e-30,
                                block=max(1, min(1024, (1 << 22) // len(p))))
    m64 = torch.as_tensor(mass, dtype=torch.float64, device=device)
    return float(0.5 * torch.sum(m64 * pot.double()))
