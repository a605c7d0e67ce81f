"""Direct-summation N-body gravity in plain PyTorch (port of
al26_tpu.ops.nbody).

This is the reference force of the port and the oracle for the CUDA
kernels (ops.cuda_nbody): dense O(N^2) for small N, row-chunked beyond,
plus the cluster diagnostics and the force cache's exact mass-delta
correction. All functions are dtype-preserving and run on the device of
their inputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..units import G_INTERNAL


def _pair_terms(dx, r2):
    """inv_r, inv_r3 with the self-interaction (r2 == eps2 on diagonal)
    handled by the caller via masking."""
    inv_r = torch.rsqrt(r2)
    inv_r3 = inv_r / r2
    return inv_r, inv_r3


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def acc_pot_dense(
    pos: torch.Tensor,
    mass: torch.Tensor,
    eps2: float | torch.Tensor = 0.0,
    g: float = G_INTERNAL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accelerations [N,3] and per-particle potentials [N] by dense O(N^2).
    Potential excludes the self term: pot_i = -G sum_{j!=i} m_j / r_ij."""
    n = pos.shape[0]
    dx = pos[None, :, :] - pos[:, None, :]          # x_j - x_i
    r2 = torch.sum(dx * dx, dim=-1) + eps2
    inv_r, inv_r3 = _pair_terms(dx, r2)
    eye = _eye(n, pos.device)
    inv_r = torch.where(eye, 0.0, inv_r)
    inv_r3 = torch.where(eye, 0.0, inv_r3)
    acc = g * torch.einsum("ij,ijk->ik", mass[None, :] * inv_r3, dx)
    pot = -g * torch.sum(mass[None, :] * inv_r, dim=1)
    return acc, pot


def acc_jerk_pot_dense(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    eps2: float | torch.Tensor = 0.0,
    g: float = G_INTERNAL,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Accelerations, jerks and potentials for the Hermite scheme.

    jerk_i = G sum_j m_j [ v_ij/r^3 - 3 (x_ij . v_ij) x_ij / r^5 ]
    """
    n = pos.shape[0]
    dx = pos[None, :, :] - pos[:, None, :]
    dv = vel[None, :, :] - vel[:, None, :]
    r2 = torch.sum(dx * dx, dim=-1) + eps2
    inv_r, inv_r3 = _pair_terms(dx, r2)
    eye = _eye(n, pos.device)
    inv_r = torch.where(eye, 0.0, inv_r)
    inv_r3 = torch.where(eye, 0.0, inv_r3)
    xv = torch.sum(dx * dv, dim=-1)                  # x_ij . v_ij
    mj3 = mass[None, :] * inv_r3
    r2_safe = torch.where(eye, 1.0, r2)              # diagonal: 0/0 guard
    acc = g * torch.einsum("ij,ijk->ik", mj3, dx)
    jerk = g * (
        torch.einsum("ij,ijk->ik", mj3, dv)
        - 3.0 * torch.einsum("ij,ijk->ik", mj3 * xv / r2_safe, dx)
    )
    pot = -g * torch.sum(mass[None, :] * inv_r, dim=1)
    return acc, jerk, pot


def _row_block_acc_jerk_pot(pos_i, vel_i, pos, vel, mass, eps2, g, self_rows,
                            pot_eps2=None, col_offset=0, with_jerk=True,
                            with_pot=True):
    """Force on a row block [B,3] from all sources [N,3].

    `self_rows` gives the global indices of the block rows so the self pair
    can be masked out exactly; `col_offset` is the global index of the
    FIRST source column. `pot_eps2` softens the potential separately from
    the forces (1e-30 ~ unsoftened), in the JAX package's form
    r2 - eps2 + pot_eps2 (the kernels form d2 + pot_eps2 instead).
    `with_pot=False` skips the potential reduction."""
    n = pos.shape[0]
    dx = pos[None, :, :] - pos_i[:, None, :]
    dv = vel[None, :, :] - vel_i[:, None, :]
    r2 = torch.sum(dx * dx, dim=-1) + eps2
    inv_r = torch.rsqrt(r2)
    inv_r3 = inv_r / r2
    cols = col_offset + torch.arange(n, device=pos.device)
    self_mask = cols[None, :] == self_rows[:, None].to(cols.dtype)
    inv_r = torch.where(self_mask, 0.0, inv_r)
    inv_r3 = torch.where(self_mask, 0.0, inv_r3)
    mj3 = mass[None, :] * inv_r3
    acc = g * torch.einsum("ij,ijk->ik", mj3, dx)
    if with_jerk:
        xv = torch.sum(dx * dv, dim=-1)
        r2_safe = torch.where(self_mask, 1.0, r2)    # diagonal: 0/0 guard
        jerk = g * (
            torch.einsum("ij,ijk->ik", mj3, dv)
            - 3.0 * torch.einsum("ij,ijk->ik", mj3 * xv / r2_safe, dx)
        )
    else:
        jerk = torch.zeros_like(acc)
    if not with_pot:
        return acc, jerk, torch.zeros(pos_i.shape[0], dtype=pos_i.dtype,
                                      device=pos_i.device)
    if pot_eps2 is None:
        inv_rp = inv_r
    else:
        r2p = r2 - eps2 + pot_eps2
        inv_rp = torch.where(self_mask, 0.0, torch.rsqrt(r2p))
    pot = -g * torch.sum(mass[None, :] * inv_rp, dim=1)
    return acc, jerk, pot


def acc_jerk_pot_chunked(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    eps2: float | torch.Tensor = 0.0,
    g: float = G_INTERNAL,
    block: int = 1024,
    *,
    pot_eps2=None,
    with_jerk: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(N^2) force/jerk/potential with O(N*block) memory: a loop over row
    blocks (the last one ragged; no padding rows are needed). `pot_eps2`
    and `with_jerk` as in _row_block_acc_jerk_pot (the per-row sums do not
    depend on the blocking)."""
    n = pos.shape[0]
    outs = []
    for s in range(0, n, block):
        idx = torch.arange(s, min(s + block, n), device=pos.device)
        outs.append(_row_block_acc_jerk_pot(pos[idx], vel[idx], pos, vel,
                                            mass, eps2, g, idx,
                                            pot_eps2=pot_eps2,
                                            with_jerk=with_jerk))
    acc, jerk, pot = (torch.cat(x, 0) for x in zip(*outs))
    return acc, jerk, pot


def acc_jerk_pot(
    pos, vel, mass, eps2=0.0, g=G_INTERNAL, block: Optional[int] = None
):
    """Dispatch dense vs chunked on a size threshold."""
    n = pos.shape[0]
    if block is None:
        block = 1024
    if n <= 2048:
        return acc_jerk_pot_dense(pos, vel, mass, eps2, g)
    return acc_jerk_pot_chunked(pos, vel, mass, eps2, g, block)


# ---------------------------------------------------------------------------
# Cluster diagnostics (replacing AMUSE particle-set builtins,
# al26_nbody.py:770 virial_radius, al26_plot.py:281-299 energies)
# ---------------------------------------------------------------------------
def potential_chunked(pos, mass, eps2=0.0, g=G_INTERNAL,
                      block: int = 1024) -> torch.Tensor:
    """Per-particle potentials with O(N*block) memory."""
    n = pos.shape[0]
    cols = torch.arange(n, device=pos.device)
    outs = []
    for s in range(0, n, block):
        idx = cols[s:s + block]
        dx = pos[None, :, :] - pos[idx][:, None, :]
        r2 = torch.sum(dx * dx, dim=-1) + eps2
        inv_r = torch.rsqrt(r2)
        inv_r = torch.where(cols[None, :] == idx[:, None], 0.0, inv_r)
        outs.append(-g * torch.sum(mass[None, :] * inv_r, dim=1))
    return torch.cat(outs, 0)


def potential_energy(pos, mass, eps2=0.0, g=G_INTERNAL) -> torch.Tensor:
    """Total potential energy U = 1/2 sum_i m_i pot_i. Dense for small N,
    row-chunked beyond."""
    if pos.shape[0] <= 2048:
        _, pot = acc_pot_dense(pos, mass, eps2, g)
    else:
        pot = potential_chunked(pos, mass, eps2, g)
    return 0.5 * torch.sum(mass * pot)


def kinetic_energy(vel, mass) -> torch.Tensor:
    return 0.5 * torch.sum(mass * torch.sum(vel * vel, dim=-1))


def total_energy(pos, vel, mass, eps2=0.0, g=G_INTERNAL) -> torch.Tensor:
    return kinetic_energy(vel, mass) + potential_energy(pos, mass, eps2, g)


def virial_radius(pos, mass, g=G_INTERNAL) -> torch.Tensor:
    """R_vir = -G M^2 / (2 U), matching AMUSE particles.virial_radius()
    used each step by the reference (al26_nbody.py:770). Unsoftened."""
    u = potential_energy(pos, mass, 0.0, g)
    mtot = torch.sum(mass)
    return -g * mtot * mtot / (2.0 * u)


def center_of_mass(pos, mass) -> torch.Tensor:
    return torch.sum(pos * mass[:, None], dim=0) / torch.sum(mass)


def half_mass_radius(pos, mass) -> torch.Tensor:
    """Radius enclosing half the total mass about the barycentre
    (al26_nbody.py:1336-1363). Sort-based."""
    com = center_of_mass(pos, mass)
    d2 = torch.sum((pos - com) ** 2, dim=-1)
    order = torch.argsort(d2)
    csum = torch.cumsum(mass[order], dim=0)
    target = 0.5 * torch.sum(mass)
    idx = torch.searchsorted(csum, target.reshape(1))[0]
    idx = torch.clamp(idx, 0, pos.shape[0] - 1)
    return torch.sqrt(d2[order[idx]])


def min_intercept_time(pos, vel, lm_mask, hm_mask) -> torch.Tensor:
    """Minimum straight-line intercept time d_ij / |v_i| over (low-mass,
    high-mass) pairs — the reference's experimental adaptive-timestep
    criterion (`calc_min_intercept_time`, al26_nbody.py:1116-1154).
    Dense; a diagnostic or a timestep bound."""
    d2 = torch.sum((pos[:, None, :] - pos[None, :, :]) ** 2, dim=-1)
    spd2 = torch.sum(vel * vel, dim=-1)
    pair = lm_mask[:, None] & hm_mask[None, :]
    t2 = torch.where(pair, d2 / torch.clamp(spd2[:, None], min=1e-30),
                     torch.inf)
    return torch.sqrt(torch.min(t2))


LOCAL_DENSITY_BLOCK_ELEMS = 1 << 26   # d2 entries a row block holds


def local_density_block(n: int) -> int:
    """Rows a block of `nearest_neighbours` takes at N = n: at most 2^26
    d2 entries (the [B, N, 3] f64 differences are 1.6 GB; 163 rows at
    N = 409600)."""
    return max(1, min(n, LOCAL_DENSITY_BLOCK_ELEMS // max(n, 1)))


def nearest_neighbours(pos, k: int = 10, block: int | None = None,
                       rows=None):
    """The k nearest other stars of every row (or of the row indices
    `rows`), by blocks of `block` rows (default `local_density_block(N)`):
    a block's squared distances to all N columns and their k + 1 smallest
    (neighbour 0 is the star itself). Returns (indices [R, k], squared
    distances [R, k]), nearest first. Peak memory O(block * N); a row's
    result does not depend on the blocks, since it sees the same columns
    in the same order. A tie at the k-th neighbour is resolved by index
    order in neither this nor the JAX package (torch.topk,
    jax.lax.top_k)."""
    n = pos.shape[0]
    block = local_density_block(n) if block is None else block
    if rows is None:
        rows = torch.arange(n, device=pos.device)
    nbrs, d2s = [], []
    for s in range(0, rows.shape[0], block):
        d2 = torch.sum((pos[rows[s:s + block], None, :] - pos[None, :, :])
                       ** 2, dim=-1)
        top = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True)
        nbrs.append(top.indices[:, 1:k + 1])
        d2s.append(top.values[:, 1:k + 1])
    return torch.cat(nbrs, 0), torch.cat(d2s, 0)


def local_densities(pos, mass, k: int = 10,
                    block: int | None = None) -> torch.Tensor:
    """10th-nearest-neighbour local mass density per star
    (al26_plot.py:324-371): rho_i = sum(mass of k nearest) / (4/3 pi d_k^3),
    the neighbours from `nearest_neighbours` by row blocks. Each row's
    value is that of one dense [N, N] sweep. The JAX counterpart
    (al26_tpu/ops/nbody.py local_densities) forms [N, N, 3] at once (R6:
    252 GB in f64 at N = 102400)."""
    nbr, d2 = nearest_neighbours(pos, k, block)
    m_sum = torch.sum(mass[nbr], dim=1)
    d_k = torch.sqrt(d2[:, -1])
    four_thirds_pi = 4.18879020479  # constant as written in al26_plot.py:327
    return m_sum / (four_thirds_pi * d_k**3)


def _mass_delta_block(acc, jerk, pot, pos_b, vel_b, targets_b, xs, vs,
                      src_idx, dm, eps2, g, group_size, pot_softened):
    """mass_delta_correction body on a row block [B] of the N targets. The
    per-row reduction over the M sources is independent of the block
    split."""
    dx = xs[None, :, :] - pos_b[:, None, :]     # [B,M,3]
    d2 = torch.sum(dx * dx, dim=-1)             # [B,M]
    r2 = torch.clamp(d2 + eps2, min=1e-30)
    invalid = targets_b[:, None] == src_idx[None, :]        # self pairs
    if group_size > 0:
        invalid = invalid | (torch.div(targets_b[:, None], group_size,
                                       rounding_mode="floor")
                             != torch.div(src_idx[None, :], group_size,
                                          rounding_mode="floor"))
    invr = torch.where(invalid, 0.0, torch.rsqrt(r2))
    w = dm[None, :] * invr * invr * invr        # [B,M]
    acc = acc + g * torch.einsum("nm,nmk->nk", w, dx)
    if jerk is not None:
        dv = vs[None, :, :] - vel_b[:, None, :]
        s = 3.0 * torch.sum(dx * dv, dim=-1) / r2
        jerk = jerk + g * (torch.einsum("nm,nmk->nk", w, dv)
                           - torch.einsum("nm,nmk->nk", w * s, dx))
    if pot_softened:
        pot = pot - g * (invr @ dm)
    else:
        # the raw distance from d2, not the JAX form r2 - eps2: in f32 that
        # cancels to 0 for d2 below half an ulp of eps2 and the term becomes
        # dm * 1e15 (a positive potential, a negative virial radius)
        invr_u = torch.where(invalid, 0.0, torch.rsqrt(d2 + 1e-30))
        pot = pot - g * (invr_u @ dm)
    return acc, jerk, pot


# auto row-chunk threshold: above ~2^23 (N*M) pair terms the [N,M,3]
# broadcast temporaries stop being small
_MDC_DENSE_MAX = 1 << 23


def mass_delta_correction(acc, jerk, pot, pos, vel, src_idx, dm,
                          eps2, g=G_INTERNAL, group_size: int = 0,
                          pot_softened: bool = False,
                          block: int | None = None):
    """Exact update of a cached force evaluation for SOURCE-MASS changes at
    fixed positions.

    Pairwise gravity is linear in the source masses, so when only the M
    mass-evolving stars change between steps, the previous step's closing
    (acc, jerk, pot) evaluation becomes this step's opening one after
    adding the delta-mass contributions — O(N*M) work instead of a fresh
    O(N^2) sweep (sim/step.py force cache).

    Conventions match the kernels: acc/jerk softened by eps2; pot
    unsoftened by default, or eps2-softened with `pot_softened=True`.
    `jerk=None` skips the jerk update (leapfrog cache). `dm` must already
    be zero for padding slots. group_size > 0 restricts pairs to the same
    realization.

    `block` bounds the memory footprint by looping over row blocks of the
    N targets (each per-row sum over M is the same math): None
    auto-chunks above _MDC_DENSE_MAX pair terms, 0 forces the dense
    path."""
    n = pos.shape[0]
    m = src_idx.shape[0]
    xs = pos[src_idx]                           # [M,3]
    vs = vel[src_idx]
    targets = torch.arange(n, dtype=src_idx.dtype, device=pos.device)
    if block is None and n * m > _MDC_DENSE_MAX:
        block = max(1024, _MDC_DENSE_MAX // max(m, 1))
    if not block or block >= n:
        return _mass_delta_block(acc, jerk, pot, pos, vel, targets, xs, vs,
                                 src_idx, dm, eps2, g, group_size,
                                 pot_softened)
    outs = []
    for s in range(0, n, block):
        sl = slice(s, min(s + block, n))
        outs.append(_mass_delta_block(
            acc[sl], None if jerk is None else jerk[sl], pot[sl], pos[sl],
            vel[sl], targets[sl], xs, vs, src_idx, dm, eps2, g, group_size,
            pot_softened))
    acc_o, jerk_o, pot_o = zip(*outs)
    return (torch.cat(acc_o, 0),
            None if jerk is None else torch.cat(jerk_o, 0),
            torch.cat(pot_o, 0))
