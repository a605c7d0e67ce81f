"""Direct-summation force kernels: the CUDA counterpart of
al26_tpu/ops/pallas_nbody.py.

Two hand-written Hopper kernels live in `al26_tpu_torch/csrc/nbody.cu`
(its header says what each replaces, what bounds it and how its grid is
shaped):

  * `nbody_rows`     — acc / jerk / potential of B target rows against all
    N sources (the full sweep, and the fast-group row sweeps); with
    `group_size` gs > 0 only against the sources of each row's own group
    (global id // gs): the block-diagonal windows of a flattened ensemble
    of realizations of gs stars, launches counted under
    `LAUNCHES["nbody_rows_group"]`;
  * `nbody_predcols` — acc / jerk of K fast rows against N source columns
    Hermite-predicted to offset tau inside the kernel (the hermite4_block
    subcycle, one launch per substep).

The source is compiled by nvcc for sm_90a at first use into
`al26_tpu_torch/_build/` (ops.cuda_build: a shared library named after a
hash of the source, so an edited .cu rebuilds) and bound with ctypes. A
missing nvcc or a failed build raises; nothing falls back.

Every wrapper checks device, dtype (f32), shape and contiguity. On a CUDA
tensor it launches its kernel (or raises); on a CPU tensor it runs the
plain PyTorch version beside it (`nbody_rows_plain`, `nbody_predcols_plain`),
the counterpart of Pallas interpret mode. `LAUNCHES` counts the kernel
launches of each wrapper and nothing else.

The JAX package's entry points and factories keep their names and
layouts (pos [N,3]): `kernel_acc_jerk_pot(_rows)` for
`pallas_acc_jerk_pot(_rows)`, and `make_pallas_force`, `make_pallas_acc`,
`make_pallas_force_rows`, `make_pred_force_rows`. The matmul reduction of
kernels 1 and 2 (`use_mxu=True`) is not ported; asking for it raises
NotImplementedError (ROADMAP queue 2).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..units import G_INTERNAL
from . import cuda_build

LAUNCHES = {"nbody_rows": 0, "nbody_rows_group": 0, "nbody_predcols": 0}

# must match TB / TJ in csrc/nbody.cu: rows per block, columns per tile
_TB = 128
_TJ = 256
# column splits are chosen so a launch has at least this many blocks
# (4 per SM of an H100)
_TARGET_BLOCKS = 4 * 132
# plain versions: rows per chunk so a [rows, N] temporary stays <= 2^22
_PLAIN_CHUNK_ELEMS = 1 << 22

_lib = None


def use_kernel(n: int, dtype, device) -> bool:
    """Should the direct-sum kernels run here: a CUDA device and f32 data,
    at every N (the N above which the kernel beats the plain path on the
    card is not measured yet)."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


# --------------------------------------------------------------------------
# build and bind
# --------------------------------------------------------------------------

def load():
    """Build csrc/nbody.cu (if needed) and bind its library, once per
    process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(cuda_build.build("nbody.cu"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nbody_rows_launch.argtypes = [
        p, p, p, i,           # rows_pos, rows_vel, row_ids, b
        p, p, p, i,           # pos, vel, mass, n
        f, f, f,              # eps2, pot_eps2, g
        i, i, i, i,           # with_jerk, with_pot, sep_pot, group_size
        p, i,                 # partial, splits
        p, p, p, p,           # acc, jerk, pot, stream
    ]
    lib.nbody_rows_launch.restype = i
    lib.nbody_predcols_launch.argtypes = [
        p, p, p, i,           # rows_pos, rows_vel, row_ids, b
        p, p, p, p, p, i,     # pos0, vel0, acc0, jerk0, mass, n
        p, f, f,              # tau, eps2, g
        p, i,                 # partial, splits
        p, p, p,              # acc, jerk, stream
    ]
    lib.nbody_predcols_launch.restype = i
    _lib = lib
    return lib


def _splits(b: int, n: int, group_size: int = 0) -> int:
    """Column splits: enough blocks to fill the card when the row count is
    small (fast-group calls), never more splits than column tiles. With
    group windows the splits divide a block's window: in a full sweep
    (contiguous rows) at most ceil((TB - 1) / gs) + 1 groups, while a row
    subset may scatter over all of [0, n) (the fast group)."""
    if group_size > 0 and b >= n:
        n = min(n, (-(-(_TB - 1) // group_size) + 1) * group_size)
    row_blocks = -(-b // _TB)
    tiles = -(-n // _TJ)
    return max(1, min(-(-_TARGET_BLOCKS // row_blocks), tiles))


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(pos_rows, vel_rows, row_ids, cols):
    """Shared argument checks; returns (b, n, device)."""
    device = pos_rows.device
    b, n = pos_rows.shape[0], cols[-1][1].shape[0]
    f32 = torch.float32
    _check("pos_rows", pos_rows, (b, 3), f32, device)
    _check("vel_rows", vel_rows, (b, 3), f32, device)
    _check("row_ids", row_ids, (b,), torch.int32, device)
    for name, t in cols[:-1]:
        _check(name, t, (n, 3), f32, device)
    _check("mass", cols[-1][1], (n,), f32, device)
    return b, n, device


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the comparison on the card)
# --------------------------------------------------------------------------

def _group(ids: torch.Tensor, group_size: int) -> torch.Tensor:
    """Group of each global id (id // gs; -1 for a padding id of -1)."""
    return torch.div(ids.long(), group_size, rounding_mode="floor")


def _pair_sums(xi, vi, ids, px, pv, mass, eps2, pot_eps2, with_jerk,
               with_pot, col0: int = 0, group_size: int = 0):
    """The kernels' per-pair arithmetic on a [C] x [N] block of rows and
    columns (same masks, same FMA-form expressions); returns the unscaled
    sums (acc, jerk, pot) of the rows. The columns are global ids col0,
    col0 + 1, ...; group_size > 0 keeps only the pairs of one group."""
    n = px.shape[0]
    dx = px[None, :, 0] - xi[:, 0, None]
    dy = px[None, :, 1] - xi[:, 1, None]
    dz = px[None, :, 2] - xi[:, 2, None]
    d2 = dx * dx + dy * dy + dz * dz
    cols = col0 + torch.arange(n, device=xi.device)
    valid = cols[None, :] != ids[:, None].to(cols.dtype)
    if group_size > 0:
        valid &= _group(cols, group_size)[None, :] == _group(
            ids, group_size)[:, None]
    inv_r = torch.where(valid, torch.rsqrt(d2 + eps2), 0.0)
    inv_r2 = inv_r * inv_r
    w = mass[None, :] * (inv_r * inv_r2)
    acc = torch.stack([(w * dx).sum(1), (w * dy).sum(1), (w * dz).sum(1)],
                      dim=1)
    if with_jerk:
        dvx = pv[None, :, 0] - vi[:, 0, None]
        dvy = pv[None, :, 1] - vi[:, 1, None]
        dvz = pv[None, :, 2] - vi[:, 2, None]
        s = 3.0 * (dx * dvx + dy * dvy + dz * dvz) * inv_r2
        jerk = torch.stack([(w * (dvx - s * dx)).sum(1),
                            (w * (dvy - s * dy)).sum(1),
                            (w * (dvz - s * dz)).sum(1)], dim=1)
    else:
        jerk = torch.zeros_like(acc)
    if not with_pot:
        pot = torch.zeros_like(acc[:, 0])
    elif pot_eps2 is None:
        pot = -(mass[None, :] * inv_r).sum(1)
    else:
        inv_rp = torch.where(valid, torch.rsqrt(d2 + pot_eps2), 0.0)
        pot = -(mass[None, :] * inv_rp).sum(1)
    return acc, jerk, pot


def _rows_chunked(pos_rows, vel_rows, row_ids, pos, vel, mass, eps2,
                  pot_eps2, with_jerk, with_pot, col0=0, group_size=0):
    """_pair_sums over row chunks that keep a [rows, N] temporary small."""
    b, n = pos_rows.shape[0], pos.shape[0]
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(n, 1))
    outs = [_pair_sums(pos_rows[s:s + chunk], vel_rows[s:s + chunk],
                       row_ids[s:s + chunk], pos, vel, mass, eps2, pot_eps2,
                       with_jerk, with_pot, col0, group_size)
            for s in range(0, b, chunk)]
    if not outs:
        z = pos_rows.new_zeros((0, 3))
        return z, z.clone(), pos_rows.new_zeros((0,))
    return tuple(torch.cat(x, 0) for x in zip(*outs))


def nbody_rows_plain(pos_rows, vel_rows, row_ids, pos, vel, mass,
                     eps2: float, g: float = G_INTERNAL,
                     with_jerk: bool = True, with_pot: bool = True,
                     pot_eps2: float | None = None, group_size: int = 0):
    """What the nbody_rows kernel computes, in plain row-chunked PyTorch,
    in the dtype of its inputs: (acc [B,3], jerk [B,3], pot [B]). `pot_eps2`
    None softens the potential by eps2; a value softens it separately (d2
    + pot_eps2). Rows with id -1 are padding and mask no pair.

    group_size gs > 0: each row only against the columns of its own group
    (id // gs): the rows of each group present are swept over that group's
    window [g gs, (g + 1) gs) with the group mask, as the kernel's windows
    do; a padding row gets zeros."""
    if group_size <= 0:
        acc, jerk, pot = _rows_chunked(pos_rows, vel_rows, row_ids, pos, vel,
                                       mass, eps2, pot_eps2, with_jerk,
                                       with_pot)
        return g * acc, g * jerk, g * pot
    n = pos.shape[0]
    acc = pos_rows.new_zeros(pos_rows.shape)
    jerk = torch.zeros_like(acc)
    pot = pos_rows.new_zeros(pos_rows.shape[:1])
    grp = _group(row_ids, group_size)
    for gid in torch.unique(grp[grp >= 0]).tolist():
        rows = torch.nonzero(grp == gid).flatten()
        c0, c1 = gid * group_size, min(n, (gid + 1) * group_size)
        a, j, p = _rows_chunked(pos_rows[rows], vel_rows[rows],
                                row_ids[rows], pos[c0:c1], vel[c0:c1],
                                mass[c0:c1], eps2, pot_eps2, with_jerk,
                                with_pot, c0, group_size)
        acc[rows], jerk[rows], pot[rows] = a, j, p
    return g * acc, g * jerk, g * pot


def predict_columns(pos0, vel0, a0, j0, tau):
    """The Hermite column prediction nbody_predcols does while staging a
    tile: (p0 + tau v0 + tau^2/2 a0 + tau^3/6 j0, v0 + tau a0 + tau^2/2 j0),
    with the kernel's coefficient forms."""
    t2h = 0.5 * tau * tau
    t3h = t2h * tau * (1.0 / 3.0)
    return (pos0 + tau * vel0 + t2h * a0 + t3h * j0,
            vel0 + tau * a0 + t2h * j0)


def nbody_predcols_plain(pos_rows, vel_rows, row_ids, pos0, vel0, a0, j0,
                         mass, tau, eps2: float, g: float = G_INTERNAL):
    """What the nbody_predcols kernel computes, in plain PyTorch: acc and
    jerk of the rows against the columns predicted to offset `tau` (a
    0-dim tensor or a float)."""
    p, v = predict_columns(pos0, vel0, a0, j0, tau)
    acc, jerk, _ = nbody_rows_plain(pos_rows, vel_rows, row_ids, p, v, mass,
                                    eps2, g, with_pot=False)
    return acc, jerk


# --------------------------------------------------------------------------
# wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# --------------------------------------------------------------------------

def nbody_rows(pos_rows, vel_rows, row_ids, pos, vel, mass, eps2: float,
               g: float = G_INTERNAL, with_jerk: bool = True,
               with_pot: bool = True, pot_eps2: float | None = None,
               group_size: int = 0):
    """Kernel 1: (acc [B,3], jerk [B,3], pot [B]) of B f32 rows (global
    ids `row_ids`, int32, -1 = padding) against N f32 columns. Jerk and
    pot are zeros when not asked for. group_size > 0: each row only
    against its own group's columns (the block-diagonal windows)."""
    b, n, device = _check_rows(pos_rows, vel_rows, row_ids,
                               [("pos", pos), ("vel", vel), ("mass", mass)])
    group_size = max(int(group_size), 0)
    if device.type == "cpu":
        return nbody_rows_plain(pos_rows, vel_rows, row_ids, pos, vel, mass,
                                eps2, g, with_jerk, with_pot, pot_eps2,
                                group_size)
    if device.type != "cuda":
        raise ValueError(f"nbody_rows runs on cuda or cpu, not {device}")
    acc = torch.empty((b, 3), dtype=torch.float32, device=device)
    jerk = torch.empty_like(acc)
    pot = torch.empty((b,), dtype=torch.float32, device=device)
    if b == 0:
        return acc, jerk, pot
    if n == 0:
        return acc.zero_(), jerk.zero_(), pot.zero_()
    lib = load()
    splits = _splits(b, n, group_size)
    partial = torch.empty((splits, b, 7), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nbody_rows_launch(
            pos_rows.data_ptr(), vel_rows.data_ptr(), row_ids.data_ptr(), b,
            pos.data_ptr(), vel.data_ptr(), mass.data_ptr(), n,
            float(eps2), float(0.0 if pot_eps2 is None else pot_eps2),
            float(g), int(with_jerk), int(with_pot),
            int(pot_eps2 is not None), group_size,
            partial.data_ptr(), splits,
            acc.data_ptr(), jerk.data_ptr(), pot.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nbody_rows launch failed: cudaError {err}")
    LAUNCHES["nbody_rows_group" if group_size > 0 else "nbody_rows"] += 1
    return acc, jerk, pot


def nbody_predcols(pos_rows, vel_rows, row_ids, pos0, vel0, a0, j0, mass,
                   tau: torch.Tensor, eps2: float, g: float = G_INTERNAL):
    """Kernel 2: (acc [K,3], jerk [K,3]) of K f32 rows against the N
    columns predicted from the step-start (pos0, vel0, a0, j0) to offset
    `tau`, a one-element f32 tensor on the rows' device (read by the
    kernel, never by the host)."""
    b, n, device = _check_rows(
        pos_rows, vel_rows, row_ids,
        [("pos0", pos0), ("vel0", vel0), ("a0", a0), ("j0", j0),
         ("mass", mass)])
    _check("tau", tau.reshape(()), (), torch.float32, device)
    if device.type == "cpu":
        return nbody_predcols_plain(pos_rows, vel_rows, row_ids, pos0, vel0,
                                    a0, j0, mass, tau.reshape(()), eps2, g)
    if device.type != "cuda":
        raise ValueError(f"nbody_predcols runs on cuda or cpu, not {device}")
    acc = torch.empty((b, 3), dtype=torch.float32, device=device)
    jerk = torch.empty_like(acc)
    if b == 0:
        return acc, jerk
    if n == 0:
        return acc.zero_(), jerk.zero_()
    tau = tau.reshape(()).contiguous()
    lib = load()
    splits = _splits(b, n)
    partial = torch.empty((splits, b, 7), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nbody_predcols_launch(
            pos_rows.data_ptr(), vel_rows.data_ptr(), row_ids.data_ptr(), b,
            pos0.data_ptr(), vel0.data_ptr(), a0.data_ptr(), j0.data_ptr(),
            mass.data_ptr(), n, tau.data_ptr(), float(eps2), float(g),
            partial.data_ptr(), splits, acc.data_ptr(), jerk.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"nbody_predcols launch failed: cudaError {err}")
    LAUNCHES["nbody_predcols"] += 1
    return acc, jerk


# --------------------------------------------------------------------------
# the JAX package's entry points and factories
# --------------------------------------------------------------------------

def _not_ported(use_mxu: bool) -> None:
    if use_mxu:
        raise NotImplementedError(
            "use_mxu=True (the matmul reduction of kernels 1 and 2) is not "
            "ported yet (ROADMAP queue 2)")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def kernel_acc_jerk_pot_rows(
    pos_rows, vel_rows, row_ids, pos, vel, mass, eps2: float = 0.0,
    g: float = G_INTERNAL, with_jerk: bool = True, group_size: int = 0,
    pot_eps2: float | None = None, use_mxu: bool = False,
    with_pot: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forces on `pos_rows` (global ids `row_ids`, any order or subset,
    -1 = padding) from all of `pos` — pallas_acc_jerk_pot_rows. Computed
    in f32 and returned in the rows' dtype, as the Pallas path does.
    `with_pot=False` skips the potential (callers that discard it).
    `group_size` gs > 0: block-diagonal groups of gs stars (a flattened
    ensemble; gs counts an interloper), each row against its own group's
    columns only."""
    _not_ported(use_mxu)
    a, j, p = nbody_rows(
        _f32(pos_rows), _f32(vel_rows),
        row_ids.to(torch.int32).contiguous(), _f32(pos), _f32(vel),
        _f32(mass), eps2, g, with_jerk, with_pot, pot_eps2, group_size)
    dtype = pos_rows.dtype
    return a.to(dtype), j.to(dtype), p.to(dtype)


def kernel_acc_jerk_pot(
    pos, vel, mass, eps2: float = 0.0, g: float = G_INTERNAL,
    with_jerk: bool = True, group_size: int = 0,
    pot_eps2: float | None = None, use_mxu: bool = False,
    with_pot: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(acc [N,3], jerk [N,3], pot [N]) of every star — the full sweep,
    pallas_acc_jerk_pot. `pot_eps2` softens the potential separately
    (1e-30 ~ unsoftened) so one sweep serves both the integrator and the
    virial radius."""
    ids = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    return kernel_acc_jerk_pot_rows(
        pos, vel, ids, pos, vel, mass, eps2, g, with_jerk, group_size,
        pot_eps2, use_mxu, with_pot)


def make_pallas_force(mass, eps2: float = 0.0, g: float = G_INTERNAL):
    """`force_fn(pos, vel) -> (acc, jerk)` using kernel 1 (plugs into
    ops.integrators.hermite4_advance)."""
    def force_fn(pos, vel):
        a, j, _ = kernel_acc_jerk_pot(pos, vel, mass, float(eps2), g,
                                      with_pot=False)
        return a, j

    return force_fn


def make_pallas_acc(mass, eps2: float = 0.0, g: float = G_INTERNAL):
    """`acc_fn(pos) -> acc` (acceleration only) for the leapfrog path."""
    def acc_fn(pos):
        a, _, _ = kernel_acc_jerk_pot(pos, torch.zeros_like(pos), mass,
                                      float(eps2), g, with_jerk=False,
                                      with_pot=False)
        return a

    return acc_fn


def make_pallas_force_rows(mass, eps2: float = 0.0, g: float = G_INTERNAL):
    """`force_rows_fn(pos_rows, vel_rows, row_ids, pos_all, vel_all) ->
    (acc, jerk)` for the block-timestep fast-group subcycle."""
    def force_rows_fn(pr, vr, ids, p_all, v_all):
        a, j, _ = kernel_acc_jerk_pot_rows(pr, vr, ids, p_all, v_all, mass,
                                           float(eps2), g, with_pot=False)
        return a, j

    return force_rows_fn


def make_pred_force_rows(pos0, vel0, a0, j0, mass, eps2: float = 0.0,
                         g: float = G_INTERNAL, use_mxu: bool = False):
    """`rows_at(pos_rows, vel_rows, row_ids, tau) -> (acc, jerk)` with the
    column prediction fused into kernel 2. The f32 copies of the
    step-start columns are made HERE, once per step, outside the substep
    loop; each substep is then one launch. No mean-centring: it served
    only the matmul-reduction variant, which is not ported."""
    _not_ported(use_mxu)
    cols = tuple(_f32(t) for t in (pos0, vel0, a0, j0, mass))

    def rows_at(pos_rows, vel_rows, row_ids, tau):
        dtype = pos_rows.dtype
        tau32 = torch.as_tensor(tau, device=pos_rows.device).to(
            torch.float32).reshape(())
        a, j = nbody_predcols(_f32(pos_rows), _f32(vel_rows),
                              row_ids.to(torch.int32).contiguous(), *cols,
                              tau32, float(eps2), g)
        return a.to(dtype), j.to(dtype)

    return rows_at
