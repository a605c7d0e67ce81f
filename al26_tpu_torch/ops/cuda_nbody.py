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
hash of the source and its headers, so an edit rebuilds) and bound with
ctypes. A missing nvcc or a failed build raises; nothing falls back.

Every wrapper checks device, dtype (f32), shape and contiguity. On a CUDA
tensor it launches its kernel (or raises); on a CPU tensor it runs the
plain PyTorch version beside it (`nbody_rows_plain`, `nbody_predcols_plain`),
the counterpart of Pallas interpret mode. `LAUNCHES` counts the kernel
launches of each wrapper and nothing else. With tracing on
(utils.timing), each call of `nbody_rows`, `nbody_predcols` and
`PredcolsMma` is the span "kernels.nbody_rows", "kernels.nbody_predcols"
or "kernels.predcols_mma": the wrapper's host time.

The FMA bodies (kernels 1, 1b and 2) sweep on the loop they share with
the tree's near field (csrc/pair_fma.cuh), and each call is ONE launch:
the column splits are summed in a fixed order inside the kernel by the
blocks that finish last, through the zeroed ticket buffer per device the
matmul bodies use too (`_counters`). Kernels 1 and 2 take their splits
and column lanes from `fma_plan` (whole tiles, at least two a block,
whole waves of the variant's resident blocks, enough resident warps for a
few hundred rows); kernel 1b its splits from `_splits`. `rows_launcher`
and `predcols_launcher` prepare a launch's outputs, scratch and ctypes
arguments once (a timer calls the launch many times).

The matmul reduction of kernels 1 and 2 (`use_mxu=True`, the JAX
package's default and so the port's) is a third and fourth kernel in the
same source, launched by the same wrappers: `nbody_rows(..., use_mxu=True)`
(counted under `LAUNCHES["nbody_rows_mma"]`) and
`nbody_predcols(..., use_mxu=True)` (`LAUNCHES["nbody_predcols_mma"]`):
the per-pair sums as two tensor-core products against the column matrix
C8 = (x, y, z, vx, vy, vz, 1, |x|^2), after mean-centring. Their plain
versions perform the same decomposition in torch, in the input dtype
(`nbody_rows_plain(..., use_mxu=True)`, `nbody_predcols_plain(...,
use_mxu=True)`). As in the JAX package the mode is forced off under
group windows (`group_size > 0`, the entry points below). Each matmul
call is ONE launch: the column splits of `split_plan` (whole tiles,
filling whole waves of the card's resident blocks) are summed in a fixed
order inside the kernel, as the FMA bodies' are. `rows_mma_launcher`
and `PredcolsMma` prepare a launch's outputs, scratch and ctypes
arguments; `make_pred_force_rows` makes its PredcolsMma once per step, so
a substep's `rows_at` checks its rows and makes one ctypes call.

The JAX package's entry points and factories keep their names, layouts
(pos [N,3]) and defaults: `kernel_acc_jerk_pot(_rows)` for
`pallas_acc_jerk_pot(_rows)`, and `make_pallas_force`, `make_pallas_acc`,
`make_pallas_force_rows`, `make_pred_force_rows`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..units import G_INTERNAL
from ..utils.timing import spanned
from . import cuda_build

LAUNCHES = {"nbody_rows": 0, "nbody_rows_group": 0, "nbody_predcols": 0,
            "nbody_rows_mma": 0, "nbody_predcols_mma": 0,
            # the fused hermite4_block substep around kernel 2c
            # (ops.cuda_substep)
            "substep_predict": 0, "substep_correct": 0}

# must match TB / TJ in csrc/nbody.cu: rows per block, columns per tile
_TB = 128
_TJ = 256
# kernel 1b's column splits (_splits) are chosen so a launch has at least
# this many blocks (4 per SM of an H100); kernels 1, 2 and the matmul
# bodies' by split_plan
_TARGET_BLOCKS = 4 * 132
# the FMA bodies' kinds (csrc/nbody.cu KIND_*): kernel 1, 1b, 2
KIND_ROWS, KIND_GROUP, KIND_PRED = 0, 1, 2
# column lanes a row the FMA bodies of kernels 1 and 2 may take (a block
# is 128 rows x lanes threads), and the resident warps an SM that fma_plan
# asks of the fewest lanes (two lanes were never the fastest at a path's
# shape on an H100, PERF.md)
_FMA_LANES = (1, 4)
_FMA_MIN_WARPS = 16
# plain versions: rows per chunk so a [rows, N] temporary stays <= 2^22
_PLAIN_CHUNK_ELEMS = 1 << 22
# sums per row of the matmul sweep's partials (Sw[8], Sws[8], explicit pot)
_NS_MMA = 17
# column splits (split_plan): at least this many whole tiles a block where
# N allows (2 measured fastest for kernel 2c at K = 256, N = 32768 on an
# H100: 1 and 4 were slower, PERF.md), and a split count whose makespan
# (waves x tiles a block) is within this factor of the best, the fewest
# such splits
_MIN_TILES = 2
_PLAN_SLACK = 1.05
# must match RED_GROUP in csrc/nbody.cu: splits summed by one block before
# the final sum over the groups
_RED_GROUP = 16
# partial sums a row of the FMA bodies (acc, jerk, pot)
_NSUM = 7
# potential modes of the matmul sweep (csrc/nbody.cu POT_*)
POT_NONE, POT_EXPLICIT, POT_SEPARATE, POT_PRODUCT = 0, 1, 2, 3

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
        p, p, i, i, i,        # partial, counters, splits, cols_per_split,
                              # lanes
        p, p, p, p,           # acc, jerk, pot, stream
    ]
    lib.nbody_rows_launch.restype = i
    lib.nbody_predcols_launch.argtypes = [
        p, p, p, i,           # rows_pos, rows_vel, row_ids, b
        p, p, p, p, p, i,     # pos0, vel0, acc0, jerk0, mass, n
        p, f, f,              # tau, eps2, g
        p, p, i, i, i,        # partial, counters, splits, cols_per_split,
                              # lanes
        p, p, p,              # acc, jerk, stream
    ]
    lib.nbody_predcols_launch.restype = i
    lib.nbody_fma_blocks_per_sm.argtypes = [i, i, i, i, i,
                                            ctypes.POINTER(i)]
    lib.nbody_fma_blocks_per_sm.restype = i
    lib.nbody_rows_mma_launch.argtypes = [
        p, p, p, i,           # rows_pos, rows_vel, row_ids, b
        p, p, p, i,           # pos, vel, mass, n
        p, f, f, f,           # centre, eps2, pot_eps2, g
        i, i,                 # with_jerk, pot_mode
        p, p, i, i,           # partial, counters, splits, cols_per_split
        p, p, p, p,           # acc, jerk, pot, stream
    ]
    lib.nbody_rows_mma_launch.restype = i
    lib.nbody_predcols_mma_launch.argtypes = [
        p, p, p, i,           # rows_pos, rows_vel, row_ids, b
        p, p, p, p, p, i,     # pos0, vel0, acc0, jerk0, mass, n
        p, p, f, f,           # centre, tau, eps2, g
        p, p, i, i,           # partial, counters, splits, cols_per_split
        p, p, p,              # acc, jerk, stream
    ]
    lib.nbody_predcols_mma_launch.restype = i
    lib.nbody_mma_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.nbody_mma_blocks_per_sm.restype = i
    lib.substep_predict_launch.argtypes = [
        p, p, p, p,           # s0, s, w, sc
        p, p, f, i, p,        # dt, h_min, eta, k, stream
    ]
    lib.substep_predict_launch.restype = i
    lib.substep_correct_launch.argtypes = [
        p, p, p,              # w, s, sc
        p, p, p,              # mass, a1, j1
        p, p, f, f, i, p,     # dt, eps2_ptr, eps2, g, k, stream
    ]
    lib.substep_correct_launch.restype = i
    _lib = lib
    return lib


def _splits(b: int, n: int, group_size: int = 0) -> int:
    """Kernel 1b's column splits: enough blocks to fill the card when the
    row count is small (fast-group calls), never more splits than column
    tiles. The splits divide a block's window: in a full sweep (contiguous
    rows) at most ceil((TB - 1) / gs) + 1 groups, while a row subset may
    scatter over all of [0, n) (the fast group)."""
    if group_size > 0 and b >= n:
        n = min(n, (-(-(_TB - 1) // group_size) + 1) * group_size)
    row_blocks = -(-b // _TB)
    tiles = -(-n // _TJ)
    return max(1, min(-(-_TARGET_BLOCKS // row_blocks), tiles))


@functools.lru_cache(maxsize=None)
def split_plan(b: int, n: int, slots: int) -> Tuple[int, int]:
    """(splits, tiles per split) of a launch of b rows against n columns
    (a matmul body, or kernel 1 or 2's FMA body) on a card that holds
    `slots` blocks at once (SMs x resident blocks per SM). Each split is a
    run of whole TJ-column tiles from [0, n), so only the last split can
    end in a ragged tile. A block walks at least _MIN_TILES tiles where n
    allows (the sums it writes and the ordered reduction are paid once per
    block, and the double buffer has a tile to overlap), and never more
    splits than tiles. Among those, the split counts whose makespan, waves
    of `slots` blocks x tiles a block, is within _PLAN_SLACK of the least;
    of them the fewest splits (the least scratch and reduction)."""
    row_blocks = -(-b // _TB)
    tiles = max(1, -(-n // _TJ))
    plans = []
    for s in range(1, max(1, tiles // min(_MIN_TILES, tiles)) + 1):
        per = -(-tiles // s)
        splits = -(-tiles // per)
        plans.append((-(-row_blocks * splits // slots) * per, splits, per))
    best = min(p[0] for p in plans)
    return min((splits, per) for span, splits, per in plans
               if span <= _PLAN_SLACK * best)


@functools.lru_cache(maxsize=None)
def fma_plan(b: int, n: int, sms: int,
             blocks_per_sm: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(lanes, splits, tiles per split) of kernel 1 or 2's FMA body: b
    rows against n columns on a card of `sms` SMs that holds
    blocks_per_sm[i] blocks of _FMA_LANES[i] column lanes an SM. Each lane
    count's splits are split_plan's at its own slots; a block of l lanes
    has 4 l warps. The lanes: the fewest whose plan keeps at least
    _FMA_MIN_WARPS warps resident an SM over its first wave (a fast group
    of 256 rows is 2 row blocks: one lane leaves 4 warps an SM), else the
    count that keeps the most."""
    row_blocks = -(-b // _TB)
    best = None
    for count, bpsm in zip(_FMA_LANES, blocks_per_sm):
        splits, per = split_plan(b, n, sms * bpsm)
        warps = min(row_blocks * splits / sms, bpsm) * 4 * count
        if warps >= _FMA_MIN_WARPS:
            return count, splits, per
        if best is None or warps > best[0]:
            best = (warps, count, splits, per)
    return best[1:]


_SLOTS = {}
_FMA_BLOCKS = {}


def _fma_blocks_per_sm(device: torch.device, with_jerk: bool,
                       with_pot: bool, sep_pot: bool,
                       kind: int) -> Tuple[int, ...]:
    """Resident blocks an SM of one FMA variant at each of _FMA_LANES (the
    library's occupancy query), once per variant and device."""
    key = (device.index, bool(with_jerk), bool(with_pot), bool(sep_pot),
           kind)
    if key not in _FMA_BLOCKS:
        got = []
        for lanes in _FMA_LANES:
            blocks = ctypes.c_int(0)
            err = load().nbody_fma_blocks_per_sm(
                int(with_jerk), int(with_pot), int(sep_pot), kind, lanes,
                ctypes.byref(blocks))
            if err != 0 or blocks.value < 1:
                raise RuntimeError(f"the FMA body's occupancy query failed: "
                                   f"cudaError {err}, {blocks.value} blocks")
            got.append(blocks.value)
        _FMA_BLOCKS[key] = tuple(got)
    return _FMA_BLOCKS[key]


def fma_plan_of(b: int, n: int, device: torch.device, with_jerk: bool,
                with_pot: bool, sep_pot: bool,
                kind: int) -> Tuple[int, int, int]:
    """fma_plan on `device` for one variant of kernel 1 (KIND_ROWS) or 2
    (KIND_PRED)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return fma_plan(b, n, sms, _fma_blocks_per_sm(device, with_jerk,
                                                  with_pot, sep_pot, kind))


def _mma_slots(device: torch.device, with_jerk: bool, pot: int,
               pred: bool) -> int:
    """Resident blocks of one matmul variant on the card: SMs x blocks per
    SM (the library's occupancy query), once per variant and device."""
    key = (device.index, bool(with_jerk), pot, bool(pred))
    if key not in _SLOTS:
        blocks = ctypes.c_int(0)
        err = load().nbody_mma_blocks_per_sm(int(with_jerk), pot, int(pred),
                                             ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"the matmul body's occupancy query failed: "
                               f"cudaError {err}, {blocks.value} blocks")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _SLOTS[key] = sms * blocks.value
    return _SLOTS[key]


_COUNTERS = {}


def _counters(device: torch.device, count: int) -> torch.Tensor:
    """The split tickets of every kernel-1 and -2 body (int32), zero
    between launches: the block that takes a counter's last ticket resets
    it, so one zeroed buffer per device serves every launch in stream order
    (grown, zeroed, when a launch needs more). A launch on another stream
    while one is in flight would race on it."""
    got = _COUNTERS.get(device.index)
    if got is None or got.numel() < count:
        got = _COUNTERS[device.index] = torch.zeros(
            max(count, 4096), dtype=torch.int32, device=device)
    return got


def _mma_scratch(device, b: int, n: int, with_jerk: bool, pot: int,
                 pred: bool):
    """(partial or None, counters or None, splits, cols per split) of a
    matmul launch of b rows against n columns (b, n > 0)."""
    splits, per = split_plan(b, n, _mma_slots(device, with_jerk, pot, pred))
    return (*_split_scratch(device, b, splits, _NS_MMA), splits, per * _TJ)


def _split_scratch(device, b: int, splits: int, nsum: int):
    """(partial [splits, b, nsum], counters) of a launch of `splits`
    column splits, (None, None) for one split."""
    if splits == 1:
        return None, None
    partial = torch.empty((splits, b, nsum), dtype=torch.float32,
                          device=device)
    # per row block: a ticket per group of _RED_GROUP splits, and one for
    # the groups
    tickets = -(-b // _TB) * (-(-splits // _RED_GROUP) + 1)
    return partial, _counters(device, tickets)


def _fma_scratch(device, b: int, n: int, with_jerk: bool, with_pot: bool,
                 sep_pot: bool, group_size: int = 0, pred: bool = False):
    """(partial or None, counters or None, splits, cols per split, lanes)
    of an FMA-body launch of b rows against n columns (b, n > 0): kernel 1b
    (group_size > 0) by _splits, one lane; kernels 1 and 2 by fma_plan."""
    if group_size > 0:
        splits, cps, lanes = _splits(b, n, group_size), 0, 1
    else:
        kind = KIND_PRED if pred else KIND_ROWS
        lanes, splits, per = fma_plan_of(b, n, device, with_jerk, with_pot,
                                         sep_pot, kind)
        cps = per * _TJ
    return (*_split_scratch(device, b, splits, _NSUM), splits, cps, lanes)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


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


def pot_mode(with_pot: bool, eps2: float, pot_eps2) -> int:
    """The matmul sweep's potential (pallas_nbody.py:111): none; through
    the Sw product when eps2 >= 1e-2 and no separate pot_eps2; else an
    explicit per-pair sum, at pot_eps2 when given (for small eps2 the
    |x|^2 decomposition's close-pair cancellation exceeds the error
    budget)."""
    if not with_pot:
        return POT_NONE
    if pot_eps2 is not None:
        return POT_SEPARATE
    return POT_PRODUCT if eps2 >= 1e-2 else POT_EXPLICIT


def column_matrix(pos, vel):
    """C8 = (x, y, z, vx, vy, vz, 1, |x|^2) of the columns, [N, 8]: the
    operand of the matmul reduction (pallas_nbody.py:428-432)."""
    return torch.cat([pos, vel, torch.ones_like(pos[:, :1]),
                      (pos * pos).sum(1, keepdim=True)], 1)


def _mma_sums(xi, vi, ids, px, pv, mass, eps2, pot_eps2, with_jerk, pot):
    """The matmul sweep's per-pair weights on a [C] x [N] block of
    centred rows and columns, and its products: (Sw [C,8], Sws [C,8],
    explicit potential [C]), as pallas_nbody.py:209-241 forms them."""
    n = px.shape[0]
    dx = px[None, :, 0] - xi[:, 0, None]
    dy = px[None, :, 1] - xi[:, 1, None]
    dz = px[None, :, 2] - xi[:, 2, None]
    d2 = dx * dx + dy * dy + dz * dz
    cols = torch.arange(n, device=xi.device)
    valid = cols[None, :] != ids[:, None].to(cols.dtype)
    inv_r = torch.where(valid, torch.rsqrt(d2 + eps2), 0.0)
    inv_r2 = inv_r * inv_r
    w = mass[None, :] * (inv_r * inv_r2)
    c8 = column_matrix(px, pv)
    sw = w @ c8
    sws = torch.zeros_like(sw)
    if with_jerk:
        dvx = pv[None, :, 0] - vi[:, 0, None]
        dvy = pv[None, :, 1] - vi[:, 1, None]
        dvz = pv[None, :, 2] - vi[:, 2, None]
        s = (dx * dvx + dy * dvy + dz * dvz) * inv_r2
        sws = (w * s) @ c8
    if pot == POT_EXPLICIT:
        p = -(mass[None, :] * inv_r).sum(1)
    elif pot == POT_SEPARATE:
        inv_rp = torch.where(valid, torch.rsqrt(d2 + pot_eps2), 0.0)
        p = -(mass[None, :] * inv_rp).sum(1)
    else:
        p = torch.zeros_like(sw[:, 0])
    return sw, sws, p


def _recover(sw, sws, p, xi, vi, eps2, with_jerk, pot):
    """The row recovery after the column loop (pallas_nbody.py:256-273):
    unscaled (acc, jerk, pot) from Sw, Sws and the explicit potential."""
    sw1 = sw[:, 6:7]
    acc = sw[:, 0:3] - xi * sw1
    if with_jerk:
        # the jerk's factor 3 once per row
        jerk = (sw[:, 3:6] - vi * sw1) - 3.0 * (sws[:, 0:3]
                                                - xi * sws[:, 6:7])
    else:
        jerk = torch.zeros_like(acc)
    if pot == POT_PRODUCT:
        xi2 = (xi * xi).sum(1)
        p = -(sw[:, 7] + (eps2 - xi2) * sw[:, 6] - 2.0 * (xi * acc).sum(1))
    elif pot == POT_NONE:
        p = torch.zeros_like(acc[:, 0])
    return acc, jerk, p


def _rows_mma_plain(xi, vi, ids, px, pv, mass, eps2, pot_eps2, with_jerk,
                    pot):
    """_mma_sums and _recover over row chunks of centred inputs."""
    b, n = xi.shape[0], px.shape[0]
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(n, 1))
    outs = []
    for s in range(0, b, chunk):
        x, v = xi[s:s + chunk], vi[s:s + chunk]
        sums = _mma_sums(x, v, ids[s:s + chunk], px, pv, mass, eps2,
                         pot_eps2, with_jerk, pot)
        outs.append(_recover(*sums, x, v, eps2, with_jerk, pot))
    if not outs:
        z = xi.new_zeros((0, 3))
        return z, z.clone(), xi.new_zeros((0,))
    return tuple(torch.cat(x, 0) for x in zip(*outs))


def column_centre(pos, vel):
    """[6]: the columns' mean position and velocity, the centre of the
    matmul reduction (pallas_nbody.py:394-402, :720-721)."""
    return torch.cat([pos.mean(0), vel.mean(0)])


def nbody_rows_plain(pos_rows, vel_rows, row_ids, pos, vel, mass,
                     eps2: float, g: float = G_INTERNAL,
                     with_jerk: bool = True, with_pot: bool = True,
                     pot_eps2: float | None = None, group_size: int = 0,
                     use_mxu: bool = False):
    """What the nbody_rows kernel computes, in plain row-chunked PyTorch,
    in the dtype of its inputs: (acc [B,3], jerk [B,3], pot [B]). `pot_eps2`
    None softens the potential by eps2; a value softens it separately (d2
    + pot_eps2). Rows with id -1 are padding and mask no pair.

    group_size gs > 0: each row only against the columns of its own group
    (id // gs): the rows of each group present are swept over that group's
    window [g gs, (g + 1) gs) with the group mask, as the kernel's windows
    do; a padding row gets zeros.

    use_mxu=True: the matmul reduction's decomposition (rows and columns
    centred on the columns' means, Sw / Sws against C8, the row recovery;
    the potential through the product when pot_mode says so). Not defined
    with group_size > 0."""
    if use_mxu:
        if group_size > 0:
            raise ValueError("use_mxu=True has no group windows: the entry "
                             "points force it off under group_size > 0")
        c = column_centre(pos, vel)
        cp, cv = c[:3], c[3:]
        acc, jerk, pot = _rows_mma_plain(
            pos_rows - cp, vel_rows - cv, row_ids, pos - cp, vel - cv, mass,
            eps2, pot_eps2, with_jerk, pot_mode(with_pot, eps2, pot_eps2))
        return g * acc, g * jerk, g * pot
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
                         mass, tau, eps2: float, g: float = G_INTERNAL,
                         use_mxu: bool = False, centre=None):
    """What the nbody_predcols kernel computes, in plain PyTorch: acc and
    jerk of the rows against the columns predicted to offset `tau` (a
    0-dim tensor or a float).

    use_mxu=True: the matmul reduction, as make_pred_force_rows centres it
    (pallas_nbody.py:720-741): columns centred on `centre` (default: the
    step-start means, column_centre) and predicted, rows shifted by c_pos +
    tau c_vel."""
    if use_mxu:
        c = column_centre(pos0, vel0) if centre is None else centre
        cp, cv = c[:3], c[3:]
        p, v = predict_columns(pos0 - cp, vel0 - cv, a0, j0, tau)
        acc, jerk, _ = _rows_mma_plain(
            pos_rows - (cp + tau * cv), vel_rows - cv, row_ids, p, v, mass,
            eps2, None, True, POT_NONE)
        return g * acc, g * jerk
    p, v = predict_columns(pos0, vel0, a0, j0, tau)
    acc, jerk, _ = nbody_rows_plain(pos_rows, vel_rows, row_ids, p, v, mass,
                                    eps2, g, with_pot=False)
    return acc, jerk


# --------------------------------------------------------------------------
# wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# --------------------------------------------------------------------------

@spanned("kernels.nbody_rows")
def nbody_rows(pos_rows, vel_rows, row_ids, pos, vel, mass, eps2: float,
               g: float = G_INTERNAL, with_jerk: bool = True,
               with_pot: bool = True, pot_eps2: float | None = None,
               group_size: int = 0, use_mxu: bool = False):
    """Kernel 1: (acc [B,3], jerk [B,3], pot [B]) of B f32 rows (global
    ids `row_ids`, int32, -1 = padding) against N f32 columns. Jerk and
    pot are zeros when not asked for. group_size > 0: each row only
    against its own group's columns (the block-diagonal windows).
    use_mxu=True: the matmul reduction (launches `nbody_rows_mma`; the
    potential's route per pot_mode); not defined with group_size > 0."""
    b, n, device = _check_rows(pos_rows, vel_rows, row_ids,
                               [("pos", pos), ("vel", vel), ("mass", mass)])
    group_size = max(int(group_size), 0)
    if use_mxu and group_size > 0:
        raise ValueError("use_mxu=True has no group windows: the entry "
                         "points force it off under group_size > 0")
    if device.type == "cpu":
        return nbody_rows_plain(pos_rows, vel_rows, row_ids, pos, vel, mass,
                                eps2, g, with_jerk, with_pot, pot_eps2,
                                group_size, use_mxu)
    if device.type != "cuda":
        raise ValueError(f"nbody_rows runs on cuda or cpu, not {device}")
    if b == 0 or n == 0:
        acc = torch.zeros((b, 3), dtype=torch.float32, device=device)
        return acc, torch.zeros_like(acc), torch.zeros_like(acc[:, 0])
    if use_mxu:
        launch, out = rows_mma_launcher(pos_rows, vel_rows, row_ids, pos,
                                        vel, mass, eps2, g, with_jerk,
                                        with_pot, pot_eps2)
        _count(launch(), "nbody_rows_mma")
        return out
    launch, out = rows_launcher(pos_rows, vel_rows, row_ids, pos, vel, mass,
                                eps2, g, with_jerk, with_pot, pot_eps2,
                                group_size)
    _count(launch(), "nbody_rows_group" if group_size > 0 else "nbody_rows")
    return out


def rows_launcher(pos_rows, vel_rows, row_ids, pos, vel, mass, eps2: float,
                  g: float = G_INTERNAL, with_jerk: bool = True,
                  with_pot: bool = True, pot_eps2: float | None = None,
                  group_size: int = 0):
    """One launch of kernel 1's FMA body (group_size > 0: kernel 1b, the
    group windows) on checked CUDA tensors (B, N > 0): outputs, the split
    scratch and the ctypes arguments made here, once. Returns
    (launch, (acc, jerk, pot)): launch() issues the sweep with its ordered
    split sum (one kernel) on the current stream through one ctypes call
    and returns the CUDA error. nbody_rows calls it once; a timer may call
    launch() many times, rewriting the same outputs."""
    b, n, device = pos_rows.shape[0], pos.shape[0], pos.device
    group_size = max(int(group_size), 0)
    acc = torch.empty((b, 3), dtype=torch.float32, device=device)
    jerk = torch.empty_like(acc)
    pot = torch.empty((b,), dtype=torch.float32, device=device)
    partial, counters, splits, cps, lanes = _fma_scratch(
        device, b, n, with_jerk, with_pot, pot_eps2 is not None, group_size)
    fn = load().nbody_rows_launch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
    args = (pos_rows.data_ptr(), vel_rows.data_ptr(), row_ids.data_ptr(), b,
            pos.data_ptr(), vel.data_ptr(), mass.data_ptr(), n, float(eps2),
            float(0.0 if pot_eps2 is None else pot_eps2), float(g),
            int(with_jerk), int(with_pot), int(pot_eps2 is not None),
            group_size, _ptr(partial), _ptr(counters), splits, cps, lanes,
            acc.data_ptr(), jerk.data_ptr(), pot.data_ptr(), stream)

    def launch(_keep=(pos_rows, vel_rows, row_ids, pos, vel, mass,
                      partial, counters, acc, jerk, pot)):
        return fn(*args)

    return launch, (acc, jerk, pot)


@spanned("kernels.nbody_predcols")
def nbody_predcols(pos_rows, vel_rows, row_ids, pos0, vel0, a0, j0, mass,
                   tau: torch.Tensor, eps2: float, g: float = G_INTERNAL,
                   use_mxu: bool = False, centre=None):
    """Kernel 2: (acc [K,3], jerk [K,3]) of K f32 rows against the N
    columns predicted from the step-start (pos0, vel0, a0, j0) to offset
    `tau`, a one-element f32 tensor on the rows' device (read by the
    kernel, never by the host). use_mxu=True: the matmul reduction
    (launches `nbody_predcols_mma`), centred on `centre` [6] (default:
    column_centre of pos0, vel0)."""
    b, n, device = _check_rows(
        pos_rows, vel_rows, row_ids,
        [("pos0", pos0), ("vel0", vel0), ("a0", a0), ("j0", j0),
         ("mass", mass)])
    _check("tau", tau.reshape(()), (), torch.float32, device)
    if use_mxu:
        centre = column_centre(pos0, vel0) if centre is None else centre
        _check("centre", centre, (6,), torch.float32, device)
    if device.type == "cpu":
        return nbody_predcols_plain(pos_rows, vel_rows, row_ids, pos0, vel0,
                                    a0, j0, mass, tau.reshape(()), eps2, g,
                                    use_mxu, centre)
    if device.type != "cuda":
        raise ValueError(f"nbody_predcols runs on cuda or cpu, not {device}")
    if use_mxu:
        return PredcolsMma(pos0, vel0, a0, j0, mass, eps2, g, centre)(
            pos_rows, vel_rows, row_ids, tau)
    if b == 0 or n == 0:
        acc = torch.zeros((b, 3), dtype=torch.float32, device=device)
        return acc, torch.zeros_like(acc)
    launch, out = predcols_launcher(pos_rows, vel_rows, row_ids, pos0, vel0,
                                    a0, j0, mass, tau.reshape(()), eps2, g)
    _count(launch(), "nbody_predcols")
    return out


def predcols_launcher(pos_rows, vel_rows, row_ids, pos0, vel0, a0, j0, mass,
                      tau: torch.Tensor, eps2: float, g: float = G_INTERNAL):
    """One launch of kernel 2's FMA body on checked CUDA tensors (K, N > 0;
    tau one f32 element): outputs, the split scratch and the ctypes
    arguments made here, once. Returns (launch, (acc, jerk)): launch()
    issues the kernel (the sweep and its ordered split sum) on the current
    stream through one ctypes call and returns the CUDA error.
    nbody_predcols calls it once; a timer may call launch() many times,
    rewriting the same outputs."""
    b, n, device = pos_rows.shape[0], pos0.shape[0], pos0.device
    tau = tau.contiguous()
    acc = torch.empty((b, 3), dtype=torch.float32, device=device)
    jerk = torch.empty_like(acc)
    partial, counters, splits, cps, lanes = _fma_scratch(
        device, b, n, True, False, False, pred=True)
    fn = load().nbody_predcols_launch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
    args = (pos_rows.data_ptr(), vel_rows.data_ptr(), row_ids.data_ptr(), b,
            pos0.data_ptr(), vel0.data_ptr(), a0.data_ptr(), j0.data_ptr(),
            mass.data_ptr(), n, tau.data_ptr(), float(eps2), float(g),
            _ptr(partial), _ptr(counters), splits, cps, lanes,
            acc.data_ptr(), jerk.data_ptr(), stream)

    def launch(_keep=(pos_rows, vel_rows, row_ids, pos0, vel0, a0, j0, mass,
                      tau, partial, counters, acc, jerk)):
        return fn(*args)

    return launch, (acc, jerk)


def _count(err: int, key: str) -> None:
    """Raise on a launch's CUDA error, else count the launch."""
    if err != 0:
        raise RuntimeError(f"{key} launch failed: cudaError {err}")
    LAUNCHES[key] += 1


# --------------------------------------------------------------------------
# the matmul bodies' launches, prepared once
# --------------------------------------------------------------------------

def rows_mma_launcher(pos_rows, vel_rows, row_ids, pos, vel, mass,
                      eps2: float, g: float = G_INTERNAL,
                      with_jerk: bool = True, with_pot: bool = True,
                      pot_eps2: float | None = None):
    """One nbody_rows_mma launch of checked CUDA tensors (B, N > 0), its
    outputs, scratch, centre and ctypes arguments made here, once.
    Returns (launch, (acc, jerk, pot)): launch() issues the kernel on the
    current stream through one ctypes call and returns the CUDA error.
    nbody_rows(use_mxu=True) calls it once; a timer may call it many
    times, rewriting the same outputs."""
    b, n, device = pos_rows.shape[0], pos.shape[0], pos.device
    fn = load().nbody_rows_mma_launch
    acc = torch.empty((b, 3), dtype=torch.float32, device=device)
    jerk = torch.empty_like(acc)
    pot = torch.empty((b,), dtype=torch.float32, device=device)
    centre = column_centre(pos, vel)
    mode = pot_mode(with_pot, eps2, pot_eps2)
    partial, counters, splits, cps = _mma_scratch(device, b, n, with_jerk,
                                                  mode, False)
    args = (pos_rows.data_ptr(), vel_rows.data_ptr(), row_ids.data_ptr(), b,
            pos.data_ptr(), vel.data_ptr(), mass.data_ptr(), n,
            centre.data_ptr(), float(eps2),
            float(0.0 if pot_eps2 is None else pot_eps2), float(g),
            int(with_jerk), mode, _ptr(partial), _ptr(counters), splits, cps,
            acc.data_ptr(), jerk.data_ptr(), pot.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)

    def launch(_keep=(centre, partial, counters)):
        return fn(*args)

    return launch, (acc, jerk, pot)


class PredcolsMma:
    """Kernel 2c's launches against one step's columns: the f32 CUDA
    step-start columns, checked once, their centre (default: the
    step-start means) and, per row count, the scratch, all made once per
    step. Each call then checks its rows and tau and issues one launch
    into fresh outputs: a returned tensor is never rewritten by a later
    call."""

    def __init__(self, pos0, vel0, a0, j0, mass, eps2: float,
                 g: float = G_INTERNAL, centre=None):
        n, device = pos0.shape[0], pos0.device
        for name, t in (("pos0", pos0), ("vel0", vel0), ("a0", a0),
                        ("j0", j0)):
            _check(name, t, (n, 3), torch.float32, device)
        _check("mass", mass, (n,), torch.float32, device)
        if centre is None:
            centre = column_centre(pos0, vel0)
        _check("centre", centre, (6,), torch.float32, device)
        self.n, self.device = n, device
        self._keep = (pos0, vel0, a0, j0, mass, centre)
        self._cols = (pos0.data_ptr(), vel0.data_ptr(), a0.data_ptr(),
                      j0.data_ptr(), mass.data_ptr(), n, centre.data_ptr())
        self._eps2, self._g = float(eps2), float(g)
        self._fn = load().nbody_predcols_mma_launch
        self._stream = torch.cuda.current_stream(device).cuda_stream
        self._scratch = {}

    def _scratch_for(self, b: int):
        """_mma_scratch for b rows, made at the first call with b."""
        got = self._scratch.get(b)
        if got is None:
            got = self._scratch[b] = _mma_scratch(self.device, b, self.n,
                                                  True, POT_NONE, True)
        return got

    def _check_rows(self, pos_rows, vel_rows, row_ids, tau) -> None:
        """The rows' and tau's device, dtype, shape and contiguity: one
        pass of cheap comparisons, _check's messages on a mismatch."""
        b, dev, f32 = pos_rows.shape[0], self.device, torch.float32
        if not (pos_rows.dtype is f32 and vel_rows.dtype is f32
                and row_ids.dtype is torch.int32 and tau.dtype is f32
                and pos_rows.shape == (b, 3) and vel_rows.shape == (b, 3)
                and row_ids.shape == (b,) and tau.numel() == 1
                and pos_rows.device == dev and vel_rows.device == dev
                and row_ids.device == dev and tau.device == dev
                and pos_rows.is_contiguous() and vel_rows.is_contiguous()
                and row_ids.is_contiguous() and tau.is_contiguous()):
            _check("pos_rows", pos_rows, (b, 3), f32, dev)
            _check("vel_rows", vel_rows, (b, 3), f32, dev)
            _check("row_ids", row_ids, (b,), torch.int32, dev)
            _check("tau", tau.reshape(()), (), f32, dev)

    def launcher(self, pos_rows, vel_rows, row_ids, tau):
        """(launch, (acc, jerk)) of one call: the rows and tau (one f32
        element) checked, fresh outputs, the ctypes arguments; launch()
        issues the kernel and returns the CUDA error (B, N > 0). launch
        holds this plan (its columns, centre and scratch), so it may
        outlive every other reference to the plan."""
        self._check_rows(pos_rows, vel_rows, row_ids, tau)
        b = pos_rows.shape[0]
        # one allocation for both outputs (each costs ~10 us of host time
        # on an H100's machine)
        acc, jerk = torch.empty((2, b, 3), dtype=torch.float32,
                                device=self.device).unbind(0)
        partial, counters, splits, cps = self._scratch_for(b)
        args = (pos_rows.data_ptr(), vel_rows.data_ptr(), row_ids.data_ptr(),
                b, *self._cols, tau.data_ptr(), self._eps2, self._g,
                _ptr(partial), _ptr(counters), splits, cps, acc.data_ptr(),
                jerk.data_ptr(), self._stream)
        fn = self._fn

        def launch(_keep=(self, pos_rows, vel_rows, row_ids, tau)):
            return fn(*args)

        return launch, (acc, jerk)

    @spanned("kernels.predcols_mma")
    def __call__(self, pos_rows, vel_rows, row_ids, tau):
        b = pos_rows.shape[0]
        if b == 0 or self.n == 0:
            self._check_rows(pos_rows, vel_rows, row_ids, tau)
            z = torch.zeros((b, 3), dtype=torch.float32, device=self.device)
            return z, z.clone()
        launch, out = self.launcher(pos_rows, vel_rows, row_ids, tau)
        _count(launch(), "nbody_predcols_mma")
        return out


# --------------------------------------------------------------------------
# the JAX package's entry points and factories
# --------------------------------------------------------------------------

def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def kernel_acc_jerk_pot_rows(
    pos_rows, vel_rows, row_ids, pos, vel, mass, eps2: float = 0.0,
    g: float = G_INTERNAL, with_jerk: bool = True, group_size: int = 0,
    pot_eps2: float | None = None, use_mxu: bool = True,
    with_pot: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forces on `pos_rows` (global ids `row_ids`, any order or subset,
    -1 = padding) from all of `pos` — pallas_acc_jerk_pot_rows. Computed
    in f32 and returned in the rows' dtype, as the Pallas path does.
    `with_pot=False` skips the potential (callers that discard it).
    `group_size` gs > 0: block-diagonal groups of gs stars (a flattened
    ensemble; gs counts an interloper), each row against its own group's
    columns only. use_mxu=True (the default, as in the JAX package): the
    matmul reduction, forced off under group_size > 0
    (pallas_nbody.py:382). With with_jerk=False the jerk is zeros (the
    JAX matmul body leaves a meaningless jerk there)."""
    use_mxu = use_mxu and group_size <= 0
    a, j, p = nbody_rows(
        _f32(pos_rows), _f32(vel_rows),
        row_ids.to(torch.int32).contiguous(), _f32(pos), _f32(vel),
        _f32(mass), eps2, g, with_jerk, with_pot, pot_eps2, group_size,
        use_mxu)
    dtype = pos_rows.dtype
    return a.to(dtype), j.to(dtype), p.to(dtype)


def kernel_acc_jerk_pot(
    pos, vel, mass, eps2: float = 0.0, g: float = G_INTERNAL,
    with_jerk: bool = True, group_size: int = 0,
    pot_eps2: float | None = None, use_mxu: bool = True,
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
                         g: float = G_INTERNAL, use_mxu: bool = True):
    """`rows_at(pos_rows, vel_rows, row_ids, tau) -> (acc, jerk)` with the
    column prediction fused into kernel 2. The f32 copies of the
    step-start columns, and with use_mxu (the default) their centre (the
    step-start means), are made HERE, once per step, outside the substep
    loop; each substep is then one launch. On a card with use_mxu the
    columns are checked and the matmul body's scratch made once per step
    (PredcolsMma): a substep checks its rows and makes one ctypes call."""
    cols = tuple(_f32(t) for t in (pos0, vel0, a0, j0, mass))
    if use_mxu and cols[0].device.type == "cuda":
        plan = PredcolsMma(*cols, eps2, g)

        def rows_at(pos_rows, vel_rows, row_ids, tau):
            # converted only where needed: this runs once per substep
            dtype, f32 = pos_rows.dtype, torch.float32
            if dtype is not f32:
                pos_rows, vel_rows = _f32(pos_rows), _f32(vel_rows)
            if row_ids.dtype is not torch.int32:
                row_ids = row_ids.to(torch.int32)
            if not (isinstance(tau, torch.Tensor) and tau.dtype is f32):
                tau = torch.as_tensor(tau, device=plan.device).to(f32)
            a, j = plan(pos_rows.contiguous(), vel_rows.contiguous(),
                        row_ids.contiguous(), tau.contiguous())
            if dtype is not f32:
                a, j = a.to(dtype), j.to(dtype)
            return a, j

        return rows_at
    centre = column_centre(cols[0], cols[1]) if use_mxu else None

    def rows_at(pos_rows, vel_rows, row_ids, tau):
        dtype = pos_rows.dtype
        tau32 = torch.as_tensor(tau, device=pos_rows.device).to(
            torch.float32).reshape(())
        a, j = nbody_predcols(_f32(pos_rows), _f32(vel_rows),
                              row_ids.to(torch.int32).contiguous(), *cols,
                              tau32, float(eps2), g, use_mxu, centre)
        return a.to(dtype), j.to(dtype)

    return rows_at
