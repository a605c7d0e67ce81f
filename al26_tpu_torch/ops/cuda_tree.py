"""The Barnes-Hut tier's exact near field: the CUDA counterpart of
al26_tpu/ops/pallas_tree.py.

One hand-written Hopper kernel in `al26_tpu_torch/csrc/tree.cu`
(`near_items` and its ordered sum `near_reduce`; the header says what they
replace, what bounds them and how the grid is shaped), built at first use
by ops.cuda_build and bound with ctypes.

`near_field` keeps the contract of `pallas_p2p_near_field`: the [B, B]
MAC-fail mask is packed into ONE flat target-major pair list padded to
`tree.near_budget(kavg, B)` by `tree.pack_pair_list` (so the budget and
the overflow flag are the JAX package's exactly), and the pairs of each
target block are summed exactly. On a CUDA tensor it launches the kernel
in f32 (inputs cast in, outputs cast back, as the Pallas kernel does); on
a CPU tensor it runs the plain PyTorch version beside it,
`near_field_plain`, the counterpart of the JAX package's XLA near field.
`LAUNCHES` counts kernel launches; with tracing on (utils.timing) each
call is the span "kernels.near_field".

Both evaluate the list through the same work items (`near_items`): a
source block that holds only padding slots (s * leaf >= n_true) adds only
masked zeros, so it is left out, and each target block's run of the
remaining source blocks is cut into items of at most ITEM_PAIRS blocks,
summed per item and then per target in item order. The item table is
built on the device with no read-back to the host; its length is a static
bound, B + ceil(budget / ITEM_PAIRS).

Self pairs are masked by the sorted slot (each star owns one slot) and
padding columns by `slot < n_true`; masks are selects, never products
with 0. The separately softened potential adds `pot_eps2` to d^2 formed
once (the JAX form r2 - eps2 + pot_eps2 cancels in f32).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..units import G_INTERNAL
from ..utils.timing import spanned
from . import cuda_build

LAUNCHES = {"near_field": 0}

# source blocks a work item takes at most (one CTA each): 8 was fastest
# of 8, 16, 32 and 64 on an H100 at both of the tree tier's measured
# shapes (PERF.md); the partial slabs then take 7 x leaf floats a static
# item (~580 MB at N = 409600, kavg 310)
ITEM_PAIRS = 8
# most rows a CTA runs in one pass (csrc/tree.cu loops over row chunks
# for larger leaves); the largest leaf the kernel takes
_MAX_THREADS = 256
MAX_LEAF = 1024
# sums per row of a partial slab (acc, jerk, pot)
_NS = 7
# plain version: pairs per chunk so a [C, L, L] temporary stays <= 2^22
_PLAIN_CHUNK_ELEMS = 1 << 22

_lib = None


def load():
    """Build csrc/tree.cu (if needed) and bind its library, once per
    process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(cuda_build.build("tree.cu"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.near_field_launch.argtypes = [
        p, p, p,              # pos_s, vel_s, mass_s
        p, p, p,              # src, item, tinfo
        i, i, i, i, i,        # n_items, b, leaf, n_true, threads
        f, f, f,              # eps2, pot_eps2, g
        i, i,                 # with_jerk, sep_pot
        p, p, p, p, p,        # partial, acc, jerk, pot, stream
    ]
    lib.near_field_launch.restype = i
    _lib = lib
    return lib


def _check_args(pos_s, mass_s, p2p, leaf, vel_s, with_jerk):
    if pos_s.dim() != 3 or pos_s.shape[2] != 3:
        raise ValueError(f"pos_s has shape {tuple(pos_s.shape)}, "
                         "expected [B, L, 3]")
    b, L, _ = pos_s.shape
    if L != leaf:
        raise ValueError(f"pos_s has leaf {L}, expected {leaf}")
    if tuple(mass_s.shape) != (b, L):
        raise ValueError(f"mass_s has shape {tuple(mass_s.shape)}, "
                         f"expected {(b, L)}")
    if tuple(p2p.shape) != (b, b) or p2p.dtype != torch.bool:
        raise ValueError(f"p2p must be bool [{b}, {b}]")
    if with_jerk and vel_s is None:
        raise ValueError("with_jerk requires vel_s")
    for name, t in (("mass_s", mass_s), ("p2p", p2p), ("vel_s", vel_s)):
        if t is not None and t.device != pos_s.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{pos_s.device}")


class NearItems(NamedTuple):
    """The near field's work items. The pairs of target block t that are
    swept are src[p] for p in [start_t, start_t + kept[t]); work item i
    takes target item[0, i] (B: no target, past the real items) and its
    pairs item[1, i] ... item[1, i] + item[2, i] - 1; target t owns items
    tinfo[0, t] ... tinfo[0, t] + tinfo[1, t] - 1 (at least one, which
    writes zeros where the target has no pair)."""

    src: torch.Tensor          # int32 [P] source block of each listed pair
    item: torch.Tensor         # int32 [3, I] target, first pair, pairs
    tinfo: torch.Tensor        # int32 [2, B] first item, items
    kept: torch.Tensor         # int32 [B] pairs swept per target block
    overflow: torch.Tensor     # 0-dim bool: the list exceeded its budget


def item_bound(b: int, budget: int, item_pairs: int) -> int:
    """The static item count: one item per target with at most
    `item_pairs` pairs, and one more per `item_pairs` pairs above that, of
    at most `budget` listed pairs (max(1, ceil(c / S)) <= 1 + floor(c / S))."""
    return b + -(-budget // item_pairs)


def near_items(p2p, kavg: int, n_true: int, leaf: int,
               item_pairs: int | None = None,
               part: Tuple[int, int] | None = None) -> NearItems:
    """The work items of the packed pair list of `p2p` (pack_pair_list,
    so the budget and overflow are the JAX package's): every listed pair
    whose source block holds a real star (s * leaf < n_true), each target
    block's run cut into items of at most `item_pairs` (default
    ITEM_PAIRS) source blocks. The list is target-major with ascending
    sources, and padding blocks come last, so a target's kept pairs are
    the head of its run. Built on the device of p2p; nothing is read back
    to the host.

    part=(rank, world): the items of rank `rank`'s share only, for the
    tree mesh (parallel.tree_mesh). The items, in list order, are cut into
    `world` runs of about equal PAIR counts (partner counts are
    heavy-tailed, so equal item counts would not balance); every item
    outside this rank's run keeps its slot with no pairs, so it writes
    zeros. The table keeps its shape and every target its items, and the
    sum of the ranks' results is the whole near field."""
    from .tree import pack_pair_list

    s = ITEM_PAIRS if item_pairs is None else int(item_pairs)
    b, dev = p2p.shape[0], p2p.device
    ti, sj, ok, overflow = pack_pair_list(p2p, kavg)
    t64 = ti.long()
    keep = ok & (sj.long() * leaf < n_true)
    listed = torch.zeros(b, dtype=torch.int64, device=dev)
    listed.index_add_(0, t64, ok.long())
    kept = torch.zeros(b, dtype=torch.int64, device=dev)
    kept.index_add_(0, t64, keep.long())
    start = torch.cumsum(listed, 0) - listed
    chunks = torch.clamp((kept + s - 1) // s, min=1)
    first = torch.cumsum(chunks, 0) - chunks
    n_items = item_bound(b, ti.shape[0], s)
    total = chunks.sum().reshape(1)
    # the items past the real ones belong to a dummy target b
    owner = torch.repeat_interleave(
        torch.arange(b + 1, device=dev), torch.cat([chunks, n_items - total]),
        output_size=n_items)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    k = torch.arange(n_items, device=dev) - torch.cat([first, total])[owner]
    p0 = torch.cat([start, zero])[owner] + k * s
    npairs = torch.clamp(torch.cat([kept, zero])[owner] - k * s, 0, s)
    if part is not None:
        rank, world = part
        # item i's share: where its first pair falls among all kept pairs
        lead = torch.cumsum(npairs, 0) - npairs
        total = torch.clamp(npairs.sum(), min=1)
        share = torch.clamp(lead * world // total, max=world - 1)
        npairs = torch.where(share == rank, npairs, 0)
    item = torch.stack([owner, p0, npairs]).to(torch.int32).contiguous()
    tinfo = torch.stack([first, chunks]).to(torch.int32).contiguous()
    return NearItems(sj.contiguous(), item, tinfo, kept.to(torch.int32),
                     overflow)


def pair_sums(pos_s, mass_s, ti, sj, n_true: int, eps2, pot_eps2=None,
              vel_s=None, with_jerk: bool = False):
    """The unscaled sums of each (target block ti[c], source block sj[c])
    pair, [C, L, 7]: acc (0:3), jerk (3:6, zeros without the jerk) and
    -sum m / r (6) of every target row over the source block's slots, with
    the kernel's masks and arithmetic forms."""
    L = pos_s.shape[1]
    i_c, j_c = ti.long(), sj.long()
    slot = torch.arange(L, device=pos_s.device)
    pos_t = pos_s[i_c]                                    # [C,L,3]
    pos_j = pos_s[j_c]
    mass_j = mass_s[j_c][:, None, :]                      # [C,1,L]
    dx = pos_j[:, None, :, 0] - pos_t[:, :, None, 0]      # [C,Lt,Ls]
    dy = pos_j[:, None, :, 1] - pos_t[:, :, None, 1]
    dz = pos_j[:, None, :, 2] - pos_t[:, :, None, 2]
    d2 = dx * dx + dy * dy + dz * dz
    grow = (i_c[:, None] * L + slot)[:, :, None]          # [C,L,1]
    gcol = (j_c[:, None] * L + slot)[:, None, :]          # [C,1,L]
    valid = (gcol != grow) & (gcol < n_true)
    inv_r = torch.where(valid, torch.rsqrt(d2 + eps2), 0.0)
    inv_r2 = inv_r * inv_r
    w = mass_j * (inv_r * inv_r2)                         # m_j / r^3
    out = pos_s.new_zeros((i_c.shape[0], L, _NS))
    out[..., 0] = (w * dx).sum(2)
    out[..., 1] = (w * dy).sum(2)
    out[..., 2] = (w * dz).sum(2)
    if with_jerk:
        vel_t = vel_s[i_c]
        vel_j = vel_s[j_c]
        dvx = vel_j[:, None, :, 0] - vel_t[:, :, None, 0]
        dvy = vel_j[:, None, :, 1] - vel_t[:, :, None, 1]
        dvz = vel_j[:, None, :, 2] - vel_t[:, :, None, 2]
        s = 3.0 * (dx * dvx + dy * dvy + dz * dvz) * inv_r2
        out[..., 3] = (w * (dvx - s * dx)).sum(2)
        out[..., 4] = (w * (dvy - s * dy)).sum(2)
        out[..., 5] = (w * (dvz - s * dz)).sum(2)
    if pot_eps2 is not None:
        inv_r = torch.where(valid, torch.rsqrt(d2 + pot_eps2), 0.0)
    out[..., 6] = -(mass_j * inv_r).sum(2)
    return out


def near_field_plain(pos_s, mass_s, p2p, n_true: int, eps2, *, leaf: int,
                     kavg: int, g: float = G_INTERNAL, pot_eps2=None,
                     vel_s=None, with_jerk: bool = False, part=None):
    """What the near-field kernel computes, in plain PyTorch, in the dtype
    of its inputs: (acc [B,L,3], jerk [B,L,3] | None, pot [B,L],
    overflow). The swept pairs of near_items are evaluated in chunks of
    [C, L, L] exact tiles (pair_sums), added to their work items in list
    order and the items to their target blocks in item order (index_add_),
    then scaled by G. It reads the item count back to the host, so it is
    for the CPU path and for comparisons, not for a step loop on a card.
    `part` as in near_items: one rank's share of the items."""
    _check_args(pos_s, mass_s, p2p, leaf, vel_s, with_jerk)
    b, L, _ = pos_s.shape
    device = pos_s.device
    it = near_items(p2p, kavg, n_true, leaf, part=part)
    n_real = int(it.tinfo[1].sum())
    owner = it.item[0, :n_real].long()
    npairs = it.item[2, :n_real].long()
    # every swept pair: its item and its place in the list
    pair_item = torch.repeat_interleave(
        torch.arange(n_real, device=device), npairs)
    lead = torch.cumsum(npairs, 0) - npairs
    pidx = (it.item[1, :n_real].long()[pair_item]
            + torch.arange(pair_item.shape[0], device=device)
            - lead[pair_item])
    tgt, src = owner[pair_item], it.src.long()[pidx]
    sums = pos_s.new_zeros((n_real, L, _NS))
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (L * L))
    for s0 in range(0, pair_item.shape[0], chunk):
        sl = slice(s0, s0 + chunk)
        sums.index_add_(0, pair_item[sl], pair_sums(
            pos_s, mass_s, tgt[sl], src[sl], n_true, eps2, pot_eps2, vel_s,
            with_jerk))
    out = pos_s.new_zeros((b, L, _NS)).index_add_(0, owner, sums)
    jerk = g * out[..., 3:6] if with_jerk else None
    return g * out[..., 0:3], jerk, g * out[..., 6], it.overflow


def near_field_launcher(pos_s, mass_s, p2p, n_true: int, eps2, *,
                        leaf: int, kavg: int, g: float = G_INTERNAL,
                        pot_eps2=None, vel_s=None, with_jerk: bool = False,
                        part=None):
    """One kernel-3 launch of checked CUDA tensors: the f32 inputs, the
    work items (near_items), the outputs, the partial slabs and the ctypes
    arguments are made here, once. Returns (launch, (acc, jerk | None,
    pot, overflow)), all f32: launch() issues the kernel and its ordered
    sum on the current stream through one ctypes call and returns the
    CUDA error. near_field calls it once; a timer may call launch() many
    times, rewriting the same outputs. `part` as in near_items."""
    if leaf > MAX_LEAF:
        raise ValueError(f"leaf={leaf}: the near-field kernel takes at most "
                         f"{MAX_LEAF} stars per block")
    b, device, f32 = pos_s.shape[0], pos_s.device, torch.float32
    pos32 = pos_s.to(f32).contiguous()
    mass32 = mass_s.to(f32).contiguous()
    vel32 = vel_s.to(f32).contiguous() if with_jerk else None
    it = near_items(p2p, kavg, n_true, leaf, part=part)
    n_items = it.item.shape[1]
    acc = torch.empty((b, leaf, 3), dtype=f32, device=device)
    jerk = torch.empty_like(acc) if with_jerk else None
    pot = torch.empty((b, leaf), dtype=f32, device=device)
    partial = torch.empty((n_items, _NS, leaf), dtype=f32, device=device)
    threads = min(_MAX_THREADS, -(-leaf // 32) * 32)
    fn = load().near_field_launch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
    args = (pos32.data_ptr(), vel32.data_ptr() if with_jerk else None,
            mass32.data_ptr(), it.src.data_ptr(), it.item.data_ptr(),
            it.tinfo.data_ptr(), n_items, b, leaf, int(n_true), threads,
            float(eps2), float(0.0 if pot_eps2 is None else pot_eps2),
            float(g), int(with_jerk), int(pot_eps2 is not None),
            partial.data_ptr(), acc.data_ptr(),
            jerk.data_ptr() if with_jerk else None, pot.data_ptr(), stream)

    def launch(_keep=(pos32, vel32, mass32, it, partial, acc, jerk, pot)):
        return fn(*args)

    return launch, (acc, jerk, pot, it.overflow)


@spanned("kernels.near_field")
def near_field(pos_s, mass_s, p2p, n_true: int, eps2, *, leaf: int,
               kavg: int, g: float = G_INTERNAL, pot_eps2=None, vel_s=None,
               with_jerk: bool = False, part=None):
    """Kernel 3: (acc [B,L,3], jerk [B,L,3] | None, pot [B,L], overflow)
    of the sorted, padded leaf blocks over the MAC-failing pairs of `p2p`
    — the contract of pallas_p2p_near_field. CPU tensors take
    near_field_plain. `part=(rank, world)`: only that rank's share of the
    work items (near_items), for the tree mesh."""
    _check_args(pos_s, mass_s, p2p, leaf, vel_s, with_jerk)
    device = pos_s.device
    if device.type == "cpu":
        return near_field_plain(pos_s, mass_s, p2p, n_true, eps2, leaf=leaf,
                                kavg=kavg, g=g, pot_eps2=pot_eps2,
                                vel_s=vel_s, with_jerk=with_jerk, part=part)
    if device.type != "cuda":
        raise ValueError(f"near_field runs on cuda or cpu, not {device}")
    dtype = pos_s.dtype
    launch, (acc, jerk, pot, overflow) = near_field_launcher(
        pos_s, mass_s, p2p, n_true, eps2, leaf=leaf, kavg=kavg, g=g,
        pot_eps2=pot_eps2, vel_s=vel_s, with_jerk=with_jerk, part=part)
    err = launch()
    if err != 0:
        raise RuntimeError(f"near_field launch failed: cudaError {err}")
    LAUNCHES["near_field"] += 1
    return (acc.to(dtype), jerk.to(dtype) if with_jerk else None,
            pot.to(dtype), overflow)
