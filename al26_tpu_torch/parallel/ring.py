"""Ring-streamed pairwise forces (port of al26_tpu/parallel/ring.py).

The all-gather path (parallel.sharded) hands every rank all N columns.
This module streams the COLUMN blocks around a ring of ranks instead, the
ring-attention dataflow: each rank keeps its row block, adds the partial
forces of the circulating column block, and passes the block on to rank
(r + 1) % D while taking the next from (r - 1) % D (batch_isend_irecv) —
D - 1 hops. The row blocks are then all-gathered so that every rank holds
the whole result, as the port's mesh paths keep the whole state on every
rank (parallel.sharded's docstring). At a world of one there are no hops.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..units import G_INTERNAL
from .sharded import _block, _rows_force, all_gather_cat, axis_rank, \
    kernel_here

RING_AXIS = "rows"


def _partial_block_force(pos_r, vel_r, row_ids, pos_c, vel_c, mass_c,
                         col0: int, eps2, g: float = G_INTERNAL,
                         pot_eps2=None, with_jerk: bool = True,
                         use_kernel: bool | None = None,
                         use_mxu: bool = True):
    """acc/jerk/pot contribution of one column block (global ids col0,
    col0 + 1, ...) onto the row block (global ids `row_ids`): kernel 1 /
    1c with the ids shifted onto the block (parallel.sharded.slice_ids),
    or the plain row block. Self pairs are masked by global id;
    `pot_eps2` softens the potential separately."""
    return _rows_force(pos_r, vel_r, row_ids, pos_c, vel_c, mass_c, eps2, g,
                       col0=col0, with_jerk=with_jerk, with_pot=True,
                       pot_eps2=pot_eps2,
                       kernel=kernel_here(pos_c, use_kernel),
                       use_mxu=use_mxu)


def _pack(pos, vel, mass):
    """One [n, 7] message of a column block (one send a hop)."""
    return torch.cat([pos, vel, mass[:, None]], 1).contiguous()


def ring_acc_jerk_pot(pos, vel, mass, mesh, eps2=0.0,
                      g: float = G_INTERNAL, axis: str = RING_AXIS,
                      pot_eps2: float | None = None,
                      with_jerk: bool = True):
    """(acc, jerk, pot) of every star with ring-streamed columns, on every
    rank. Equals parallel.sharded.sharded_acc_jerk_pot up to summation
    order; N must divide by the mesh size."""
    me, world = axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    n = pos.shape[0]
    block = _block(n, world)
    start = me * block
    sl = slice(start, start + block)
    pos_r, vel_r = pos[sl], vel[sl]
    row_ids = torch.arange(start, start + block, dtype=torch.int32,
                           device=pos.device)
    msg = _pack(pos_r, vel_r, mass[sl])
    nxt = dist.get_global_rank(group, (me + 1) % world)
    prv = dist.get_global_rank(group, (me - 1) % world)
    acc = jerk = pot = None
    for hop in range(world):
        # the circulating block started at rank (me - hop) % world
        src = (me - hop) % world
        if hop + 1 < world:
            recv = torch.empty_like(msg)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, msg, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
        a, j, p = _partial_block_force(
            pos_r, vel_r, row_ids, msg[:, 0:3], msg[:, 3:6], msg[:, 6],
            src * block, eps2, g, pot_eps2, with_jerk)
        if acc is None:
            acc, jerk, pot = a, j, p
        else:
            acc, jerk, pot = acc + a, jerk + j, pot + p
        if hop + 1 < world:
            for r in reqs:
                r.wait()
            msg = recv
    return tuple(all_gather_cat(t, group, world) for t in (acc, jerk, pot))


def make_ring_force(mesh, mass, eps2=0.0, g: float = G_INTERNAL,
                    axis: str = RING_AXIS):
    """`force_fn(pos, vel) -> (acc, jerk)` using the ring dataflow."""

    def force_fn(pos, vel):
        a, j, _ = ring_acc_jerk_pot(pos, vel, mass, mesh, eps2, g, axis)
        return a, j

    return force_fn
