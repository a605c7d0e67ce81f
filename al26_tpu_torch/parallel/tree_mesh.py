"""Barnes-Hut tree sweep over a device mesh (port of
al26_tpu/parallel/tree_mesh.py).

The reference's default BHTree runs with number_of_workers=8
(al26_nbody.py:57,1712-1714): force work split across workers against a
shared tree. Here every rank builds the SAME tree (the state is whole on
every rank, parallel.sharded's docstring; the Morton sort, the node
reduction and the MAC are O(N log N) next to the force work), and the two
heavy phases split:

  * FAR FIELD: the dense point-node monopole sweep (ops.tree
    ._far_field_rows) over this rank's TARGET blocks [r B/D, (r+1) B/D),
    then an all-gather of the blocks;
  * NEAR FIELD: kernel 3 (ops.cuda_tree.near_field; its plain version on
    the CPU) over this rank's share of the work items, cut by PAIR count
    (cuda_tree.near_items part=), then an all-reduce (SUM) of the
    full-size accumulators. A target's items may fall to several ranks,
    which is what balances heavy-tailed partner counts.

The JAX mesh sweeps its near field with the XLA scatter-scan instead; the
results agree up to summation order. Every rank ends with the whole
result. hermite4_block only under a mesh (sim.init enforces it): the fast
group's exact K x N subcycle rows go through
parallel.sharded.make_sharded_force_rows.
"""
from __future__ import annotations

import torch

from ..ops import cuda_nbody, cuda_tree
from ..ops import tree as T
from ..units import G_INTERNAL
from .sharded import all_gather_cat, all_reduce_sum, axis_rank


def _check_blocks(b: int, world: int) -> None:
    if b % world:
        raise ValueError(
            f"tree mesh path needs the block count ({b}) divisible by "
            f"the mesh size ({world}); lower tree_leaf")


def _far_field_part(rank: int, world: int, tree: T.BlockTree, accepts,
                    eps2, g: float = G_INTERNAL, pot_eps2=None,
                    with_jerk: bool = False):
    """Local body of the far field: the monopole sweep of rank `rank`'s
    target blocks [r B/D, (r+1) B/D) against every accepted node.
    Returns (acc [B/D,L,3], jerk | None, pot [B/D,L])."""
    b = tree.pos_s.shape[0]
    _check_blocks(b, world)
    blk = b // world
    sl = slice(rank * blk, (rank + 1) * blk)
    m_all = torch.cat(tree.masses)
    com_all = torch.cat(tree.coms, dim=0)
    w_all = torch.where(torch.cat(accepts, dim=1), m_all[None, :], 0.0)
    vcom_all = torch.cat(tree.vcoms, dim=0) if with_jerk else None
    return T._far_field_rows(
        tree.pos_s[sl], tree.vel_s[sl] if with_jerk else None, w_all[sl],
        com_all, vcom_all, eps2, g, pot_eps2, with_jerk=with_jerk)


def _near_field_part(rank: int, world: int, tree: T.BlockTree, p2p,
                     n_true: int, eps2, g: float = G_INTERNAL, *,
                     leaf: int, kavg: int, pot_eps2=None,
                     with_jerk: bool = False,
                     use_kernel: bool | None = None):
    """Local body of the near field: kernel 3 (or its plain version) over
    rank `rank`'s share of the work items. Returns this rank's partial
    (acc [B,L,3], jerk | None, pot [B,L], overflow); the sum over the
    ranks is the near field."""
    if use_kernel is None:
        use_kernel = cuda_nbody.use_kernel(n_true, tree.pos_s.dtype,
                                           tree.pos_s.device)
    near_fn = cuda_tree.near_field if use_kernel else \
        cuda_tree.near_field_plain
    return near_fn(tree.pos_s, tree.mass_s, p2p, n_true, eps2, leaf=leaf,
                   kavg=kavg, g=g, pot_eps2=pot_eps2, vel_s=tree.vel_s,
                   with_jerk=with_jerk, part=(rank, world))


def tree_acc_jerk_pot_mesh(pos, vel, mass, mesh, eps2=0.0,
                           g: float = G_INTERNAL, *, leaf: int = 256,
                           theta: float = 0.5, kavg: int = 256,
                           pot_eps2: float | None = None, aref=None,
                           with_jerk: bool = False):
    """(acc [N,3], jerk [N,3] | None, pot [N], overflow) on every rank —
    the mesh counterpart of ops.tree.tree_acc_jerk_pot. The block count
    B = 2^ceil(log2(N / leaf)) must divide by the mesh size."""
    T._check_theta(theta, aref)
    axis = mesh.mesh_dim_names[0]
    rank, world = axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    n = pos.shape[0]
    tree = T.build_block_tree(pos, mass, leaf, vel if with_jerk else None)
    _check_blocks(tree.pos_s.shape[0], world)
    aref_b = T.aref_block_min(tree, aref, n) if aref is not None else None
    accepts, p2p = T.mac_masks(tree, theta, g, aref_b)

    far = _far_field_part(rank, world, tree, accepts, eps2, g, pot_eps2,
                          with_jerk)
    far_acc, far_jerk, far_pot = (
        None if t is None else all_gather_cat(t, group, world)
        for t in far)
    *near, overflow = _near_field_part(
        rank, world, tree, p2p, n, eps2, g, leaf=leaf, kavg=kavg,
        pot_eps2=pot_eps2, with_jerk=with_jerk)
    near_acc, near_jerk, near_pot = (
        None if t is None else all_reduce_sum(t.contiguous(), group, world)
        for t in near)
    acc, jerk, pot = T.unsort(
        tree, far_acc + near_acc,
        far_jerk + near_jerk if with_jerk else None, far_pot + near_pot, n)
    return acc, jerk, pot, overflow


def make_tree_mesh_sweep(mass, mesh, eps2, *, leaf: int, theta: float,
                         kavg: int, pot_eps2: float | None,
                         g: float = G_INTERNAL, with_jerk: bool = False,
                         aref=None):
    """Full sweep `(pos, vel) -> (acc, jerk, pot)` for sim.step under a
    mesh — the mesh counterpart of ops.tree.make_tree_sweep, with its
    NaN poison on a pair-list overflow (on the device, never read back)."""

    def sweep(pos, vel=None):
        acc, jerk, pot, ovf = tree_acc_jerk_pot_mesh(
            pos, vel, mass, mesh, eps2, g, leaf=leaf, theta=theta,
            kavg=kavg, pot_eps2=pot_eps2, aref=aref, with_jerk=with_jerk)
        poison = T._poison(ovf, acc.dtype)
        jerk = torch.zeros_like(acc) if jerk is None else jerk + poison
        return acc + poison, jerk, pot + poison

    return sweep
