"""Fixed-shape Barnes-Hut tree gravity; torch port of al26_tpu.ops.tree.

The reference's default gravity is AMUSE BHTree (a classic Barnes-Hut
octree treecode, monopole cells, opening angle 0.75;
al26_nbody.py:59,1712-1714). The default here stays exact direct
summation; this module is the opt-in approximate tier for clusters too
large for it (force_impl="tree"). The algorithm and its static shapes are
the JAX package's:

  1. Morton-sort stars and split the sorted order into B = 2^D
     equal-count *leaf blocks* of L stars (one reshape).
  2. Build a complete binary tree over the blocks bottom-up: each node
     stores total mass, centre of mass and a bounding radius.
  3. For every (target block, node) pair evaluate a *conservative* MAC:

         accept  <=>  r_node < theta * (|com_node - com_block| - r_block)

     (or the relative criterion, see mac_masks). Nodes whose parent was
     already accepted are masked off top-down.
  4. Far field: accepted nodes contribute their monopole, evaluated densely
     (every star against every node, masked by the accept matrices) in
     plain torch at full f32 — no TF32 anywhere (the package turns it off
     at import): the gram-form r^2 cancels, and a reduced-precision product
     poisons the masked near pairs with NaN.
  5. Near field: leaf blocks that survive unaccepted (the block itself
     included) are resolved by exact pair sums over ONE flat target-major
     pair list padded to near_budget(kavg, B) (pack_pair_list). On a CUDA
     device in f32 that is the hand-written kernel of ops.cuda_tree
     (csrc/tree.cu); elsewhere its plain version. Both sweep the list
     through cuda_tree.near_items: source blocks of padding slots only
     (which pair with every other padding block, 61 % of the list at
     N = 409600) are left out, and each target's run is cut into items of
     bounded length (partner counts are heavy-tailed on fractal ICs). Pairs
     past the budget are dropped and `overflow` is set; the sweep
     factories then poison the forces with NaN on the device.

With a velocity-built tree the tier carries JERK (far field: monopole
jerk with nodes moving at their mass-weighted mean velocities; near field:
exact pairwise jerk), so hermite4_block runs over tree forces.

Everything runs eagerly on the device of its inputs: the level loops of
the tree build and the MAC, and the far field's chunk loop, are Python
loops over a few dozen small torch operations each.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..units import G_INTERNAL
from . import cuda_nbody, cuda_tree


# ---------------------------------------------------------------------------
# Morton (Z-order) keys — 10 bits per axis, int32-safe (30-bit keys).
# Ties inside one 1/1024-box cell are harmless (the tree works on the
# positions; the keys only choose the ordering) — but the sort must be
# stable so both packages break them the same way.
# ---------------------------------------------------------------------------
def _spread_bits_10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 x so consecutive bits land 3 apart
    (standard magic-number bit interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_keys(pos: torch.Tensor) -> torch.Tensor:
    """int32 Z-order keys for pos [N,3], normalised to the data bounds
    (the float -> int32 cast truncates, as in the JAX package)."""
    lo = torch.amin(pos, dim=0)
    hi = torch.amax(pos, dim=0)
    span = torch.clamp(hi - lo, min=1e-30)
    q = ((pos - lo) / span * 1023.0).to(torch.int32)
    q = torch.clamp(q, 0, 1023)
    return (
        _spread_bits_10(q[:, 0])
        | (_spread_bits_10(q[:, 1]) << 1)
        | (_spread_bits_10(q[:, 2]) << 2)
    )


class BlockTree(NamedTuple):
    """Complete binary tree over Morton-sorted equal-count leaf blocks.

    levels[l] holds (mass [2^l], com [2^l,3], radius [2^l]) for the 2^l
    nodes at depth l; levels[-1] are the leaves (one per block). A tree
    built with velocities also carries vel_s and the per-node
    mass-weighted mean velocities vcoms; otherwise they are None.
    """

    order: torch.Tensor        # [Np] sorted-particle -> original index
    pos_s: torch.Tensor        # [B, L, 3] sorted, padded positions
    mass_s: torch.Tensor       # [B, L] sorted, padded masses (pad = 0)
    gidx_s: torch.Tensor       # [B, L] original index per slot (pad = Np..)
    masses: Tuple[torch.Tensor, ...]
    coms: Tuple[torch.Tensor, ...]
    radii: Tuple[torch.Tensor, ...]
    vel_s: torch.Tensor | None = None      # [B, L, 3] sorted velocities
    vcoms: Tuple[torch.Tensor, ...] | None = None  # per-level velocities


def near_budget(kavg: int, b: int, chunk: int = 8) -> int:
    """Near-field pair-list length: kavg * B rounded up to a multiple of
    `chunk`, capped at B^2. One definition for the kernel and its plain
    version, so both overflow at the same count."""
    budget = min(kavg * b, b * b)
    return min(-(-budget // chunk) * chunk, b * b)


def pack_pair_list(p2p: torch.Tensor, kavg: int, chunk: int = 8):
    """Flat target-major near-field pair list from the [B, B] mask, padded
    to near_budget: (ti int32, sj int32, ok bool, overflow 0-dim bool), all
    1-D of length near_budget(kavg, B, chunk). The true entries come first
    in row-major order (a stable sort of ~flat, as uint8); padding entries
    carry ok=False with ti = sj = 0. Nothing is read back to the host."""
    b = p2p.shape[0]
    budget = near_budget(kavg, b, chunk)
    flat = p2p.reshape(-1)
    overflow = torch.sum(flat) > budget
    idx = torch.argsort((~flat).to(torch.uint8), stable=True)[:budget]
    ok = flat[idx]
    ti = torch.where(ok, idx // b, 0).to(torch.int32)
    sj = torch.where(ok, idx % b, 0).to(torch.int32)
    return ti, sj, ok, overflow


def aref_block_min(tree: BlockTree, aref: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Per-block minimum reference-acceleration magnitudes [B] for the
    relative MAC: the per-star |a| [N] sorted into tree order, padding
    slots at +inf so they never weaken a block's bound."""
    pad = tree.gidx_s.numel() - n
    aref_s = aref[tree.order]
    if pad:
        aref_s = torch.cat([aref_s, aref.new_full((pad,), float("inf"))])
    return torch.amin(aref_s.reshape(tree.pos_s.shape[0], -1), dim=1)


def build_block_tree(pos: torch.Tensor, mass: torch.Tensor, leaf: int,
                     vel: torch.Tensor | None = None) -> BlockTree:
    """Sort by Morton key (stable), pad to B = 2^D blocks of `leaf`,
    reduce the node properties bottom-up. Padding slots replicate the last
    sorted star's position with zero mass, so they never perturb a centre
    of mass or inflate a bounding radius. Passing `vel` also sorts the
    velocities and reduces per-node mass-weighted mean velocities."""
    n = pos.shape[0]
    nblocks = -(-n // leaf)
    depth = max(1, (nblocks - 1).bit_length())
    b = 1 << depth
    npad = b * leaf

    order = torch.argsort(morton_keys(pos), stable=True)
    pos_sorted = pos[order]
    mass_sorted = mass[order]
    vel_sorted = vel[order] if vel is not None else None

    pad = npad - n
    if pad:
        pos_sorted = torch.cat([pos_sorted, pos_sorted[-1:].expand(pad, 3)])
        mass_sorted = torch.cat([mass_sorted, mass.new_zeros(pad)])
        if vel_sorted is not None:
            vel_sorted = torch.cat([vel_sorted, vel.new_zeros((pad, 3))])
    pos_s = pos_sorted.reshape(b, leaf, 3)
    mass_s = mass_sorted.reshape(b, leaf)
    vel_s = (vel_sorted.reshape(b, leaf, 3)
             if vel_sorted is not None else None)
    gidx = torch.cat([order, torch.arange(n, npad, device=pos.device)]
                     ).reshape(b, leaf)

    # leaves
    m_leaf = torch.sum(mass_s, dim=1)                          # [B]
    wsum = torch.sum(pos_s * mass_s[..., None], dim=1)         # [B,3]
    m_safe = torch.clamp(m_leaf, min=1e-30)[:, None]
    com_leaf = torch.where(m_leaf[:, None] > 0.0, wsum / m_safe,
                           torch.mean(pos_s, dim=1))
    r_leaf = torch.sqrt(torch.amax(
        torch.sum((pos_s - com_leaf[:, None, :]) ** 2, dim=-1), dim=1))

    masses = [m_leaf]
    coms = [com_leaf]
    radii = [r_leaf]
    vcoms = None
    if vel_s is not None:
        vw = torch.sum(vel_s * mass_s[..., None], dim=1)
        vcoms = [torch.where(m_leaf[:, None] > 0.0, vw / m_safe, 0.0)]
    while masses[0].shape[0] > 1:
        mc = masses[0].reshape(-1, 2)
        cc = coms[0].reshape(-1, 2, 3)
        rc = radii[0].reshape(-1, 2)
        mp = torch.sum(mc, dim=1)
        wp = torch.sum(cc * mc[..., None], dim=1)
        mp_safe = torch.clamp(mp, min=1e-30)[:, None]
        cp = torch.where(mp[:, None] > 0.0, wp / mp_safe,
                         torch.mean(cc, dim=1))
        rp = torch.amax(
            torch.sqrt(torch.sum((cc - cp[:, None, :]) ** 2, dim=-1)) + rc,
            dim=1)
        masses.insert(0, mp)
        coms.insert(0, cp)
        radii.insert(0, rp)
        if vcoms is not None:
            vc = vcoms[0].reshape(-1, 2, 3)
            vp = torch.sum(vc * mc[..., None], dim=1)
            vcoms.insert(0, torch.where(mp[:, None] > 0.0, vp / mp_safe,
                                        0.0))

    return BlockTree(order, pos_s, mass_s, gidx, tuple(masses), tuple(coms),
                     tuple(radii), vel_s,
                     tuple(vcoms) if vcoms is not None else None)


def mac_masks(tree: BlockTree, theta: float, g: float = G_INTERNAL,
              aref: torch.Tensor | None = None):
    """Per-level accept matrices.

    Returns (accepts, p2p): accepts[l] is bool [B, 2^l] — node c at level
    l serves target block i as a monopole — and p2p is bool [B, B] — leaf
    block j must be resolved exactly for target block i. Every (target
    star, source star) pair is covered exactly once: a node is accepted at
    the first (shallowest) level whose MAC passes, its subtree is masked
    below, and unaccepted leaves fall through to p2p.

    * geometric (aref=None):  r_node < theta * (d - r_block) — the node
      must subtend less than theta from every star of the target block.
    * relative (aref [B], the per-block minimum reference acceleration
      magnitude): accept iff the worst-case monopole truncation error is a
      small fraction of the actual force,

          3 G M_node r_node^2 / d_min^4  <  theta * aref_block,

      with d_min = d - r_block and the expansion-validity guard
      d_min > r_node (Springel 2005, GADGET-2 eq. 18, adapted to bounding
      spheres); `theta` is then the tolerance alpha.
    """
    b = tree.pos_s.shape[0]
    com_b = tree.coms[-1]                                      # [B,3]
    r_b = tree.radii[-1]                                       # [B]

    accepts = []
    avail = torch.ones((b, 1), dtype=torch.bool, device=com_b.device)
    for m_l, com_l, r_l in zip(tree.masses, tree.coms, tree.radii):
        d = torch.sqrt(torch.sum(
            (com_l[None, :, :] - com_b[:, None, :]) ** 2, dim=-1))  # [B,2^l]
        if aref is None:
            ok = r_l[None, :] < theta * (d - r_b[:, None])
        else:
            dmin = d - r_b[:, None]
            valid = dmin > r_l[None, :]
            d2 = torch.clamp(dmin, min=1e-30)
            d2 = d2 * d2
            err = 3.0 * g * m_l[None, :] * r_l[None, :] ** 2 / (d2 * d2)
            ok = valid & (err < theta * aref[:, None])
        acc = avail & ok
        accepts.append(acc)
        if m_l.shape[0] < b:
            avail = (avail & ~acc).repeat_interleave(2, dim=1)  # [B,2^(l+1)]
    p2p = avail & ~accepts[-1]                                 # [B, B]
    return accepts, p2p


def _monopole_far_field(tree, accepts, eps2, g, pot_eps2, chunk=128,
                        with_jerk=False):
    """Masked dense point-node monopole sweep over all tree levels
    flattened into one node axis (C_tot = 2B - 1 nodes). See
    _far_field_rows for the arithmetic and the monopole jerk."""
    m_all = torch.cat(tree.masses)                             # [C]
    com_all = torch.cat(tree.coms, dim=0)                      # [C,3]
    mask_all = torch.cat(accepts, dim=1)                       # [B,C]
    w_all = torch.where(mask_all, m_all[None, :], 0.0)         # [B,C]
    vcom_all = torch.cat(tree.vcoms, dim=0) if with_jerk else None
    return _far_field_rows(tree.pos_s, tree.vel_s, w_all, com_all,
                           vcom_all, eps2, g, pot_eps2, chunk, with_jerk)


def _far_field_rows(pos_s, vel_s, w_all, com_all, vcom_all, eps2, g,
                    pot_eps2, chunk=128, with_jerk=False):
    """Far field of target blocks pos_s/vel_s [B, L, 3] against the node
    axis com_all/vcom_all [C, 3] with masked weights w_all [B, C], in
    target-block chunks so peak memory is [chunk, L, C] whatever N.

    The quadratic forms use the matmul identity r^2 = |x|^2 + |c|^2 - 2 x.c
    and the monopole sum factorises as (sum_c s_c com_c) - pos * sum_c s_c,
    as in the JAX package; accepted nodes are far (d > r_node / theta), so
    the identity's cancellation is bounded where the weights are nonzero,
    and the clamp to 1e-30 keeps the masked near pairs (which may cancel
    below zero) from producing 0 * NaN. With `with_jerk` the monopole jerk

        jerk_i = G sum_c [ s_c v_rel - 3 s_c (d.v_rel)/r^2 d ],
        d = com_c - x_i,  v_rel = vcom_c - v_i,  s_c = m_c / r^3,

    is factorised the same way. The products run in full f32 on a CUDA
    device (TF32 stays off)."""
    b, leaf, _ = pos_s.shape
    com_sq = torch.sum(com_all * com_all, dim=-1)              # [C]
    # cap each [chunk, L, C] temporary at 32 Mi elements (several are live
    # at once); chunk is a power of two, so it divides b exactly
    c_tot = int(com_all.shape[0])
    cap = max(1, (32 * 1024 * 1024) // max(leaf * c_tot, 1))
    cap = 1 << (cap.bit_length() - 1)
    chunk = min(chunk, b, cap)
    if with_jerk:
        cvdot = torch.sum(com_all * vcom_all, dim=-1)          # [C]

    accs, jerks, pots = [], [], []
    for s0 in range(0, b, chunk):
        pos_c = pos_s[s0:s0 + chunk]                           # [Bc,L,3]
        w_c = w_all[s0:s0 + chunk]                             # [Bc,C]
        dot = torch.einsum("blk,ck->blc", pos_c, com_all)
        r2 = torch.clamp(
            torch.sum(pos_c * pos_c, dim=-1)[..., None]
            + com_sq[None, None, :] - 2.0 * dot + eps2, min=1e-30)
        inv_r = torch.rsqrt(r2)
        s = w_c[:, None, :] * inv_r / r2                       # [Bc,L,C]
        s_sum = torch.sum(s, dim=-1)[..., None]
        accs.append(g * (torch.einsum("blc,ck->blk", s, com_all)
                         - pos_c * s_sum))
        if with_jerk:
            vel_c = vel_s[s0:s0 + chunk]
            xv = torch.sum(pos_c * vel_c, dim=-1)              # [Bc,L]
            rv = (cvdot[None, None, :]
                  - torch.einsum("blk,ck->blc", vel_c, com_all)
                  - torch.einsum("blk,ck->blc", pos_c, vcom_all)
                  + xv[..., None])                             # [Bc,L,C]
            q = 3.0 * s * rv / r2
            q_sum = torch.sum(q, dim=-1)[..., None]
            jerks.append(g * (torch.einsum("blc,ck->blk", s, vcom_all)
                              - vel_c * s_sum
                              - torch.einsum("blc,ck->blk", q, com_all)
                              + pos_c * q_sum))
        if pot_eps2 is not None:
            r2p = torch.clamp(r2 - eps2 + pot_eps2, min=1e-30)
            inv_r = torch.rsqrt(r2p)
        pots.append(-g * torch.sum(w_c[:, None, :] * inv_r, dim=-1))
    jerk = torch.cat(jerks) if with_jerk else None
    return torch.cat(accs), jerk, torch.cat(pots)


def _check_theta(theta: float, aref) -> None:
    """Geometric-MAC validity: the no-self-interaction argument (an
    ancestor node's bounding sphere contains the target block, so it can
    never pass r_node < theta * (d - r_block)) only holds for theta <= 1.
    The relative criterion carries its own d_min > r_node guard, so there
    `theta` is the tolerance alpha and any positive value is safe."""
    if theta <= 0.0:
        raise ValueError(f"tree_theta={theta}: must be > 0")
    if aref is None and theta > 1.0:
        raise ValueError(
            f"tree_theta={theta}: the geometric MAC requires theta <= 1 "
            "(above that an accepted ancestor node would double-count "
            "the target block's own stars); use the relative criterion "
            "(aref) for aggressive opening instead"
        )


def tree_acc_jerk_pot(
    pos: torch.Tensor,
    vel: torch.Tensor | None,
    mass: torch.Tensor,
    eps2: float = 0.0,
    g: float = G_INTERNAL,
    *,
    leaf: int = 256,
    theta: float = 0.5,
    kavg: int = 256,
    pot_eps2: float | None = None,
    aref: torch.Tensor | None = None,
    with_jerk: bool = False,
):
    """Barnes-Hut accelerations [N,3], jerks [N,3] (None unless
    `with_jerk`), potentials [N] and an `overflow` 0-dim bool tensor (true
    => the near-field pair list exceeded near_budget(kavg, B) and the
    result is truncated; size kavg with p2p_partner_counts).

    `aref` [N]: per-star reference acceleration magnitudes switching the
    MAC to the relative criterion at tolerance `theta`; None uses the
    geometric criterion. `pot_eps2` softens the potential separately from
    the forces; None reuses `eps2`. The near field runs the kernel of
    ops.cuda_tree on a CUDA device in f32 (the direct-sum kernels' gate,
    cuda_nbody.use_kernel) and its plain version in the input dtype
    elsewhere."""
    _check_theta(theta, aref)
    n = pos.shape[0]
    tree = build_block_tree(pos, mass, leaf, vel if with_jerk else None)
    aref_b = aref_block_min(tree, aref, n) if aref is not None else None
    accepts, p2p = mac_masks(tree, theta, g, aref_b)
    far_acc, far_jerk, far_pot = _monopole_far_field(
        tree, accepts, eps2, g, pot_eps2, with_jerk=with_jerk)
    near_fn = (cuda_tree.near_field
               if cuda_nbody.use_kernel(n, pos.dtype, pos.device)
               else cuda_tree.near_field_plain)
    near_acc, near_jerk, near_pot, overflow = near_fn(
        tree.pos_s, tree.mass_s, p2p, n, eps2, leaf=leaf, kavg=kavg, g=g,
        pot_eps2=pot_eps2, vel_s=tree.vel_s, with_jerk=with_jerk)
    acc, jerk, pot = unsort(
        tree, far_acc + near_acc,
        far_jerk + near_jerk if with_jerk else None, far_pot + near_pot, n)
    return acc, jerk, pot, overflow


def unsort(tree: BlockTree, acc_s, jerk_s, pot_s, n: int):
    """Block-layout results [B, L, ...] back in the original star order:
    (acc [N,3], jerk [N,3] | None, pot [N]); padding slots (gidx >= n)
    are dropped."""
    acc_s = acc_s.reshape(-1, 3)
    npad = acc_s.shape[0]
    inv = torch.empty(npad, dtype=torch.int64, device=acc_s.device)
    inv.scatter_(0, tree.gidx_s.reshape(-1),
                 torch.arange(npad, device=acc_s.device))
    inv = inv[:n]
    jerk = None if jerk_s is None else jerk_s.reshape(-1, 3)[inv]
    return acc_s[inv], jerk, pot_s.reshape(-1)[inv]


def tree_acc_pot(pos, mass, eps2=0.0, g: float = G_INTERNAL, *,
                 leaf: int = 256, theta: float = 0.5, kavg: int = 256,
                 pot_eps2: float | None = None, aref=None):
    """(acc [N,3], pot [N], overflow) — the jerk-free entry point (the
    leapfrog path and the diagnostics use it)."""
    acc, _, pot, overflow = tree_acc_jerk_pot(
        pos, None, mass, eps2, g, leaf=leaf, theta=theta, kavg=kavg,
        pot_eps2=pot_eps2, aref=aref, with_jerk=False)
    return acc, pot, overflow


def _poison(ovf: torch.Tensor, dtype) -> torch.Tensor:
    """NaN where the pair list overflowed, 0 elsewhere — on the device,
    without reading the flag back: silent force truncation must never pass
    as physics."""
    return torch.where(ovf, float("nan"), 0.0).to(dtype)


def make_tree_sweep(mass, eps2, *, leaf: int, theta: float, kavg: int,
                    pot_eps2: float | None, g: float = G_INTERNAL,
                    with_jerk: bool = False, aref=None):
    """Full sweep `(pos, vel) -> (acc, jerk, pot)` for sim.step, the tree
    counterpart of cuda_nbody.kernel_acc_jerk_pot. `with_jerk=False`
    (leapfrog) returns zeros for jerk; True the tree jerk (hermite4_block).
    A pair-list overflow poisons all three outputs with NaN."""

    def sweep(pos, vel=None):
        acc, jerk, pot, ovf = tree_acc_jerk_pot(
            pos, vel, mass, eps2, g, leaf=leaf, theta=theta, kavg=kavg,
            pot_eps2=pot_eps2, with_jerk=with_jerk, aref=aref)
        poison = _poison(ovf, acc.dtype)
        jerk = torch.zeros_like(acc) if jerk is None else jerk + poison
        return acc + poison, jerk, pot + poison

    return sweep


def make_tree_force(mass, eps2, *, leaf: int, theta: float, kavg: int,
                    g: float = G_INTERNAL):
    """`(pos, vel) -> (acc, jerk)` for the Hermite integrators' force_fn
    hook, geometric MAC (overflow NaN-poisons)."""

    def force_fn(pos, vel):
        acc, jerk, _, ovf = tree_acc_jerk_pot(
            pos, vel, mass, eps2, g, leaf=leaf, theta=theta, kavg=kavg,
            with_jerk=True)
        poison = _poison(ovf, acc.dtype)
        return acc + poison, jerk + poison

    return force_fn


def make_tree_acc(mass, eps2, *, leaf: int, theta: float, kavg: int,
                  g: float = G_INTERNAL):
    """Substep `pos -> acc` for the leapfrog interior evaluations,
    geometric MAC (the potential reuses the force softening)."""

    def acc_fn(pos):
        acc, _, ovf = tree_acc_pot(pos, mass, eps2, g, leaf=leaf,
                                   theta=theta, kavg=kavg)
        return acc + _poison(ovf, acc.dtype)

    return acc_fn


def p2p_partner_counts(pos, mass, leaf: int = 256, theta: float = 0.5,
                       g: float = G_INTERNAL, aref=None) -> torch.Tensor:
    """Per-block near-field partner counts [B] (for sizing
    kavg = ceil(mean count) on a given distribution before a run; overflow
    then flags any drift past the budget)."""
    n = pos.shape[0]
    tree = build_block_tree(pos, mass, leaf)
    aref_b = aref_block_min(tree, aref, n) if aref is not None else None
    _, p2p = mac_masks(tree, theta, g, aref_b)
    return torch.sum(p2p, dim=1)
