"""The port's Barnes-Hut tier (al26_tpu_torch.ops.tree, ops.cuda_tree)
against the JAX package's (al26_tpu.ops.tree), on numpy-seeded inputs.

The JAX side runs on the CPU in f64 through its XLA near field
(_p2p_near_field, its own plain reference); the port through the plain
version of its near-field kernel. Clumpy fixtures (widely separated
Gaussian clumps, the pattern of tests/test_tree.py) make the MAC accept
far nodes. Bars:

* integer structure (Morton keys, sort order, slot indices, accept
  matrices, the packed pair list, partner counts): exactly equal;
* node mass / centre of mass / radius / mean velocity: 1e-12;
* far field, near field and the full sweep: 1e-12 of the max.

Both packages are compared on identical trees where a piece takes a tree
(block_tree_from_numpy carries a JAX BlockTree over).

`test_near_field_kernel_matches_plain_on_card` holds the CUDA kernel
against its f64 plain version on a card and skips elsewhere. The JAX side
is imported by a fixture, so on a machine with the card and no JAX it runs
alone (tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest tests/test_torch_tree.py -m gpu
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from al26_tpu_torch.ops import cuda_tree
from al26_tpu_torch.ops import tree as tt
from al26_tpu_torch.units import G_INTERNAL

torch.set_num_threads(1)

T = torch.as_tensor


@pytest.fixture(scope="module")
def jx():
    """The JAX package's tree module (CPU, x64 from tests/conftest.py)."""
    import jax.numpy as jnp

    from al26_tpu.ops import tree

    return SimpleNamespace(J=jnp.asarray, tree=tree)


def block_tree_from_numpy(jtree, dtype=torch.float64, device="cpu"):
    """The port's BlockTree holding the same bits as a JAX BlockTree."""
    f = lambda a: torch.tensor(np.array(a), dtype=dtype, device=device)
    i = lambda a: torch.tensor(np.array(a), dtype=torch.int64,
                               device=device)
    return tt.BlockTree(
        order=i(jtree.order), pos_s=f(jtree.pos_s), mass_s=f(jtree.mass_s),
        gidx_s=i(jtree.gidx_s),
        masses=tuple(f(a) for a in jtree.masses),
        coms=tuple(f(a) for a in jtree.coms),
        radii=tuple(f(a) for a in jtree.radii),
        vel_s=None if jtree.vel_s is None else f(jtree.vel_s),
        vcoms=(None if jtree.vcoms is None
               else tuple(f(a) for a in jtree.vcoms)),
    )


def _clumpy(rng, n, n_clumps=48, spread=20.0, width=0.3):
    centers = rng.normal(size=(n_clumps, 3)) * spread
    pos = centers[rng.integers(0, n_clumps, n)] \
        + rng.normal(size=(n, 3)) * width
    return pos, rng.normal(size=(n, 3)), rng.uniform(0.1, 5.0, n)


def _gridded(rng, n):
    """Stars on a coarse lattice: many Morton keys tie exactly."""
    pos = rng.integers(0, 6, size=(n, 3)).astype(np.float64) * 3.0
    pos[: n // 2] += rng.normal(size=(n // 2, 3)) * 0.2
    return pos, rng.normal(size=(n, 3)), rng.uniform(0.1, 5.0, n)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _aref(jx, pos, mass, eps2):
    """Exact |a| per star (the JAX chunked sweep), for the relative MAC."""
    from al26_tpu.ops.nbody import acc_jerk_pot_chunked

    a, _, _ = acc_jerk_pot_chunked(jx.J(pos), jx.J(pos) * 0.0, jx.J(mass),
                                   eps2, block=512)
    return np.linalg.norm(np.asarray(a), axis=1)


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,n,leaf", [
    ("clumpy", 900, 128),       # 900 -> 8 blocks, 124 padding slots
    ("gridded", 1000, 64),      # tied keys: the stable sort decides
])
def test_morton_order_and_nodes_match_jax(jx, case, n, leaf):
    rng = np.random.default_rng(19)
    pos, vel, mass = (_clumpy if case == "clumpy" else _gridded)(rng, n)
    kj = np.asarray(jx.tree.morton_keys(jx.J(pos)))
    kt = tt.morton_keys(T(pos)).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert kt.dtype == np.int32
    if case == "gridded":
        assert n - len(np.unique(kj)) > 200     # ties really occur
    trj = jx.tree.build_block_tree(jx.J(pos), jx.J(mass), leaf, jx.J(vel))
    trt = tt.build_block_tree(T(pos), T(mass), leaf, T(vel))
    for f in ("order", "gidx_s", "pos_s", "mass_s", "vel_s"):
        np.testing.assert_array_equal(getattr(trt, f).numpy(),
                                      np.asarray(getattr(trj, f)))
    assert len(trt.masses) == len(trj.masses)
    for f in ("masses", "coms", "radii", "vcoms"):
        for a, b in zip(getattr(trt, f), getattr(trj, f)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)
    # total node mass at every level equals the real total mass
    for m_l in trt.masses:
        assert abs(float(m_l.sum()) - mass.sum()) < 1e-12 * mass.sum()


@pytest.mark.parametrize("mac", ["geometric", "relative"])
def test_mac_masks_pair_list_and_counts_match_jax(jx, mac):
    rng = np.random.default_rng(7)
    n, leaf, eps2 = 4096, 64, 1e-4
    pos, vel, mass = _clumpy(rng, n)
    theta, aref = 0.75, None
    if mac == "relative":
        theta, aref = 3e-3, _aref(jx, pos, mass, eps2)
    trj = jx.tree.build_block_tree(jx.J(pos), jx.J(mass), leaf)
    trt = block_tree_from_numpy(trj)
    aref_bj = aref_bt = None
    if aref is not None:
        aref_bj = jx.tree.aref_block_min(trj, jx.J(aref), n)
        aref_bt = tt.aref_block_min(trt, T(aref), n)
        np.testing.assert_array_equal(aref_bt.numpy(), np.asarray(aref_bj))
    acc_j, p2p_j = jx.tree.mac_masks(trj, theta, G_INTERNAL, aref_bj)
    acc_t, p2p_t = tt.mac_masks(trt, theta, G_INTERNAL, aref_bt)
    for a, b in zip(acc_t, acc_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(p2p_t.numpy(), np.asarray(p2p_j))
    b = p2p_t.shape[0]
    assert 0 < int(p2p_t.sum()) < 0.5 * b * b      # the MAC is engaged
    mean = float(p2p_t.sum(1).double().mean())
    for kavg in (int(mean) + 4, 1, b):             # fits, overflows, all
        for x, y in zip(tt.pack_pair_list(p2p_t, kavg),
                        jx.tree.pack_pair_list(p2p_j, kavg)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert bool(tt.pack_pair_list(p2p_t, 1)[3])
    cnt_j = jx.tree.p2p_partner_counts(
        jx.J(pos), jx.J(mass), leaf=leaf, theta=theta,
        aref=None if aref is None else jx.J(aref))
    cnt_t = tt.p2p_partner_counts(T(pos), T(mass), leaf=leaf, theta=theta,
                                  aref=None if aref is None else T(aref))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))


def test_near_budget_matches_jax(jx):
    for kavg, b in ((1, 2), (3, 16), (171, 2048), (5000, 64), (7, 1)):
        assert tt.near_budget(kavg, b) == jx.tree.near_budget(kavg, b)


# ---------------------------------------------------------------------------
# far field, near field, full sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_jerk", [False, True])
@pytest.mark.parametrize("pot_eps2", [None, 1e-30])
def test_far_field_matches_jax(jx, with_jerk, pot_eps2):
    rng = np.random.default_rng(23)
    pos, vel, mass = _clumpy(rng, 1500)
    trj = jx.tree.build_block_tree(jx.J(pos), jx.J(mass), 64, jx.J(vel))
    trt = block_tree_from_numpy(trj)
    acc_j, _ = jx.tree.mac_masks(trj, 0.75)
    acc_t, _ = tt.mac_masks(trt, 0.75)
    fj = jx.tree._monopole_far_field(trj, acc_j, 1e-4, G_INTERNAL, pot_eps2,
                                     with_jerk=with_jerk)
    ft = tt._monopole_far_field(trt, acc_t, 1e-4, G_INTERNAL, pot_eps2,
                                with_jerk=with_jerk)
    assert _rel(ft[0], fj[0]) < 1e-12
    assert _rel(ft[2], fj[2]) < 1e-12
    if with_jerk:
        assert _rel(ft[1], fj[1]) < 1e-12
    else:
        assert ft[1] is None
    # the chunk loop does not change the result (a small chunk forces many)
    ft8 = tt._far_field_rows(trt.pos_s, trt.vel_s,
                             torch.where(torch.cat(acc_t, 1),
                                         torch.cat(trt.masses)[None], 0.0),
                             torch.cat(trt.coms), None, 1e-4, G_INTERNAL,
                             pot_eps2, chunk=2)
    assert _rel(ft8[0], fj[0]) < 1e-12


@pytest.mark.parametrize("with_jerk", [False, True])
@pytest.mark.parametrize("pot_eps2", [None, 1e-30])
def test_near_field_plain_matches_jax(jx, with_jerk, pot_eps2):
    rng = np.random.default_rng(29)
    n, leaf, eps2 = 1700, 64, 1e-4            # 1700 -> 32 blocks, padded
    pos, vel, mass = _clumpy(rng, n)
    trj = jx.tree.build_block_tree(jx.J(pos), jx.J(mass), leaf, jx.J(vel))
    trt = block_tree_from_numpy(trj)
    _, p2p_j = jx.tree.mac_masks(trj, 0.75)
    p2p_t = torch.tensor(np.array(p2p_j))
    kavg = int(np.asarray(p2p_j).sum(1).mean()) + 4
    aj, jj, pj, oj = jx.tree._p2p_near_field(trj, p2p_j, eps2, G_INTERNAL,
                                             pot_eps2, kavg,
                                             with_jerk=with_jerk)
    before = dict(cuda_tree.LAUNCHES)
    outs = [f(trt.pos_s, trt.mass_s, p2p_t, n, eps2, leaf=leaf, kavg=kavg,
              pot_eps2=pot_eps2, vel_s=trt.vel_s, with_jerk=with_jerk)
            for f in (cuda_tree.near_field_plain, cuda_tree.near_field)]
    assert cuda_tree.LAUNCHES == before       # CPU tensors: plain version
    at, jt, pt, ot = outs[0]
    assert not bool(ot) and not bool(oj)
    assert _rel(at, aj) < 1e-12
    assert _rel(pt, pj) < 1e-12
    if with_jerk:
        assert _rel(jt, jj) < 1e-12
    else:
        assert jt is None
    for x, y in zip(outs[0], outs[1]):        # the wrapper IS the plain
        if x is not None:                     # version on the CPU
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    # too small a budget: both flag the overflow
    assert bool(cuda_tree.near_field_plain(
        trt.pos_s, trt.mass_s, p2p_t, n, eps2, leaf=leaf, kavg=1)[3])


def test_pair_runs_cover_the_pair_list():
    """Each target block's run of the packed list, as the item table reads
    it (from its first item's first pair), holds the target's listed
    source blocks in order, and its swept head is exactly those that hold
    a real star."""
    rng = np.random.default_rng(31)
    p2p = T(rng.uniform(size=(16, 16)) < 0.3) | torch.eye(16, dtype=bool)
    leaf, n_true = 8, 101                    # blocks 13-15 are padding
    for kavg in (16, 3):
        it = cuda_tree.near_items(p2p, kavg, n_true, leaf)
        ti, sj, ok, ovf2 = tt.pack_pair_list(p2p, kavg)
        assert bool(it.overflow) == bool(ovf2) == (int(p2p.sum()) > 16 * kavg)
        for t in range(16):
            start = int(it.item[1, int(it.tinfo[0, t])])
            want = sj[ok & (ti == t)]
            run = it.src[start:start + len(want)]
            np.testing.assert_array_equal(run.numpy(), want.numpy())
            real = want[want.long() * leaf < n_true]
            np.testing.assert_array_equal(
                run[:int(it.kept[t])].numpy(), real.numpy())
            if not bool(it.overflow):
                np.testing.assert_array_equal(
                    run.numpy(), torch.nonzero(p2p[t])[:, 0].numpy())


def _padded_tree(dtype=torch.float64):
    """A clumpy n = 1700 tree at leaf 64: 27 blocks hold stars (the last
    one straddles n), 5 of the 32 are padding; its MAC and a budget that
    fits."""
    rng = np.random.default_rng(29)
    n, leaf = 1700, 64
    pos, vel, mass = (T(a, dtype=dtype) for a in _clumpy(rng, n))
    tree = tt.build_block_tree(pos, mass, leaf, vel)
    _, p2p = tt.mac_masks(tree, 0.75)
    kavg = int(p2p.sum(1).double().mean()) + 4
    return tree, p2p, n, leaf, kavg


@pytest.mark.parametrize("item_pairs,kavg", [(1, None), (3, None),
                                             (16, None), (3, 2)])
def test_near_items_cover_kept_pairs_once(item_pairs, kavg):
    """The work items take every listed pair whose source block holds a
    real star exactly once and no all-padding source; each holds at most
    `item_pairs` pairs, each target owns a run of consecutive items (at
    least one), and the table fits its static bound with the surplus
    items past the real ones (kavg = 2 overflows: the listed pairs
    only)."""
    tree, p2p, n, leaf, fit = _padded_tree()
    kavg = kavg or fit
    b = p2p.shape[0]
    real = -(-n // leaf)
    assert (b, real) == (32, 27)
    it = cuda_tree.near_items(p2p, kavg, n, leaf, item_pairs)
    ti, sj, ok, ovf = tt.pack_pair_list(p2p, kavg)
    assert bool(ovf) == (kavg == 2)
    budget = ti.shape[0]
    n_items = it.item.shape[1]
    assert n_items == cuda_tree.item_bound(b, budget, item_pairs)
    first, chunks = (x.long() for x in it.tinfo)
    n_real = int(chunks.sum())
    assert n_real <= n_items and bool((chunks >= 1).all())
    owner, p0, npairs = (x.long() for x in it.item)
    np.testing.assert_array_equal(
        owner[:n_real].numpy(),
        torch.repeat_interleave(torch.arange(b), chunks).numpy())
    np.testing.assert_array_equal(first.numpy(),
                                  (torch.cumsum(chunks, 0) - chunks).numpy())
    assert bool((owner[n_real:] == b).all()) and not npairs[n_real:].any()
    assert bool((npairs <= item_pairs).all())
    got = []
    for i in range(n_real):
        for p in range(int(p0[i]), int(p0[i] + npairs[i])):
            got.append((int(owner[i]), int(it.src[p])))
    listed = [(int(t), int(s)) for t, s, k in zip(ti, sj, ok) if k]
    want = [(t, s) for t, s in listed if s < real]
    assert sorted(got) == sorted(want) and len(set(got)) == len(got)
    assert all(s < real for _, s in got)
    assert int(it.kept.sum()) == len(want)
    if kavg == fit:
        assert len(listed) == int(p2p.sum())
        assert len(listed) - len(want) > 0        # padding pairs dropped


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dropping_padding_sources_changes_no_row(dtype):
    """Every pair of the list whose source block holds only padding adds
    exact zeros to every target row (padding rows included), so the sum
    over the list in its order is the same, bit for bit, with or without
    them; near_field_plain (through the items) agrees with it to
    round-off."""
    tree, p2p, n, leaf, kavg = _padded_tree(dtype=dtype)
    ti, sj, ok, _ = tt.pack_pair_list(p2p, kavg)
    ti, sj = ti[ok], sj[ok]
    pad = sj.long() * leaf >= n
    assert int(pad.sum()) > 0 and bool((ti.long() * leaf >= n).any())
    kw = dict(eps2=1e-4, pot_eps2=1e-30, vel_s=tree.vel_s, with_jerk=True)
    sums = cuda_tree.pair_sums(tree.pos_s, tree.mass_s, ti, sj, n, **kw)
    assert not sums[pad].any()
    b = p2p.shape[0]
    full = torch.zeros((b, leaf, 7), dtype=dtype).index_add_(0, ti.long(),
                                                             sums)
    kept = torch.zeros((b, leaf, 7), dtype=dtype).index_add_(
        0, ti[~pad].long(), sums[~pad])
    np.testing.assert_array_equal(kept.numpy(), full.numpy())
    acc, jerk, pot, ovf = cuda_tree.near_field_plain(
        tree.pos_s, tree.mass_s, p2p, n, leaf=leaf, kavg=kavg, **kw)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert not bool(ovf)
    assert _rel(acc, G_INTERNAL * full[..., 0:3]) < tol
    assert _rel(jerk, G_INTERNAL * full[..., 3:6]) < tol
    assert _rel(pot, G_INTERNAL * full[..., 6]) < tol


@pytest.mark.parametrize("mac", ["geometric", "relative"])
@pytest.mark.parametrize("with_jerk", [False, True])
@pytest.mark.parametrize("pot_eps2", [None, 1e-30])
def test_tree_acc_jerk_pot_matches_jax(jx, mac, with_jerk, pot_eps2):
    rng = np.random.default_rng(37)
    n, leaf, eps2 = 4096, 64, 1e-4
    pos, vel, mass = _clumpy(rng, n)
    theta, aref_j, aref_t = 0.75, None, None
    if mac == "relative":
        aref = _aref(jx, pos, mass, eps2)
        theta, aref_j, aref_t = 3e-3, jx.J(aref), T(aref)
    cnt = tt.p2p_partner_counts(T(pos), T(mass), leaf=leaf, theta=theta,
                                aref=aref_t)
    kavg = int(cnt.double().mean()) + 4
    assert float(cnt.double().mean()) < 0.5 * len(cnt)   # MAC engaged
    kw = dict(leaf=leaf, theta=theta, kavg=kavg, pot_eps2=pot_eps2,
              with_jerk=with_jerk)
    aj, jj, pj, oj = jx.tree.tree_acc_jerk_pot(
        jx.J(pos), jx.J(vel), jx.J(mass), eps2, aref=aref_j,
        near_impl="xla", **kw)
    before = dict(cuda_tree.LAUNCHES)
    at, jt, pt, ot = tt.tree_acc_jerk_pot(T(pos), T(vel), T(mass), eps2,
                                          aref=aref_t, **kw)
    assert cuda_tree.LAUNCHES == before       # CPU tensors: plain version
    assert not bool(oj) and not bool(ot)
    assert _rel(at, aj) < 1e-12
    assert _rel(pt, pj) < 1e-12
    if with_jerk:
        assert _rel(jt, jj) < 1e-12
    else:
        assert jt is None


def test_small_n_tree_is_exact_in_f32():
    """All-P2P scale in f32 (the dtype of the card's path): the tree sweep
    equals the plain direct sweep to f32 round-off, through the padding
    and the unsort."""
    from al26_tpu_torch.ops.cuda_nbody import nbody_rows_plain

    rng = np.random.default_rng(3)
    pos, vel, mass = (T(a, dtype=torch.float32)
                      for a in _clumpy(rng, 1500, width=3.0, spread=2.0))
    ids = torch.arange(1500, dtype=torch.int32)
    a, j, p, ovf = tt.tree_acc_jerk_pot(pos, vel, mass, 1e-4, leaf=128,
                                        theta=0.75, kavg=16, with_jerk=True,
                                        pot_eps2=1e-30)
    ar, jr, pr = nbody_rows_plain(pos.double(), vel.double(), ids,
                                  pos.double(), vel.double(), mass.double(),
                                  1e-4, pot_eps2=1e-30)
    assert not bool(ovf) and a.dtype == torch.float32
    assert _rel(a, ar) < 1e-5 and _rel(j, jr) < 1e-5 and _rel(p, pr) < 1e-5


def test_overflow_poisons_with_nan(jx):
    rng = np.random.default_rng(13)
    pos, vel, mass = _clumpy(rng, 2048)
    _, _, ovf = tt.tree_acc_pot(T(pos), T(mass), 1e-4, leaf=128,
                                theta=0.75, kavg=1)
    _, _, ovf_j = jx.tree.tree_acc_pot(jx.J(pos), jx.J(mass), 1e-4,
                                       leaf=128, theta=0.75, kavg=1,
                                       near_impl="xla")
    assert bool(ovf) and bool(ovf_j)
    kw = dict(leaf=128, theta=0.75, kavg=1)
    acc, jerk, pot = tt.make_tree_sweep(T(mass), 1e-4, pot_eps2=1e-30,
                                        with_jerk=True, **kw)(T(pos), T(vel))
    assert torch.isnan(acc).all() and torch.isnan(jerk).all()
    assert torch.isnan(pot).all()
    a, j = tt.make_tree_force(T(mass), 1e-4, **kw)(T(pos), T(vel))
    assert torch.isnan(a).all() and torch.isnan(j).all()
    assert torch.isnan(tt.make_tree_acc(T(mass), 1e-4, **kw)(T(pos))).all()
    # a sufficient budget is clean; the jerk-free sweep returns zero jerk
    cnt = tt.p2p_partner_counts(T(pos), T(mass), leaf=128, theta=0.75)
    sweep = tt.make_tree_sweep(T(mass), 1e-4, leaf=128, theta=0.75,
                               kavg=int(cnt.double().mean()) + 4,
                               pot_eps2=1e-30)
    acc, jerk, pot = sweep(T(pos))
    assert torch.isfinite(acc).all() and torch.isfinite(pot).all()
    assert jerk.shape == acc.shape and not jerk.any()


def test_theta_and_argument_guards():
    pos = T(np.random.default_rng(43).normal(size=(256, 3)))
    mass = torch.ones(256, dtype=torch.float64)
    with pytest.raises(ValueError, match="theta <= 1"):
        tt.tree_acc_pot(pos, mass, 1e-4, leaf=128, theta=1.5, kavg=8)
    with pytest.raises(ValueError, match="must be > 0"):
        tt.tree_acc_pot(pos, mass, 1e-4, leaf=128, theta=0.0, kavg=8)
    # the relative criterion takes any positive tolerance
    tt.tree_acc_pot(pos, mass, 1e-4, leaf=128, theta=5.0, kavg=8,
                    aref=torch.ones(256, dtype=torch.float64))
    tree = tt.build_block_tree(pos, mass, 64)
    p2p = torch.ones((4, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="leaf"):
        cuda_tree.near_field(tree.pos_s, tree.mass_s, p2p, 256, 1e-4,
                             leaf=128, kavg=4)
    with pytest.raises(ValueError, match="vel_s"):
        cuda_tree.near_field(tree.pos_s, tree.mass_s, p2p, 256, 1e-4,
                             leaf=64, kavg=4, with_jerk=True)
    with pytest.raises(ValueError, match="p2p"):
        cuda_tree.near_field(tree.pos_s, tree.mass_s, p2p[:2], 256, 1e-4,
                             leaf=64, kavg=4)


def test_uncached_relative_step_raises():
    """R2: tree_mac='relative' reaches the integrator only through the
    force cache; an uncached step raises instead of opening
    geometrically, and the cached runners go through."""
    from al26_tpu_torch.config import SimConfig
    from al26_tpu_torch.sim import init_cluster

    port_step = importlib.import_module("al26_tpu_torch.sim.step")
    cfg = SimConfig(n=300, rc=1.0, final_time=0.1, n_plot=10,
                    steps_per_plot=1, seed=42, model="fractal", dtype="f64",
                    force_impl="tree", tree_leaf=16, tree_mac="relative")
    ts, ta, tcfg = init_cluster(cfg, device="cpu")
    assert tcfg.integrator == "hermite4_block"
    with pytest.raises(ValueError, match="relative"):
        port_step.step(ts, ta, tcfg, force_impl="tree")
    with pytest.raises(ValueError, match="relative"):
        port_step.run_steps(ts, ta, tcfg.replace(force_cache=False), 1,
                            force_impl="tree")
    cache = port_step.fresh_cache(ts, tcfg, "hermite4_block", None, "tree")
    s, cache = port_step.run_steps_cached(ts, cache, ta, tcfg, 1, None,
                                          "tree")
    assert torch.isfinite(s.cluster.pos).all()
    assert all(torch.isfinite(c).all() for c in cache)


@pytest.mark.gpu
def test_near_field_kernel_matches_plain_on_card(monkeypatch):
    """Kernel 3 against its f64 plain version on the card (1e-5 of the max,
    the bar of tests/test_tree.py's Pallas-vs-XLA near field), with
    padding, a leaf wider than a CTA's row pass (512), a narrow one (32),
    jerk and the separate potential softening, items of the wrapper's size
    and of 2 pairs (targets with several items: the ordered sum); the
    overflow flag; the same bits on a repeat run; and the whole tree sweep
    through the kernel against the same sweep through the plain near
    field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    for n, leaf in ((900, 128), (5000, 512), (3000, 32), (1700, 64)):
        pos, vel, mass = (T(a, dtype=torch.float32, device=dev)
                          for a in _clumpy(rng, n))
        tree = tt.build_block_tree(pos, mass, leaf, vel)
        _, p2p = tt.mac_masks(tree, 0.75)
        kavg = int(p2p.sum(1).double().mean()) + 4
        d = lambda t: None if t is None else t.double()
        for with_jerk, pot_eps2, items in ((False, None, 2), (False, 1e-30, 0),
                                           (True, None, 0), (True, 1e-30, 2)):
            with monkeypatch.context() as mp:
                if items:
                    mp.setattr(cuda_tree, "ITEM_PAIRS", items)
                kw = dict(leaf=leaf, kavg=kavg, pot_eps2=pot_eps2,
                          with_jerk=with_jerk)
                before = cuda_tree.LAUNCHES["near_field"]
                got = cuda_tree.near_field(tree.pos_s, tree.mass_s, p2p, n,
                                           1e-4, vel_s=tree.vel_s, **kw)
                assert cuda_tree.LAUNCHES["near_field"] == before + 1
                ref = cuda_tree.near_field_plain(
                    d(tree.pos_s), d(tree.mass_s), p2p, n, 1e-4,
                    vel_s=d(tree.vel_s), **kw)
                assert not bool(got[3]) and not bool(ref[3])
                for g_, r_ in zip(got[:3], ref[:3]):
                    if r_ is None:
                        assert g_ is None
                    else:
                        assert _rel(g_.cpu(), r_.cpu()) < 1e-5
                again = cuda_tree.near_field(tree.pos_s, tree.mass_s, p2p,
                                             n, 1e-4, vel_s=tree.vel_s, **kw)
                for g_, a_ in zip(got[:3], again[:3]):
                    if g_ is not None:
                        assert torch.equal(g_, a_)
        assert bool(cuda_tree.near_field(tree.pos_s, tree.mass_s, p2p, n,
                                         1e-4, leaf=leaf, kavg=1)[3])
        # the whole sweep on the card, kernel against plain near field (the
        # same tree and far field bits; only the near field differs)
        kw = dict(leaf=leaf, theta=0.75, kavg=kavg, with_jerk=True,
                  pot_eps2=1e-30)
        got = tt.tree_acc_jerk_pot(pos, vel, mass, 1e-4, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(cuda_tree, "near_field", cuda_tree.near_field_plain)
            ref = tt.tree_acc_jerk_pot(pos, vel, mass, 1e-4, **kw)
        assert not bool(got[3]) and not bool(ref[3])
        for g_, r_ in zip(got[:3], ref[:3]):
            assert _rel(g_.cpu(), r_.cpu()) < 1e-5
    torch.cuda.synchronize()
