"""The roofline arithmetic on hand-counted pairs, and the pair counter on
the kernel wrappers' plain CPU versions: the direct sum's, and the tree's
near field against a brute count."""
import pytest
import torch

from perfbench.harness import roofline, tracing


def test_bound_full_sweep():
    n, sms, clk = 1024, 132, 1.98e9
    b = roofline.bound_seconds(n * n, True,
                               roofline.rows_bytes(n, n, True, True),
                               sms, clk)
    assert b["fp32"] == pytest.approx(n * n * 50 / 67e12)
    assert b["sfu"] == pytest.approx(n * n / (16 * 132 * 1.98e9))
    assert b["by"] == "fp32" and b["bound"] == b["fp32"]


def test_bound_without_jerk_and_bytes():
    b = roofline.bound_seconds(10, False, 3.35e12, 132, 1.98e9)
    assert b["by"] == "hbm" and b["bound"] == pytest.approx(1.0)
    assert roofline.rows_bytes(2, 5, False, False) == 2 * 28 + 5 * 16
    assert roofline.rows_bytes(1, 1, True, True) == 28 + 28 + 28


def test_pair_counter_counts_algorithm_pairs():
    from al26_tpu_torch.ops import cuda_nbody

    g = torch.Generator().manual_seed(0)
    b, n = 3, 16
    pos = torch.randn(b * n, 3, generator=g)
    vel = torch.randn(b * n, 3, generator=g)
    mass = torch.rand(b * n, generator=g)
    counter = tracing.PairCounter()
    with counter.installed():
        cuda_nbody.kernel_acc_jerk_pot(pos, vel, mass, 0.1, group_size=n)
        cuda_nbody.kernel_acc_jerk_pot(pos[:n], vel[:n], mass[:n], 0.1,
                                       with_jerk=False)
        rows_at = cuda_nbody.make_pred_force_rows(
            pos[:n], vel[:n], torch.zeros(n, 3), torch.zeros(n, 3),
            mass[:n], 0.1)
        rows_at(pos[:4], vel[:4], torch.arange(4), 0.01)
    assert [(p, j) for p, j, _ in counter.calls] == [
        (b * n * n, True), (n * n, False), (4 * n, True)]
    assert cuda_nbody.nbody_rows is not None
    assert counter.calls[2][2] == roofline.predcols_bytes(4, n)


def _fractal(n=6000, seed=5):
    import numpy as np

    from al26_tpu_torch.models.fractal import fractal_positions_velocities

    pos, vel = fractal_positions_velocities(np.random.default_rng(seed), n,
                                            1.0, 0.5 * n, device="cpu")
    g = torch.Generator().manual_seed(seed)
    mass = 0.1 + torch.rand(n, generator=g, dtype=torch.float64)
    return torch.as_tensor(pos), torch.as_tensor(vel), mass


def test_pair_counter_counts_near_field_interactions():
    """The tree's near field on a fractal state (leaf 256, theta 0.75; 6000
    stars, so the last real block is part padding and 8 of the 32 blocks
    are padding only; the MAC accepts ~6 % of the interactions): the
    counted interactions are the real stars of each MAC-failing (target,
    source) block pair times each other, as a brute count over
    build_block_tree and mac_masks has them, with each call's jerk flag and
    bytes. The direct-sum wrappers record nothing here."""
    from al26_tpu_torch.ops import tree

    pos, vel, mass = _fractal()
    n, leaf, theta = pos.shape[0], 256, 0.75
    t = tree.build_block_tree(pos, mass, leaf)
    _, p2p = tree.mac_masks(t, theta)
    real = (t.gidx_s < n).sum(1)
    brute = int((p2p * real[:, None] * real[None, :]).sum())
    listed = int((p2p & (real[None, :] > 0)).sum())
    b = p2p.shape[0]
    assert 0 < brute < n * n and b == 32
    counter = tracing.PairCounter()
    with counter.installed():
        for jerk in (True, False):
            tree.tree_acc_jerk_pot(pos, vel, mass, 1e-4, leaf=leaf,
                                   theta=theta, kavg=b, with_jerk=jerk)
    assert counter.calls == [
        (brute, True, roofline.near_bytes(n, True, listed)),
        (brute, False, roofline.near_bytes(n, False, listed))]
    assert roofline.near_bytes(2, True, 3) == 2 * (28 + 28) + 12


def test_near_field_count_splits_over_ranks():
    """The tree mesh's ranks (near_items part=) count shares that add up to
    the whole near field's."""
    from al26_tpu_torch.ops import cuda_tree, tree

    pos, _, mass = _fractal(2000, 8)
    t = tree.build_block_tree(pos, mass, 128)
    _, p2p = tree.mac_masks(t, 0.75)
    b = p2p.shape[0]
    whole = cuda_tree.near_items(p2p, b, 2000, 128)
    parts = [cuda_tree.near_items(p2p, b, 2000, 128, part=(r, 4))
             for r in range(4)]
    count = lambda it: roofline.near_interactions(it.item, it.src, 2000, 128)
    got = [count(it) for it in parts]
    assert all(g[0] > 0 for g in got)
    assert tuple(map(sum, zip(*got))) == count(whole)
