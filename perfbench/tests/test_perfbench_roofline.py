"""The roofline arithmetic on hand-counted pairs, and the pair counter on
the kernel wrappers' plain CPU versions."""
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
