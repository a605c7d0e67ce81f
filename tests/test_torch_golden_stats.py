"""The port's N = 1k golden statistics (tests/torch_golden_stats.py)
against the JAX package's.

Tier 1: the golden configuration for 50 steps in both packages on the CPU
in f64, the summaries within 1e-12 relative (integers equal); the bar
file (tests/golden/n1k_roundoff.json) covers every mode and key of the
golden file; the bar's rule on hand-made cases.

Slow lane (`pytest -m slow`): each mode's full 1000-step run of the port
on the CPU in f64 against tests/golden/n1k_stats.json, within the bar
(torch_golden_stats module docstring). About 8 min a mode on one CPU
thread (the dense f64 step at N = 1000 takes ~0.45 s).
"""
import math

import numpy as np
import pytest
import torch

import torch_golden_stats as tgs

SHORT_STEPS = 50


def _jax_summary(mode: str, n_steps: int) -> dict:
    from al26_tpu.config import SimConfig
    from al26_tpu.sim import init_cluster, run_steps
    from golden_stats import N_GOLDEN, SEED_GOLDEN, summarize

    parity, tracks = tgs.MODES[mode]
    cfg = SimConfig(n=N_GOLDEN, rc=1.0, final_time=10.0, seed=SEED_GOLDEN,
                    dtype="f64", sn_parity_mode=parity, mass_tracks=tracks)
    state, aux, cfg = init_cluster(cfg)
    return summarize(run_steps(state, aux, cfg, n_steps), cfg)


@pytest.mark.parametrize("mode", sorted(tgs.MODES))
def test_golden_config_short_run_matches_jax(mode):
    """50 steps of the golden configuration in both packages (f64, CPU):
    the same keys, integers equal, floats within 1e-12 relative."""
    torch.set_num_threads(1)
    want = _jax_summary(mode, SHORT_STEPS)
    got = tgs.summarize(*tgs.run_golden(mode, device="cpu", dtype="f64",
                                        n_steps=SHORT_STEPS))
    assert set(got) == set(want)
    assert got["time"] == pytest.approx(SHORT_STEPS * 0.01, rel=1e-12)
    assert want["sum_local_26al"] > 0.0 and want["sum_global_26al"] > 0.0
    assert want["n_enriched_26al"] > 0 and want["ratio_26al_p50"] > 0.0
    for k in sorted(want):
        if k in tgs.INT_KEYS:
            assert got[k] == want[k], k
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0.0), k


def test_roundoff_file_covers_the_golden():
    """Every mode and key of n1k_stats.json has its d_k, finite and >= 0,
    integers for the integer keys, and time's d is 0."""
    golden, roundoff = tgs.load("n1k_stats"), tgs.load("n1k_roundoff")
    assert set(roundoff) == set(golden) == set(tgs.MODES)
    for mode in golden:
        assert set(roundoff[mode]) == set(golden[mode])
        for k, d in roundoff[mode].items():
            assert math.isfinite(d) and d >= 0, (mode, k)
            if k in tgs.INT_KEYS:
                assert isinstance(d, int), (mode, k)
        assert roundoff[mode]["time"] == 0.0


_BAR_CASES = {
    # key, golden, d_k, value, passes
    "int_d0_equal": ("n_kicked", 1, 0, 1, True),
    "int_d0_off": ("n_kicked", 1, 0, 2, False),
    "int_d1_within": ("n_enriched_26al", 22, 1, 21, True),
    "int_d1_outside": ("n_enriched_26al", 22, 1, 24, False),
    "float_roundoff": ("sum_sne_26al", 1e-10, 1e-20, 1e-10 + 9e-20, True),
    "float_past_roundoff": ("sum_sne_26al", 1e-10, 1e-20, 1e-10 + 2e-19,
                            False),
    "float_rel_floor": ("ratio_26al_p50", 3e-9, 0.0, 3e-9 * (1 + 9e-13),
                        True),
    "float_past_rel_floor": ("ratio_26al_p50", 3e-9, 0.0, 3e-9 * (1 + 2e-12),
                             False),
    "zero_golden": ("sum_sne_60fe", 0.0, 0.0, 0.0, True),
    "zero_golden_off": ("sum_sne_60fe", 0.0, 0.0, 1e-300, False),
    "time_exact": ("time", 10.0, 0.0, 10.0, True),
    "time_ulp": ("time", 10.0, 0.0, np.nextafter(10.0, 11.0), False),
}


@pytest.mark.parametrize("case", sorted(_BAR_CASES))
def test_bar_rule(case):
    key, golden, d, value, passes = _BAR_CASES[case]
    dist, b = tgs.against_golden({key: value}, {key: golden}, {key: d})[key]
    assert (dist <= b) == passes


@pytest.mark.slow
@pytest.mark.parametrize("mode", sorted(tgs.MODES))
def test_port_n1k_within_roundoff_bar(mode):
    """The full 1000-step run of the port (f64, CPU) against the JAX
    package's golden statistics, within the bar."""
    torch.set_num_threads(1)
    golden = tgs.load("n1k_stats")[mode]
    roundoff = tgs.load("n1k_roundoff")[mode]
    got = tgs.summarize(*tgs.run_golden(mode, device="cpu", dtype="f64"))
    dist = tgs.against_golden(got, golden, roundoff)
    over = {k: db for k, db in dist.items() if db[0] > db[1]}
    assert not over, f"{mode}: distance, bar of the keys past the bar: {over}"
