"""The plain reference at a tiny size on the CPU: the same step as the
program in f64 (both compute in f64 there, so only rounding separates
them), the stellar model, and the file readers on a program-written run."""
import glob
import os

import numpy as np
import pytest
import torch

from perfbench.harness import check
from perfbench.reference import files, physics, stellar


def _follow(cfg_kw, steps_before=2, n_steps=3):
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.sim import init_cluster, run_steps

    cfg = SimConfig(rc=1.0, dtype="f64", seed=11, **cfg_kw)
    s, aux, cfg = init_cluster(cfg, device="cpu")
    s = run_steps(s, aux, cfg, steps_before)
    c0, sc = check._cluster(s, None, "cpu")
    c1, _ = check._cluster(run_steps(s, aux, cfg, n_steps), None, "cpu")
    rp = physics.resolve(cfg.to_dict(), c0["pos"].shape[0],
                         float(c0["m0"].sum()), False)
    ref = check._ref_steps(c0, rp, sc, n_steps, False)
    g = check.Gaps(check.NUMBERS_STEP)
    check._compare_fields(g, {f: [c0[f]] for f in c0},
                          {f: [c1[f]] for f in c1},
                          {f: [ref[f]] for f in ref})
    return rp["integrator"], g.v


@pytest.mark.parametrize("cfg_kw,integ", [
    ({"n": 96}, "hermite4"),
    ({"n": 96, "integrator": "leapfrog"}, "leapfrog"),
    ({"n": 256, "integrator": "hermite4_block", "k_fast": 32},
     "hermite4_block"),
])
def test_reference_step_matches_program_in_f64(cfg_kw, integ):
    got_integ, gaps = _follow(cfg_kw)
    assert got_integ == integ
    for k, v in gaps.items():
        assert v < 1e-9, (k, v)


def test_stellar_model_matches_program():
    from al26_tpu_torch.models.stellar import evolution as ev

    m0 = np.geomspace(0.05, 149.0, 300).astype(np.float32)
    tbl = ev.phase_table(torch.tensor(m0), 0.02, "lc18")
    tbl = ev.PhaseTable(*(a if a.dtype == torch.bool else a.double()
                          for a in tbl))
    for t in (0.01, 3.3, 7.77, 10.0):
        m_p, md_p = ev.evolve_from_table(tbl, torch.tensor(m0),
                                         torch.tensor(t, dtype=torch.float64))
        m_r, md_r = stellar.mass_and_wind(m0.astype(np.float64), t)
        assert np.max(np.abs(m_p.numpy() - m_r) / m_r) < 1e-5
        assert np.max(np.abs(md_p.numpy() - md_r)) < 1e-6 * md_r.max()


def test_readers_on_a_program_run(tmp_path, monkeypatch):
    from al26_tpu_torch import cli
    from al26_tpu_torch.io import checkpoint, compression, ubjson

    monkeypatch.chdir(tmp_path)
    cli.main(["-n", "32", "-rc", "1", "-t_f", "0.02", "--dtype", "f32",
              "--device", "cpu", "-f", "demo", "--seed", "3"])
    saves = sorted(glob.glob("demo-state-*.pkl.zst"))
    assert len(saves) == 102
    cols, meta = files.read_state(saves[5])
    want = checkpoint.load_state(saves[5])
    for k, v in want.cluster.columns().items():
        np.testing.assert_array_equal(cols[k], v)
    assert check._save_time(meta) == pytest.approx(
        want.metadata.time.value_in(want.metadata.time.unit))
    with open("demo-yields.ubj.zst", "rb") as f:
        raw = f.read()
    blob = files.ubjson_decode(files.zstd_decode(raw))
    theirs = ubjson.loadb(compression.decompress(raw))
    assert set(blob) == set(theirs)
    for k in ("time", "local_26al", "sne_60fe_final"):
        np.testing.assert_array_equal(np.asarray(blob[k], np.float64),
                                      np.asarray(theirs[k], np.float64))
    c0 = check._save_cluster(files.read_state(saves[0])[0], "cpu")
    rp = physics.resolve({"final_time": 0.02, "n_plot": 100,
                          "steps_per_plot": 10, "rc": 1.0}, 32,
                         float(c0["m0"].sum()), False)
    init = physics.initial(c0["m0"].numpy(), rp)
    cols0 = files.read_state(saves[0])[0]
    for k, v in init.items():
        np.testing.assert_allclose(np.asarray(cols0[k], np.float64), v,
                                   rtol=1e-6, atol=1e-12 * np.abs(v).max())


def test_start_within_rounding_of_the_initial_mass(tmp_path, monkeypatch):
    """Save 0 of a 1000-star run whose star 415 has m0 = 8.0055 Msun, where
    the wind rate moves ~1500 times faster than the mass: the program
    derives its rate from the drawn f64 mass and stores the mass in f32,
    so the rate at the stored mass is 8e-5 of itself away. That is within
    rounding of the input and not wrong; the same rate off by 1e-3, and an
    ordinary value off by 2e-5, are."""
    from al26_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    cli.main(["-n", "1000", "-rc", "1", "-t_f", "0.02", "--dtype", "f32",
              "--device", "cpu", "-f", "run", "--seed", "3100000006"])
    cols0, _ = files.read_state(sorted(glob.glob("run-state-*.pkl.zst"))[0])
    c0 = check._save_cluster(cols0, "cpu")
    rp = physics.resolve({"final_time": 10.0, "n_plot": 100,
                          "steps_per_plot": 10, "rc": 1.0}, 1000,
                         float(c0["m0"].sum()), False)

    def start(cols):
        g = check.Gaps(("start_wrong", "start_gap"))
        check._start(cols, c0, rp, g)
        return g.v

    m0 = np.asarray(cols0["initial_mass"], np.float64)
    steep = int(np.argmin(np.abs(m0 - 8.0055)))
    assert abs(m0[steep] - 8.0055) < 1e-4
    assert start(cols0) == {"start_wrong": 0,
                            "start_gap": pytest.approx(7.98e-5, rel=1e-2)}
    heavy = int(np.argmax(m0))
    for f, i, by in (("mdot", steep, 1e-3), ("mdot", heavy, 2e-5),
                     ("m_disk_gas", 3, 2e-5)):
        bad = {k: np.array(v, copy=True) for k, v in cols0.items()}
        bad[f][i] *= 1 + by
        assert start(bad)["start_wrong"] == 1, (f, i)
