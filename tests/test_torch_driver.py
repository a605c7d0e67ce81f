"""The port's run driver (al26_tpu_torch.sim.driver) on the CPU: the same
run as the JAX package's driver from the same SimConfig (files and final
state), bit-identical resume, run extension and the truncation of stale
files under the JAX package's rules (tests/test_io.py), the interloper
trajectory file, the pt-grid ensemble driver, and the post-processing of
a port pt-grid.

Tolerances. The port and the JAX package run the same f64 arithmetic in
another order (torch's and XLA's reductions), so their states after 20
steps agree to ~1e-13 relative, not bitwise: they are held at 1e-11 of
each column's scale. The CSV is written at 7 significant digits, so its
rows are held to one unit in the 7th digit (rtol 1e-6). A resume of the
port on the CPU repeats the same operations on the same bits: held
bitwise.
"""
import glob
import os

import numpy as np
import pytest
import torch

from al26_tpu_torch import SimConfig as TConfig
from al26_tpu_torch.io import compression, ubjson
from al26_tpu_torch.io.checkpoint import load_state
from al26_tpu_torch.io.compat import particles_to_cluster
from al26_tpu_torch.sim import driver
from al26_tpu_torch.state import cluster_to_numpy
from test_reference_postprocess import (  # noqa: F401  (a fixture)
    REF_POSTPROCESS, reference_env,
)

torch.set_num_threads(1)

KW = dict(n=40, rc=0.5, final_time=0.2, seed=9, n_plot=5, steps_per_plot=4,
          dtype="f64")


class _Cwd:
    def __init__(self, path):
        self.path, self.old = str(path), None

    def __enter__(self):
        self.old = os.getcwd()
        os.makedirs(self.path, exist_ok=True)
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _state_np(path):
    st = load_state(path)
    return cluster_to_numpy(particles_to_cluster(st.cluster, device="cpu"))


def _csv(path):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    return lines[0], np.array([[float(x) for x in ln.split(",")]
                               for ln in lines[1:]])


def _blob(path):
    with open(path, "rb") as f:
        return ubjson.loadb(compression.decompress(f.read()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same SimConfig through both drivers (f64, n = 40, 20 steps, 7
    saves), the port's again as "part", and the port's resumed from
    checkpoint 3 of "part" (with a stale higher state file planted)."""
    from al26_tpu.config import SimConfig as JConfig
    from al26_tpu.sim.driver import run as jrun

    root = tmp_path_factory.mktemp("drv")
    with _Cwd(root / "jax"):
        jrun(JConfig(filename="par", **KW), progress=False)
    with _Cwd(root / "port"):
        full = driver.run(TConfig(filename="par", **KW), progress=False,
                          device="cpu")
        driver.run(TConfig(filename="part", **KW), progress=False,
                   device="cpu")
        with open("part-state-00006.pkl.zst", "rb") as f:
            stale = f.read()
        with open("part-state-00009.pkl.zst", "wb") as f:
            f.write(stale)
        resumed = driver.run(TConfig(reload="part", n_checkpoint=3),
                             progress=False, device="cpu")
    return root, full, resumed


def test_port_run_matches_jax_run(runs):
    """Files of the same names and counts; the CSV rows, the final state's
    columns and the decoded yields agree (tolerances: module docstring)."""
    root, full, _ = runs
    names = {p: sorted(os.path.basename(f)
                       for f in glob.glob(str(root / p / "par-*")))
             for p in ("jax", "port")}
    assert names["jax"] == names["port"]
    assert len([f for f in names["port"] if "-state-" in f]) == 7
    hj, rows_j = _csv(root / "jax" / "par-cluster-yields.csv")
    hp, rows_p = _csv(root / "port" / "par-cluster-yields.csv")
    assert hj == hp and rows_p.shape == (7, 7)
    np.testing.assert_allclose(rows_p, rows_j, rtol=1e-6, atol=0)
    sj = _state_np(str(root / "jax" / "par-state-00006.pkl.zst"))
    sp = _state_np(str(root / "port" / "par-state-00006.pkl.zst"))
    for k in sj:
        scale = max(float(np.abs(sj[k]).max()), 1e-300)
        np.testing.assert_allclose(sp[k], sj[k], rtol=0, atol=1e-11 * scale,
                                   err_msg=k)
    yj = _blob(root / "jax" / "par-yields.ubj.zst")
    yp = _blob(root / "port" / "par-yields.ubj.zst")
    assert sorted(yj) == sorted(yp) and yj["time"] == yp["time"]
    for k, v in yj.items():
        if k.startswith(("local", "global", "sne", "agb", "sum_")):
            a, b = np.asarray(yp[k], float), np.asarray(v, float)
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-11 * max(np.abs(b).max(), 1e-300),
                err_msg=k)
    mj = load_state(str(root / "jax" / "par-state-00006.pkl.zst")).metadata
    mp = load_state(str(root / "port" / "par-state-00006.pkl.zst")).metadata
    assert sorted(vars(mj.args)) == sorted(vars(mp.args))
    assert mp.most_recent_checkpoint == mj.most_recent_checkpoint == 6
    assert full.phase_seconds["physics"] > 0


def test_resume_is_bit_identical_and_truncates(runs):
    """Resuming "part" from checkpoint 3 reproduces the uninterrupted run
    bit for bit; the planted stale state file is gone, the CSV and the
    framed file hold each save once, in order."""
    root, full, resumed = runs
    a, b = cluster_to_numpy(full.state.cluster), cluster_to_numpy(
        resumed.state.cluster)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert float(resumed.state.time) == float(full.state.time)
    port = root / "port"
    assert not os.path.exists(port / "part-state-00009.pkl.zst")
    assert len(glob.glob(str(port / "part-state-*"))) == 7
    _, rows = _csv(port / "part-cluster-yields.csv")
    _, rows_full = _csv(port / "par-cluster-yields.csv")
    np.testing.assert_array_equal(rows, rows_full)
    from al26_tpu_torch.io.yields_store import Yields

    y = Yields("")
    y.plate_frames(str(port / "part-yields.ubjf"))
    assert y.time == pytest.approx(list(rows_full[:, 0]), rel=1e-6)


def test_extension_follows_the_jax_rules(tmp_path):
    """`-r X -t_f T`: the run continues on its own step grid to T and
    matches an uninterrupted run of that length bit for bit; the stored
    schedule is the extended one; a target at or behind the checkpoint,
    or an extension without a reload, is refused."""
    kw = dict(n=40, rc=0.5, seed=9, steps_per_plot=2, dtype="f64")
    with _Cwd(tmp_path):
        driver.run(TConfig(filename="short", final_time=0.1, n_plot=5, **kw),
                   progress=False, device="cpu")
        long = driver.run(TConfig(filename="long", final_time=0.2,
                                  n_plot=10, **kw), progress=False,
                          device="cpu")
        ext = driver.run(TConfig(reload="short", extend_final_time=0.2),
                         progress=False, device="cpu")
        assert ext.cfg.final_time == pytest.approx(0.2)
        assert ext.cfg.n_plot == 10 and ext.cfg.dt_override == 0.01
        a = cluster_to_numpy(long.state.cluster)
        b = cluster_to_numpy(ext.state.cluster)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        md = load_state("short-state-00012.pkl.zst").metadata
        assert md.args.final_time == pytest.approx(0.2)
        assert md.args.n_plot == 10
        with pytest.raises(ValueError, match="does not extend"):
            driver.run(TConfig(reload="short", extend_final_time=0.1),
                       progress=False, device="cpu")
        with pytest.raises(ValueError, match="resume directive"):
            driver.run(TConfig(n=8, extend_final_time=2.0), progress=False,
                       device="cpu")
        # a resume of a complete run takes no step and writes nothing new
        again = driver.run(TConfig(reload="short"), progress=False,
                           device="cpu")
        assert int(again.state.step_count) == 20
        assert len(glob.glob("short-state-*")) == 13


def test_interloper_trajectory_file_and_resume(tmp_path):
    """-trji: one row a step once the AGB clock is positive, the
    reference's six columns; a resume from an earlier checkpoint drops the
    rows from its time on and re-emits them."""
    cfg = TConfig(n=24, rc=0.5, final_time=0.06, n_plot=3, steps_per_plot=2,
                  seed=4, dtype="f64", interloper=True,
                  interloper_trajectory=True, filename="tr")
    with _Cwd(tmp_path):
        res = driver.run(cfg, progress=False, device="cpu")
        rows = np.loadtxt("interloper_trajectory.dat", delimiter=",")
        assert rows.shape == (5, 6)          # t_old = 0 is inactive
        np.testing.assert_allclose(rows[:, 0], np.arange(1, 6) * 0.01,
                                   rtol=1e-3)
        p = res.state.cluster.pos[-1].numpy()
        np.testing.assert_allclose(rows[-1, 2:5], p, rtol=2e-3, atol=1e-6)
        before = open("interloper_trajectory.dat").read()
        driver.run(TConfig(reload="tr", n_checkpoint=1), progress=False,
                   device="cpu")
        assert open("interloper_trajectory.dat").read() == before


def test_ensemble_driver_grid_resume_and_postprocess(tmp_path):
    """run_ensemble writes the reference pt-grid; load_ensemble resumes
    every realization bit-identically and extends them together; the JAX
    package's post-processing (plotting.postprocess, the reference's
    pipeline) reads the port's grid."""
    from al26_tpu.plotting import postprocess

    cfg = TConfig(n=24, rc=0.5, ensemble=3, final_time=0.06, n_plot=3,
                  steps_per_plot=2, seed=11, dtype="f64")
    bs, dirs, _ = driver.run_ensemble(cfg, progress=False,
                                      root=str(tmp_path), device="cpu")
    assert [os.path.relpath(d, tmp_path) for d in dirs] == [
        os.path.join("pt-0.5-24", "pt-0.5-24", f"pt-{k}") for k in range(3)]
    for d in dirs:
        assert len(glob.glob(os.path.join(d, "pt-*-state-*"))) == 5
        assert os.path.exists(os.path.join(
            d, os.path.basename(d) + "-yields.ubj.zst"))
    bs2, dirs2, _ = driver.run_ensemble(
        TConfig(reload=str(tmp_path), n_checkpoint=2), progress=False,
        device="cpu")
    assert dirs2 == sorted(dirs2) and len(dirs2) == 3
    for k in ("pos", "vel", "slr", "mass"):
        np.testing.assert_array_equal(getattr(bs2.cluster, k).numpy(),
                                      getattr(bs.cluster, k).numpy())
    bs3, _, _ = driver.run_ensemble(
        TConfig(reload=str(tmp_path), extend_final_time=0.08),
        progress=False, device="cpu")
    assert torch.allclose(bs3.time, torch.full((3,), 0.08,
                                               dtype=torch.float64))
    out = str(tmp_path / "ratios.pkl.zst")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        postprocess.main(".", out)
    finally:
        os.chdir(cwd)
    import pandas as pd

    df = pd.read_pickle(out)
    assert len(df) > 0


def test_refusals_come_before_any_run(tmp_path):
    """The multi-device options are ported. What a run cannot do raises
    the JAX package's ValueError before anything is written: a mesh of 2
    in a plain process (a world of one; the message names torchrun), the
    mesh backends without a mesh, a 1-D mesh_shape for an ensemble, and
    the gravity stride for an ensemble; orbax_dir runs (the DCP tree at
    every save); a cuda run without a card raises."""
    with _Cwd(tmp_path):
        for extra, match in (({"mesh_shape": (2,)}, "torchrun"),
                             ({"force_impl": "sharded"}, "device mesh"),
                             ({"force_impl": "ring"}, "device mesh")):
            with pytest.raises(ValueError, match=match):
                driver.run(TConfig(n=8, filename="x", **extra),
                           progress=False, device="cpu")
        with pytest.raises(ValueError, match="2-tuple"):
            driver.run_ensemble(TConfig(n=8, ensemble=2, mesh_shape=(2,)),
                                progress=False, device="cpu")
        with pytest.raises(ValueError, match="perf-ladder flags"):
            driver.run_ensemble(TConfig(n=8, ensemble=2, gravity_stride=2),
                                progress=False, device="cpu")
        assert os.listdir(".") == []
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                driver.run(TConfig(n=8, filename="x"), progress=False)
            assert os.listdir(".") == []
    from al26_tpu_torch.io.orbax_backend import latest_step

    with _Cwd(tmp_path / "orbax"):
        driver.run(TConfig(filename="o", orbax_dir="tree", **KW),
                   progress=False, device="cpu")
        assert latest_step("tree") == 20


@pytest.mark.skipif(not os.path.exists(REF_POSTPROCESS),
                    reason="reference repository not available")
def test_reference_postprocess_runs_verbatim_on_port_grid(tmp_path,
                                                          reference_env):
    """The reference's own plotting/postprocess.py, run unmodified over a
    pt-grid the port wrote (the environment of
    tests/test_reference_postprocess.py: its shims resolve the JAX
    package's class names, which the port's pickles carry), agrees with
    the JAX package's postprocess over the same grid."""
    import runpy
    import sys

    import pandas as pd

    from al26_tpu.plotting import postprocess

    cfg = TConfig(n=32, rc=0.5, ensemble=2, final_time=1.0, n_plot=4,
                  steps_per_plot=3, seed=101, dtype="f64")
    driver.run_ensemble(cfg, progress=False, root=str(tmp_path),
                        device="cpu")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sys.argv = [REF_POSTPROCESS]
        runpy.run_path(REF_POSTPROCESS, run_name="__main__")
        ref_df = pd.read_pickle("all-sims-ratios.pkl.zst")
        postprocess.main(".", "ours.pkl.zst")
        ours = pd.read_pickle("ours.pkl.zst")
    finally:
        os.chdir(cwd)
    assert len(ref_df) == len(ours) > 0
