"""The port's analysis layer (al26_tpu_torch.plotting) on the CPU, held to
the JAX package's (al26_tpu.plotting) on the same files.

The files: a two-sim pt-0.5-48 grid written by the port's driver, the
same grid written by the JAX driver (the settings of
tests/test_plotting.py's grid, files of their own), and, where a case
reads one state, the reference's AMUSE fixture
(tests/golden/amuse/pt-0-state-00003.pkl.zst). On each, the JAX function
and the port's (device="cpu") read the same file.

Bars. The readers and the disc-lifetime interpolation run the same numpy
and scipy code on the same bits: bitwise. The diagnostics run the same
f64 arithmetic in torch's and XLA's reduction orders: 1e-12 relative
(the half-mass radius, a sort and a pick, is equal). The table's ratios
come from those readers: its columns are equal, the two ratio columns
held at 1e-12 relative.
"""
import os
import pickle
import subprocess
import sys
from glob import glob

import numpy as np
import pytest
import torch

from al26_tpu_torch import SimConfig as TConfig
from al26_tpu_torch.io import compression
from al26_tpu_torch.ops import nbody as tnbody
from al26_tpu_torch.plotting import lib as tlib
from al26_tpu_torch.plotting import postprocess as tpost
from al26_tpu_torch.sim import driver as tdriver
from al26_tpu_torch.units import myr as tmyr

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
AMUSE_STATE = os.path.join(HERE, "golden", "amuse", "pt-0-state-00003.pkl.zst")
RTOL = 1e-12
WRITERS = ["port", "jax"]
STATE_SOURCES = ["port", "jax", "amuse"]


class _Cwd:
    def __init__(self, path):
        self.path, self.old = str(path), None

    def __enter__(self):
        self.old = os.getcwd()
        os.makedirs(self.path, exist_ok=True)
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _grid_cfg(config_cls, sim_i):
    return config_cls(n=48, rc=0.5, final_time=1.0, seed=31 + sim_i,
                      filename=f"pt-{sim_i}", n_plot=5, steps_per_plot=4)


@pytest.fixture(scope="module")
def port_grid(tmp_path_factory):
    """A pt-0.5-48 grid of two sims written by the port's driver at
    tests/test_plotting.py's settings."""
    root = tmp_path_factory.mktemp("grid-port")
    for sim_i in range(2):
        with _Cwd(root / "pt-0.5-48" / "pt-0.5-48" / f"pt-{sim_i}"):
            tdriver.run(_grid_cfg(TConfig, sim_i), progress=False,
                        device="cpu")
    return root


@pytest.fixture(scope="module")
def grids(port_grid, tmp_path_factory):
    """{writer: root}: the port's grid and the same grid written by the
    JAX driver."""
    from al26_tpu.config import SimConfig as JConfig
    from al26_tpu.sim.driver import run as jrun

    root = tmp_path_factory.mktemp("grid-jax")
    for sim_i in range(2):
        with _Cwd(root / "pt-0.5-48" / "pt-0.5-48" / f"pt-{sim_i}"):
            jrun(_grid_cfg(JConfig, sim_i), progress=False)
    return {"port": port_grid, "jax": root}


def _sim_dir(grids, writer, sim_i=0):
    return sorted(glob(f"{grids[writer]}/pt-*/pt-*/pt-{sim_i}/"))[0]


def _state_files(grids, writer):
    return sorted(glob(_sim_dir(grids, writer) + "*-state-*.zst"))


def _state_file(grids, source, which=-1):
    if source == "amuse":
        return AMUSE_STATE
    return _state_files(grids, source)[which]


def _both_states(path):
    from al26_tpu.plotting import read_state as jread

    return jread(path), tlib.read_state(path)


def _assert_columns_equal(jc, tc):
    jcols, tcols = jc.columns(), tc.columns()
    assert sorted(jcols) == sorted(tcols)
    for name, arr in jcols.items():
        assert tcols[name].dtype == arr.dtype, name
        assert np.array_equal(tcols[name], arr, equal_nan=True), name


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", STATE_SOURCES)
def test_read_state_bitwise(grids, source):
    """Every column of the first and last state (or the AMUSE fixture)
    equal bitwise, dtype included; the metadata's time and args equal."""
    from al26_tpu.units import myr as jmyr

    paths = ([AMUSE_STATE] if source == "amuse"
             else [_state_file(grids, source, 0),
                   _state_file(grids, source, -1)])
    for path in paths:
        js, ts = _both_states(path)
        assert len(ts.cluster) == len(js.cluster)
        _assert_columns_equal(js.cluster, ts.cluster)
        assert (ts.metadata.time.value_in(tmyr)
                == js.metadata.time.value_in(jmyr))
        assert vars(ts.metadata.args) == vars(js.metadata.args)


@pytest.mark.parametrize("fmt", ["ubj.zst", "ubjf"])
@pytest.mark.parametrize("writer", WRITERS)
def test_read_yields_bitwise(grids, writer, fmt):
    """The reference blob and the framed store: every attribute equal
    bitwise, arrays where the JAX reader gives arrays."""
    from al26_tpu.plotting import read_yields as jread

    path = glob(_sim_dir(grids, writer) + f"*-yields.{fmt}")[0]
    jy, ty = jread(path), tlib.read_yields(path)
    jd = {k: v for k, v in vars(jy).items() if not k.startswith("_")}
    td = {k: v for k, v in vars(ty).items() if not k.startswith("_")}
    assert sorted(jd) == sorted(td)
    for name, val in jd.items():
        if isinstance(val, np.ndarray):
            assert isinstance(td[name], np.ndarray), name
            assert td[name].dtype == val.dtype, name
            assert np.array_equal(td[name], val), name
        else:
            assert td[name] == val, name
    assert ty.local_26al.shape == (7, 48)


def test_read_interloper_trajectory(tmp_path):
    """The trajectory reader (pandas) on a file of the driver's layout."""
    pd = pytest.importorskip("pandas")
    from al26_tpu.plotting import read_interloper_trajectory as jread

    rng = np.random.default_rng(5)
    path = str(tmp_path / "interloper_trajectory.dat")
    np.savetxt(path, rng.normal(size=(9, 6)), delimiter=",")
    pd.testing.assert_frame_equal(tlib.read_interloper_trajectory(path),
                                  jread(path))


@pytest.mark.parametrize("writer", WRITERS)
def test_disk_final_enrichment_bitwise(grids, writer):
    """The vectorised Akima evaluation on the last yields and disc
    lifetimes, with the fallbacks forced (outlives the run, predates the
    first snapshot, not finite): every `_final` list equal bitwise."""
    from al26_tpu.plotting import calc_disk_final_enrichment as jcalc
    from al26_tpu.plotting import read_yields as jread

    sim = _sim_dir(grids, writer)
    state = tlib.read_state(_state_files(grids, writer)[-1])
    taus = np.asarray(state.cluster.tau_disk.value_in(tmyr)).copy()
    taus[0], taus[1], taus[2] = 1e9, -1.0, np.nan
    path = glob(sim + "*-yields.ubj.zst")[0]
    jy = jcalc(jread(path), taus.copy())
    ty = tlib.calc_disk_final_enrichment(tlib.read_yields(path), taus.copy())
    for iso in ("26al", "60fe"):
        for model in ("global", "local", "sne"):
            key = f"{model}_{iso}_final"
            got, want = getattr(ty, key), getattr(jy, key)
            assert isinstance(got, list) and len(got) == 48
            assert np.array_equal(np.asarray(got), np.asarray(want)), key


# ---------------------------------------------------------------------------
# the post-processor
# ---------------------------------------------------------------------------

_RATIOS = ("yield_ratio_nodecay", "yield_ratio_decay")


def _assert_tables_equal(got, want):
    """Column for column: the names and their order, dtypes, every
    non-ratio column equal, the ratios at 1e-12 relative."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        assert got[col].dtype == want[col].dtype, col
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if col in _RATIOS:
            _close(g, w)
        else:
            assert np.array_equal(g, w), col


@pytest.mark.parametrize("writer", WRITERS)
def test_process_sim_table(grids, writer):
    """One sim's rows through both process_sim: the same ten lists, the
    ratios at 1e-12 relative."""
    from al26_tpu.plotting import postprocess as jpost

    cols = ["nstars", "rc", "sim_number", "star", "initial_mass", "mass",
            "isotope", "model", "yield_ratio_nodecay", "yield_ratio_decay"]
    jd = {k: [] for k in cols}
    td = {k: [] for k in cols}
    sim = _sim_dir(grids, writer, 1)
    jpost.process_sim(sim, 1, jd)
    tpost.process_sim(sim, 1, td)
    assert len(td["star"]) == 48 * 2 * 5
    for k in cols:
        if k in _RATIOS:
            _close(td[k], jd[k])
        else:
            assert td[k] == jd[k], k
            assert [type(v) for v in td[k]] == [type(v) for v in jd[k]], k


@pytest.mark.parametrize("writer", WRITERS)
def test_postprocess_main_dataframe(grids, writer, tmp_path, capsys):
    """Both mains over the same grid: the port's table read back by its
    own reader and by pd.read_pickle, each equal to the JAX package's
    column for column; the grid's 2 x 48 x 2 x 5 rows."""
    pd = pytest.importorskip("pandas")
    from al26_tpu.plotting import postprocess as jpost

    jout, tout = str(tmp_path / "jax.pkl.zst"), str(tmp_path / "port.pkl.zst")
    with _Cwd(grids[writer]):
        jpost.main(".", jout)
        tpost.main(".", tout)
    assert capsys.readouterr().out.count("Finished processing!") == 2
    want = pd.read_pickle(jout)
    assert len(want) == 2 * 48 * 2 * 5
    _assert_tables_equal(tpost._read_table(tout), want)
    _assert_tables_equal(pd.read_pickle(tout), want)


def test_postprocess_walk_and_skip_line(grids, tmp_path, capsys):
    """The walk's fallbacks: a flat directory of sims, and an incomplete
    sim folder skipped with the JAX package's line."""
    pd = pytest.importorskip("pandas")
    from al26_tpu.plotting import postprocess as jpost

    flat = tmp_path / "flat"
    for sim_i in range(2):
        src = _sim_dir(grids, "port", sim_i)
        dst = flat / f"pt-{sim_i}"
        dst.mkdir(parents=True)
        for f in os.listdir(src):
            os.link(os.path.join(src, f), dst / f)
    lone = flat / "pt-2"
    lone.mkdir()
    state0 = _state_files(grids, "port")[0]
    os.link(state0, lone / os.path.basename(state0))
    outs = {}
    for name, mod in (("jax", jpost), ("port", tpost)):
        outs[name] = str(tmp_path / f"{name}.pkl.zst")
        mod.main(str(flat), outs[name])
    printed = capsys.readouterr().out.splitlines()
    skips = [ln for ln in printed if ln.startswith("skipping incomplete")]
    assert len(skips) == 2 and skips[0] == skips[1]
    _assert_tables_equal(tpost._read_table(outs["port"]),
                         pd.read_pickle(outs["jax"]))


def test_postprocess_without_zstandard(tmp_path, monkeypatch):
    """With the zstandard package absent (the card's machine): a port
    grid written then, and main's table of it, are stored zstd frames;
    the port's reader loads the table without the package and
    pd.read_pickle loads it with it."""
    pd = pytest.importorskip("pandas")
    monkeypatch.setattr(compression, "_zstandard", lambda: None)
    assert compression.writer().startswith("stored zstd frames")
    cfg = TConfig(n=24, rc=0.5, final_time=0.5, seed=50, ensemble=2,
                  n_plot=2, steps_per_plot=5,
                  no_massive_star_requirement=True)
    tdriver.run_ensemble(cfg, progress=False, root=str(tmp_path),
                         device="cpu")
    out = str(tmp_path / "stored.pkl.zst")
    with _Cwd(tmp_path):
        tpost.main(".", out)
    plain = tpost._read_table(out)
    with open(out, "rb") as fh:
        raw = fh.read()
    assert raw == compression.stored_frame(
        pickle.dumps(plain, protocol=pickle.HIGHEST_PROTOCOL))
    assert len(plain) == 2 * 24 * 2 * 5
    monkeypatch.undo()
    assert compression._zstandard() is not None
    _assert_tables_equal(pd.read_pickle(out), plain)


def test_postprocess_module_command(grids, tmp_path):
    """`python -m al26_tpu_torch.plotting.postprocess root out` in a
    subprocess, with jax and al26_tpu made unimportable: the table of
    main."""
    pd = pytest.importorskip("pandas")
    out = str(tmp_path / "cmd.pkl.zst")
    block = ("import sys\n"
             "class _Block:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('jax', 'al26_tpu'):\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, _Block())\n"
             "import runpy\n"
             "sys.argv = ['postprocess', sys.argv[1], sys.argv[2]]\n"
             "runpy.run_module('al26_tpu_torch.plotting.postprocess',"
             " run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", block, str(grids["port"]), out],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "Finished processing!" in r.stdout
    with _Cwd(grids["port"]):
        tpost.main(".", str(tmp_path / "lib.pkl.zst"))
    _assert_tables_equal(pd.read_pickle(out),
                         pd.read_pickle(str(tmp_path / "lib.pkl.zst")))


def test_run_ensemble_into_postprocess(tmp_path):
    """The port's run_ensemble grid through the port's post-processor:
    tests/test_plotting.py's row count, and the JAX package's table of
    the same grid."""
    pd = pytest.importorskip("pandas")
    from al26_tpu.plotting import postprocess as jpost

    cfg = TConfig(n=24, rc=0.5, final_time=0.5, seed=50, ensemble=2,
                  n_plot=2, steps_per_plot=5,
                  no_massive_star_requirement=True)
    _, sim_dirs, _ = tdriver.run_ensemble(cfg, progress=False,
                                          root=str(tmp_path), device="cpu")
    assert sim_dirs[0].endswith("pt-0.5-24/pt-0.5-24/pt-0")
    out, jout = str(tmp_path / "table.pkl.zst"), str(tmp_path / "j.pkl.zst")
    with _Cwd(tmp_path):
        tpost.main(".", out)
        jpost.main(".", jout)
    df = tpost._read_table(out)
    assert len(df) == 2 * 24 * 2 * 5
    assert set(df.sim_number.unique()) == {0, 1}
    _assert_tables_equal(df, pd.read_pickle(jout))


# ---------------------------------------------------------------------------
# the diagnostics on tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", STATE_SOURCES)
def test_calc_sn_times(grids, source):
    """Times at 1e-12 relative, masses and keys equal, from the run's
    metadata (the AMUSE fixture records neither metallicity nor tracks:
    the lc18 / 0.02 defaults)."""
    from al26_tpu.plotting import calc_sn_times as jcalc

    js, ts = _both_states(_state_file(grids, source, 0))
    jt, jm, jk = jcalc(js.cluster, return_keys=True, metadata=js.metadata)
    tt, tm, tk = tlib.calc_sn_times(ts.cluster, return_keys=True,
                                    metadata=ts.metadata, device="cpu")
    # the reference's 24-star fixture has no star of 13 Msun or more
    assert (len(jt) > 0) == (source != "amuse")
    _close(tt, jt)
    assert tm == jm and tk == jk
    t2, m2 = tlib.calc_sn_times(ts.cluster, device="cpu")
    assert t2 == tt and m2 == tm


@pytest.mark.parametrize("eps2", [None, 0.0, 0.01])
@pytest.mark.parametrize("source", STATE_SOURCES)
def test_calc_etot(grids, source, eps2):
    """The run's own softening (default) and explicit ones: 1e-12."""
    from al26_tpu.plotting import calc_etot as jcalc

    js, ts = _both_states(_state_file(grids, source))
    got = tlib.calc_etot(ts, eps2=eps2, device="cpu")
    assert isinstance(got, float)
    _close(got, jcalc(js, eps2=eps2))


@pytest.mark.parametrize("source", STATE_SOURCES)
def test_calc_local_densities(grids, source):
    from al26_tpu.plotting import calc_local_densities as jcalc

    js, ts = _both_states(_state_file(grids, source))
    got = tlib.calc_local_densities(ts.cluster, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (len(ts.cluster),)
    assert (got > 0).all()
    _close(got, jcalc(js.cluster))


@pytest.mark.parametrize("source", STATE_SOURCES)
def test_calc_cluster_half_mass(grids, source):
    """The same star picked, its distance at 1e-12 relative: the centre
    of mass and the total mass are sums that torch and XLA reduce in
    different orders (one ulp apart on the grid's last state)."""
    from al26_tpu.plotting import calc_cluster_half_mass as jcalc

    js, ts = _both_states(_state_file(grids, source))
    got = tlib.calc_cluster_half_mass(ts.cluster, device="cpu")
    want = jcalc(js.cluster)
    assert isinstance(got, float)
    _close(got, want)
    pos, _, mass = (t.numpy() for t in tlib._pos_vel_mass(ts.cluster, "cpu"))
    com = (pos * mass[:, None]).sum(0) / mass.sum()
    r = np.sqrt(((pos - com) ** 2).sum(-1))
    assert np.argmin(np.abs(r - got)) == np.argmin(np.abs(r - want))


@pytest.mark.parametrize("radius_method", ["halfmass", "virial"])
@pytest.mark.parametrize("source", STATE_SOURCES)
def test_calc_global_model_yield(grids, source, radius_method):
    """Both radius methods at the snapshot's time, f64: 1e-12; an
    unknown method raises as in the JAX package."""
    from al26_tpu.plotting import calc_global_model_yield as jcalc
    from al26_tpu.units import myr as jmyr

    js, ts = _both_states(_state_file(grids, source))
    t = js.metadata.time.value_in(jmyr)
    assert t == ts.metadata.time.value_in(tmyr)
    want = jcalc(js.cluster, t, 0.01, radius_method=radius_method,
                 metadata=js.metadata)
    got = tlib.calc_global_model_yield(ts.cluster, t, 0.01,
                                       radius_method=radius_method,
                                       metadata=ts.metadata, device="cpu")
    # the reference's fixture has no massive star: zero rates
    assert np.asarray(want[0]).any() == (source != "amuse")
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float64
        _close(g, w)
    with pytest.raises(ValueError, match="INVALID RADIUS METHOD"):
        tlib.calc_global_model_yield(ts.cluster, t, 0.01,
                                     radius_method="tidal", device="cpu")


def _dense_nearest(pos, k=10):
    """The dense formula the port's local_densities replaced: one
    [N, N, 3] difference tensor."""
    d2 = torch.sum((pos[:, None, :] - pos[None, :, :]) ** 2, dim=-1)
    idx = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True).indices
    nbr = idx[:, 1:k + 1]
    return nbr, torch.gather(d2, 1, nbr[:, -1:])[:, 0]


@pytest.mark.parametrize("block", [64, 1000, None])
def test_chunked_local_densities_match_dense(block):
    """N = 3001 (a multiple of no block here) by blocks of 64 and 1000
    rows and the default: the neighbour sets of the dense formula, and
    its densities (and the JAX package's) at 1e-12."""
    import jax.numpy as jnp

    from al26_tpu.ops.nbody import local_densities as jdens

    rng = np.random.default_rng(11)
    n = 3001
    pos_np = rng.normal(size=(n, 3))
    mass_np = rng.uniform(0.1, 3.0, size=n)
    pos, mass = torch.as_tensor(pos_np), torch.as_tensor(mass_np)
    nbr_d, d2k_d = _dense_nearest(pos)
    nbr, d2 = tnbody.nearest_neighbours(pos, block=block)
    assert nbr.shape == (n, 10) and d2.shape == (n, 10)
    assert np.array_equal(np.sort(nbr.numpy(), 1), np.sort(nbr_d.numpy(), 1))
    _close(d2[:, -1].numpy(), d2k_d.numpy())
    rho = tnbody.local_densities(pos, mass, block=block).numpy()
    dense_rho = (torch.sum(mass[nbr_d], 1)
                 / (4.18879020479 * torch.sqrt(d2k_d) ** 3)).numpy()
    _close(rho, dense_rho)
    _close(rho, np.asarray(jdens(jnp.asarray(pos_np), jnp.asarray(mass_np))))
    rows = torch.as_tensor(rng.choice(n, 37, replace=False))
    nbr_r, _ = tnbody.nearest_neighbours(pos, block=block, rows=rows)
    assert torch.equal(nbr_r, nbr[rows])


def test_local_density_block_size():
    """A block holds at most 2^26 squared distances: 163 rows at
    N = 409600 (0.54 GB of d2 in f64), all rows at small N."""
    assert tnbody.local_density_block(409600) == 163
    assert 163 * 409600 <= 1 << 26
    assert tnbody.local_density_block(48) == 48
    assert tnbody.local_density_block(1) == 1


@pytest.mark.parametrize("name", ["calc_sn_times", "calc_etot",
                                  "calc_local_densities",
                                  "calc_cluster_half_mass",
                                  "calc_global_model_yield"])
def test_default_device_without_card_raises(grids, name, monkeypatch):
    """device defaults to "cuda"; without a card each diagnostic raises
    and names device='cpu' (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = tlib.read_state(_state_file(grids, "port"))
    args = {"calc_etot": (state,),
            "calc_global_model_yield": (state.cluster, 1.0, 0.01)}
    fn = getattr(tlib, name)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args.get(name, (state.cluster,)))


# ---------------------------------------------------------------------------
# host helpers, names, imports, figures
# ---------------------------------------------------------------------------

def _helper_cases():
    rng = np.random.default_rng(3)
    x = rng.normal(size=40)
    pts = [rng.normal(size=40) for _ in range(3)]
    return {
        "calc_cdf": lambda m: m.calc_cdf(x),
        "calc_current_heating_rate":
            lambda m: m.calc_current_heating_rate(np.abs(x), np.abs(x[::-1])),
        "calc_dE": lambda m: m.calc_dE(-1.25, -1.5),
        "check_interaction":
            lambda m: m.check_interaction(0.1, 0.0, -0.2, *pts, 0.9)[:3],
        "sphere_wireframe": lambda m: m.sphere_wireframe(1.0, 2.0, 3.0, 0.5),
        "get_digit_from_filename":
            lambda m: m.get_digit_from_filename("a7/pt-3-state-00042.pkl.zst"),
    }


@pytest.mark.parametrize("name", sorted(_helper_cases()))
def test_host_helpers_match(name):
    """The numpy-only helpers give the JAX package's values exactly."""
    from al26_tpu.plotting import lib as jlib

    case = _helper_cases()[name]
    got, want = case(tlib), case(jlib)
    assert np.array_equal(np.asarray(got, dtype=float),
                          np.asarray(want, dtype=float))


@pytest.mark.parametrize("source", STATE_SOURCES)
def test_state_helpers_match(grids, source):
    """get_high_mass_star_indices and the stellar parameters a run
    recorded (the AMUSE fixture: the defaults) as in the JAX package."""
    from al26_tpu.plotting import lib as jlib

    js, ts = _both_states(_state_file(grids, source))
    assert (tlib.get_high_mass_star_indices(ts.cluster)
            == jlib.get_high_mass_star_indices(js.cluster))
    for z, tracks in ((None, None), (0.014, "seba")):
        assert (tlib._run_stellar_params(ts.metadata, z, tracks)
                == jlib._run_stellar_params(js.metadata, z, tracks))
    if source == "amuse":
        assert tlib._run_stellar_params(ts.metadata, None, None) == (
            0.02, "lc18")


def test_public_names_and_modules_match():
    """The eight modules and every public name of al26_tpu.plotting."""
    import al26_tpu.plotting as jplot

    import al26_tpu_torch.plotting as tplot

    def modules(pkg):
        d = os.path.dirname(pkg.__file__)
        return sorted(f for f in os.listdir(d) if f.endswith(".py"))

    assert modules(tplot) == modules(jplot) and len(modules(tplot)) == 8
    public = sorted(n for n in vars(jplot) if not n.startswith("_"))
    assert sorted(n for n in vars(tplot) if not n.startswith("_")) == public
    from al26_tpu.plotting import lib as jlib
    assert tlib.__all__ == jlib.__all__
    for name in jlib.__all__ + ["use_tex", "sphere_wireframe",
                                "check_interaction",
                                "get_digit_from_filename"]:
        assert callable(getattr(tlib, name)), name


def test_plain_import_pulls_no_plotting_packages():
    """`import al26_tpu_torch.plotting` (and its figure modules) imports
    neither matplotlib nor pandas, nor jax or the JAX package."""
    code = ("import sys\n"
            "import al26_tpu_torch.plotting\n"
            "from al26_tpu_torch.plotting import (box_plot, plot_3d_pos,"
            " plot_slr_heating, plot_slr_statistics, postprocess,"
            " violin_plot)\n"
            "print(sorted(m for m in ('matplotlib', 'pandas', 'jax',"
            " 'al26_tpu') if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_figure_scripts_produce_output(grids, tmp_path, monkeypatch):
    """The five figure scripts write their files from the port's grid
    (the tables through the port's post-processor)."""
    pytest.importorskip("matplotlib")
    from al26_tpu_torch.plotting import (box_plot, plot_3d_pos,
                                         plot_slr_heating,
                                         plot_slr_statistics, violin_plot)

    simset = sorted(glob(f"{grids['port']}/pt-*/pt-*/"))[0]
    monkeypatch.chdir(tmp_path)
    plot_slr_statistics.main("cdf", simset)
    plot_slr_heating.main("heat", simset)
    plot_3d_pos.main(_state_file(grids, "port"), "pos")
    with _Cwd(grids["port"]):
        tpost.main(".", str(tmp_path / "table.pkl.zst"))
    box_plot.main("table.pkl.zst", "boxes")
    violin_plot.main("table.pkl.zst", "violins")
    for name in ("cdf.pdf", "heat.pdf", "pos.png", "boxes.pdf",
                 "violins.pdf"):
        assert os.path.getsize(tmp_path / name) > 0, name


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_diagnostics_on_card_match_cpu(port_grid):
    """The five diagnostics on the card against device="cpu" from the
    same file, f64: 1e-12 relative (torch's CUDA and CPU reductions sum
    in different orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state = tlib.read_state(_state_file({"port": port_grid}, "port"))
    c = state.cluster
    _close(tlib.calc_etot(state, device="cuda"),
           tlib.calc_etot(state, device="cpu"))
    _close(tlib.calc_local_densities(c, device="cuda"),
           tlib.calc_local_densities(c, device="cpu"))
    _close(tlib.calc_cluster_half_mass(c, device="cuda"),
           tlib.calc_cluster_half_mass(c, device="cpu"))
    _close(tlib.calc_sn_times(c, device="cuda")[0],
           tlib.calc_sn_times(c, device="cpu")[0])
    for method in ("halfmass", "virial"):
        for g, w in zip(
                tlib.calc_global_model_yield(c, 1.0, 0.01, method,
                                             device="cuda"),
                tlib.calc_global_model_yield(c, 1.0, 0.01, method,
                                             device="cpu")):
            _close(g, w)
