"""The port's host scripts (scripts/*_torch.py) on the CPU against the
JAX package's: wind_ratio's table at 1e-12 in f64 (and its printed table
equal), the Plummer and disc-lifetime draws bitwise from the same numpy
seed, the fractal draws at 1e-12 (their virialisation scale is a
potential sum, reduced in another order), the disc histogram against
numpy's, and the compression harness's payload: the JAX harness's bytes,
read back equal through the port's native and Python codecs.
"""
import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path: str):
    spec = importlib.util.spec_from_file_location(
        "_s_" + os.path.basename(path)[:-3], os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args):
    """fn(*args)'s result and what it printed, less the "wrote" lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    lines = [ln for ln in buf.getvalue().splitlines()
             if not ln.startswith("wrote")]
    return out, lines


def _jax_wind_table(mass_tracks: str, yields_vel: int) -> dict:
    """scripts/wind_ratio.py's computation (main, its loop body) with
    every number kept."""
    import jax.numpy as jnp

    from al26_tpu.models.stellar import evolution as st
    from al26_tpu.models.yields import calc_slr_yield, read_slrs

    al = read_slrs(vel=yields_vel)["Al26"]
    out = {}
    for m in (20.0, 25.0, 30.0, 40.0, 60.0):
        m0 = jnp.asarray(m)
        t_cc = float(st.t_sn(m0, tracks=mass_tracks))
        wy = calc_slr_yield(m, al.wind_mass, al.wind_yield)
        twl = float(st.total_wind_loss(m0, tracks=mass_tracks))
        ratio = wy / twl if twl > 0 else 0.0
        ts = np.linspace(0.0, t_cc * 0.99999, 2048)
        rates = np.asarray(
            st.wind_mdot(m0, jnp.asarray(ts), tracks=mass_tracks)) * ratio
        cum = np.concatenate([[0.0], np.cumsum(
            0.5 * (rates[1:] + rates[:-1]) * np.diff(ts))])
        out[m] = (t_cc, wy, twl, ts, cum)
    return out


@pytest.mark.parametrize("tracks,vel", [("lc18", 300), ("seba", 300),
                                        ("lc18_vel0", 0)])
def test_wind_ratio_table_matches_jax(tmp_path, tracks, vel):
    port = _load("scripts/wind_ratio_torch.py")
    jax_script = _load("scripts/wind_ratio.py")
    got, got_lines = _run(port.main, str(tmp_path / "p.pdf"), tracks, vel,
                          "cpu")
    _, want_lines = _run(jax_script.main, str(tmp_path / "j.pdf"), tracks,
                         vel)
    assert got_lines == want_lines and len(got_lines) == 6
    want = _jax_wind_table(tracks, vel)
    assert list(got) == list(want)
    for m in want:
        for g, w in zip(got[m], want[m]):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0.0)
        assert got[m][4][-1] > 0.0


def test_cluster_ic_draws_match_jax(tmp_path):
    """benchmarks/cluster_ics.py's draws, in its order from one
    default_rng(0): Plummer bitwise, the fractals at 1e-12."""
    from al26_tpu.models.fractal import fractal_positions_velocities
    from al26_tpu.models.plummer import plummer_positions_velocities

    n = 600
    torch.set_num_threads(1)
    port = _load("scripts/cluster_ics_torch.py")
    got, lines = _run(port.main, str(tmp_path / "ics.png"), n, "cpu")
    assert len(lines) == 3
    rng = np.random.default_rng(0)
    want = {"plummer": plummer_positions_velocities(rng, n, 1.0, n * 0.5)[0]}
    for d in port.FRACTAL_DIMS:
        want[f"fractal D={d}"] = np.asarray(fractal_positions_velocities(
            rng, n, 1.0, n * 0.5, d)[0])
    assert list(got) == list(want)
    np.testing.assert_array_equal(got["plummer"], want["plummer"])
    for k in list(want)[1:]:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                   atol=1e-12 * np.abs(want[k]).max())


def test_disc_lifetime_draws_match_jax(tmp_path):
    from al26_tpu.models.discs import draw_disk_lifetimes

    port = _load("scripts/disc_lifetimes_torch.py")
    n = 20_000
    tau, lines = _run(port.main, str(tmp_path / "d.png"), n, "cpu")
    np.testing.assert_array_equal(
        tau, draw_disk_lifetimes(np.random.default_rng(0), n))
    assert lines[0].startswith(f"mean {tau.mean():.3f} Myr")
    centres, dens, pdf = port.histogram(tau, "cpu")
    want, edges = np.histogram(tau, bins=port.BINS, range=(0, port.T_MAX),
                               density=True)
    np.testing.assert_allclose(dens, want, rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(centres, 0.5 * (edges[1:] + edges[:-1]),
                               rtol=1e-12)
    assert np.abs(dens - pdf).max() < 0.05


def test_compression_harness_payload(tmp_path):
    """The harness's payload is the JAX harness's bytes; the native and
    Python codecs read it back to the same object; a yields file from the
    port's writer times the same way."""
    from al26_tpu_torch.io import compression, ubjson

    port = _load("scripts/compression_tests_torch.py")
    jax_script = _load("benchmarks/compression_tests.py")
    res, lines = _run(port.main, None, 40, 12)
    want, _ = _run(jax_script.build_payload, 40, 12)
    assert res["payload"] == want
    assert set(res["codecs"]) == {"native", "python"}
    assert ubjson.native_codec()[1](want) == ubjson.loadb_python(want)
    assert any(name.startswith("port (") for name in res["packed_bytes"])
    path = tmp_path / "x-yields.ubj.zst"
    path.write_bytes(compression.compress(res["payload"]))
    again, _ = _run(port.main, str(path))
    assert again["payload"] == res["payload"]


@pytest.mark.parametrize("path", [
    "scripts/wind_ratio_torch.py", "scripts/cluster_ics_torch.py",
    "scripts/disc_lifetimes_torch.py", "scripts/compression_tests_torch.py",
    "tests/torch_golden_stats.py", "al26_tpu_torch/io/native_build.py",
    "al26_tpu_torch/io/ubjson.py",
])
def test_port_scripts_import_no_jax(path):
    """The port's scripts and its golden helper import neither jax nor
    the JAX package (a line-start import, as the acceptance grep reads)."""
    import re

    rx = re.compile(r"^\s*(import|from)\s+(al26_tpu|jax)(\.|\s|$)")
    with open(os.path.join(REPO, path)) as f:
        assert [ln for ln in f if rx.match(ln)] == []
