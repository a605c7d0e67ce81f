"""The gravity stride (cfg.gravity_stride = m > 1) through the port's
runners against the JAX package's, from the same initial bits (the JAX
package's init_cluster output, carried over with state_from_numpy /
aux_from_numpy).

(a) stride_active gives the JAX package's answer for a table of configs.
(b) The tree path (force_impl="tree") in f64: fractal n = 1024, leaf 16,
    hermite4_block with k_fast = 64, through fresh_cache and
    run_steps_cached_strided: full strides, strides with a remainder, a
    remainder alone, the relative MAC (stride-start reference
    accelerations), softened_virial and the three-tier k_ultra. The state
    and the returned cache (acc, jerk, pot) to 1e-12 relative (atol 1e-12
    of each column's scale), the SLR reservoirs to 1e-25 Msun absolute
    (tests/test_tree.py's bar), masses exactly: the two packages run the
    same f64 arithmetic in another reduction order.
(c) The kernel path (force_impl="pallas") at n = 96, k_fast = 16, m = 2,
    10 steps in two chunks (the JAX package's Pallas sweeps in interpret
    mode, the port's plain versions), within tests/test_force_cache.py's
    bars (pos rtol 2e-4 atol 2e-5, slr rtol 2e-3, mass exactly), in f32
    and in f64. Not at (b)'s 1e-12 in f64: the JAX package's kernel
    wrapper casts its operands to f32 (al26_tpu/ops/pallas_nbody.py
    :415-422), so its f64 kernel path carries f32-accurate sweeps (its
    cache differs from the port's f64 one by ~1e-6 relative with or
    without a stride).
(d) run_steps engages the stride by itself.
(e) A strided driver run (tree, n = 1024, m = 4, two chunks of 10 steps)
    against the JAX package's driver: the same files, the final states to
    (b)'s bars.
No kernel launches anywhere here: every tensor lies on the CPU.
"""
import glob
import importlib
import os

import numpy as np
import pytest
import torch

from al26_tpu.config import SimConfig as JaxConfig
from al26_tpu.sim import init_cluster as jax_init
from al26_tpu.state import cluster_to_numpy as jax_to_numpy
from al26_tpu_torch.config import SimConfig
from al26_tpu_torch.ops import cuda_nbody, cuda_tree
from al26_tpu_torch.state import (
    aux_from_numpy, cluster_to_numpy, state_from_numpy,
)

torch.set_num_threads(1)

jax_step = importlib.import_module("al26_tpu.sim.step")
port_step = importlib.import_module("al26_tpu_torch.sim.step")

_AUX = ("hm_idx", "hm_slot_valid", "msrc_idx", "msrc_valid", "agb_grid_t",
        "agb_grid_rates", "kick_vel")

_TREE = dict(n=1024, rc=1.0, final_time=0.1, n_plot=10, steps_per_plot=1,
             seed=42, model="fractal", dtype="f64", force_impl="tree",
             tree_leaf=16, integrator="hermite4_block", k_fast=64)
_KERNEL = dict(n=96, rc=1.0, final_time=10.0, seed=31,
               integrator="hermite4_block", k_fast=16)


def _both(**kw):
    """JAX state/aux/cfg and the port's copies of the same bits."""
    js, ja, jcfg = jax_init(JaxConfig(**kw))
    dtype = torch.float64 if jcfg.dtype == "f64" else torch.float32
    ts = state_from_numpy(jax_to_numpy(js.cluster), np.asarray(js.time),
                          np.asarray(js.step_count), dtype=dtype,
                          device="cpu")
    aux_np = {f: np.asarray(getattr(ja, f)) for f in _AUX}
    aux_np["stellar_tbl"] = [np.asarray(a) for a in ja.stellar_tbl]
    tcfg = SimConfig.from_dict(jcfg.to_dict())
    return (js, ja, jcfg), (ts, aux_from_numpy(aux_np, device="cpu"), tcfg)


_INITS = {}


def _tree_both(relative: bool):
    """One JAX init per MAC, shared by the cases (the stride knobs do not
    enter init_cluster)."""
    if relative not in _INITS:
        extra = {"tree_mac": "relative", "tree_alpha": 3e-3} if relative \
            else {}
        _INITS[relative] = _both(**_TREE, **extra)
    return _INITS[relative]


def _strided(pkg, s, a, cfg, n_steps, chunks, force_impl):
    """fresh_cache, then run_steps_cached_strided over `chunks` equal
    chunks, threading the cache; returns (state, cache)."""
    cache = pkg.fresh_cache(s, cfg, "hermite4_block", None, force_impl)
    for _ in range(chunks):
        s, cache = pkg.run_steps_cached_strided(s, cache, a, cfg,
                                                n_steps // chunks, None,
                                                force_impl)
    return s, cache


def _held_f64(t, j):
    """(b)'s bars on two cluster dicts."""
    assert np.isfinite(t["pos"]).all()
    for k in ("pos", "vel"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-12,
                                   atol=1e-12 * np.abs(j[k]).max(),
                                   err_msg=k)
    np.testing.assert_allclose(t["slr"], j["slr"], rtol=0, atol=1e-25)
    np.testing.assert_array_equal(t["mass"], j["mass"])
    for k in ("kicked", "disk_alive"):
        np.testing.assert_array_equal(t[k], j[k])


def _held_cache(tc, jc):
    for name, t, j in zip(("acc", "jerk", "pot"), tc, jc):
        j = np.asarray(j, np.float64)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-12,
                                   atol=1e-12 * np.abs(j).max(),
                                   err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(gravity_stride=2),
    dict(gravity_stride=4),
    dict(gravity_stride=8),
    dict(gravity_stride=1),
    dict(gravity_stride=4, natal_kicks=True),
    dict(gravity_stride=4, force_cache=False),
    dict(gravity_stride=2, integrator="leapfrog", leapfrog_n_sub=2),
    dict(gravity_stride=2, integrator="hermite4"),
    dict(gravity_stride=2, integrator="auto", k_fast=0),
    dict(gravity_stride=4, tree_mac="relative"),
], ids=["m2", "m4", "m8", "m1", "natal_kicks", "no_force_cache",
        "leapfrog", "hermite4", "auto_small_n", "relative"])
@pytest.mark.parametrize("force_impl", ["pallas", "auto", "tree"])
def test_stride_active_matches_jax(kw, force_impl):
    """(a) The gate: off by default, off for leapfrog / hermite4 (the
    small-n auto resolution included), off with natal kicks or without
    the force cache, on for cache-capable hermite4_block on the kernel
    and tree paths, as in the JAX package. "auto" on the CPU is the plain
    path in both packages (no kernel), hence never strided."""
    import jax.numpy as jnp

    base = dict(_KERNEL, dtype="f32", force_impl=force_impl, **kw)
    got = port_step.stride_active(SimConfig(**base), 96, torch.float32,
                                  "cpu", None, force_impl)
    want = jax_step.stride_active(JaxConfig(**base), 96, jnp.float32, None,
                                  force_impl)
    assert got == want


@pytest.mark.parametrize("kw,n_steps", [
    (dict(gravity_stride=2), 6),
    (dict(gravity_stride=4), 7),                  # 1 stride + 3 steps
    (dict(gravity_stride=8), 3),                  # remainder only
    (dict(gravity_stride=2, tree_mac="relative"), 4),
    (dict(gravity_stride=4, softened_virial=True), 4),
    (dict(gravity_stride=2, k_ultra=8), 4),
], ids=["m2", "m4_remainder", "m8_remainder_only", "relative_m2",
        "softened_virial_m4", "k_ultra_m2"])
def test_tree_stride_f64_matches_jax(kw, n_steps):
    """(b)"""
    kw = dict(kw)
    relative = kw.pop("tree_mac", None) == "relative"
    (js, ja, jcfg), (ts, ta, tcfg) = _tree_both(relative)
    jcfg, tcfg = jcfg.replace(**kw), tcfg.replace(**kw)
    assert port_step.stride_active(tcfg, 1024, torch.float64, "cpu", None,
                                   "tree")
    before = (dict(cuda_nbody.LAUNCHES), dict(cuda_tree.LAUNCHES))
    s_t, c_t = _strided(port_step, ts, ta, tcfg, n_steps, 1, "tree")
    assert (dict(cuda_nbody.LAUNCHES), dict(cuda_tree.LAUNCHES)) == before
    s_j, c_j = _strided(jax_step, js, ja, jcfg, n_steps, 1, "tree")
    _held_f64(cluster_to_numpy(s_t.cluster), jax_to_numpy(s_j.cluster))
    _held_cache(c_t, c_j)
    assert int(s_t.step_count) == n_steps
    assert float(s_t.time) == float(s_j.time)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_kernel_path_stride_matches_jax(dtype):
    """(c)"""
    (js, ja, jcfg), (ts, ta, tcfg) = _both(**_KERNEL, dtype=dtype,
                                           gravity_stride=2)
    assert port_step.stride_active(tcfg, 96, ts.cluster.pos.dtype, "cpu",
                                   None, "pallas")
    before = dict(cuda_nbody.LAUNCHES)
    s_t, c_t = _strided(port_step, ts, ta, tcfg, 10, 2, "pallas")
    assert cuda_nbody.LAUNCHES == before
    s_j, c_j = _strided(jax_step, js, ja, jcfg, 10, 2, "pallas")
    t, j = cluster_to_numpy(s_t.cluster), jax_to_numpy(s_j.cluster)
    assert int(s_t.step_count) == 10 and float(s_t.time) == float(s_j.time)
    assert t["slr"][:, :, 0:2].sum() > 0          # the winds deposited
    assert t["pos"].dtype == (np.float32 if dtype == "f32" else np.float64)
    np.testing.assert_allclose(t["pos"], j["pos"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(t["slr"], j["slr"], rtol=2e-3, atol=1e-30)
    np.testing.assert_array_equal(t["mass"], j["mass"])


def test_run_steps_engages_the_stride():
    """(d) run_steps on a stride-capable path equals
    run_steps_cached_strided from a fresh cache, bit for bit, and differs
    from the unstrided run (the stride did engage)."""
    _, (ts, ta, tcfg) = _both(**_KERNEL, dtype="f64", gravity_stride=4)
    got = port_step.run_steps(ts, ta, tcfg, 6, force_impl="pallas")
    want, _ = _strided(port_step, ts, ta, tcfg, 6, 1, "pallas")
    plain = port_step.run_steps(ts, ta, tcfg.replace(gravity_stride=1), 6,
                                force_impl="pallas")
    for k in ("pos", "vel", "slr", "mass"):
        assert torch.equal(getattr(got.cluster, k),
                           getattr(want.cluster, k)), k
    assert not torch.equal(got.cluster.pos, plain.cluster.pos)
    assert int(got.step_count) == 6


def test_strided_driver_run_matches_jax(tmp_path):
    """(e)"""
    from al26_tpu.sim.driver import run as jrun
    from al26_tpu_torch.io.checkpoint import load_state
    from al26_tpu_torch.io.compat import particles_to_cluster
    from al26_tpu_torch.sim import driver

    kw = dict(_TREE, final_time=0.2, n_plot=2, steps_per_plot=10,
              gravity_stride=4, filename="str")
    cwd = os.getcwd()
    try:
        for pkg, d in (("jax", "jax"), ("port", "port")):
            os.makedirs(tmp_path / d)
            os.chdir(tmp_path / d)
            if pkg == "jax":
                jrun(JaxConfig(**kw), progress=False)
            else:
                res = driver.run(SimConfig(**kw), progress=False,
                                 device="cpu")
    finally:
        os.chdir(cwd)
    assert int(res.state.step_count) == 20
    names = {d: sorted(os.path.basename(f)
                       for f in glob.glob(str(tmp_path / d / "str-*")))
             for d in ("jax", "port")}
    assert names["jax"] == names["port"]
    states = [f for f in names["port"] if "-state-" in f]
    assert len(states) == 4

    def final(d):
        st = load_state(str(tmp_path / d / states[-1]))
        return cluster_to_numpy(particles_to_cluster(st.cluster,
                                                     device="cpu"))

    _held_f64(final("port"), final("jax"))
