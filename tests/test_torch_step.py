"""The slice end to end: the port's step runners against the JAX
package's, from the same initial bits (the JAX package's init_cluster
output, carried over with state_from_numpy / aux_from_numpy).

(a) The default (plain-torch) path in f64: hermite4 at n = 96 through
    run_steps, to 1e-12 after one step and after five. Chaos does not
    call for a looser bar at five steps (0.05 Myr, far below a crossing
    time): the two packages differ only by f64 reduction order, ~1e-15
    relative.
(b) The kernel path (force_impl="pallas") in f32 at n = 96, hermite4 and
    hermite4_block with k_fast = 16, the config of
    tests/test_force_cache.py: 10 steps through fresh_cache and
    run_steps_cached in two chunks. The JAX package runs its Pallas
    kernels in interpret mode (their default matmul reduction), the port
    its kernels' plain versions; agreement within test_force_cache's
    bars (pos rtol 2e-4 atol 2e-5, slr rtol 2e-3), mass exactly.
"""
import importlib

import numpy as np
import pytest
import torch

from al26_tpu.config import SimConfig as JaxConfig
from al26_tpu.sim import init_cluster as jax_init
from al26_tpu.state import cluster_to_numpy as jax_to_numpy
from al26_tpu_torch.config import SimConfig
from al26_tpu_torch.ops import cuda_nbody
from al26_tpu_torch.state import (
    aux_from_numpy, cluster_to_numpy, state_from_numpy,
)

torch.set_num_threads(1)

# the modules (each package's sim/__init__ re-exports a function `step`)
jax_step = importlib.import_module("al26_tpu.sim.step")
port_step = importlib.import_module("al26_tpu_torch.sim.step")

_AUX = ("hm_idx", "hm_slot_valid", "msrc_idx", "msrc_valid", "agb_grid_t",
        "agb_grid_rates", "kick_vel")


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


def _close(got, want, rtol, atol_scale):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()))


def test_default_path_f64_hermite4_matches_jax():
    (js, ja, jcfg), (ts, ta, tcfg) = _both(n=96, rc=1.0, final_time=10.0,
                                           seed=31, dtype="f64",
                                           integrator="hermite4")
    assert not port_step._cacheable(tcfg, 96, torch.float64, "cpu", None,
                                    "auto")
    for n_steps in (1, 5):
        j_out = jax_to_numpy(jax_step.run_steps(js, ja, jcfg,
                                                n_steps).cluster)
        t_out = cluster_to_numpy(port_step.run_steps(ts, ta, tcfg,
                                                     n_steps).cluster)
        for k in ("pos", "vel", "mass", "slr", "slr_final"):
            _close(t_out[k], j_out[k], 1e-12, 1e-12)
        for k in ("kicked", "disk_alive"):
            np.testing.assert_array_equal(t_out[k], j_out[k])


@pytest.mark.parametrize("integ,extra", [
    ("hermite4", {}), ("hermite4_block", {"k_fast": 16}),
])
def test_kernel_path_f32_matches_jax(integ, extra):
    (js, ja, jcfg), (ts, ta, tcfg) = _both(n=96, rc=1.0, final_time=10.0,
                                           seed=31, dtype="f32",
                                           integrator=integ, **extra)
    assert port_step._cacheable(tcfg, 96, torch.float32, "cpu", None,
                                "pallas")
    cache_j = jax_step.fresh_cache(js, jcfg, integ, None, "pallas")
    cache_t = port_step.fresh_cache(ts, tcfg, integ, None, "pallas")
    before = dict(cuda_nbody.LAUNCHES)
    for _ in range(2):                     # two checkpoint-sized chunks
        js, cache_j = jax_step.run_steps_cached(js, cache_j, ja, jcfg, 5,
                                                None, "pallas")
        ts, cache_t = port_step.run_steps_cached(ts, cache_t, ta, tcfg, 5,
                                                 None, "pallas")
    assert cuda_nbody.LAUNCHES == before   # CPU tensors: plain versions
    j_out, t_out = jax_to_numpy(js.cluster), cluster_to_numpy(ts.cluster)
    np.testing.assert_allclose(t_out["pos"], j_out["pos"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(t_out["slr"], j_out["slr"], rtol=2e-3,
                               atol=1e-30)
    np.testing.assert_array_equal(t_out["mass"], j_out["mass"])
    assert t_out["pos"].dtype == np.float32
    assert int(ts.step_count) == 10
    assert float(ts.time) == float(js.time)
    assert t_out["slr"][:, :, 0:2].sum() > 0     # the winds deposited


def test_not_ported_backends_raise():
    from al26_tpu_torch.sim import init_cluster

    ts, ta, tcfg = init_cluster(SimConfig(n=32, seed=2), device="cpu")
    for fi in ("sharded", "ring"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_step.step(ts, ta, tcfg, force_impl=fi)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_step.step(ts, ta, tcfg, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_step.run_steps(ts, ta, tcfg.replace(
            integrator="hermite4_block", k_fast=8, gravity_stride=2), 2,
            force_impl="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_step.run_steps_traj(ts, ta, tcfg, 2)
