"""The tree tier through the port's step runners against the JAX
package's, from the same initial bits, plus the tier's configuration
guards.

Both packages run init_cluster on the same config (fractal ICs, f64, on
the CPU): the resolved configs — integrator, leapfrog substeps, k_fast and
the auto-sized tree_kavg — must be equal, and the initial states agree to
1e-12 (tests/test_torch_fractal.py). Then 3 steps of force_impl="tree"
through run_steps (the cached path) for leapfrog, hermite4_block with the
geometric MAC, and hermite4_block with the relative MAC (exact seeding
sweep, relative closing sweeps): positions to 1e-12 relative, the SLR
reservoirs to tests/test_tree.py's absolute bar (1e-25 Msun). At n = 1024
with tree_leaf = 16 (64 blocks) the MAC accepts far nodes, so the far
field, the near field and their composition are all on the path.

The port refuses what the JAX package silently degrades (an uncached
relative-MAC step raises ValueError): tests/test_torch_tree.py.
"""
import importlib

import numpy as np
import pytest
import torch

from al26_tpu.config import SimConfig as JaxConfig
from al26_tpu.sim import init_cluster as jax_init
from al26_tpu.state import cluster_to_numpy as jax_to_numpy
from al26_tpu_torch.config import SimConfig
from al26_tpu_torch.ops import cuda_nbody, cuda_tree
from al26_tpu_torch.ops.tree import p2p_partner_counts
from al26_tpu_torch.sim import init_cluster
from al26_tpu_torch.sim.init import resolve_integrator
from al26_tpu_torch.state import cluster_to_numpy

torch.set_num_threads(1)

jax_step = importlib.import_module("al26_tpu.sim.step")
port_step = importlib.import_module("al26_tpu_torch.sim.step")

_BASE = dict(n=1024, rc=1.0, final_time=0.1, n_plot=10, steps_per_plot=1,
             seed=42, model="fractal", dtype="f64", force_impl="tree",
             tree_leaf=16)


@pytest.mark.parametrize("extra", [
    {},                                                  # auto -> leapfrog
    {"integrator": "hermite4_block", "k_fast": 64},
    {"tree_mac": "relative", "tree_alpha": 3e-3, "k_fast": 64},
], ids=["leapfrog", "hermite4_block", "relative"])
def test_tree_steps_match_jax(extra):
    cfg = dict(_BASE, **extra)
    js, ja, jcfg = jax_init(JaxConfig(**cfg))
    ts, ta, tcfg = init_cluster(SimConfig(**cfg), device="cpu")
    assert tcfg.to_dict() == jcfg.to_dict()        # incl. tree_kavg
    assert tcfg.tree_kavg > 0
    assert tcfg.integrator == ("leapfrog" if not extra
                               else "hermite4_block")
    cnt = p2p_partner_counts(ts.cluster.pos, ts.cluster.mass, leaf=16,
                             theta=tcfg.tree_theta)
    assert float(cnt.double().mean()) < 0.6 * len(cnt)    # MAC engaged
    before = (dict(cuda_nbody.LAUNCHES), dict(cuda_tree.LAUNCHES))
    s_t = port_step.run_steps(ts, ta, tcfg, 3, force_impl="tree")
    assert (dict(cuda_nbody.LAUNCHES), dict(cuda_tree.LAUNCHES)) == before
    s_j = jax_step.run_steps(js, ja, jcfg, 3, force_impl="tree")
    t, j = cluster_to_numpy(s_t.cluster), jax_to_numpy(s_j.cluster)
    assert np.isfinite(t["pos"]).all()
    for k in ("pos", "vel"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-12,
                                   atol=1e-12 * np.abs(j[k]).max())
    np.testing.assert_allclose(t["slr"], j["slr"], rtol=0, atol=1e-25)
    np.testing.assert_array_equal(t["mass"], j["mass"])
    assert int(s_t.step_count) == 3 and float(s_t.time) == float(s_j.time)


def test_uncached_geometric_step_matches_jax():
    """One uncached step (the integrator's closing evaluation through
    make_tree_force) against the JAX package's uncached step."""
    cfg = dict(_BASE, integrator="hermite4_block", k_fast=64)
    js, ja, jcfg = jax_init(JaxConfig(**cfg))
    ts, ta, tcfg = init_cluster(SimConfig(**cfg), device="cpu")
    t = cluster_to_numpy(port_step.step(ts, ta, tcfg,
                                        force_impl="tree").cluster)
    j = jax_to_numpy(jax_step.step(js, ja, jcfg, force_impl="tree").cluster)
    np.testing.assert_allclose(t["pos"], j["pos"], rtol=1e-12,
                               atol=1e-12 * np.abs(j["pos"]).max())


def test_tree_config_guards_and_resolution():
    base = dict(_BASE, n=300)
    with pytest.raises(ValueError, match="supports integrator"):
        init_cluster(SimConfig(**base, integrator="hermite4"), device="cpu")
    with pytest.raises(ValueError, match="tree_theta"):
        init_cluster(SimConfig(**base, tree_theta=1.5), device="cpu")
    with pytest.raises(ValueError, match="relative"):
        init_cluster(SimConfig(**base, tree_mac="relative",
                               integrator="leapfrog"), device="cpu")
    for bad in ({"force_cache": False}, {"natal_kicks": True}):
        with pytest.raises(ValueError, match="force cache"):
            init_cluster(SimConfig(**base, tree_mac="relative", **bad),
                         device="cpu")
    with pytest.raises(ValueError, match="tree_alpha"):
        init_cluster(SimConfig(**base, tree_mac="relative", tree_alpha=0.0),
                     device="cpu")
    with pytest.raises(ValueError, match="tree_mac"):
        init_cluster(SimConfig(**base, tree_mac="nope"), device="cpu")
    # under a mesh: hermite4_block at every N, a block count that divides
    # by the mesh size (300 stars at leaf 16: 32 blocks; at leaf 128: 4)
    _, _, mcfg = init_cluster(SimConfig(**base, mesh_shape=(8,)),
                              device="cpu")
    assert mcfg.integrator == "hermite4_block"
    with pytest.raises(ValueError, match="hermite4_block"):
        init_cluster(SimConfig(**base, mesh_shape=(8,),
                               integrator="leapfrog"), device="cpu")
    with pytest.raises(ValueError, match="divide by the mesh"):
        init_cluster(SimConfig(**dict(base, tree_leaf=128),
                               mesh_shape=(8,)), device="cpu")
    # a step() caller bypassing init cannot run the tree under hermite4
    ts, ta, tcfg = init_cluster(SimConfig(**base), device="cpu")
    with pytest.raises(ValueError, match="supports integrator"):
        port_step.step(ts, ta, tcfg.replace(integrator="hermite4"),
                       force_impl="tree")
    # config-level resolution, as the JAX package's
    from al26_tpu.sim.init import resolve_integrator as jax_resolve

    for kw in ({"n": 10000}, {"n": 512}, {"n": 512, "tree_mac": "relative"},
               {"n": 20000, "integrator": "leapfrog"},
               {"n": 512, "tree_leaf": 16, "mesh_shape": (4,)}):
        c = dict(force_impl="tree", **kw)
        got = resolve_integrator(SimConfig(**c), m_total=0.6 * kw["n"])
        want = jax_resolve(JaxConfig(**c), m_total=0.6 * kw["n"])
        assert got.to_dict() == want.to_dict()
        assert port_step._resolve_integ(
            SimConfig(**c), kw["n"]) == jax_step._resolve_integ(
                JaxConfig(**c), kw["n"])
