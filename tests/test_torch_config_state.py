"""Config and state of the port against the JAX package: the same
SimConfig fields and defaults with dicts that round-trip both ways, the
same initial conditions from the same seed, and the numpy conversion
helpers that let both packages start from the same bits."""
import dataclasses

import numpy as np
import pytest
import torch

from al26_tpu.config import SimConfig as JaxConfig
from al26_tpu.sim import init_cluster as jax_init
from al26_tpu.state import cluster_to_numpy as jax_to_numpy
from al26_tpu_torch.config import SimConfig
from al26_tpu_torch.sim import init_cluster
from al26_tpu_torch.state import (
    aux_from_numpy, cluster_to_numpy, state_from_numpy,
)

torch.set_num_threads(1)

# fields that pass through the stellar fits (exp/log/pow): XLA's CPU
# compiler and torch evaluate and contract these f64 expressions
# differently, so they agree to a few ulp rather than bit for bit
_FIT_FIELDS = {"mdot"}


def test_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(SimConfig)]
    assert tf == jf
    assert SimConfig().to_dict() == JaxConfig().to_dict()


def test_config_dict_round_trips_between_packages():
    cfg = JaxConfig(n=512, rc=0.7, seed=9, dtype="f32", k_fast=64,
                    mesh_shape=(2, 2), interloper=True, mass_tracks="seba")
    d = cfg.to_dict()
    mine = SimConfig.from_dict(d)
    assert mine.to_dict() == d
    assert JaxConfig.from_dict(mine.to_dict()) == cfg
    assert mine.eps2 == cfg.eps2 and mine.dt == cfg.dt
    # list-typed mesh_shape (a JSON round trip) and checkpoint restores
    d["mesh_shape"] = [2, 2]
    assert SimConfig.from_dict(d).mesh_shape == (2, 2)
    legacy = {k: v for k, v in d.items() if k != "mass_tracks"}
    assert (SimConfig.from_checkpoint_dict(legacy).to_dict()
            == JaxConfig.from_checkpoint_dict(legacy).to_dict())
    assert (SimConfig(final_time=10.0).extended_to(20.0).to_dict()
            == JaxConfig(final_time=10.0).extended_to(20.0).to_dict())


@pytest.mark.parametrize("seed,interloper,dtype", [
    (3, False, "f64"), (17, True, "f64"), (29, False, "f32"),
])
def test_init_cluster_matches_jax(seed, interloper, dtype):
    """Same seed, same initial conditions: every field drawn by numpy is
    bit-identical (positions, velocities, masses, discs, yields, slots,
    kicks, AGB grids); the fields computed by the stellar fits agree to
    4e-16 relative. The resolved configs are equal."""
    kw = dict(n=256, seed=seed, dtype=dtype, interloper=interloper)
    js, ja, jcfg = jax_init(JaxConfig(**kw))
    ts, ta, tcfg = init_cluster(SimConfig(**kw), device="cpu")
    assert tcfg.to_dict() == jcfg.to_dict()
    a, b = jax_to_numpy(js.cluster), cluster_to_numpy(ts.cluster)
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == a[k].dtype, k
        if k in _FIT_FIELDS:
            np.testing.assert_allclose(b[k], a[k], rtol=4e-16, err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for f in ("hm_idx", "hm_slot_valid", "msrc_idx", "msrc_valid",
              "agb_grid_t", "agb_grid_rates", "kick_vel"):
        x, y = np.asarray(getattr(ja, f)), getattr(ta, f).numpy()
        assert y.dtype == x.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    for x, y in zip(ja.stellar_tbl, ta.stellar_tbl):
        x, y = np.asarray(x), y.numpy()
        assert y.dtype == x.dtype
        np.testing.assert_allclose(y, x, rtol=4e-15)
    assert float(ts.time) == 0.0 and int(ts.step_count) == 0
    assert ts.step_count.dtype == torch.int32


def test_state_and_aux_from_numpy_round_trip():
    """The JAX package's state and aux, pulled to numpy, become the
    port's state and aux bit for bit, and back."""
    js, ja, _ = jax_init(JaxConfig(n=256, seed=29, dtype="f32"))
    cl = jax_to_numpy(js.cluster)
    st = state_from_numpy(cl, np.asarray(js.time), np.asarray(js.step_count),
                          dtype=torch.float32, device="cpu")
    back = cluster_to_numpy(st.cluster)
    for k in cl:
        assert back[k].dtype == cl[k].dtype
        np.testing.assert_array_equal(back[k], cl[k])
    assert st.time.dtype == torch.float32
    assert st.step_count.dtype == torch.int32
    aux_np = {f: np.asarray(getattr(ja, f))
              for f in ("hm_idx", "hm_slot_valid", "msrc_idx", "msrc_valid",
                        "agb_grid_t", "agb_grid_rates", "kick_vel")}
    aux_np["stellar_tbl"] = [np.asarray(a) for a in ja.stellar_tbl]
    aux = aux_from_numpy(aux_np, device="cpu")
    for f, x in aux_np.items():
        if f == "stellar_tbl":
            for a, b in zip(aux.stellar_tbl, x):
                assert a.numpy().dtype == b.dtype
                np.testing.assert_array_equal(a.numpy(), b)
        else:
            assert getattr(aux, f).numpy().dtype == x.dtype
            np.testing.assert_array_equal(getattr(aux, f).numpy(), x)


def test_not_ported_options_raise():
    # fractal ICs, the tree tier and the tree under a device mesh are
    # ported; a mesh whose size does not divide the tree's block count
    # (n = 32 at the default leaf: 2 blocks) raises the JAX package's
    # ValueError
    with pytest.raises(ValueError, match="divide by the mesh"):
        init_cluster(SimConfig(n=32, model="fractal", force_impl="tree",
                               mesh_shape=(8,)), device="cpu")
    with pytest.raises(ValueError):
        init_cluster(SimConfig(n=32, model="king"), device="cpu")
