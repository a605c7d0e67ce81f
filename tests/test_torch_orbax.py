"""The port's device-state checkpoint tree (al26_tpu_torch.io.orbax_backend,
on torch.distributed.checkpoint) on the CPU: the counterparts of
tests/test_orbax.py, in a gloo world of 4 ranks (tests/torch_mesh_ranks.py,
spawned once for the module) under the (4,) mesh.

A DCP tree holds the exact tensors, so a save and restore is bitwise, and
a run restored mid-way continues bitwise (the uncached mesh step repeats
the same operations on the same bits). An orbax tree and a DCP tree do
not read each other; the driver's final state is also held to the JAX
package's driver run at 1e-12.
"""
import json
import os

import numpy as np
import pytest
import torch

from al26_tpu.state import cluster_to_numpy as jax_to_numpy
from al26_tpu_torch.config import SimConfig
from al26_tpu_torch.io.orbax_backend import (
    drop_steps_above, latest_step, load_sharded_state, save_sharded_state,
)
from test_torch_parallel import _close_state, _ranks, spawn

torch.set_num_threads(1)

CASES = ["orbax_roundtrip", "orbax_driver"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("orbax4")
    spawn(d, 4, CASES)
    return d


def _part(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("case", CASES)
def test_every_rank_holds_the_same_bits(world, case):
    outs = _ranks(world, case, 4)
    for r in range(1, 4):
        for k in outs[0]:
            np.testing.assert_array_equal(outs[r][k], outs[0][k],
                                          err_msg=f"rank {r}: {k}")


def test_roundtrip_preserves_values(world):
    """Saved under the (4,) mesh by every rank, restored onto the template
    and without one (CPU, stored shapes and dtypes): bitwise, and the
    resolved config round-trips through the JSON sidecar."""
    out = _ranks(world, "orbax_roundtrip", 4)[0]
    saved = _part(out, "saved.")
    for prefix in ("restored.", "bare."):
        got = _part(out, prefix)
        assert got.keys() == saved.keys()
        for k, v in saved.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(out["latest"]) == int(out["step"]) == 7
    assert bool(out["cfg_equal"])
    ck = world / "ck"
    assert sorted(os.listdir(ck)) == ["7", "7.cfg.json"]


def test_driver_writes_the_tree_at_every_save(world):
    """Saves land after steps 1, 5, 9, 13, 17 and 20 (final); the latest
    tree is the run's final state."""
    out = _ranks(world, "orbax_driver", 4)[0]
    assert out["steps"].tolist() == [1, 5, 9, 13, 17, 20]
    run, tree = _part(out, "run."), _part(out, "tree.")
    for k in run:
        np.testing.assert_array_equal(tree[k], run[k], err_msg=k)


def test_resume_from_the_tree_continues_bitwise(world):
    out = _ranks(world, "orbax_driver", 4)[0]
    assert int(out["mid_step"]) == 9
    assert bool(out["cfg_equal"])
    run, cont = _part(out, "run."), _part(out, "cont.")
    for k in run:
        np.testing.assert_array_equal(cont[k], run[k], err_msg=k)


def test_nc_resume_drops_the_abandoned_steps(world):
    """A -nc 2 resume (checkpoint 2 = step 5) drops the tree's steps above
    5 (a planted stale step 99 among them) before it writes its own
    again."""
    out = _ranks(world, "orbax_driver", 4)[0]
    assert out["steps_after"].tolist() == [1, 5, 9, 13, 17, 20]
    ob = world / "orbax_driver" / "orbax"
    assert not (ob / "99").exists() and not (ob / "99.cfg.json").exists()
    for s in (9, 13, 17, 20):
        assert (ob / f"{s}.cfg.json").exists()


def test_mesh_driver_matches_jax_driver(world, tmp_path, monkeypatch):
    from al26_tpu.config import SimConfig as JConfig
    from al26_tpu.sim.driver import run as jrun

    out = _ranks(world, "orbax_driver", 4)[0]
    monkeypatch.chdir(tmp_path)
    r = jrun(JConfig(n=32, rc=0.5, final_time=0.5, seed=6, filename="orun",
                     n_plot=5, steps_per_plot=4, force_cache=False),
             progress=False)
    _close_state(_part(out, "run."), jax_to_numpy(r.state.cluster))


def test_missing_tree_raises(tmp_path):
    with pytest.raises(IOError, match="no orbax checkpoints"):
        load_sharded_state(str(tmp_path / "nope"))


def test_incomplete_step_is_skipped_and_dropped(tmp_path):
    """latest_step skips a step without its sidecar (a save cut short);
    drop_steps_above removes trees and sidecars above a step."""
    from al26_tpu_torch.sim import init_cluster

    state, _, cfg = init_cluster(SimConfig(n=16, seed=1,
                                           no_massive_star_requirement=True),
                                 device="cpu")
    ck = str(tmp_path / "ck")
    save_sharded_state(ck, 3, state, cfg)
    save_sharded_state(ck, 8, state, cfg)
    os.remove(os.path.join(ck, "8.cfg.json"))
    assert latest_step(ck) == 3
    with open(os.path.join(ck, "3.cfg.json")) as f:
        assert json.load(f)["n"] == 16
    drop_steps_above(ck, 2)
    assert os.listdir(ck) == []
    assert latest_step(ck) is None
