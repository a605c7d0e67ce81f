"""The port's device meshes (al26_tpu_torch.parallel: sharded, ring,
tree_mesh, the ensemble meshes; sim.step, the driver and the CLI under a
mesh) against the JAX package's mesh code, on the CPU.

The port runs real gloo worlds of 4 ranks (meshes (4,) and (2, 2)) and of
2 ranks, one process a rank (tests/torch_mesh_ranks.py, which imports no
JAX), spawned once per world for the whole module; the JAX side runs its
mesh code on the fake CPU devices of tests/conftest.py, at the same mesh
sizes, from the same numpy-seeded inputs or the same initial bits (the
JAX package's init_cluster output, handed to the ranks as .npz).

Bars. f64: 1e-12 (relative, with an absolute floor of 1e-12 of each
column's scale) for the sharded, ring, sharded-rows and tree-mesh sweeps,
the mesh steps, the stride under a mesh, the ensembles and the drivers —
the packages differ only in summation order. Every rank's outputs are
bit-identical (the replicated state must not drift apart). The kernels'
local bodies, run for all ranks in one process through the wrappers'
plain versions on f32 tensors, are held to the matmul bodies' bars
(3e-4 / 5e-4 of the max) against the unsplit call, each column slice
against its own FMA-form sum, and to 1e-12 in f64 against the unsplit
plain sweep.
"""
import functools
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from al26_tpu.config import SimConfig as JConfig
from al26_tpu.state import cluster_to_numpy as jax_to_numpy
from al26_tpu_torch.config import SimConfig
from al26_tpu_torch.ops import cuda_nbody, cuda_tree
from al26_tpu_torch.ops import tree as T
from al26_tpu_torch.parallel import ensemble as ens
from al26_tpu_torch.parallel import ring, sharded, tree_mesh
import torch_mesh_ranks as mr

torch.set_num_threads(1)

jax_step = importlib.import_module("al26_tpu.sim.step")
port_step = importlib.import_module("al26_tpu_torch.sim.step")

WORLD4 = ["sharded_force", "ring_force", "sharded_rows", "tree_sweep",
          "tree_sweep_rel", "mesh_step", "mesh_cached", "mesh_block",
          "ring_cached", "mesh_stride", "tree_step", "ensemble_1d",
          "ensemble_2d", "driver_mesh", "driver_ensemble_2d"]
WORLD2 = ["sharded_force", "sharded_rows", "ensemble_2d",
          "driver_ensemble_1d"]

_TREE_BASE = dict(n=512, rc=1.0, final_time=0.1, n_plot=10, steps_per_plot=1,
                  seed=42, model="fractal")
# the JAX package's initial bits of each state case
STATES = {
    "mesh_step": dict(n=64, rc=1.0, final_time=10.0, seed=13,
                      force_cache=False),
    "mesh_cached": dict(n=64, rc=1.0, final_time=10.0, seed=29),
    "mesh_block": dict(n=64, rc=1.0, final_time=10.0, seed=31,
                       integrator="hermite4_block", k_fast=16,
                       force_cache=False),
    "ring_cached": dict(n=64, rc=1.0, final_time=10.0, seed=37),
    "mesh_stride": dict(n=96, rc=1.0, final_time=10.0, seed=31,
                        integrator="hermite4_block", k_fast=16,
                        gravity_stride=2),
    "tree_step": dict(_TREE_BASE, force_impl="tree", tree_leaf=16,
                      integrator="hermite4_block", k_fast=32),
}
ENSEMBLES = {
    "ensemble_1d": (dict(n=32, rc=1.0, final_time=10.0, seed=100,
                         no_massive_star_requirement=True), 8),
    "ensemble_2d": (dict(n=64, rc=1.0, final_time=10.0, seed=5), 4),
}


def _aux_np(ja):
    aux = {f: np.asarray(getattr(ja, f)) for f in mr.AUX}
    aux["stellar_tbl"] = [np.asarray(a) for a in ja.stellar_tbl]
    return aux


@functools.lru_cache(maxsize=None)
def jax_state(name):
    from al26_tpu.sim import init_cluster

    return init_cluster(JConfig(**STATES[name]))


@functools.lru_cache(maxsize=None)
def jax_ensemble(name):
    from al26_tpu.parallel.ensemble import init_ensemble

    kw, b = ENSEMBLES[name]
    return init_ensemble(JConfig(**kw), b)


def _write_inputs(d):
    for name in STATES:
        js, ja, jcfg = jax_state(name)
        mr.save_state_npz(str(d / f"{name}-in"), jax_to_numpy(js.cluster),
                          np.asarray(js.time), np.asarray(js.step_count),
                          _aux_np(ja), jcfg.to_dict())
    for name in ENSEMBLES:
        bs, ba, cfgs = jax_ensemble(name)
        mr.save_state_npz(str(d / f"{name}-in"), jax_to_numpy(bs.cluster),
                          np.asarray(bs.time), np.asarray(bs.step_count),
                          _aux_np(ba), cfgs[0].to_dict())


def spawn(d, world, cases, timeout=900):
    """Run `cases` in a gloo world of `world` rank processes; raise with
    the failing rank's stderr."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    store = d / "store"
    procs = [subprocess.Popen(
        [sys.executable, mr.__file__, "--world", str(world), "--rank",
         str(r), "--store", str(store), "--dir", str(d), "--cases",
         ",".join(cases)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, rc, e) for r, (rc, e) in enumerate(errs) if rc != 0]
    if bad:
        r, rc, e = bad[0]
        raise RuntimeError(f"rank {r} exited {rc}:\n{e[-4000:]}")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both gloo worlds, each spawned once; returns {world: directory}."""
    out = {}
    for world, cases in ((4, WORLD4), (2, WORLD2)):
        d = tmp_path_factory.mktemp(f"world{world}")
        _write_inputs(d)
        spawn(d, world, cases)
        out[world] = d
    return out


def _ranks(d, case, world):
    return [dict(np.load(d / f"{case}-r{r}.npz")) for r in range(world)]


def _close(got, want, rtol=1e-12, atol_scale=1e-12, msg=""):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_scale * scale, err_msg=msg)


def _close_state(got: dict, want: dict, keys=("pos", "vel", "mass", "slr",
                                               "slr_final", "agb_raw")):
    for k in keys:
        _close(got[k], want[k], msg=k)
    for k in ("kicked", "disk_alive"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# every rank ends on the same bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,case", [(4, c) for c in WORLD4]
                         + [(2, c) for c in WORLD2])
def test_every_rank_holds_the_same_bits(worlds, world, case):
    outs = _ranks(worlds[world], case, world)
    for r in range(1, world):
        assert outs[r].keys() == outs[0].keys()
        for k in outs[0]:
            np.testing.assert_array_equal(outs[r][k], outs[0][k],
                                          err_msg=f"rank {r}: {k}")


# ---------------------------------------------------------------------------
# the sweeps against the JAX mesh code
# ---------------------------------------------------------------------------

def _jmesh(world):
    from al26_tpu.parallel.sharded import make_mesh

    return make_mesh(world)


@pytest.mark.parametrize("world", [4, 2])
def test_sharded_force_matches_jax_mesh(worlds, world):
    import jax.numpy as jnp
    from al26_tpu.parallel.sharded import (
        sharded_acc_jerk_pot, sharded_potential_energy,
    )

    got = _ranks(worlds[world], "sharded_force", world)[0]
    pos, vel, mass = (jnp.asarray(a) for a in mr.force_inputs(0, 256))
    a, j, p = sharded_acc_jerk_pot(pos, vel, mass, _jmesh(world), 1e-3)
    u = sharded_potential_energy(pos, mass, _jmesh(world), 1e-3)
    for k, want in (("acc", a), ("jerk", j), ("pot", p), ("u", u)):
        _close(got[k], np.asarray(want), msg=k)


def test_ring_force_matches_jax_mesh(worlds):
    import jax.numpy as jnp
    from al26_tpu.ops.integrators import hermite4_advance
    from al26_tpu.parallel.ring import make_ring_force, ring_acc_jerk_pot

    got = _ranks(worlds[4], "ring_force", 4)[0]
    pos, vel, mass = (jnp.asarray(a) for a in mr.force_inputs(8, 256))
    a, j, p = ring_acc_jerk_pot(pos, vel, mass, _jmesh(4), 1e-3)
    pa, va = hermite4_advance(pos, vel, mass, jnp.asarray(0.01), eps2=1e-3,
                              force_fn=make_ring_force(_jmesh(4), mass,
                                                       1e-3))
    for k, want in (("acc", a), ("jerk", j), ("pot", p), ("pos_h4", pa),
                    ("vel_h4", va)):
        _close(got[k], np.asarray(want), msg=k)


@pytest.mark.parametrize("world", [4, 2])
def test_sharded_rows_match_jax_mesh(worlds, world):
    """K fast rows drawn from every shard against each rank's column
    slice, all-reduced (the ids of the other shards must keep their
    forces)."""
    import jax.numpy as jnp
    from al26_tpu.parallel.sharded import make_sharded_force_rows

    got = _ranks(worlds[world], "sharded_rows", world)[0]
    pos, vel, mass = (jnp.asarray(a) for a in mr.force_inputs(5, 64))
    ids = jnp.asarray(mr.rows_ids(5, 64, world))
    fn = make_sharded_force_rows(_jmesh(world), mass, eps2=0.0)
    a, j = fn(pos[ids], vel[ids], ids, pos, vel)
    _close(got["acc"], np.asarray(a), msg="acc")
    _close(got["jerk"], np.asarray(j), msg="jerk")


@pytest.mark.parametrize("case", ["tree_sweep", "tree_sweep_rel"])
def test_tree_mesh_sweep_matches_jax_mesh(worlds, case):
    import jax.numpy as jnp
    from al26_tpu.ops.nbody import acc_jerk_pot_chunked
    from al26_tpu.parallel.tree_mesh import tree_acc_jerk_pot_mesh

    got = _ranks(worlds[4], case, 4)[0]
    pos, vel, mass = (jnp.asarray(a) for a in mr.tree_inputs(3, 500))
    aref, theta = None, 0.75
    if case == "tree_sweep_rel":
        a_ex, _, _ = acc_jerk_pot_chunked(pos, vel, mass, 1e-4)
        aref, theta = jnp.sqrt(jnp.sum(a_ex * a_ex, axis=-1)), 0.01
    a, j, p, ovf = tree_acc_jerk_pot_mesh(
        pos, vel, mass, _jmesh(4), 1e-4, leaf=16, theta=theta, kavg=32,
        pot_eps2=1e-30, aref=aref, with_jerk=True)
    assert not bool(got["overflow"]) and not bool(ovf)
    for k, want in (("acc", a), ("jerk", j), ("pot", p)):
        _close(got[k], np.asarray(want), msg=k)


# ---------------------------------------------------------------------------
# steps, the stride and the tree under a mesh
# ---------------------------------------------------------------------------

def _jax_steps(name, n_steps, force_impl="auto"):
    from al26_tpu.parallel.sharded import shard_state_rows

    js, ja, jcfg = jax_state(name)
    m4 = _jmesh(4)
    if force_impl == "tree":
        jcfg = jcfg.replace(mesh_shape=(4,))
    out = jax_step.run_steps(shard_state_rows(js, m4), ja, jcfg, n_steps,
                             mesh=m4, force_impl=force_impl)
    return jax_to_numpy(out.cluster), out


@pytest.mark.parametrize("case,n_steps,force_impl", [
    ("mesh_step", 5, "auto"), ("mesh_cached", 10, "auto"),
    ("mesh_block", 5, "auto"), ("ring_cached", 10, "ring"),
    ("mesh_stride", 10, "auto"), ("tree_step", 3, "tree"),
])
def test_mesh_steps_match_jax_mesh(worlds, case, n_steps, force_impl):
    """run_steps under the (4,) mesh: hermite4 uncached and cached, the
    block integrator through the column-split rows, the ring, the gravity
    stride and the tree mesh (hermite4_block)."""
    got = _ranks(worlds[4], case, 4)[0]
    want, jout = _jax_steps(case, n_steps, force_impl)
    _close_state(got, want)
    assert int(got["step_count"]) == int(jout.step_count) == n_steps
    assert float(got["time"]) == float(jout.time)


def test_mesh_stride_engages_on_the_mesh():
    js, ja, jcfg = jax_state("mesh_stride")
    tcfg = SimConfig.from_dict(jcfg.to_dict())
    mesh = sharded.make_mesh(1, device="cpu")
    for fi in ("auto", "sharded", "ring", "tree"):
        assert port_step.stride_active(tcfg, 96, torch.float64, "cpu", mesh,
                                       fi)
    assert port_step._cacheable(tcfg, 96, torch.float64, "cpu", mesh, "ring")


# ---------------------------------------------------------------------------
# the ensemble meshes
# ---------------------------------------------------------------------------

def test_ensemble_1d_mesh_matches_jax_mesh(worlds):
    """8 realizations over the 4-rank ensemble mesh, each rank running its
    two as its own ensemble."""
    from al26_tpu.parallel.ensemble import (
        ensemble_run_steps, make_ensemble_mesh, shard_ensemble,
    )

    got = _ranks(worlds[4], "ensemble_1d", 4)[0]
    bs, ba, cfgs = jax_ensemble("ensemble_1d")
    bs, ba = shard_ensemble(bs, ba, make_ensemble_mesh(4))
    want = jax_to_numpy(ensemble_run_steps(bs, ba, cfgs[0], 3).cluster)
    assert got["pos"].shape == (8, 32, 3)
    _close_state(got, want)


@pytest.mark.parametrize("world", [4, 2])
def test_ensemble_2d_matches_jax_mesh(worlds, world):
    """The (2, world/2) ens x rows mesh: 5 uncached steps, and the cached
    path threaded over chunks of 2 and 3 steps."""
    from al26_tpu.parallel.ensemble import (
        ensemble2d_fresh_cache, ensemble_run_steps_2d,
        ensemble_run_steps_2d_cached, make_ensemble2d_mesh,
        shard_ensemble_2d,
    )

    got = _ranks(worlds[world], "ensemble_2d", world)[0]
    bs, ba, cfgs = jax_ensemble("ensemble_2d")
    mesh = make_ensemble2d_mesh(2, world // 2)
    bs, ba = shard_ensemble_2d(bs, ba, mesh)
    want = jax_to_numpy(ensemble_run_steps_2d(bs, ba, cfgs[0], 5,
                                              mesh).cluster)
    _close_state(got, want)
    cache = ensemble2d_fresh_cache(bs, cfgs[0], mesh)
    c1, cache = ensemble_run_steps_2d_cached(bs, cache, ba, cfgs[0], 2, mesh)
    c1, _ = ensemble_run_steps_2d_cached(c1, cache, ba, cfgs[0], 3, mesh)
    _close_state({k[7:]: v for k, v in got.items()
                  if k.startswith("cached.")}, jax_to_numpy(c1.cluster))


# ---------------------------------------------------------------------------
# the drivers under a mesh
# ---------------------------------------------------------------------------

def _files(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def test_driver_mesh_matches_jax_driver(worlds, tmp_path, monkeypatch):
    """run() with mesh_shape=(4,): rank 0 alone writes the run's files
    (the JAX driver's set), and the final state is the JAX mesh run's."""
    from al26_tpu.sim.driver import run as jrun

    got = _ranks(worlds[4], "driver_mesh", 4)[0]
    monkeypatch.chdir(tmp_path)
    r = jrun(JConfig(n=64, rc=0.5, final_time=0.5, seed=17, n_plot=2,
                     steps_per_plot=5, force_cache=False, filename="meshed",
                     mesh_shape=(4,)), progress=False)
    assert list(got["files"]) == _files(tmp_path)
    _close_state(got, jax_to_numpy(r.state.cluster))


@pytest.mark.parametrize("world,case,mesh_shape", [
    (4, "driver_ensemble_2d", (2, 2)), (2, "driver_ensemble_1d", None),
])
def test_driver_ensemble_meshes_match_jax(worlds, tmp_path, world, case,
                                          mesh_shape):
    """run_ensemble on the 2-D mesh (2, 2) and on the 1-D ensemble mesh of
    a 2-rank world: each realization's pt-<k> folder is written once, by
    the rank that runs it, with the JAX driver's files, and the final
    states match."""
    from al26_tpu.sim.driver import run_ensemble as jrun_ensemble

    got = _ranks(worlds[world], case, world)[0]
    bs, _, _ = jrun_ensemble(
        JConfig(n=24, rc=0.5, final_time=0.5, seed=88, ensemble=2,
                n_plot=2, steps_per_plot=5,
                no_massive_star_requirement=True, mesh_shape=mesh_shape),
        progress=False, root=str(tmp_path))
    assert list(got["files"]) == _files(tmp_path)
    _close_state(got, jax_to_numpy(bs.cluster))


# ---------------------------------------------------------------------------
# the local bodies of every rank in one process (the kernels' wrappers:
# their plain versions on CPU tensors)
# ---------------------------------------------------------------------------

def _f32(*arrays):
    return tuple(torch.as_tensor(a, dtype=torch.float32) for a in arrays)


def _max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("use_mxu,bars", [(True, (3e-4, 5e-4)),
                                          (False, (1e-5, 2e-5))])
@pytest.mark.parametrize("world", [4, 2])
def test_local_rows_bodies_assemble_the_kernel_sweep(world, use_mxu, bars):
    pos, vel, mass = _f32(*mr.force_inputs(11, 512))
    parts = [sharded._local_rows_force(r, world, pos, vel, mass, 1e-3,
                                       pot_eps2=1e-30, use_kernel=True,
                                       use_mxu=use_mxu)
             for r in range(world)]
    got = [torch.cat(x) for x in zip(*parts)]
    want = cuda_nbody.kernel_acc_jerk_pot(pos, vel, mass, 1e-3,
                                          pot_eps2=1e-30, use_mxu=use_mxu)
    ref = cuda_nbody.nbody_rows_plain(
        *(t.double() for t in (pos, vel)),
        torch.arange(512, dtype=torch.int32),
        *(t.double() for t in (pos, vel, mass)), 1e-3, pot_eps2=1e-30)
    # the explicit potential keeps the FMA bar in both bodies
    for g, w, r, bar in zip(got, want, ref, (bars[0], bars[0], 1e-5)):
        assert _max_rel(g.double(), w.double()) <= bar
        assert _max_rel(g.double(), r) <= bar


@pytest.mark.parametrize("use_mxu,bar", [(True, 5e-4), (False, 2e-5)])
@pytest.mark.parametrize("world", [4, 2])
def test_partial_rows_bodies_sum_to_the_row_force(world, use_mxu, bar):
    """K rows drawn from every shard against each column slice: each
    slice's partial (1c centres on its OWN columns) against the FMA-form
    sum of that slice in f64, and the sum against the unsplit call."""
    n = 512
    pos, vel, mass = _f32(*mr.force_inputs(12, n))
    ids = torch.as_tensor(mr.rows_ids(12, n, world, per_shard=32))
    pr, vr = pos[ids.long()], vel[ids.long()]
    blk = n // world
    tot_a = tot_j = 0
    for r in range(world):
        a, j = sharded._partial_rows_force(r, world, pr, vr, ids, pos, vel,
                                           mass, 1e-3, use_kernel=True,
                                           use_mxu=use_mxu)
        sl = slice(r * blk, (r + 1) * blk)
        ra, rj, _ = cuda_nbody.nbody_rows_plain(
            pr.double(), vr.double(),
            sharded.slice_ids(ids, r * blk, blk), pos[sl].double(),
            vel[sl].double(), mass[sl].double(), 1e-3, with_pot=False)
        assert _max_rel(a.double(), ra) <= bar
        assert _max_rel(j.double(), rj) <= bar
        tot_a, tot_j = tot_a + a.double(), tot_j + j.double()
    wa, wj, _ = cuda_nbody.nbody_rows_plain(
        pr.double(), vr.double(), ids, pos.double(), vel.double(),
        mass.double(), 1e-3, with_pot=False)
    assert _max_rel(tot_a, wa) <= bar
    assert _max_rel(tot_j, wj) <= bar


def test_slice_ids_keep_other_shards_rows():
    ids = torch.tensor([-1, 0, 5, 8, 11, 12, 31], dtype=torch.int32)
    got = sharded.slice_ids(ids, 8, 4)
    assert got.tolist() == [-1, 4, 4, 0, 3, 4, 4]
    assert got.dtype == torch.int32


@pytest.mark.parametrize("world", [4, 2])
def test_ring_blocks_assemble_the_sweep_f64(world):
    pos, vel, mass = (torch.as_tensor(a) for a in mr.force_inputs(8, 128))
    blk = 128 // world
    out = []
    for r in range(world):
        sl = slice(r * blk, (r + 1) * blk)
        ids = torch.arange(r * blk, (r + 1) * blk, dtype=torch.int32)
        parts = [ring._partial_block_force(
            pos[sl], vel[sl], ids, pos[s * blk:(s + 1) * blk],
            vel[s * blk:(s + 1) * blk], mass[s * blk:(s + 1) * blk],
            s * blk, 1e-3) for s in range(world)]
        out.append([sum(x) for x in zip(*parts)])
    got = [torch.cat(x) for x in zip(*out)]
    from al26_tpu_torch.ops.nbody import acc_jerk_pot_chunked

    want = acc_jerk_pot_chunked(pos, vel, mass, 1e-3)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_tree_parts_assemble_the_tree_sweep(world, use_kernel):
    """Far field by target blocks and near field by pair-balanced shares
    of the work items (kernel 3's wrapper, or the plain near field), summed
    over the ranks: the unsplit tree sweep at 1e-12 in f64."""
    pos, vel, mass = (torch.as_tensor(a) for a in mr.tree_inputs(4, 700))
    tree = T.build_block_tree(pos, mass, 16, vel)
    accepts, p2p = T.mac_masks(tree, 0.75)
    far = [tree_mesh._far_field_part(r, world, tree, accepts, 1e-4,
                                     pot_eps2=1e-30, with_jerk=True)
           for r in range(world)]
    far = [torch.cat(x) for x in zip(*far)]
    near = [tree_mesh._near_field_part(r, world, tree, p2p, 700, 1e-4,
                                       leaf=16, kavg=64, pot_eps2=1e-30,
                                       with_jerk=True, use_kernel=use_kernel)
            for r in range(world)]
    assert not any(bool(x[3]) for x in near)
    near = [sum(x[i] for x in near) for i in range(3)]
    got = T.unsort(tree, far[0] + near[0], far[1] + near[1],
                   far[2] + near[2], 700)
    want = T.tree_acc_jerk_pot(pos, vel, mass, 1e-4, leaf=16, theta=0.75,
                               kavg=64, pot_eps2=1e-30, with_jerk=True)
    for g, w in zip(got, want[:3]):
        _close(g.numpy(), w.numpy())


@pytest.mark.parametrize("world", [4, 3, 2])
def test_near_item_shares_cover_every_pair_once(world):
    pos, vel, mass = (torch.as_tensor(a) for a in mr.tree_inputs(5, 2000))
    tree = T.build_block_tree(pos, mass, 16)
    _, p2p = T.mac_masks(tree, 0.75)
    whole = cuda_tree.near_items(p2p, 64, 2000, 16)
    parts = [cuda_tree.near_items(p2p, 64, 2000, 16, part=(r, world))
             for r in range(world)]
    np_whole = whole.item[2].long()
    counts = torch.stack([p.item[2].long() for p in parts])
    assert torch.equal(counts.sum(0), np_whole)
    assert int((counts > 0).sum(0).max()) <= 1     # one owner an item
    for p in parts:
        assert torch.equal(p.item[:2], whole.item[:2])
        assert torch.equal(p.tinfo, whole.tinfo)
    share = counts.sum(1).double()
    # pair-balanced within one item's pairs of the even share
    assert float(share.max() - share.min()) <= 2 * cuda_tree.ITEM_PAIRS


@pytest.mark.parametrize("world", [2, 1])
def test_ensemble2d_bodies_assemble_the_group_sweep(world):
    """Kernel 1b's row slices of every local realization (group windows),
    assembled over the rows axis: the unsplit group sweep."""
    b, n = 3, 40
    rng = np.random.default_rng(2)
    pos, vel = _f32(rng.normal(size=(b, n, 3)), rng.normal(size=(b, n, 3)))
    (mass,) = _f32(rng.uniform(0.1, 2.0, (b, n)))
    parts = [ens._ensemble2d_local(r, world, pos, vel, mass, 1e-3,
                                   pot_eps2=1e-30, use_kernel=True)
             for r in range(world)]
    acc = torch.cat([p[0] for p in parts], 1)
    pot = torch.cat([p[1] for p in parts], 1)
    wa, _, wp = cuda_nbody.kernel_acc_jerk_pot(
        pos.reshape(-1, 3), vel.reshape(-1, 3), mass.reshape(-1), 1e-3,
        with_jerk=False, group_size=n, pot_eps2=1e-30)
    assert _max_rel(acc.reshape(-1, 3).double(), wa.double()) <= 1e-5
    assert _max_rel(pot.reshape(-1).double(), wp.double()) <= 1e-5


# ---------------------------------------------------------------------------
# what a mesh refuses (the JAX package's ValueErrors)
# ---------------------------------------------------------------------------

def test_mesh_larger_than_the_world_names_torchrun(tmp_path, monkeypatch):
    from al26_tpu_torch.sim import driver

    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        sharded.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        driver.run(SimConfig(n=8, filename="x", mesh_shape=(4,)),
                   progress=False, device="cpu")
    assert os.listdir(tmp_path) == []


def test_driver_mesh_divisibility_error(tmp_path, monkeypatch):
    from al26_tpu_torch.sim import driver

    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="must divide"):
        driver.run(SimConfig(n=30, rc=0.5, final_time=0.5, seed=1,
                             mesh_shape=(8,), n_plot=2, steps_per_plot=5,
                             no_massive_star_requirement=True),
                   progress=False, device="cpu")
    assert os.listdir(tmp_path) == []


def test_backend_errors_follow_jax():
    from al26_tpu_torch.sim import init_cluster

    ts, ta, tcfg = init_cluster(SimConfig(n=32, seed=2), device="cpu")
    for fi in ("sharded", "ring"):
        with pytest.raises(ValueError, match="requires a device mesh"):
            port_step.step(ts, ta, tcfg, force_impl=fi)
    mesh = sharded.make_mesh(1, device="cpu")
    for fi in ("pallas", "default"):
        with pytest.raises(ValueError, match="single-device"):
            port_step.step(ts, ta, tcfg, mesh=mesh, force_impl=fi)


def test_ensemble_2d_rejects_non_leapfrog_and_bad_shapes(tmp_path):
    from al26_tpu_torch.sim import driver

    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=6,
                    integrator="hermite4", no_massive_star_requirement=True)
    bs, ba, cfgs = ens.init_ensemble(cfg, 2, device="cpu")
    mesh = ens.make_ensemble2d_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="leapfrog"):
        ens.ensemble_step_2d(bs, ba, cfgs[0], mesh)
    with pytest.raises(ValueError, match="degenerate"):
        ens.make_ensemble2d_mesh(16, device="cpu")
    ecfg = SimConfig(n=24, rc=0.5, final_time=0.5, seed=88, ensemble=3,
                     n_plot=1, steps_per_plot=5, mesh_shape=(2, 4),
                     no_massive_star_requirement=True)
    with pytest.raises(ValueError, match="divide"):
        driver.run_ensemble(ecfg, progress=False, root=str(tmp_path),
                            device="cpu")
    with pytest.raises(ValueError, match="2-tuple"):
        driver.run_ensemble(ecfg.replace(ensemble=2, mesh_shape=(8,)),
                            progress=False, root=str(tmp_path),
                            device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        driver.run_ensemble(ecfg.replace(ensemble=2, mesh_shape=(2, 4)),
                            progress=False, root=str(tmp_path),
                            device="cpu")
    assert os.listdir(tmp_path) == []


def test_world_of_one_runs_the_mesh_path_in_a_plain_process():
    """A plain process asking for a mesh of one initialises a world of one
    itself; the mesh step then equals the single-device one to round-off
    (f64, hermite4_block through the column-split rows)."""
    js, ja, jcfg = jax_state("mesh_block")
    from al26_tpu_torch.sim import init_cluster

    ts, ta, tcfg = init_cluster(SimConfig.from_dict(jcfg.to_dict()),
                                device="cpu")
    mesh = sharded.make_mesh(1, device="cpu")
    assert torch.distributed.get_world_size() == 1
    s1 = port_step.run_steps(sharded.shard_state_rows(ts, mesh), ta, tcfg, 3,
                             mesh)
    s0 = port_step.run_steps(ts, ta, tcfg, 3)
    _close(s1.cluster.pos.numpy(), s0.cluster.pos.numpy())
    u = sharded.sharded_potential_energy(ts.cluster.pos, ts.cluster.mass,
                                         mesh, 1e-3)
    from al26_tpu_torch.ops.nbody import potential_energy

    _close(u.numpy(), potential_energy(ts.cluster.pos, ts.cluster.mass,
                                       1e-3).numpy())
