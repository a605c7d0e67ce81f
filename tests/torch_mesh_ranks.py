"""Rank bodies of the port's mesh tests: one process per rank of a gloo
world on the CPU. This module imports only torch, numpy and the port, so
the ranks never import JAX.

Run as a script by tests/test_torch_parallel.py and
tests/test_torch_orbax.py (one module-scoped spawn each):

    python tests/torch_mesh_ranks.py --world 4 --rank R --store FILE \
        --dir DIR --cases a,b,...

Each case reads its inputs from DIR (`<case>-in.npz`, written by the test
from the JAX package's initial bits, or drawn here from a numpy seed) and
writes this rank's outputs to DIR/<case>-r<R>.npz; the tests compare them
with the JAX mesh code and across ranks (bitwise).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from al26_tpu_torch.config import SimConfig  # noqa: E402
from al26_tpu_torch.state import (  # noqa: E402
    aux_from_numpy, cluster_to_numpy, state_from_numpy,
)

CPU = "cpu"
AUX = ("hm_idx", "hm_slot_valid", "msrc_idx", "msrc_valid", "agb_grid_t",
       "agb_grid_rates", "kick_vel")


# ---------------------------------------------------------------------------
# inputs shared with the tests
# ---------------------------------------------------------------------------

def force_inputs(seed: int, n: int):
    """pos, vel, mass (f64 numpy) of the force cases."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3))
    mass = rng.uniform(0.1, 2.0, n)
    return pos, vel, mass


def rows_ids(seed: int, n: int, world: int, per_shard: int = 2):
    """K fast-row ids drawn from EVERY shard of a world-way column split."""
    rng = np.random.default_rng(seed)
    blk = n // world
    return np.concatenate([rng.choice(np.arange(s * blk, (s + 1) * blk),
                                      per_shard, replace=False)
                           for s in range(world)]).astype(np.int32)


def tree_inputs(seed: int, n: int):
    """A clumpy f64 cloud for the tree cases: pos, vel, mass."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(8, 3)) * 2.0
    pos = centres[rng.integers(0, 8, n)] + 0.3 * rng.normal(size=(n, 3))
    vel = 0.5 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.1, 2.0, n)
    return pos, vel, mass


def save_state_npz(path: str, cluster_np: dict, time, step_count,
                   aux_np: dict, cfg_dict: dict) -> None:
    """The inputs of a state case (the JAX package's initial bits):
    path.npz and the config as path.json."""
    arrays = {f"c.{k}": v for k, v in cluster_np.items()}
    arrays.update({f"a.{k}": v for k, v in aux_np.items()
                   if k != "stellar_tbl"})
    arrays.update({f"t.{i}": v for i, v in enumerate(aux_np["stellar_tbl"])})
    arrays["time"] = np.asarray(time)
    arrays["step_count"] = np.asarray(step_count)
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(cfg_dict, f)


def load_state_npz(path: str):
    """(state, aux, cfg) on the CPU from save_state_npz's files."""
    z = np.load(path + ".npz")
    cl = {k[2:]: z[k] for k in z.files if k.startswith("c.")}
    aux = {k[2:]: z[k] for k in z.files if k.startswith("a.")}
    n_t = len([k for k in z.files if k.startswith("t.")])
    aux["stellar_tbl"] = [z[f"t.{i}"] for i in range(n_t)]
    with open(path + ".json") as f:
        cfg = SimConfig.from_dict(json.load(f))
    dtype = torch.float64 if cfg.dtype == "f64" else torch.float32
    state = state_from_numpy(cl, z["time"], z["step_count"], dtype=dtype,
                             device=CPU)
    return state, aux_from_numpy(aux, device=CPU), cfg


def _out_state(s) -> dict:
    out = cluster_to_numpy(s.cluster)
    out["time"] = s.time.numpy()
    out["step_count"] = s.step_count.numpy()
    return out


# ---------------------------------------------------------------------------
# the cases: (ctx) -> dict of numpy arrays
# ---------------------------------------------------------------------------

def _t(a):
    return torch.as_tensor(a)


def case_sharded_force(ctx):
    from al26_tpu_torch.parallel.sharded import (
        make_mesh, sharded_acc_jerk_pot, sharded_potential_energy,
    )

    pos, vel, mass = (_t(a) for a in force_inputs(0, 256))
    mesh = make_mesh(ctx.world, device=CPU)
    a, j, p = sharded_acc_jerk_pot(pos, vel, mass, mesh, 1e-3)
    u = sharded_potential_energy(pos, mass, mesh, 1e-3)
    return dict(acc=a.numpy(), jerk=j.numpy(), pot=p.numpy(),
                u=u.numpy())


def case_ring_force(ctx):
    from al26_tpu_torch.ops.integrators import hermite4_advance
    from al26_tpu_torch.parallel.ring import make_ring_force, \
        ring_acc_jerk_pot
    from al26_tpu_torch.parallel.sharded import make_mesh

    pos, vel, mass = (_t(a) for a in force_inputs(8, 256))
    mesh = make_mesh(ctx.world, device=CPU)
    a, j, p = ring_acc_jerk_pot(pos, vel, mass, mesh, 1e-3)
    ff = make_ring_force(mesh, mass, 1e-3)
    pa, va = hermite4_advance(pos, vel, mass, torch.tensor(0.01,
                                                           dtype=pos.dtype),
                              eps2=1e-3, force_fn=ff)
    return dict(acc=a.numpy(), jerk=j.numpy(), pot=p.numpy(),
                pos_h4=pa.numpy(), vel_h4=va.numpy())


def case_sharded_rows(ctx):
    from al26_tpu_torch.parallel.sharded import make_mesh, \
        make_sharded_force_rows

    pos, vel, mass = (_t(a) for a in force_inputs(5, 64))
    ids = _t(rows_ids(5, 64, ctx.world))
    mesh = make_mesh(ctx.world, device=CPU)
    fn = make_sharded_force_rows(mesh, mass, eps2=0.0)
    a, j = fn(pos[ids.long()], vel[ids.long()], ids, pos, vel)
    return dict(acc=a.numpy(), jerk=j.numpy())


def _tree_case(ctx, relative: bool):
    from al26_tpu_torch.ops.nbody import acc_jerk_pot_chunked
    from al26_tpu_torch.parallel.sharded import make_mesh
    from al26_tpu_torch.parallel.tree_mesh import tree_acc_jerk_pot_mesh

    pos, vel, mass = (_t(a) for a in tree_inputs(3, 500))
    mesh = make_mesh(ctx.world, device=CPU)
    aref, theta = None, 0.75
    if relative:
        a_ex, _, _ = acc_jerk_pot_chunked(pos, vel, mass, 1e-4)
        aref, theta = torch.sqrt(torch.sum(a_ex * a_ex, dim=-1)), 0.01
    a, j, p, ovf = tree_acc_jerk_pot_mesh(
        pos, vel, mass, mesh, 1e-4, leaf=16, theta=theta, kavg=32,
        pot_eps2=1e-30, aref=aref, with_jerk=True)
    return dict(acc=a.numpy(), jerk=j.numpy(), pot=p.numpy(),
                overflow=ovf.numpy())


def case_tree_sweep(ctx):
    return _tree_case(ctx, False)


def case_tree_sweep_rel(ctx):
    return _tree_case(ctx, True)


def _steps(ctx, name, n_steps, force_impl="auto", strided=False):
    """n_steps of a state case through run_steps under the 1-D mesh."""
    import importlib

    from al26_tpu_torch.parallel.sharded import make_mesh, shard_state_rows

    step = importlib.import_module("al26_tpu_torch.sim.step")
    s, a, cfg = load_state_npz(os.path.join(ctx.dir, f"{name}-in"))
    mesh = make_mesh(ctx.world, device=CPU)
    s = shard_state_rows(s, mesh)
    if strided:
        assert step.stride_active(cfg, s.cluster.n, s.cluster.pos.dtype,
                                  CPU, mesh, force_impl)
    out = step.run_steps(s, a, cfg, n_steps, mesh, force_impl)
    return _out_state(out)


def case_mesh_step(ctx):
    return _steps(ctx, "mesh_step", 5)


def case_mesh_cached(ctx):
    return _steps(ctx, "mesh_cached", 10)


def case_mesh_block(ctx):
    return _steps(ctx, "mesh_block", 5)


def case_ring_cached(ctx):
    return _steps(ctx, "ring_cached", 10, "ring")


def case_mesh_stride(ctx):
    return _steps(ctx, "mesh_stride", 10, strided=True)


def case_tree_step(ctx):
    return _steps(ctx, "tree_step", 3, "tree")


def _ensemble_in(ctx, name):
    return load_state_npz(os.path.join(ctx.dir, f"{name}-in"))


def case_ensemble_1d(ctx):
    from al26_tpu_torch.parallel.ensemble import (
        ensemble_run_steps, gather_ensemble, make_ensemble_mesh,
        shard_ensemble,
    )

    bs, ba, cfg = _ensemble_in(ctx, "ensemble_1d")
    mesh = make_ensemble_mesh(ctx.world, device=CPU)
    bs, ba = shard_ensemble(bs, ba, mesh)
    out = ensemble_run_steps(bs, ba, cfg, 3)
    return _out_state(gather_ensemble(out, mesh))


def case_ensemble_2d(ctx):
    from al26_tpu_torch.parallel.ensemble import (
        ensemble2d_fresh_cache, ensemble_run_steps_2d,
        ensemble_run_steps_2d_cached, gather_ensemble, make_ensemble2d_mesh,
        shard_ensemble_2d,
    )

    bs, ba, cfg = _ensemble_in(ctx, "ensemble_2d")
    mesh = make_ensemble2d_mesh(2, ctx.world // 2, device=CPU)
    bs, ba = shard_ensemble_2d(bs, ba, mesh)
    out = gather_ensemble(ensemble_run_steps_2d(bs, ba, cfg, 5, mesh), mesh)
    # the cache threaded over two chunks
    cache = ensemble2d_fresh_cache(bs, cfg, mesh)
    c1, cache = ensemble_run_steps_2d_cached(bs, cache, ba, cfg, 2, mesh)
    c1, cache = ensemble_run_steps_2d_cached(c1, cache, ba, cfg, 3, mesh)
    res = _out_state(out)
    res.update({f"cached.{k}": v for k, v in
                _out_state(gather_ensemble(c1, mesh)).items()})
    return res


class _Cwd:
    def __init__(self, path):
        self.path, self.old = str(path), None

    def __enter__(self):
        self.old = os.getcwd()
        os.makedirs(self.path, exist_ok=True)
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _files(path):
    return np.array(sorted(os.path.relpath(os.path.join(d, f), path)
                           for d, _, fs in os.walk(path) for f in fs))


def case_driver_mesh(ctx):
    from al26_tpu_torch.sim import driver

    work = os.path.join(ctx.dir, "driver_mesh")
    with _Cwd(work):
        r = driver.run(SimConfig(n=64, rc=0.5, final_time=0.5, seed=17,
                                 n_plot=2, steps_per_plot=5,
                                 force_cache=False, filename="meshed",
                                 mesh_shape=(ctx.world,)),
                       progress=False, device=CPU)
    out = _out_state(r.state)
    dist.barrier()
    out["files"] = _files(work)
    return out


def case_driver_ensemble_2d(ctx):
    from al26_tpu_torch.sim import driver

    work = os.path.join(ctx.dir, "driver_ensemble_2d")
    bs, dirs, _ = driver.run_ensemble(
        SimConfig(n=24, rc=0.5, final_time=0.5, seed=88, ensemble=2,
                  n_plot=2, steps_per_plot=5,
                  no_massive_star_requirement=True,
                  mesh_shape=(2, ctx.world // 2)),
        progress=False, root=work, device=CPU)
    out = _out_state(bs)
    dist.barrier()
    out["files"] = _files(work)
    return out


def case_driver_ensemble_1d(ctx):
    from al26_tpu_torch.sim import driver

    work = os.path.join(ctx.dir, "driver_ensemble_1d")
    bs, dirs, _ = driver.run_ensemble(
        SimConfig(n=24, rc=0.5, final_time=0.5, seed=88, ensemble=2,
                  n_plot=2, steps_per_plot=5,
                  no_massive_star_requirement=True),
        progress=False, root=work, device=CPU)
    out = _out_state(bs)
    dist.barrier()
    out["files"] = _files(work)
    return out


# -- the DCP tree (tests/test_torch_orbax.py) --------------------------------

def case_orbax_roundtrip(ctx):
    from al26_tpu_torch.io.orbax_backend import (
        latest_step, load_sharded_state, save_sharded_state,
    )
    from al26_tpu_torch.parallel.sharded import make_mesh, shard_state_rows
    from al26_tpu_torch.sim import init_cluster

    cfg = SimConfig(n=64, rc=0.5, seed=3, no_massive_star_requirement=True)
    state, _, cfg = init_cluster(cfg, device=CPU)
    state = shard_state_rows(state, make_mesh(ctx.world, device=CPU))
    ck = os.path.join(ctx.dir, "ck")
    save_sharded_state(ck, 7, state, cfg)
    restored, cfg_dict, step = load_sharded_state(ck, template=state)
    bare, _, _ = load_sharded_state(ck)
    out = {f"saved.{k}": v for k, v in _out_state(state).items()}
    out.update({f"restored.{k}": v
                for k, v in _out_state(restored).items()})
    out.update({f"bare.{k}": v for k, v in _out_state(bare).items()})
    out["latest"] = np.asarray(latest_step(ck))
    out["step"] = np.asarray(step)
    out["cfg_equal"] = np.asarray(SimConfig.from_dict(cfg_dict) == cfg)
    return out


def case_orbax_driver(ctx):
    import importlib

    from al26_tpu_torch.io.orbax_backend import load_sharded_state
    from al26_tpu_torch.parallel.sharded import make_mesh
    from al26_tpu_torch.sim import driver, init_cluster

    step = importlib.import_module("al26_tpu_torch.sim.step")
    work = os.path.join(ctx.dir, "orbax_driver")
    ob = os.path.join(work, "orbax")
    cfg = SimConfig(n=32, rc=0.5, final_time=0.5, seed=6, filename="orun",
                    n_plot=5, steps_per_plot=4, orbax_dir=ob,
                    force_cache=False, mesh_shape=(ctx.world,))
    with _Cwd(work):
        res = driver.run(cfg, progress=False, device=CPU)
    dist.barrier()
    steps = np.array(sorted(int(d) for d in os.listdir(ob) if d.isdigit()))
    final, _, _ = load_sharded_state(ob, template=res.state)
    # a mid-run restore, continued by run_steps under the mesh
    state0, aux, cfg_r = init_cluster(cfg, device=CPU)
    mid, cfg_dict, _ = load_sharded_state(ob, step=9, template=state0)
    cfg2 = SimConfig.from_dict(cfg_dict)
    cont = step.run_steps(mid, aux, cfg2, cfg2.n_steps - 9,
                          make_mesh(ctx.world, device=CPU), "auto")
    dist.barrier()
    # a -nc 2 resume (checkpoint 2 is step 5) drops the tree's later
    # steps, a planted stale step 99 among them
    if ctx.rank == 0:
        os.makedirs(os.path.join(ob, "99"))
        with open(os.path.join(ob, "99.cfg.json"), "w") as f:
            f.write("{}")
    dist.barrier()
    with _Cwd(work):
        driver.run(SimConfig(reload="orun", n_checkpoint=2,
                             final_time=0.5), progress=False, device=CPU)
    dist.barrier()
    steps_after = np.array(sorted(int(d) for d in os.listdir(ob)
                                  if d.isdigit()))
    out = {f"run.{k}": v for k, v in _out_state(res.state).items()}
    out.update({f"tree.{k}": v for k, v in _out_state(final).items()})
    out.update({f"cont.{k}": v for k, v in _out_state(cont).items()})
    out["steps"] = steps
    out["steps_after"] = steps_after
    out["mid_step"] = mid.step_count.numpy()
    out["cfg_equal"] = np.asarray(cfg2 == cfg_r)
    return out


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


class _Ctx:
    def __init__(self, rank, world, directory):
        self.rank, self.world, self.dir = rank, world, directory


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--cases", required=True)
    args = p.parse_args(argv)
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=300))
    ctx = _Ctx(args.rank, args.world, args.dir)
    try:
        for name in args.cases.split(","):
            out = CASES[name](ctx)
            np.savez(os.path.join(args.dir, f"{name}-r{args.rank}.npz"),
                     **out)
            dist.barrier()
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
