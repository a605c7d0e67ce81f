#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (al26_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one CUDA card

Phases, one result line each (any failure exits non-zero):

  1. device   the card's name and power limit (nvidia-smi), CUDA present,
              TF32 off;
  2. build    nvcc builds csrc/nbody.cu and csrc/tree.cu from this checkout,
              one nvcc each, started together (timed; the ptxas lines);
  3. kernels  each kernel against its plain PyTorch version at N = 32768 on
              a Plummer cluster from init_cluster: kernel 1 (nbody_rows) on
              the full sweep (jerk + raw potential), the leapfrog sweep (no
              jerk) and 256 scattered rows, held to 1e-5 of the max of the
              f64 plain result; kernel 2 (nbody_predcols) with K = 256 at a
              nonzero tau, held to 2e-5. Median times beside the plain
              f32 versions' (CUDA events, after warm-up);
  4. parity   the slice at n = 2048, f32, force_impl="pallas",
              hermite4_block, k_fast = 64, 3 steps: the port on the card
              against the port on the CPU (plain versions), same initial
              bits; bars of tests/test_force_cache.py (pos rtol 2e-4 atol
              2e-5, slr rtol 2e-3, mass exact);
  5. slice    the default run at size: Plummer rc = 1, f32,
              force_impl="auto", 20 steps as two cached chunks of 10, at
              n = 8192 (hermite4) and n = 32768 (hermite4_block,
              k_fast = 256); seconds per simulated Myr, substeps per step,
              launch counts, and the physics invariants.

The Barnes-Hut tier (force_impl="tree", fractal ICs), run in this order:

  3b. kernel near_field  kernel 3 against its f64 plain version on the
              tree and pair list of a fractal cluster of N = 131072 (theta
              0.75, leaf 256, the auto-sized kavg), with jerk and the raw
              potential, held to 1e-5 of the max; the overflow flag at
              kavg = 1; the same bits on a repeat; times beside the f32
              plain version's, and the partner-run lengths;
  4b. tree accuracy  the tree's acceleration (kernel path) against the
              exact kernel-1 sweep at N = 65536 fractal, theta 0.75:
              median <= 1e-2 and p99 <= 5e-2 of |da|/|a|, no overflow;
  4c. tree parity  the tree slice at n = 4096 fractal, leaf 64, geometric
              MAC, hermite4_block, k_fast = 64, 3 steps: card against CPU
              from the same initial bits, the bars of phase 4 (the card
              run launches kernels 3 and 2, the CPU run none);
  5b. tree slice  fractal N = 409600 with the default tree knobs
              (hermite4_block, theta 0.75, leaf 256, tree_kavg auto-sized),
              10 steps as two cached chunks of 5: init seconds, s/Myr,
              substeps per step, the launches of all three kernels from
              before init_cluster (kernel 1: the fractal virial sum) to
              after the last step; then each kernel against its f64 plain
              version at the shapes this path gives it (kernel 3 on the
              live tree's longest partner runs, kernel 2 at K = k_fast
              against all N columns, kernel 1's eps2 = 1e-30 virial sweep
              on a row subset; bars as in phases 3 and 3b), a breakdown of
              one tree sweep, and the physics invariants; then
              tree_mac="relative" at N = 131072 for 5 steps (exact kernel-1
              seeding sweep).

The flattened ensembles (parallel.ensemble, kernel 1's group windows):

  3c. kernel nbody_rows_group  the windowed kernel against its f64 plain
              grouped version on the initial states of the two ensembles
              below, B x N = 64 x 1000 and 8 x 10240: the full sweep with
              jerk and the raw potential and the acceleration-only sweep
              (bar 1e-5 of the max), 512 scattered rows spanning several
              groups (bar 2e-5); the same bits on a repeat; times beside
              the f32 plain version's;
  4d. ensemble parity  a B = 4, n = 256 ensemble, 3 flat steps: the card
              (group windows, force cache) against the CPU (per-realization
              dense forces) from the same initial bits, the bars of phase 4;
  5c. ensemble slice  init_ensemble, ensemble_fresh_cache and
              ensemble_run_steps_cached (leapfrog as resolved at the
              ensemble boundary): 64 realizations of N = 1000 for 20 steps
              (two chunks of 10) and 8 of N = 10240 for 5 steps; s/Myr, the
              step split into the per-realization physics and the rest
              (the advance and the force cache), the launches (counts set
              to 0 just before fresh_cache and read after the last step),
              the physics invariants of every realization, and the
              windowed closing sweep on the final state against its f64
              plain version.

The run order: 1, 2, 3, 3b, 3c, 4, 4d, 4b, 4c, 5, 5b, 5c.

Then one JSON line with every kernel's launches (kernels 1-3 from phase 5b,
the windowed kernel from the 64 x 1000 run of phase 5c), error (the largest
of its comparisons), times, and the least time the card could take for the
same work (bound_ms: the larger of the FLOPs over the FP32 peak and the
bytes over the HBM rate; bound_by says which), and last the line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_KERNEL = 32768
N_NEAR = 131072
N_TREE = 409600
KERNEL_TOL = 1e-5
PREDCOLS_TOL = 2e-5
# the tree's accuracy bars at theta = 0.75 on fractal ICs (the JAX
# package's own measurement: median 7.3e-3, p99 3.5e-2, docs/precision.md)
TREE_MEDIAN_TOL = 1e-2
TREE_P99_TOL = 5e-2
# the ensembles: (realizations, stars each, steps, chunks of the cached run)
ENSEMBLES = ((64, 1000, 20, (10, 10)), (8, 10240, 5, (5,)))
# bounds: one H100 SXM's published FP32 rate outside the tensor cores and
# HBM rate (at its 700 W limit), and the FLOPs of one pair as the JAX
# kernels' cost estimates count them (pallas_nbody.py:443, :783,
# pallas_tree.py:314): 50 with the jerk, 30 without, the rsqrt as one
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PAIR_FLOPS = {True: 50, False: 30}


def _line(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _fail(msg: str) -> None:
    raise RuntimeError(msg)


def _rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in f64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


def _abs_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def _bound(pairs: float, with_jerk: bool, nbytes: float) -> dict:
    """The least time the card could take for `pairs` pair interactions
    that move `nbytes` (each input read once, each output written once):
    the larger of the FLOPs over the FP32 rate and the bytes over the HBM
    rate."""
    ops_ms = 1e3 * pairs * PAIR_FLOPS[with_jerk] / FP32_FLOPS
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _rows_bytes(b: int, n: int, with_jerk: bool, with_pot: bool) -> int:
    """Bytes kernel 1 must move: rows (positions, ids; velocities with the
    jerk), columns (positions, masses; velocities with the jerk) and the
    outputs (acc; jerk, pot when asked for), all f32 / int32."""
    per_row = 12 + 4 + (12 if with_jerk else 0)
    per_col = 12 + 4 + (12 if with_jerk else 0)
    out = 12 + (12 if with_jerk else 0) + (4 if with_pot else 0)
    return b * (per_row + out) + n * per_col


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    times.sort()
    return times[len(times) // 2]


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    if any(tf32.values()):
        _fail(f"TF32 is on: {tf32}")
    _line("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, tf32=tf32)
    # a report for the port's io/ slice (its checkpoints are
    # zstd-compressed); it checks nothing
    _line("host packages", imports=_importable("zstandard", "tqdm",
                                               "pandas"))


def _importable(*names) -> dict:
    """{name: True, or the error its import raised}."""
    import importlib

    out = {}
    for name in names:
        try:
            importlib.import_module(name)
            out[name] = True
        except Exception as e:          # a report, not a phase
            out[name] = f"{type(e).__name__}: {e}"
    return out


def phase_build():
    """Both sources, one nvcc each, started together."""
    from al26_tpu_torch.ops import cuda_build, cuda_nbody, cuda_tree

    t0 = time.perf_counter()
    built = cuda_build.build_all()
    cuda_nbody.load()
    cuda_tree.load()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name, (_, log) in built.items()}
    _line("build", seconds=secs,
          libraries={k: os.path.relpath(p, HERE)
                     for k, (p, _) in built.items()},
          ptxas=ptxas)


def phase_kernels():
    """Each kernel against its plain version at N_KERNEL; returns the
    per-kernel records of the final JSON line (launches filled later)."""
    import numpy as np
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.sim import init_cluster

    dev = torch.device("cuda")
    cfg = SimConfig(n=N_KERNEL, rc=1.0, seed=7, dtype="f32")
    state, _, cfg = init_cluster(cfg, device=dev)
    c = state.cluster
    pos, vel, mass = c.pos, c.vel, c.mass
    eps2 = cfg.eps2
    ids = torch.arange(N_KERNEL, dtype=torch.int32, device=dev)
    d = lambda t: t.double()

    # kernel 1: full sweep, jerk + raw potential (the fused opening sweep)
    a, j, p = cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2,
                            pot_eps2=1e-30)
    ar, jr, pr = cn.nbody_rows_plain(d(pos), d(vel), ids, d(pos), d(vel),
                                     d(mass), eps2, pot_eps2=1e-30)
    errs = {"acc": _rel_err(a, ar), "jerk": _rel_err(j, jr),
            "pot": _rel_err(p, pr)}
    abs_err = max(_abs_err(a, ar), _abs_err(j, jr), _abs_err(p, pr))
    # leapfrog sweep: acceleration only
    a_lf, _, _ = cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2,
                               with_jerk=False, with_pot=False)
    errs["leapfrog_acc"] = _rel_err(a_lf, ar)
    # 256 scattered rows (the fast-group row sweep)
    rng = np.random.default_rng(3)
    sel = torch.as_tensor(rng.choice(N_KERNEL, 256, replace=False),
                          dtype=torch.int32, device=dev)
    rp, rv = pos[sel].contiguous(), vel[sel].contiguous()
    a_r, j_r, _ = cn.nbody_rows(rp, rv, sel, pos, vel, mass, eps2,
                                with_pot=False)
    ar_r, jr_r, _ = cn.nbody_rows_plain(d(rp), d(rv), sel, d(pos), d(vel),
                                        d(mass), eps2, with_pot=False)
    errs["rows256_acc"] = _rel_err(a_r, ar_r)
    errs["rows256_jerk"] = _rel_err(j_r, jr_r)
    abs_err = max(abs_err, _abs_err(a_r, ar_r), _abs_err(j_r, jr_r))
    torch.cuda.synchronize()
    bad = {k: v for k, v in errs.items() if not v < KERNEL_TOL}
    t_k = _median_ms(lambda: cn.nbody_rows(pos, vel, ids, pos, vel, mass,
                                           eps2, pot_eps2=1e-30), 10)
    t_p = _median_ms(lambda: cn.nbody_rows_plain(pos, vel, ids, pos, vel,
                                                 mass, eps2, pot_eps2=1e-30),
                     3, warmup=1)
    t_kr = _median_ms(lambda: cn.nbody_rows(rp, rv, sel, pos, vel, mass,
                                            eps2, with_pot=False), 20)
    t_pr = _median_ms(lambda: cn.nbody_rows_plain(rp, rv, sel, pos, vel,
                                                  mass, eps2,
                                                  with_pot=False), 5)
    _line("kernel nbody_rows", n=N_KERNEL, eps2=eps2, rel_err=errs,
          tol=KERNEL_TOL, max_abs_err=abs_err,
          full_sweep_ms=t_k, full_sweep_plain_ms=t_p,
          gpairs_per_s=N_KERNEL * N_KERNEL / (t_k * 1e6),
          rows256_ms=t_kr, rows256_plain_ms=t_pr)
    if bad:
        _fail(f"nbody_rows disagrees with its plain version: {bad}")
    rec_rows = {"name": "nbody_rows", "route": "cuda",
                "source": "al26_tpu_torch/csrc/nbody.cu",
                "replaces": "al26_tpu/ops/pallas_nbody.py:78",
                "launches": 0, "max_abs_err": abs_err, "ms": t_k,
                "plain_ms": t_p,
                **_bound(N_KERNEL * (N_KERNEL - 1), True,
                         _rows_bytes(N_KERNEL, N_KERNEL, True, True)),
                "library_ms": None}

    # kernel 2: K = 256 fast rows against columns predicted to tau
    a0, j0 = a, j
    tau = torch.tensor(0.5 * cfg.dt, dtype=torch.float32, device=dev)
    pf, vf = cn.predict_columns(pos[sel], vel[sel], a0[sel], j0[sel], tau)
    pf = (pf + 1e-4 * torch.as_tensor(rng.normal(size=(256, 3)),
                                      dtype=torch.float32,
                                      device=dev)).contiguous()
    vf = vf.contiguous()
    ak, jk = cn.nbody_predcols(pf, vf, sel, pos, vel, a0, j0, mass, tau,
                               eps2)
    akr, jkr = cn.nbody_predcols_plain(d(pf), d(vf), sel, d(pos), d(vel),
                                       d(a0), d(j0), d(mass), d(tau), eps2)
    errs2 = {"acc": _rel_err(ak, akr), "jerk": _rel_err(jk, jkr)}
    abs2 = max(_abs_err(ak, akr), _abs_err(jk, jkr))
    t_k2 = _median_ms(lambda: cn.nbody_predcols(pf, vf, sel, pos, vel, a0,
                                                j0, mass, tau, eps2), 20)
    t_p2 = _median_ms(lambda: cn.nbody_predcols_plain(pf, vf, sel, pos, vel,
                                                      a0, j0, mass, tau,
                                                      eps2), 5)
    _line("kernel nbody_predcols", n=N_KERNEL, k=256, tau=float(tau),
          rel_err=errs2, tol=PREDCOLS_TOL, max_abs_err=abs2, ms=t_k2,
          plain_ms=t_p2)
    bad2 = {k: v for k, v in errs2.items() if not v < PREDCOLS_TOL}
    if bad2:
        _fail(f"nbody_predcols disagrees with its plain version: {bad2}")
    # predcols reads the step-start pos, vel, acc, jerk and mass of every
    # column: 52 bytes each
    rec_pred = {"name": "nbody_predcols", "route": "cuda",
                "source": "al26_tpu_torch/csrc/nbody.cu",
                "replaces": "al26_tpu/ops/pallas_nbody.py:539",
                "launches": 0, "max_abs_err": abs2, "ms": t_k2,
                "plain_ms": t_p2,
                **_bound(256 * (N_KERNEL - 1), True,
                         256 * (12 + 12 + 4 + 24) + 52 * N_KERNEL + 4),
                "library_ms": None}
    return [rec_rows, rec_pred]


def phase_parity():
    """The slice on the card against the slice on the CPU."""
    import numpy as np
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.sim import init_cluster, run_steps
    from al26_tpu_torch.state import cluster_to_numpy

    cfg = SimConfig(n=2048, rc=1.0, seed=5, dtype="f32",
                    force_impl="pallas", integrator="hermite4_block",
                    k_fast=64)
    out = {}
    for dev in ("cuda", "cpu"):
        before = dict(cn.LAUNCHES)
        state, aux, rcfg = init_cluster(cfg, device=dev)
        t0 = time.perf_counter()
        s = run_steps(state, aux, rcfg, 3, force_impl="pallas")
        out[dev] = cluster_to_numpy(s.cluster)
        launched = {k: cn.LAUNCHES[k] - before[k] for k in before}
        out[dev + "_s"] = time.perf_counter() - t0
        if dev == "cpu" and any(launched.values()):
            _fail(f"the CPU run launched kernels: {launched}")
        if dev == "cuda" and not (launched["nbody_rows"] > 0
                                  and launched["nbody_predcols"] > 0):
            _fail(f"the card run missed a kernel: {launched}")
    g, r = out["cuda"], out["cpu"]
    pos_err = float(np.max(np.abs(g["pos"] - r["pos"])
                           / (2e-5 + 2e-4 * np.abs(r["pos"]))))
    slr_err = float(np.max(np.abs(g["slr"] - r["slr"])
                           / (1e-30 + 2e-3 * np.abs(r["slr"]))))
    mass_same = bool(np.array_equal(g["mass"], r["mass"]))
    _line("parity", n=2048, steps=3, pos_err_over_bar=pos_err,
          slr_err_over_bar=slr_err, mass_exact=mass_same,
          cuda_s=out["cuda_s"], cpu_s=out["cpu_s"])
    if not (pos_err <= 1.0 and slr_err <= 1.0 and mass_same):
        _fail("the card's slice disagrees with the CPU's")


def phase_slice(n: int, expect_integ: str):
    """The default run at size, 20 steps as two cached chunks."""
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.sim import init_cluster
    from al26_tpu_torch.sim.step import fresh_cache, run_steps_cached

    dev = torch.device("cuda")
    cfg = SimConfig(n=n, rc=1.0, seed=42, dtype="f32", force_impl="auto")
    t_init = time.perf_counter()
    state, aux, cfg = init_cluster(cfg, device=dev)
    t_init = time.perf_counter() - t_init
    integ = cfg.integrator                 # resolved by init_cluster
    if integ != expect_integ:
        _fail(f"n={n} resolved {integ}, expected {expect_integ}")
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = fresh_cache(state, cfg, integ, None, "auto")
    for _ in range(2):                     # two checkpoint-sized chunks
        state, cache = run_steps_cached(state, cache, aux, cfg, 10, None,
                                        "auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    steps = 20
    if integ == "hermite4":
        substeps = (launches["nbody_rows"] - 1) / steps
    else:
        substeps = launches["nbody_predcols"] / steps

    checks, host = _state_checks(state, cfg, steps)
    checks["rows_launched"] = launches["nbody_rows"] > 0
    checks["predcols_launched"] = (integ != "hermite4_block"
                                   or launches["nbody_predcols"] > 0)
    sim_myr = steps * cfg.dt
    _line("slice", n=n, integrator=integ, k_fast=cfg.k_fast,
          init_s=t_init, wall_s=wall, s_per_myr=wall / sim_myr,
          substeps_per_step=substeps, launches=launches,
          wind_total=float(host["slr"][:, :, 0:2].sum()), checks=checks)
    if not all(checks.values()):
        _fail(f"n={n}: {[k for k, v in checks.items() if not v]} failed")
    return launches


def _state_checks(state, cfg, steps: int):
    """The physics invariants of a run of `steps` steps on the card: every
    state tensor still on the card, time == steps * dt exactly, the step
    count, finite positions / velocities / reservoirs, non-negative
    reservoirs, wind only on disc stars (0.1-3 Msun, not the interloper).
    Returns (checks, the cluster as numpy)."""
    import numpy as np
    import torch

    from al26_tpu_torch.state import cluster_to_numpy

    c = state.cluster
    tensors = [getattr(c, f) for f in c.__dataclass_fields__]
    tensors += [state.time, state.step_count]
    if not all(t.device.type == "cuda" for t in tensors):
        _fail("a state tensor left the card")
    want_t = (torch.tensor(steps, dtype=torch.float32)
              * torch.tensor(cfg.dt, dtype=torch.float32))
    host = cluster_to_numpy(c)
    lm = host["mass"] >= 0.1
    lm &= host["mass"] <= 3.0
    lm &= ~host["is_interloper"]
    wind_off_disc = np.any(host["slr"][:, :, 0:2] != 0.0, axis=(1, 2)) & ~lm
    checks = {
        "time": float(state.time) == float(want_t),
        "step_count": int(state.step_count) == steps,
        "finite": bool(np.isfinite(host["pos"]).all()
                       and np.isfinite(host["vel"]).all()
                       and np.isfinite(host["slr"]).all()),
        "slr_nonneg": bool((host["slr"] >= 0).all()),
        "wind_on_discs_only": not bool(wind_off_disc.any()),
    }
    return checks, host


def _reset_launches() -> None:
    from al26_tpu_torch.ops import cuda_nbody, cuda_tree

    for counts in (cuda_nbody.LAUNCHES, cuda_tree.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    from al26_tpu_torch.ops import cuda_nbody, cuda_tree

    return {**cuda_nbody.LAUNCHES, **cuda_tree.LAUNCHES}


def phase_near_field():
    """Kernel 3 against its f64 plain version on a fractal cluster of
    N_NEAR stars (the tree and pair list the tree slice would build), the
    overflow flag, times beside the f32 plain version's, and the
    partner-run lengths (one CTA per target block is bounded by the
    longest run)."""
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_tree as ct
    from al26_tpu_torch.ops import tree as tt
    from al26_tpu_torch.sim import init_cluster

    dev = torch.device("cuda")
    cfg = SimConfig(n=N_NEAR, model="fractal", rc=1.0, seed=7, dtype="f32",
                    force_impl="tree")
    state, _, cfg = init_cluster(cfg, device=dev)
    c = state.cluster
    leaf, kavg, eps2 = cfg.tree_leaf, cfg.tree_kavg, cfg.eps2
    tree = tt.build_block_tree(c.pos, c.mass, leaf, c.vel)
    _, p2p = tt.mac_masks(tree, cfg.tree_theta)
    kw = dict(leaf=leaf, pot_eps2=1e-30, with_jerk=True)

    def kernel(k=kavg):
        return ct.near_field(tree.pos_s, tree.mass_s, p2p, N_NEAR, eps2,
                             kavg=k, vel_s=tree.vel_s, **kw)

    got = kernel()
    d = lambda t: t.double()
    ref = ct.near_field_plain(d(tree.pos_s), d(tree.mass_s), p2p, N_NEAR,
                              eps2, kavg=kavg, vel_s=d(tree.vel_s), **kw)
    errs = {k: _rel_err(g, r) for k, g, r in zip(("acc", "jerk", "pot"),
                                                  got[:3], ref[:3])}
    abs_err = max(_abs_err(g, r) for g, r in zip(got[:3], ref[:3]))
    overflow = bool(got[3])
    overflow_kavg1 = bool(kernel(1)[3])
    again = kernel()
    same_bits = all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    _, _, count, _ = ct.pair_runs(p2p, kavg)
    runs = count.double()
    q = torch.quantile(runs, torch.tensor([0.5, 0.9, 0.99], device=dev,
                                          dtype=torch.float64))
    n_pairs = int(count.sum())
    t_k = _median_ms(kernel, 10)
    t_runs = _median_ms(lambda: ct.pair_runs(p2p, kavg), 10)
    t_p = _median_ms(lambda: ct.near_field_plain(
        tree.pos_s, tree.mass_s, p2p, N_NEAR, eps2, kavg=kavg,
        vel_s=tree.vel_s, **kw), 3, warmup=1)
    _line("kernel near_field", n=N_NEAR, leaf=leaf, blocks=p2p.shape[0],
          kavg=kavg, eps2=eps2, rel_err=errs, tol=KERNEL_TOL,
          max_abs_err=abs_err, overflow=overflow,
          overflow_at_kavg1=overflow_kavg1, repeat_same_bits=same_bits,
          ms=t_k, pair_list_ms=t_runs, plain_f32_ms=t_p,
          pairs=n_pairs, gpairs_per_s=n_pairs * leaf * leaf / (t_k * 1e6),
          run_length={"mean": float(runs.mean()), "p50": float(q[0]),
                      "p90": float(q[1]), "p99": float(q[2]),
                      "max": int(count.max()), "min": int(count.min())})
    bad = {k: v for k, v in errs.items() if not v < KERNEL_TOL}
    if bad or overflow or not overflow_kavg1 or not same_bits:
        _fail(f"near_field: errors {bad}, overflow {overflow}, overflow at "
              f"kavg=1 {overflow_kavg1}, repeat same bits {same_bits}")
    # the pairs the MAC asks for (each leaf pair L x L, less the N self
    # pairs); the sorted stars in (28 bytes), acc / jerk / pot out (28),
    # the packed pair list (two int32 a pair)
    return {"name": "near_field", "route": "cuda",
            "source": "al26_tpu_torch/csrc/tree.cu",
            "replaces": "al26_tpu/ops/pallas_tree.py:63",
            "launches": 0, "max_abs_err": abs_err, "ms": t_k,
            "plain_ms": t_p,
            **_bound(n_pairs * leaf * leaf - N_NEAR, True,
                     56 * N_NEAR + 8 * n_pairs),
            "library_ms": None}


def phase_tree_accuracy():
    """The tree's acceleration on the kernel path against the exact
    kernel-1 sweep, on fractal ICs at N = 65536, theta = 0.75 (the JAX
    package's bench tree_accuracy phase): median and p99 of
    |da| / |a|."""
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.ops import tree as tt
    from al26_tpu_torch.sim import init_cluster

    dev = torch.device("cuda")
    n, theta = 65536, 0.75
    cfg = SimConfig(n=n, rc=1.0, seed=1, dtype="f32", model="fractal",
                    force_impl="tree", tree_theta=theta)
    state, _, cfg = init_cluster(cfg, device=dev)
    pos, mass = state.cluster.pos, state.cluster.mass
    zeros = torch.zeros_like(pos)

    def exact():
        return cn.kernel_acc_jerk_pot(pos, zeros, mass, cfg.eps2,
                                      with_jerk=False, with_pot=False)[0]

    def tree():
        return tt.tree_acc_pot(pos, mass, cfg.eps2, theta=theta,
                               leaf=cfg.tree_leaf, kavg=cfg.tree_kavg)

    a_x = exact()
    _reset_launches()
    a_t, _, ovf = tree()
    launched = _launches()["near_field"]
    rel = ((a_t.double() - a_x.double()).norm(dim=1)
           / a_x.double().norm(dim=1).clamp(min=1e-30))
    med = float(rel.median())
    p99 = float(torch.quantile(rel, 0.99))
    checks = {"median": med <= TREE_MEDIAN_TOL, "p99": p99 <= TREE_P99_TOL,
              "no_overflow": not bool(ovf),
              "finite": bool(torch.isfinite(a_t).all()),
              "near_field_launched": launched > 0}
    t_tree = _median_ms(tree, 5)
    t_exact = _median_ms(exact, 5)
    _line("tree accuracy", n=n, theta=theta, leaf=cfg.tree_leaf,
          kavg=cfg.tree_kavg, median=med, p99=p99,
          tol={"median": TREE_MEDIAN_TOL, "p99": TREE_P99_TOL},
          tree_sweep_ms=t_tree, exact_sweep_ms=t_exact, checks=checks)
    if not all(checks.values()):
        _fail(f"tree accuracy: {[k for k, v in checks.items() if not v]}")


def _to_device(state, aux, device):
    """The same state and aux bits on another device."""
    import numpy as np

    from al26_tpu_torch.sim.init import SimAux
    from al26_tpu_torch.state import (
        aux_from_numpy, cluster_to_numpy, state_from_numpy,
    )

    s = state_from_numpy(cluster_to_numpy(state.cluster),
                         state.time.cpu().numpy(),
                         state.step_count.cpu().numpy(),
                         dtype=state.cluster.pos.dtype, device=device)
    aux_np = {f: getattr(aux, f).cpu().numpy()
              for f in SimAux.__dataclass_fields__ if f != "stellar_tbl"}
    aux_np["stellar_tbl"] = [np.asarray(a.cpu()) for a in aux.stellar_tbl]
    return s, aux_from_numpy(aux_np, device=device)


def phase_tree_parity():
    """The tree slice on the card against the tree slice on the CPU, from
    the same initial bits (one init on the CPU, copied to the card). A
    geometric-MAC step runs kernel 3 (the tree sweeps) and kernel 2 (the
    fast-group subcycle); kernel 1 belongs to the tier's init (the fractal
    virial sum) and to the relative MAC's seeding sweep (phase 5b)."""
    import numpy as np

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.sim import init_cluster, run_steps
    from al26_tpu_torch.state import cluster_to_numpy

    cfg = SimConfig(n=4096, rc=1.0, seed=5, dtype="f32", model="fractal",
                    force_impl="tree", tree_leaf=64, tree_mac="geometric",
                    integrator="hermite4_block", k_fast=64)
    state, aux, rcfg = init_cluster(cfg, device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        s0, a0 = _to_device(state, aux, dev)
        _reset_launches()
        t0 = time.perf_counter()
        s = run_steps(s0, a0, rcfg, 3, force_impl="tree")
        out[dev] = cluster_to_numpy(s.cluster)
        out[dev + "_s"] = time.perf_counter() - t0
        launched = _launches()
        out[dev + "_launches"] = launched
        if dev == "cpu" and any(launched.values()):
            _fail(f"the CPU tree run launched kernels: {launched}")
        if dev == "cuda" and not (launched["near_field"] > 0
                                  and launched["nbody_predcols"] > 0):
            _fail(f"the card's tree run missed a kernel: {launched}")
    g, r = out["cuda"], out["cpu"]
    pos_err = float(np.max(np.abs(g["pos"] - r["pos"])
                           / (2e-5 + 2e-4 * np.abs(r["pos"]))))
    slr_err = float(np.max(np.abs(g["slr"] - r["slr"])
                           / (1e-30 + 2e-3 * np.abs(r["slr"]))))
    mass_same = bool(np.array_equal(g["mass"], r["mass"]))
    _line("tree parity", n=4096, leaf=64, kavg=rcfg.tree_kavg, steps=3,
          pos_err_over_bar=pos_err, slr_err_over_bar=slr_err,
          mass_exact=mass_same, cuda_s=out["cuda_s"], cpu_s=out["cpu_s"],
          launches=out["cuda_launches"])
    if not (pos_err <= 1.0 and slr_err <= 1.0 and mass_same):
        _fail("the card's tree slice disagrees with the CPU's")


def _sweep_breakdown(state, cfg) -> dict:
    """Median ms of the pieces of one tree sweep (with jerk and the raw
    potential) at the state's positions: tree build + MAC, far field,
    near field (pair list + kernel), and the whole sweep."""
    from al26_tpu_torch.ops import cuda_tree as ct
    from al26_tpu_torch.ops import tree as tt
    from al26_tpu_torch.sim.step import _sweep_eval_fn

    c = state.cluster
    box = {}

    def build_mac():
        box["tree"] = tt.build_block_tree(c.pos, c.mass, cfg.tree_leaf,
                                          c.vel)
        box["acc"], box["p2p"] = tt.mac_masks(box["tree"], cfg.tree_theta)

    def far():
        tt._monopole_far_field(box["tree"], box["acc"], cfg.eps2,
                               tt.G_INTERNAL, 1e-30, with_jerk=True)

    def near():
        tr = box["tree"]
        ct.near_field(tr.pos_s, tr.mass_s, box["p2p"], c.n, cfg.eps2,
                      leaf=cfg.tree_leaf, kavg=cfg.tree_kavg,
                      pot_eps2=1e-30, vel_s=tr.vel_s, with_jerk=True)

    sweep = _sweep_eval_fn(cfg, None, "tree", c.mass, True)
    return {"build_and_mac_ms": _median_ms(build_mac, 3, warmup=1),
            "far_field_ms": _median_ms(far, 3, warmup=1),
            "near_field_ms": _median_ms(near, 3, warmup=1),
            "full_sweep_ms": _median_ms(lambda: sweep(c.pos, c.vel), 3,
                                        warmup=1)}


def _main_path_kernel_checks(state, cache, cfg) -> dict:
    """Each kernel against its f64 plain version at the shapes the N_TREE
    tree slice gives it, on the slice's state after its last step:

      near_field      the state's tree and pair list (theta, leaf,
                      tree_kavg; jerk and the raw potential), on the 16
                      target blocks with the longest partner runs and 16
                      random others (the plain sweep sees only their
                      pairs);
      nbody_predcols  K = k_fast rows (the largest |a|) against all N
                      columns predicted from the force cache to dt / 2;
      nbody_rows      the fractal virial sum's sweep (eps2 = 1e-30,
                      potential) over all N stars, on 2048 random rows.

    Returns {kernel: {"rel_err": {...}, "max_abs_err": x, "tol": bar}}."""
    import numpy as np
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.ops import cuda_tree as ct
    from al26_tpu_torch.ops import tree as tt

    c = state.cluster
    n, dev = c.n, c.pos.device
    d = lambda t: t.double()
    rng = np.random.default_rng(11)

    def record(names, got, ref, tol, **extra):
        return {"rel_err": {k: _rel_err(g, r)
                            for k, g, r in zip(names, got, ref)},
                "max_abs_err": max(_abs_err(g, r) for g, r in zip(got, ref)),
                "tol": tol, **extra}

    out = {}
    tree = tt.build_block_tree(c.pos, c.mass, cfg.tree_leaf, c.vel)
    _, p2p = tt.mac_masks(tree, cfg.tree_theta)
    kw = dict(leaf=cfg.tree_leaf, kavg=cfg.tree_kavg, pot_eps2=1e-30,
              with_jerk=True)
    got = ct.near_field(tree.pos_s, tree.mass_s, p2p, n, cfg.eps2,
                        vel_s=tree.vel_s, **kw)
    runs = p2p.sum(1)
    picked = torch.cat([torch.topk(runs, 16).indices, torch.as_tensor(
        rng.choice(p2p.shape[0], 16, replace=False), device=dev)])
    blocks = torch.unique(picked)
    sub = torch.zeros_like(p2p)
    sub[blocks] = p2p[blocks]
    ref = ct.near_field_plain(d(tree.pos_s), d(tree.mass_s), sub, n,
                              cfg.eps2, vel_s=d(tree.vel_s), **kw)
    out["near_field"] = record(
        ("acc", "jerk", "pot"), [g[blocks] for g in got[:3]],
        [r[blocks] for r in ref[:3]], KERNEL_TOL, blocks=len(blocks),
        pairs=int(sub.sum()), overflow=bool(got[3]),
        run_length={"mean": float(runs.double().mean()),
                    "max": int(runs.max()), "min": int(runs.min())})

    a0, j0 = cache[0], cache[1]
    sel = torch.topk(a0.norm(dim=1), cfg.k_fast).indices.to(torch.int32)
    tau = torch.tensor(0.5 * cfg.dt, dtype=torch.float32, device=dev)
    pf, vf = cn.predict_columns(c.pos[sel], c.vel[sel], a0[sel], j0[sel],
                                tau)
    pf, vf = pf.contiguous(), vf.contiguous()
    got = cn.nbody_predcols(pf, vf, sel, c.pos, c.vel, a0, j0, c.mass, tau,
                            cfg.eps2)
    ref = cn.nbody_predcols_plain(d(pf), d(vf), sel, d(c.pos), d(c.vel),
                                  d(a0), d(j0), d(c.mass), d(tau), cfg.eps2)
    out["nbody_predcols"] = record(("acc", "jerk"), got, ref, PREDCOLS_TOL,
                                   k=cfg.k_fast, n=n)

    zeros = torch.zeros_like(c.pos)
    a1, _, p1 = cn.kernel_acc_jerk_pot(c.pos, zeros, c.mass, 1e-30,
                                       with_jerk=False)
    rows = torch.as_tensor(np.sort(rng.choice(n, 2048, replace=False)),
                           dtype=torch.int32, device=dev)
    ar, _, pr = cn.nbody_rows_plain(d(c.pos[rows]), d(zeros[rows]), rows,
                                    d(c.pos), d(zeros), d(c.mass), 1e-30,
                                    with_jerk=False)
    out["nbody_rows"] = record(("acc", "pot"), (a1[rows], p1[rows]),
                               (ar, pr), KERNEL_TOL, rows=2048, n=n,
                               eps2=1e-30)
    torch.cuda.synchronize()
    return out


def phase_tree_slice():
    """The tree tier at size: fractal N_TREE, default knobs (resolving to
    hermite4_block, theta = 0.75, leaf 256, tree_kavg auto-sized), 10
    steps as two cached chunks of 5, all three kernels, each then held
    against its plain version at this path's shapes; then the relative
    MAC at N_NEAR for 5 steps (exact kernel-1 seeding sweep). Returns the
    launches and the kernel comparisons."""
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.sim import init_cluster, run_steps
    from al26_tpu_torch.sim.step import fresh_cache, run_steps_cached

    dev = torch.device("cuda")
    cfg = SimConfig(n=N_TREE, model="fractal", rc=1.0, seed=42, dtype="f32",
                    force_impl="tree")
    # the main path is init_cluster, fresh_cache, run_steps_cached: the
    # counts run from before the init (whose fractal virial sum is a
    # kernel-1 sweep) to after the last step
    _reset_launches()
    torch.cuda.synchronize()
    t_init = time.perf_counter()
    state, aux, cfg = init_cluster(cfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    init_launches = _launches()
    resolved = {"integrator": cfg.integrator == "hermite4_block",
                "theta": cfg.tree_theta == 0.75, "leaf": cfg.tree_leaf == 256,
                "kavg": cfg.tree_kavg > 0}
    if not all(resolved.values()):
        _fail(f"tree slice resolved {cfg.integrator}, theta "
              f"{cfg.tree_theta}, leaf {cfg.tree_leaf}, kavg {cfg.tree_kavg}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = fresh_cache(state, cfg, cfg.integrator, None, "tree")
    for _ in range(2):                     # two checkpoint-sized chunks
        state, cache = run_steps_cached(state, cache, aux, cfg, 5, None,
                                        "tree")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    step_launches = {k: v - init_launches[k] for k, v in launches.items()}
    steps = 10
    checks, host = _state_checks(state, cfg, steps)
    checks["cache_finite"] = all(bool(torch.isfinite(x).all())
                                 for x in cache)
    for k in ("near_field", "nbody_rows", "nbody_predcols"):
        checks[k + "_launched"] = launches[k] > 0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # after the counts are read: these launches compare, they do not count
    kernel_checks = _main_path_kernel_checks(state, cache, cfg)
    for k, rec in kernel_checks.items():
        checks[k + "_matches_plain"] = all(
            v < rec["tol"] for v in rec["rel_err"].values())
    checks["near_field_no_overflow"] = not kernel_checks["near_field"][
        "overflow"]
    breakdown = _sweep_breakdown(state, cfg)
    _line("tree slice", n=N_TREE, integrator=cfg.integrator,
          k_fast=cfg.k_fast, theta=cfg.tree_theta, leaf=cfg.tree_leaf,
          tree_kavg=cfg.tree_kavg, init_s=t_init, wall_s=wall,
          s_per_myr=wall / (steps * cfg.dt),
          wall_per_step_ms=1e3 * wall / steps,
          substeps_per_step=step_launches["nbody_predcols"] / steps,
          launches=launches, init_launches=init_launches,
          step_launches=step_launches, peak_mem_gb=peak_gb, sweep=breakdown,
          kernels_vs_plain=kernel_checks,
          wind_total=float(host["slr"][:, :, 0:2].sum()), checks=checks)
    if not all(checks.values()):
        _fail(f"tree slice: {[k for k, v in checks.items() if not v]} "
              "failed")

    # the relative MAC: exact seeding sweep, relative closing sweeps
    rcfg = SimConfig(n=N_NEAR, model="fractal", rc=1.0, seed=42,
                     dtype="f32", force_impl="tree", tree_mac="relative")
    rstate, raux, rcfg = init_cluster(rcfg, device=dev)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rstate = run_steps(rstate, raux, rcfg, 5, force_impl="tree")
    torch.cuda.synchronize()
    rwall = time.perf_counter() - t0
    rlaunch = _launches()
    rchecks, _ = _state_checks(rstate, rcfg, 5)
    rchecks["seeding_sweep_nbody_rows"] = rlaunch["nbody_rows"] > 0
    rchecks["near_field_launched"] = rlaunch["near_field"] > 0
    _line("tree slice relative", n=N_NEAR, integrator=rcfg.integrator,
          alpha=rcfg.tree_alpha, tree_kavg=rcfg.tree_kavg, wall_s=rwall,
          s_per_myr=rwall / (5 * rcfg.dt), launches=rlaunch, checks=rchecks)
    if not all(rchecks.values()):
        _fail(f"relative tree run: "
              f"{[k for k, v in rchecks.items() if not v]} failed")
    return launches, kernel_checks


def _ensemble(b: int, n: int, device, seed: int = 42):
    """init_ensemble of b realizations of n stars (Plummer, rc = 1, f32,
    integrator auto -> leapfrog at the ensemble boundary)."""
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.parallel.ensemble import init_ensemble

    return init_ensemble(SimConfig(n=n, rc=1.0, seed=seed, dtype="f32"), b,
                         device=device)


def phase_group_kernel():
    """The windowed kernel 1 against its f64 plain grouped version on the
    initial states of both ensembles: full sweeps (jerk + raw potential;
    acceleration only; acceleration + raw potential, the leapfrog path's
    closing sweep), 512 scattered rows across the groups; returns the
    kernels-line record (launches filled from phase 5c)."""
    import numpy as np
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn

    dev = torch.device("cuda")
    d = lambda t: t.double()
    rng = np.random.default_rng(5)
    abs_err, rec = 0.0, None
    for b, n, _, _ in ENSEMBLES:
        bs, _, cfgs = _ensemble(b, n, dev)
        eps2, total = cfgs[0].eps2, b * n
        c = bs.cluster
        pos, vel = c.pos.reshape(total, 3), c.vel.reshape(total, 3)
        mass = c.mass.reshape(total)
        ids = torch.arange(total, dtype=torch.int32, device=dev)
        kw = dict(group_size=n)
        modes = {"jerk_pot": dict(pot_eps2=1e-30),
                 "acc": dict(with_jerk=False, with_pot=False),
                 "acc_pot": dict(with_jerk=False, pot_eps2=1e-30)}
        errs, times = {}, {}
        ref_full = cn.nbody_rows_plain(d(pos), d(vel), ids, d(pos), d(vel),
                                       d(mass), eps2, pot_eps2=1e-30, **kw)
        for mode, mk in modes.items():
            got = cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2, **mk,
                                **kw)
            again = cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2, **mk,
                                  **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                _fail(f"nbody_rows_group {b}x{n} {mode}: a repeat differs")
            names = ("acc", "jerk", "pot")
            keep = [0] + ([1] if mk.get("with_jerk", True) else []) + (
                [2] if mk.get("with_pot", True) else [])
            for i in keep:
                errs[f"{mode}_{names[i]}"] = _rel_err(got[i], ref_full[i])
                abs_err = max(abs_err, _abs_err(got[i], ref_full[i]))
            times[mode + "_ms"] = _median_ms(
                lambda: cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2,
                                      **mk, **kw), 10)
        # scattered rows across the groups (hermite4_block's fast rows)
        sel = torch.as_tensor(np.sort(rng.choice(total, 512, replace=False)),
                              dtype=torch.int32, device=dev)
        sel = sel[torch.as_tensor(rng.permutation(512), device=dev)]
        rp, rv = pos[sel].contiguous(), vel[sel].contiguous()
        got = cn.nbody_rows(rp, rv, sel, pos, vel, mass, eps2,
                            with_pot=False, **kw)
        ref = cn.nbody_rows_plain(d(rp), d(rv), sel, d(pos), d(vel),
                                  d(mass), eps2, with_pot=False, **kw)
        errs_rows = {"rows512_acc": _rel_err(got[0], ref[0]),
                     "rows512_jerk": _rel_err(got[1], ref[1])}
        abs_err = max(abs_err, _abs_err(got[0], ref[0]),
                      _abs_err(got[1], ref[1]))
        times["rows512_ms"] = _median_ms(
            lambda: cn.nbody_rows(rp, rv, sel, pos, vel, mass, eps2,
                                  with_pot=False, **kw), 20)
        mk = modes["acc_pot"]
        t_plain = _median_ms(lambda: cn.nbody_rows_plain(
            pos, vel, ids, pos, vel, mass, eps2, **mk, **kw), 3, warmup=1)
        pairs = b * n * (n - 1)
        bound = _bound(pairs, False, _rows_bytes(total, total, False, True))
        _line("kernel nbody_rows_group", realizations=b, n=n, eps2=eps2,
              groups_spanned_by_rows=int(torch.unique(
                  sel.long() // n).numel()),
              rel_err={**errs, **errs_rows},
              tol={"full": KERNEL_TOL, "rows": PREDCOLS_TOL},
              max_abs_err=abs_err, **times, acc_pot_plain_f32_ms=t_plain,
              useful_gpairs_per_s=pairs / (times["acc_pot_ms"] * 1e6),
              **bound)
        bad = {k: v for k, v in errs.items() if not v < KERNEL_TOL}
        bad.update({k: v for k, v in errs_rows.items()
                    if not v < PREDCOLS_TOL})
        if bad:
            _fail(f"nbody_rows_group {b}x{n} disagrees with its plain "
                  f"version: {bad}")
        if rec is None:
            # the record: the leapfrog path's closing sweep (acceleration
            # and raw potential) of the reference campaign's 64 x 1000
            rec = {"name": "nbody_rows_group", "route": "cuda",
                   "source": "al26_tpu_torch/csrc/nbody.cu",
                   "replaces": "al26_tpu/ops/pallas_nbody.py:121",
                   "launches": 0, "max_abs_err": 0.0,
                   "ms": times["acc_pot_ms"], "plain_ms": t_plain, **bound,
                   "library_ms": None}
    rec["max_abs_err"] = abs_err
    return rec


def phase_ensemble_parity():
    """A flat ensemble on the card (group windows, force cache) against
    the same ensemble on the CPU (per-realization dense forces), from the
    same initial bits: B = 4, n = 256, 3 steps, the bars of phase 4."""
    import numpy as np

    from al26_tpu_torch.parallel.ensemble import ensemble_run_steps
    from al26_tpu_torch.state import cluster_to_numpy

    out = {}
    for dev in ("cuda", "cpu"):
        bs, ba, cfgs = _ensemble(4, 256, dev, seed=5)
        _reset_launches()
        t0 = time.perf_counter()
        s = ensemble_run_steps(bs, ba, cfgs[0], 3, flat=True)
        out[dev] = cluster_to_numpy(s.cluster)
        out[dev + "_s"] = time.perf_counter() - t0
        launched = _launches()
        if dev == "cpu" and any(launched.values()):
            _fail(f"the CPU ensemble launched kernels: {launched}")
        if dev == "cuda" and not launched["nbody_rows_group"] > 0:
            _fail(f"the card's ensemble missed the group window: {launched}")
    g, r = out["cuda"], out["cpu"]
    pos_err = float(np.max(np.abs(g["pos"] - r["pos"])
                           / (2e-5 + 2e-4 * np.abs(r["pos"]))))
    slr_err = float(np.max(np.abs(g["slr"] - r["slr"])
                           / (1e-30 + 2e-3 * np.abs(r["slr"]))))
    mass_same = bool(np.array_equal(g["mass"], r["mass"]))
    _line("ensemble parity", realizations=4, n=256, steps=3,
          integrator=cfgs[0].integrator, n_sub=cfgs[0].leapfrog_n_sub,
          pos_err_over_bar=pos_err, slr_err_over_bar=slr_err,
          mass_exact=mass_same, cuda_s=out["cuda_s"], cpu_s=out["cpu_s"])
    if not (pos_err <= 1.0 and slr_err <= 1.0 and mass_same):
        _fail("the card's ensemble disagrees with the CPU's")


def phase_ensemble_slice(b: int, n: int, steps: int, chunks) -> dict:
    """The slice: init_ensemble, ensemble_fresh_cache, then
    ensemble_run_steps_cached in checkpoint-sized chunks; returns the
    launches of that run (counts set to 0 just before it)."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.parallel import ensemble as ens
    from al26_tpu_torch.units import G_INTERNAL

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter()
    bs, ba, cfgs = _ensemble(b, n, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    cfg = cfgs[0]
    if cfg.integrator != "leapfrog":
        _fail(f"the ensemble resolved {cfg.integrator}, expected leapfrog")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = ens.ensemble_fresh_cache(bs, cfg)
    for chunk in chunks:
        bs, cache = ens.ensemble_run_steps_cached(bs, cache, ba, cfg, chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    checks = {}
    for k in range(b):
        ck, _ = _state_checks(ens._take(bs, k), cfg, steps)
        for name, ok in ck.items():
            checks[name] = checks.get(name, True) and ok
    checks["cache_finite"] = all(bool(torch.isfinite(x).all())
                                 for x in cache)
    checks["rows_group_launched"] = launches["nbody_rows_group"] > 0
    checks["only_the_window"] = not any(
        v for k, v in launches.items() if k != "nbody_rows_group")

    # the per-realization physics alone, on the final state (same shapes
    # as in the run), and the windowed closing sweep there against its f64
    # plain version; after the counts were read
    c = bs.cluster
    pot = cache[2].reshape(b, n)
    mtot = c.mass.sum(1)
    r_vir = -G_INTERNAL * mtot * mtot / (c.mass * pot).sum(1)

    def physics():
        ens.ensemble_physics_after_advance(bs, ba, cfg, c.pos, c.pos, c.vel,
                                           r_vir)
        torch.cuda.synchronize()

    physics()
    reps = []
    for _ in range(3):
        t1 = time.perf_counter()
        physics()
        reps.append(time.perf_counter() - t1)
    physics_ms = 1e3 * sorted(reps)[1]
    total = b * n
    pos, mass = c.pos.reshape(total, 3), c.mass.reshape(total)
    ids = torch.arange(total, dtype=torch.int32, device=dev)
    got = cn.nbody_rows(pos, pos, ids, pos, pos, mass, cfg.eps2,
                        with_jerk=False, pot_eps2=1e-30, group_size=n)
    ref = cn.nbody_rows_plain(pos.double(), pos.double(), ids, pos.double(),
                              pos.double(), mass.double(), cfg.eps2,
                              with_jerk=False, pot_eps2=1e-30, group_size=n)
    final_err = {"acc": _rel_err(got[0], ref[0]),
                 "pot": _rel_err(got[2], ref[2])}
    checks["final_sweep_matches_plain"] = all(
        v < KERNEL_TOL for v in final_err.values())
    step_ms = 1e3 * wall / steps
    _line("ensemble slice", realizations=b, n=n, steps=steps,
          integrator=cfg.integrator, n_sub=cfg.leapfrog_n_sub,
          init_s=t_init, wall_s=wall, s_per_myr=wall / (steps * cfg.dt),
          step_ms=step_ms, physics_ms=physics_ms,
          advance_and_cache_ms=step_ms - physics_ms,
          launches=launches, peak_mem_gb=peak_gb,
          final_sweep_rel_err=final_err,
          wind_total=float(c.slr[:, :, :, 0:2].sum()), checks=checks)
    if not all(checks.values()):
        _fail(f"ensemble {b}x{n}: "
              f"{[k for k, v in checks.items() if not v]} failed")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import al26_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the al26_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(al26_tpu_torch.__file__))
    if pkg != os.path.join(HERE, "al26_tpu_torch"):
        print(f"chip_smoke: al26_tpu_torch imported from {pkg}, not from "
              f"this checkout", file=sys.stderr)
        return 2

    phase_device()
    phase_build()
    records = phase_kernels()
    records.append(phase_near_field())
    group = phase_group_kernel()
    phase_parity()
    phase_ensemble_parity()
    phase_tree_accuracy()
    phase_tree_parity()
    phase_slice(8192, "hermite4")
    phase_slice(32768, "hermite4_block")
    tree, checked = phase_tree_slice()
    ensembles = [phase_ensemble_slice(*e) for e in ENSEMBLES]
    # launches: kernels 1-3 from the N_TREE tree-tier run, which exercises
    # all three, the error the worst of the kernel phases and that run's
    # shapes; the group window from the 64 x 1000 ensemble
    for rec in records:
        rec["launches"] = tree[rec["name"]]
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 checked[rec["name"]]["max_abs_err"])
    group["launches"] = ensembles[0]["nbody_rows_group"]
    records.append(group)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
