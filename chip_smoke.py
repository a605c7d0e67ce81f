#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (al26_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one CUDA card

Phases, one result line each (any failure exits non-zero):

  1. device   the card's name and power limit (nvidia-smi), CUDA present,
              TF32 off;
  2. build    nvcc builds csrc/nbody.cu from this checkout (timed);
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

Then one JSON line with every kernel's launches (from phase 5), error and
times, and last the line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_KERNEL = 32768
KERNEL_TOL = 1e-5
PREDCOLS_TOL = 2e-5


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


def phase_build():
    from al26_tpu_torch.ops import cuda_nbody

    t0 = time.perf_counter()
    path = cuda_nbody.build()
    cuda_nbody.load()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_nbody.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    _line("build", seconds=secs, library=os.path.relpath(path, HERE),
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
                "plain_ms": t_p}

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
    rec_pred = {"name": "nbody_predcols", "route": "cuda",
                "source": "al26_tpu_torch/csrc/nbody.cu",
                "replaces": "al26_tpu/ops/pallas_nbody.py:539",
                "launches": 0, "max_abs_err": abs2, "ms": t_k2,
                "plain_ms": t_p2}
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
        if dev == "cuda" and not all(launched.values()):
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
    from al26_tpu_torch.state import cluster_to_numpy

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

    c = state.cluster
    tensors = [getattr(c, f) for f in c.__dataclass_fields__]
    tensors += [state.time, state.step_count]
    if not all(t.device.type == "cuda" for t in tensors):
        _fail("a state tensor left the card")
    want_t = (torch.tensor(steps, dtype=torch.float32)
              * torch.tensor(cfg.dt, dtype=torch.float32))
    host = cluster_to_numpy(c)
    import numpy as np

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
        "rows_launched": launches["nbody_rows"] > 0,
        "predcols_launched": (integ != "hermite4_block"
                              or launches["nbody_predcols"] > 0),
    }
    sim_myr = steps * cfg.dt
    _line("slice", n=n, integrator=integ, k_fast=cfg.k_fast,
          init_s=t_init, wall_s=wall, s_per_myr=wall / sim_myr,
          substeps_per_step=substeps, launches=launches,
          wind_total=float(host["slr"][:, :, 0:2].sum()), checks=checks)
    if not all(checks.values()):
        _fail(f"n={n}: {[k for k, v in checks.items() if not v]} failed")
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
    phase_parity()
    phase_slice(8192, "hermite4")
    big = phase_slice(32768, "hermite4_block")
    # launches: from the n = 32768 main-path run, which exercises both
    for rec in records:
        rec["launches"] = big[rec["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
