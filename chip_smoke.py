#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (al26_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one CUDA card
    python3 chip_smoke.py --mma  # phases 1, 2, 3d and kernel 2c at the
                                 # tree slice's shape, nothing else

Phases, one result line each (any failure exits non-zero):

  1. device   the card's name and power limit (nvidia-smi), CUDA present,
              TF32 off; the maximum SM clock (nvidia-smi) and the SM
              count, which give the SFU's rsqrt rate of the bounds;
  2. build    nvcc builds csrc/nbody.cu and csrc/tree.cu from this checkout,
              one nvcc each, started together (timed; the ptxas lines);
  3. kernels  kernels 1 and 2's FMA bodies against their f64 plain
              versions on Plummer clusters from init_cluster: kernel 1
              (nbody_rows) at N = 32768 on the full sweep (jerk + raw
              potential), the leapfrog sweep (no jerk) and 256 scattered
              rows, and at n = 8192 (the hermite4 path's size) on the full
              sweep and a substep's jerk-only sweep, held to 1e-5 of the
              max; kernel 2 (nbody_predcols) with
              K = 256 at a nonzero tau, held to 2e-5; the same bits on a
              repeat. Device-only times (CUDA events around 20-50
              back-to-back launches of the bare launchers, one launch a
              call) beside the matmul bodies' at the same shapes, the
              bounds, and the f32 plain versions' times;
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
              kavg = 1; the same bits on a repeat; its device time per
              launch (events around 20 back-to-back launches of the bare
              launcher) and a wrapper call's, beside the bound from the
              needed pairs and the f32 plain version's time; the pair
              classes, the padding pairs dropped, the run lengths, and
              the swept pairs counted on the card and on the CPU;
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
              live tree, as in phase 3b, with its device time and bound
              there, which the kernels line carries; kernel 2 at K = k_fast
              against all N columns, kernel 1's eps2 = 1e-30 virial sweep
              on a row subset; bars as in phases 3 and 3b; kernels 1 and 2
              also twice (the same bits) and timed there as in phase 3,
              which the kernels line carries), a breakdown of
              one tree sweep, and the physics invariants; then
              tree_mac="relative" at N = 131072 for 5 steps (exact kernel-1
              seeding sweep). Kernel 2c there (K = 512) also twice (the
              same bits) and timed as in phase 3d.

The flattened ensembles (parallel.ensemble, kernel 1's group windows):

  3c. kernel nbody_rows_group  the windowed kernel against its f64 plain
              grouped version on the initial states of the two ensembles
              below, B x N = 64 x 1000 and 8 x 10240: the full sweep with
              jerk and the raw potential and the acceleration-only sweep
              (bar 1e-5 of the max), 512 scattered rows spanning several
              groups (bar 2e-5); the same bits on a repeat; each mode's
              device time per launch (events around 50 back-to-back
              launches of the bare launcher) beside its bound, and the
              f32 plain version's time;
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

The matmul reduction (use_mxu=True, the default of every single-cluster
sweep, as in the JAX package) and the entry path of a user:

  3d. kernel mma  kernels 1c / 2c (nbody_rows_mma, nbody_predcols_mma)
              against their f64 plain decomposition on Plummer clusters
              from init_cluster: kernel 1's full sweep (jerk + raw
              potential) at N = 32768 and 131072, the uncached sweep at
              eps2 = 0.125 (potential through the product), the
              acceleration-only sweep and 256 scattered rows at 32768;
              kernel 2 at K = 256, tau != 0. Bars: 3e-4 of the max (kernel
              1), 5e-4 (kernel 2), 1e-4 (potential through the product),
              1e-5 (explicit potential); the same bits on a repeat. Times:
              each matmul body's device time per launch (CUDA events
              around 50 back-to-back launches of its bare launcher,
              arguments and outputs prepared once), its kernels' device
              times by name (torch.profiler: one kernel a launch), the
              host time of one wrapper call (kernel 2: one substep's
              rows_at), beside the FMA bodies' and the f32 plain
              versions';
  6.  cli     `python -m al26_tpu_torch.cli -n 1000 -rc 1 -t_f 1 --dtype
              f32 --seed 42 -f smoke -v` in a subprocess in a temporary
              directory (1000 steps, 102 saves): the state, yields and CSV
              files and their counts, wall time and s/Myr with the saves,
              the invariants of the last state; then `-r smoke -nc 50`, its
              final state against the uninterrupted run's at the bars of
              phase 4 (and whether the bits matched);
  6b. driver  sim.driver.run at N = 32768, f32, 20 steps, 4 state files:
              the matmul kernels launched, the FMA bodies not, s/Myr with
              the saves beside phase 5's, the seconds in the saves;
  6c. ensemble driver  sim.driver.run_ensemble, 64 x 1000, 20 steps: the
              64 pt-<k> folders and their files, s/Myr with the saves.

The run order: 1, 2, 3, 3d, 3b, 3c, 4, 4d, 4b, 4c, 5, 5b, 5c, 6, 6b, 6c.

Then one JSON line with every kernel's launches (kernels 1-3 from phase 5b,
the windowed kernel from the 64 x 1000 run of phase 5c, the matmul kernels
from phase 6b), error (the largest of its comparisons), times (device-only
`ms`; kernels 1-3 at the tree slice's shapes, kernels 1 and 2 with the
matmul body's `mma_ms` there; the matmul bodies also the wrapper's
`host_ms`), and the least time
the card could take for the same work: bound_ms, the largest of the FP32
operations over the FP32 rate, the rsqrt a pair (two with a separately
softened potential) over the SFU rate (16 a clock per SM at the maximum
SM clock, read in phase 1), the matmul bodies' 3xTF32 products over the
TF32 rate, and the bytes over the HBM rate; bound_by says "bytes" or
"operations", bound_pipe which term ("fp32", "sfu", "tf32", "hbm"). The
FMA bodies count 50 flops a pair with the jerk, 30 without, the matmul
bodies their FP32 work outside the tensor cores. Last the line
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
# the matmul reductions' bars, the JAX package's own (tests/test_pallas.py:
# 3e-4 of the max for kernel 1, 5e-4 for kernel 2, 1e-4 for the potential
# through the product; an explicit potential keeps KERNEL_TOL)
MMA_TOL = 3e-4
PRED_MMA_TOL = 5e-4
MMA_POT_TOL = 1e-4
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
# the matmul bodies: the TF32 tensor-core rate, the FP32 work a pair needs
# outside the tensor cores (dx and d2: 8; the softening, rsqrt and w =
# m / r^3: 5; with the jerk dv, dx.dv, / r^2 and w s: 10; a separately
# softened potential's add, rsqrt, product and sum: 4) and the flops of
# one pair in one C8 product (8 multiply-adds), issued three times (3xTF32)
TF32_FLOPS = 495e12
MMA_PAIR_FP32 = {"acc": 13, "jerk": 10, "pot_separate": 4}
MMA_PRODUCT_FLOPS = 3 * 16
# Hopper's SFU (MUFU) pipe: 16 rsqrt a clock per SM (the CUDA programming
# guide's throughput table, compute capability 9.0); the SM count and the
# maximum SM clock are read from the card in phase 1
SFU_PER_CLK = 16
_CARD = {"sms": 132, "sm_clock_hz": 1.98e9}
# back-to-back launches per device-only timing
MMA_REPS = 50


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


def _sfu_rate() -> float:
    """rsqrt results a second: SFU_PER_CLK per SM x the SMs x the SM clock
    at its maximum (phase 1 reads it from nvidia-smi)."""
    return SFU_PER_CLK * _CARD["sms"] * _CARD["sm_clock_hz"]


def _bound_of(terms: dict) -> dict:
    """The largest of the times in `terms` ({pipe: ms}, pipes "fp32",
    "tf32", "sfu", "hbm"): bound_ms, bound_by ("bytes" for the HBM term,
    else "operations") and bound_pipe, the term that binds."""
    pipe = max(terms, key=terms.get)
    return {"bound_ms": terms[pipe],
            "bound_by": "bytes" if pipe == "hbm" else "operations",
            "bound_pipe": pipe}


def _bound(pairs: float, with_jerk: bool, nbytes: float,
           rsqrt: int = 1) -> dict:
    """The least time the card could take for `pairs` pair interactions
    that move `nbytes` (each input read once, each output written once):
    the largest of the FLOPs over the FP32 rate, `rsqrt` reciprocal square
    roots a pair over the SFU rate, and the bytes over the HBM rate."""
    return _bound_of({"fp32": 1e3 * pairs * PAIR_FLOPS[with_jerk]
                      / FP32_FLOPS,
                      "sfu": 1e3 * pairs * rsqrt / _sfu_rate(),
                      "hbm": 1e3 * nbytes / HBM_BYTES_PER_S})


def _bound_mma(pairs: float, with_jerk: bool, pot_separate: bool,
               nbytes: float) -> dict:
    """_bound for a matmul body: its FP32 work outside the tensor cores at
    the FP32 rate, its 3xTF32 C8 products (two with the jerk) at the TF32
    rate, its rsqrt (two a pair with a separately softened potential) at
    the SFU rate, or the bytes over the HBM rate, whichever takes longest.
    The per-column work (centring, C8, kernel 2's prediction) is under 1 %
    of the per-pair work at these shapes and is left out."""
    fp32 = (MMA_PAIR_FP32["acc"] + (MMA_PAIR_FP32["jerk"] if with_jerk
                                    else 0)
            + (MMA_PAIR_FP32["pot_separate"] if pot_separate else 0))
    products = 2 if with_jerk else 1
    return _bound_of({"fp32": 1e3 * pairs * fp32 / FP32_FLOPS,
                      "tf32": 1e3 * pairs * products * MMA_PRODUCT_FLOPS
                      / TF32_FLOPS,
                      "sfu": 1e3 * pairs * (2 if pot_separate else 1)
                      / _sfu_rate(),
                      "hbm": 1e3 * nbytes / HBM_BYTES_PER_S})


def _rows_bytes(b: int, n: int, with_jerk: bool, with_pot: bool) -> int:
    """Bytes kernel 1 must move: rows (positions, ids; velocities with the
    jerk), columns (positions, masses; velocities with the jerk) and the
    outputs (acc; jerk, pot when asked for), all f32 / int32."""
    per_row = 12 + 4 + (12 if with_jerk else 0)
    per_col = 12 + 4 + (12 if with_jerk else 0)
    out = 12 + (12 if with_jerk else 0) + (4 if with_pot else 0)
    return b * (per_row + out) + n * per_col


def _near_stats(p2p, n_true: int, leaf: int) -> dict:
    """Kernel 3's work at one tree's MAC-failing block pairs `p2p` [B, B]:
    the pairs by class (a block is padding when it holds no real star:
    s * leaf >= n_true), the per-target run lengths of the pairs the
    kernel sweeps (every source block that holds a real star: `kept`),
    and the pair interactions they need: leaf x the real columns of each
    kept source block, less the self pairs. `needed` is what the bound
    counts; `listed_pairs` x leaf^2 is what a sweep of every listed pair as
    a full tile computes."""
    import torch

    b = p2p.shape[0]
    real = -(-n_true // leaf)
    p = p2p.to(torch.int64)
    cols = (n_true - torch.arange(b, device=p2p.device) * leaf).clamp(0, leaf)
    kept = p[:, :real]
    self_pairs = int((torch.diagonal(p)[:real] * cols[:real]).sum())
    needed = leaf * int((kept * cols[None, :real]).sum()) - self_pairs
    runs = kept.sum(1).double()
    real_runs = p[:real, :real].sum(1).double()
    q = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                     device=p2p.device)

    def dist(r):
        qs = torch.quantile(r, q)
        return {"mean": float(r.mean()), "p50": float(qs[0]),
                "p90": float(qs[1]), "p99": float(qs[2]),
                "max": int(r.max()), "min": int(r.min())}

    classes = {"real_real": int(p[:real, :real].sum()),
               "real_target_pad_source": int(p[:real, real:].sum()),
               "pad_target_real_source": int(p[real:, :real].sum()),
               "pad_pad": int(p[real:, real:].sum())}
    listed = int(p.sum())
    return {"blocks": b, "real_blocks": real, "listed_pairs": listed,
            "classes": classes, "kept_pairs": int(kept.sum()),
            "dropped_pairs": listed - int(kept.sum()),
            "padding_share": (listed - int(kept.sum())) / max(listed, 1),
            "needed_interactions": needed,
            "listed_interactions": listed * leaf * leaf,
            "run_length": dist(runs), "real_target_run_length":
            dist(real_runs)}


def _near_bound(stats: dict, leaf: int) -> dict:
    """_bound of kernel 3 in the tree sweep's mode (jerk and the raw
    potential: two rsqrt a pair) from _near_stats: the needed pair
    interactions; the sorted, padded slots in (positions, masses,
    velocities: 28 bytes), acc / jerk / pot out (28), and one int32
    source block a kept pair."""
    return _bound(stats["needed_interactions"], True,
                  stats["blocks"] * leaf * 56 + 4 * stats["kept_pairs"],
                  rsqrt=2)


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


def _device_ms(launch, reps: int = MMA_REPS, warmup: int = 3) -> float:
    """Device time of one launch: CUDA events around `reps` back-to-back
    calls of `launch` (a bare launcher, its arguments prepared once, which
    returns the CUDA error), over reps. Fails if a launch failed. Also
    the device time of a wrapper call whose kernels outlast its host
    work (it returns tensors)."""
    import torch

    err = 0
    for k in range(warmup + reps):
        if k == warmup:
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        r = launch()
        if isinstance(r, int):
            err |= r
    t1.record()
    torch.cuda.synchronize()
    if err:
        _fail(f"a timed launch failed: cudaError {err}")
    return t0.elapsed_time(t1) / reps


def _kernel_ms(call, reps: int = MMA_REPS) -> dict:
    """A torch.profiler window over `reps` calls of `call`: each CUDA
    kernel's own device time per call and its launches per call, by name;
    {} where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == DeviceType.CUDA and us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0]
            out[name] = {"ms": us / 1e3 / reps, "per_call": ev.count / reps}
    return out


def _kernels_sum(call) -> float:
    """Device ms of one call of `call` as the sum of its kernels' times
    (_kernel_ms): for calls whose host work outlasts their kernels."""
    return sum(v["ms"] for v in _kernel_ms(call).values())


def _host_ms(call, reps: int = MMA_REPS) -> float:
    """Host time of one call: a host clock around `reps` calls with no
    synchronize between them, over reps."""
    import torch

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * wall / reps


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if clk.returncode != 0:
        _fail(f"nvidia-smi failed: {clk.stderr.strip()}")
    mhz = clk.stdout.strip().splitlines()[0]
    _CARD["sm_clock_hz"] = float(mhz.split()[0]) * 1e6
    _CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    if any(tf32.values()):
        _fail(f"TF32 is on: {tf32}")
    _line("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, tf32=tf32, sm_clock_max=mhz,
          sms=_CARD["sms"], sfu_rsqrt_per_s=_sfu_rate())
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


def _fma_times(fma, mma, reps: int, warmup: int = 3) -> dict:
    """Device-only ms of an FMA body's bare launcher (`ms`) and of the
    matmul body's at the same shape (`mma_ms`), each _device_ms."""
    return {"ms": _device_ms(fma, reps, warmup),
            "mma_ms": _device_ms(mma, reps, warmup)}


def _same_bits(fn) -> bool:
    """Two calls of `fn` (a wrapper call) give the same bits."""
    import torch

    got, again = fn(), fn()
    return all(torch.equal(x, y) for x, y in zip(got, again))


def phase_kernels():
    """Kernels 1 and 2's FMA bodies against their f64 plain versions at
    N_KERNEL (and kernel 1 at n = 8192, the hermite4 path's size), the same
    bits on a repeat, and their device-only times (bare launchers, events
    around back-to-back launches) beside the matmul bodies' at the same
    shapes and the f32 plain versions'; returns the per-kernel records of
    the final JSON line (shape, times and launches filled from phase 5b)."""
    import numpy as np
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.sim import init_cluster

    dev = torch.device("cuda")
    d = lambda t: t.double()
    errs, abs_err, times, same = {}, {}, {}, {}

    def hold(name, got, ref, kernel):
        for k, (g, r) in enumerate(zip(got, ref)):
            errs[f"{name}_{('acc', 'jerk', 'pot')[k]}"] = _rel_err(g, r)
            abs_err[kernel] = max(abs_err.get(kernel, 0.0), _abs_err(g, r))

    for n in (N_KERNEL, 8192):
        cfg = SimConfig(n=n, rc=1.0, seed=7, dtype="f32")
        state, _, cfg = init_cluster(cfg, device=dev)
        c = state.cluster
        pos, vel, mass, eps2 = c.pos, c.vel, c.mass, cfg.eps2
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        # the fused opening / closing sweep: jerk + raw potential
        full = dict(pot_eps2=1e-30)
        sweep = lambda **kw: cn.nbody_rows(pos, vel, ids, pos, vel, mass,
                                           eps2, **kw)
        a, j, p = sweep(**full)
        ref = cn.nbody_rows_plain(d(pos), d(vel), ids, d(pos), d(vel),
                                  d(mass), eps2, **full)
        hold(f"full{n}", (a, j, p), ref, "nbody_rows")
        same[f"full{n}"] = _same_bits(lambda: sweep(**full))
        reps = 20 if n == N_KERNEL else 50
        times[f"full{n}"] = _fma_times(
            cn.rows_launcher(pos, vel, ids, pos, vel, mass, eps2, **full)[0],
            cn.rows_mma_launcher(pos, vel, ids, pos, vel, mass, eps2,
                                 **full)[0], reps)
        times[f"full{n}"].update(_bound(n * (n - 1), True,
                                        _rows_bytes(n, n, True, True),
                                        rsqrt=2))
        if n != N_KERNEL:
            # a hermite4 substep's force evaluation: jerk, no potential
            force = dict(with_pot=False)
            a_f, j_f, _ = sweep(**force)
            hold(f"force{n}", (a_f, j_f), ref[:2], "nbody_rows")
            times[f"force{n}"] = _fma_times(
                cn.rows_launcher(pos, vel, ids, pos, vel, mass, eps2,
                                 **force)[0],
                cn.rows_mma_launcher(pos, vel, ids, pos, vel, mass, eps2,
                                     **force)[0], reps)
            continue
        times[f"full{n}"]["plain_ms"] = _median_ms(
            lambda: cn.nbody_rows_plain(pos, vel, ids, pos, vel, mass, eps2,
                                        **full), 3, warmup=1)
        # the leapfrog sweep: acceleration only
        lf = dict(with_jerk=False, with_pot=False)
        hold(f"acc{n}", sweep(**lf)[:1], ref[:1], "nbody_rows")
        times[f"acc{n}"] = _fma_times(
            cn.rows_launcher(pos, vel, ids, pos, vel, mass, eps2, **lf)[0],
            cn.rows_mma_launcher(pos, vel, ids, pos, vel, mass, eps2,
                                 **lf)[0], reps)
        # 256 scattered rows (the fast-group row sweep)
        rng = np.random.default_rng(3)
        sel = torch.as_tensor(rng.choice(n, 256, replace=False),
                              dtype=torch.int32, device=dev)
        rp, rv = pos[sel].contiguous(), vel[sel].contiguous()
        rows = lambda: cn.nbody_rows(rp, rv, sel, pos, vel, mass, eps2,
                                     with_pot=False)
        hold("rows256", rows()[:2],
             cn.nbody_rows_plain(d(rp), d(rv), sel, d(pos), d(vel), d(mass),
                                 eps2, with_pot=False)[:2], "nbody_rows")
        same["rows256"] = _same_bits(rows)
        times["rows256"] = _fma_times(
            cn.rows_launcher(rp, rv, sel, pos, vel, mass, eps2,
                             with_pot=False)[0],
            cn.rows_mma_launcher(rp, rv, sel, pos, vel, mass, eps2,
                                 with_pot=False)[0], 50)
        times["rows256"]["plain_ms"] = _median_ms(
            lambda: cn.nbody_rows_plain(rp, rv, sel, pos, vel, mass, eps2,
                                        with_pot=False), 5)
        # kernel 2: K = 256 fast rows against columns predicted to tau
        tau = torch.tensor(0.5 * cfg.dt, dtype=torch.float32, device=dev)
        pf, vf = cn.predict_columns(pos[sel], vel[sel], a[sel], j[sel], tau)
        pf = (pf + 1e-4 * torch.as_tensor(rng.normal(size=(256, 3)),
                                          dtype=torch.float32,
                                          device=dev)).contiguous()
        vf = vf.contiguous()
        cols = (pos, vel, a, j, mass)
        pred = lambda: cn.nbody_predcols(pf, vf, sel, *cols, tau, eps2)
        hold("pred256", pred(),
             cn.nbody_predcols_plain(d(pf), d(vf), sel, *map(d, cols),
                                     d(tau), eps2), "nbody_predcols")
        same["pred256"] = _same_bits(pred)
        times["pred256"] = _fma_times(
            cn.predcols_launcher(pf, vf, sel, *cols, tau, eps2)[0],
            cn.PredcolsMma(*cols, eps2).launcher(pf, vf, sel, tau)[0], 50)
        times["pred256"].update(_bound(256 * (n - 1), True,
                                       52 * 256 + 52 * n + 4))
        times["pred256"]["plain_ms"] = _median_ms(
            lambda: cn.nbody_predcols_plain(pf, vf, sel, *cols, tau, eps2),
            5)
        del state, c, pos, vel, mass, a, j, p, cols
    torch.cuda.synchronize()
    bars = {k: PREDCOLS_TOL if k.startswith("pred") else KERNEL_TOL
            for k in errs}
    _line("kernel fma", n=[N_KERNEL, 8192], rel_err=errs, tol=bars,
          max_abs_err=abs_err, repeat_same_bits=same, **times,
          gpairs_per_s=N_KERNEL * N_KERNEL
          / (times[f"full{N_KERNEL}"]["ms"] * 1e6))
    bad = {k: v for k, v in errs.items() if not v < bars[k]}
    if bad or not all(same.values()):
        _fail(f"kernels 1 / 2 against their plain versions: errors over "
              f"their bars {bad}, repeat same bits {same}")
    return [{"name": name, "route": "cuda",
             "source": "al26_tpu_torch/csrc/nbody.cu",
             "replaces": replaces, "launches": 0,
             "max_abs_err": abs_err[name]}
            for name, replaces in (
                ("nbody_rows", "al26_tpu/ops/pallas_nbody.py:78"),
                ("nbody_predcols", "al26_tpu/ops/pallas_nbody.py:539"))]


def _mma_timing(launch, wrapper, fma) -> dict:
    """A matmul body's times: `ms` the device time of the bare launcher
    `launch`, `kernels` its kernels' device times by name (profiler),
    `host_ms` the host time of a `wrapper` call, `host_launch_ms` that of
    the bare launcher (one ctypes call and the launch); beside it the FMA body's
    on the same inputs (`fma`, a wrapper call): its device time over
    back-to-back calls and its kernels by name."""
    return {"ms": _device_ms(launch), "kernels": _kernel_ms(launch),
            "host_ms": _host_ms(wrapper), "host_launch_ms": _host_ms(launch),
            "fma_ms": _device_ms(fma), "fma_kernels": _kernel_ms(fma)}


def _time_pred_mma(pf, vf, sel, pos, vel, a0, j0, mass, tau, eps2) -> dict:
    """_mma_timing for kernel 2c on rows (pf, vf, ids sel) against the
    step-start columns: the bare launcher of one substep, and the host
    time of one substep's call (make_pred_force_rows's rows_at, made once
    as a step makes it). The FMA body's device time is its kernels' sum
    by the profiler: a wrapper call's host work outlasts its kernels. The
    host time splits into the bare launch (`host_launch_ms`), the plan's
    call (`host_plan_ms`: checks, two output allocations, the launch) and
    one output allocation (`host_empty_ms`)."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn

    plan = cn.PredcolsMma(pos, vel, a0, j0, mass, eps2)
    launch, _ = plan.launcher(pf, vf, sel, tau)
    rows_at = cn.make_pred_force_rows(pos, vel, a0, j0, mass, eps2)
    fma = lambda: cn.nbody_predcols(pf, vf, sel, pos, vel, a0, j0, mass,
                                    tau, eps2)
    k, n = pf.shape[0], pos.shape[0]
    # rows: positions, velocities, ids in, acc and jerk out (52 bytes);
    # columns: step-start pos, vel, acc, jerk and mass (52 bytes)
    return {"k": k, "n": n, **_bound_mma(k * (n - 1), True, False,
                                         52 * k + 52 * n + 4),
            "ms": _device_ms(launch),
            "kernels": _kernel_ms(launch),
            "host_ms": _host_ms(lambda: rows_at(pf, vf, sel, tau)),
            "host_launch_ms": _host_ms(launch),
            "host_plan_ms": _host_ms(lambda: plan(pf, vf, sel, tau)),
            "host_empty_ms": _host_ms(lambda: torch.empty(
                (k, 3), dtype=torch.float32, device=pos.device)),
            "fma_ms": _kernels_sum(fma), "fma_kernels": _kernel_ms(fma)}


def phase_kernel_mma():
    """The matmul reductions (use_mxu=True, the default of every
    single-cluster sweep) against their f64 plain versions, the same
    decomposition in f64: kernel 1's full sweep with jerk and the raw
    potential at N_KERNEL and N_NEAR, the uncached sweep at eps2 = 0.125
    (potential through the product), the acceleration-only sweep and 256
    scattered rows at N_KERNEL, kernel 2 at K = 256 and tau != 0. The same
    bits on a repeat; median times beside the FMA body's and the f32 plain
    version's at the same shapes. Returns the kernels-line records of rows
    1c and 2c (launches filled from phase 6b)."""
    import numpy as np
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.sim import init_cluster

    dev = torch.device("cuda")
    d = lambda t: t.double()
    errs, times = {}, {}
    abs_err = {"nbody_rows_mma": 0.0, "nbody_predcols_mma": 0.0}
    repeat_same = True

    def hold(name, fn, ref_fn, bars, kernel="nbody_rows_mma"):
        """Run fn twice (same bits?), hold it against ref_fn's f64
        result, per output, at bars (None: not compared); the largest
        absolute error goes to `kernel`'s record."""
        nonlocal repeat_same
        got, again = fn(), fn()
        repeat_same &= all(torch.equal(x, y) for x, y in zip(got, again))
        ref = ref_fn()
        for out, g, r, bar in zip(("acc", "jerk", "pot"), got, ref, bars):
            if bar is not None:
                errs[f"{name}_{out}"] = (_rel_err(g, r), bar)
                abs_err[kernel] = max(abs_err[kernel], _abs_err(g, r))

    for n in (N_KERNEL, N_NEAR):
        cfg = SimConfig(n=n, rc=1.0, seed=7, dtype="f32")
        state, _, cfg = init_cluster(cfg, device=dev)
        c = state.cluster
        pos, vel, mass, eps2 = c.pos, c.vel, c.mass, cfg.eps2
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        full = dict(pot_eps2=1e-30)

        def sweep(mxu, p=pos, v=vel, m=mass, **kw):
            return lambda: cn.nbody_rows(p, v, ids, p, v, m, eps2,
                                         use_mxu=mxu, **{**full, **kw})

        hold(f"full{n}", sweep(True),
             lambda: cn.nbody_rows_plain(d(pos), d(vel), ids, d(pos), d(vel),
                                         d(mass), eps2, use_mxu=True, **full),
             (MMA_TOL, MMA_TOL, KERNEL_TOL))
        launch, _ = cn.rows_mma_launcher(pos, vel, ids, pos, vel, mass,
                                         eps2, **full)
        times[f"full{n}"] = _mma_timing(launch, sweep(True), sweep(False))
        if n != N_KERNEL:
            continue
        times[f"full{n}_plain_f32_ms"] = _median_ms(
            lambda: cn.nbody_rows_plain(pos, vel, ids, pos, vel, mass, eps2,
                                        use_mxu=True, **full), 3, warmup=1)
        # the uncached sweep: the potential through the product
        prod = lambda mxu: (lambda: cn.nbody_rows(
            pos, vel, ids, pos, vel, mass, 0.125, use_mxu=mxu))
        hold("uncached", prod(True),
             lambda: cn.nbody_rows_plain(d(pos), d(vel), ids, d(pos), d(vel),
                                         d(mass), 0.125, use_mxu=True),
             (MMA_TOL, MMA_TOL, MMA_POT_TOL))
        times["uncached_ms"] = _device_ms(prod(True))
        times["uncached_fma_ms"] = _device_ms(prod(False))
        # the acceleration-only sweep (leapfrog)
        accf = lambda mxu: sweep(mxu, with_jerk=False, with_pot=False,
                                 pot_eps2=None)
        hold("acc", accf(True),
             lambda: cn.nbody_rows_plain(d(pos), d(vel), ids, d(pos), d(vel),
                                         d(mass), eps2, with_jerk=False,
                                         with_pot=False, use_mxu=True),
             (MMA_TOL, None, None))
        times["acc_ms"] = _device_ms(accf(True))
        times["acc_fma_ms"] = _device_ms(accf(False))
        # 256 scattered rows (the fast-group row sweep)
        rng = np.random.default_rng(3)
        sel = torch.as_tensor(rng.choice(n, 256, replace=False),
                              dtype=torch.int32, device=dev)
        rp, rv = pos[sel].contiguous(), vel[sel].contiguous()
        rows = lambda mxu: (lambda: cn.nbody_rows(
            rp, rv, sel, pos, vel, mass, eps2, with_pot=False,
            use_mxu=mxu))
        hold("rows256", rows(True),
             lambda: cn.nbody_rows_plain(d(rp), d(rv), sel, d(pos), d(vel),
                                         d(mass), eps2, with_pot=False,
                                         use_mxu=True),
             (MMA_TOL, MMA_TOL, None))
        times["rows256_ms"] = _kernels_sum(rows(True))
        times["rows256_fma_ms"] = _kernels_sum(rows(False))
        # kernel 2: K = 256 rows against columns predicted to tau
        a0, j0, _ = cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2)
        tau = torch.tensor(0.5 * cfg.dt, dtype=torch.float32, device=dev)
        pf, vf = cn.predict_columns(pos[sel], vel[sel], a0[sel], j0[sel],
                                    tau)
        pf = (pf + 1e-4 * torch.as_tensor(rng.normal(size=(256, 3)),
                                          dtype=torch.float32,
                                          device=dev)).contiguous()
        vf = vf.contiguous()
        pred = lambda mxu: (lambda: cn.nbody_predcols(
            pf, vf, sel, pos, vel, a0, j0, mass, tau, eps2, use_mxu=mxu))
        times["predcols256"] = _time_pred_mma(pf, vf, sel, pos, vel, a0, j0,
                                              mass, tau, eps2)
        hold("predcols256", pred(True),
             lambda: cn.nbody_predcols_plain(d(pf), d(vf), sel, d(pos),
                                             d(vel), d(a0), d(j0), d(mass),
                                             d(tau), eps2, use_mxu=True),
             (PRED_MMA_TOL, PRED_MMA_TOL), kernel="nbody_predcols_mma")
        times["predcols256_plain_f32_ms"] = _median_ms(
            lambda: cn.nbody_predcols_plain(pf, vf, sel, pos, vel, a0, j0,
                                            mass, tau, eps2, use_mxu=True), 5)
    torch.cuda.synchronize()
    bad = {k: v for k, (v, bar) in errs.items() if not v < bar}
    _line("kernel mma", n=[N_KERNEL, N_NEAR],
          rel_err={k: v for k, (v, _) in errs.items()},
          tol={k: bar for k, (_, bar) in errs.items()},
          max_abs_err=abs_err, repeat_same_bits=repeat_same, **times,
          mma_over_fma_full=times[f"full{N_KERNEL}"]["ms"]
          / times[f"full{N_KERNEL}"]["fma_ms"])
    if bad or not repeat_same:
        _fail(f"matmul kernels: errors over their bars {bad}, repeat same "
              f"bits {repeat_same}")
    rec_rows = {"name": "nbody_rows_mma", "route": "cuda",
                "source": "al26_tpu_torch/csrc/nbody.cu",
                "replaces": "al26_tpu/ops/pallas_nbody.py:209",
                "launches": 0, "max_abs_err": abs_err["nbody_rows_mma"],
                "ms": times[f"full{N_KERNEL}"]["ms"],
                "host_ms": times[f"full{N_KERNEL}"]["host_ms"],
                "plain_ms": times[f"full{N_KERNEL}_plain_f32_ms"],
                **_bound_mma(N_KERNEL * (N_KERNEL - 1), True, True,
                             _rows_bytes(N_KERNEL, N_KERNEL, True, True)),
                "library_ms": None}
    rec_pred = {"name": "nbody_predcols_mma", "route": "cuda",
                "source": "al26_tpu_torch/csrc/nbody.cu",
                "replaces": "al26_tpu/ops/pallas_nbody.py:632",
                "launches": 0,
                "max_abs_err": abs_err["nbody_predcols_mma"],
                "ms": times["predcols256"]["ms"],
                "host_ms": times["predcols256"]["host_ms"],
                "plain_ms": times["predcols256_plain_f32_ms"],
                **{b: times["predcols256"][b]
                   for b in ("bound_ms", "bound_by", "bound_pipe")},
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
        if dev == "cuda" and not (launched["nbody_rows_mma"] > 0
                                  and launched["nbody_predcols_mma"] > 0):
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
        substeps = (launches["nbody_rows_mma"] - 1) / steps
    else:
        substeps = launches["nbody_predcols_mma"] / steps

    checks, host = _state_checks(state, cfg, steps)
    checks["rows_mma_launched"] = launches["nbody_rows_mma"] > 0
    checks["predcols_mma_launched"] = (integ != "hermite4_block"
                                       or launches["nbody_predcols_mma"] > 0)
    checks["fma_bodies_idle"] = not (launches["nbody_rows"]
                                     or launches["nbody_predcols"])
    sim_myr = steps * cfg.dt
    _line("slice", n=n, integrator=integ, k_fast=cfg.k_fast,
          init_s=t_init, wall_s=wall, s_per_myr=wall / sim_myr,
          substeps_per_step=substeps, launches=launches,
          wind_total=float(host["slr"][:, :, 0:2].sum()), checks=checks)
    if not all(checks.values()):
        _fail(f"n={n}: {[k for k, v in checks.items() if not v]} failed")
    return wall / sim_myr


def _host_invariants(host) -> dict:
    """The physics invariants of a cluster as a numpy dict: finite
    positions / velocities / reservoirs, non-negative reservoirs, wind only
    on disc stars (0.1-3 Msun, not the interloper)."""
    import numpy as np

    lm = (host["mass"] >= 0.1) & (host["mass"] <= 3.0)
    lm &= ~host["is_interloper"]
    wind_off_disc = np.any(host["slr"][:, :, 0:2] != 0.0, axis=(1, 2)) & ~lm
    return {"finite": bool(np.isfinite(host["pos"]).all()
                           and np.isfinite(host["vel"]).all()
                           and np.isfinite(host["slr"]).all()),
            "slr_nonneg": bool((host["slr"] >= 0).all()),
            "wind_on_discs_only": not bool(wind_off_disc.any())}


def _state_checks(state, cfg, steps: int):
    """The checks of a run of `steps` steps on the card: every state
    tensor still on the card, time == steps * dt exactly, the step count,
    and _host_invariants. Returns (checks, the cluster as numpy)."""
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
    checks = {"time": float(state.time) == float(want_t),
              "step_count": int(state.step_count) == steps,
              **_host_invariants(host)}
    return checks, host


def _reset_launches() -> None:
    from al26_tpu_torch.ops import cuda_nbody, cuda_tree

    for counts in (cuda_nbody.LAUNCHES, cuda_tree.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    from al26_tpu_torch.ops import cuda_nbody, cuda_tree

    return {**cuda_nbody.LAUNCHES, **cuda_tree.LAUNCHES}


def _near_check(tree, p2p, n: int, cfg, reps: int = 20) -> dict:
    """Kernel 3 (jerk and the raw potential, the tree sweep's mode) on one
    tree's MAC-failing pairs: against its f64 plain version, a repeat for
    the same bits, its device time per launch (_device_ms around `reps`
    back-to-back launches of the bare launcher: the work items and the
    ordered sum), a wrapper call's device time (the item table's torch
    work and the launch), one f32 plain call's time, the pair classes,
    runs and bound (_near_stats, _near_bound), and the swept pairs of the
    item table on the card and on a CPU copy of the mask."""
    import torch

    from al26_tpu_torch.ops import cuda_tree as ct

    leaf, kavg, eps2 = cfg.tree_leaf, cfg.tree_kavg, cfg.eps2
    kw = dict(leaf=leaf, kavg=kavg, pot_eps2=1e-30, with_jerk=True)
    launch, out = ct.near_field_launcher(tree.pos_s, tree.mass_s, p2p, n,
                                         eps2, vel_s=tree.vel_s, **kw)
    err = launch()
    torch.cuda.synchronize()
    if err:
        _fail(f"near_field launch failed: cudaError {err}")
    got = [x.clone() for x in out[:3]]
    launch()
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(got, out[:3]))
    d = lambda t: t.double()
    ref = ct.near_field_plain(d(tree.pos_s), d(tree.mass_s), p2p, n, eps2,
                              vel_s=d(tree.vel_s), **kw)
    stats = _near_stats(p2p, n, leaf)
    kept_card = int(ct.near_items(p2p, kavg, n, leaf).kept.sum())
    kept_cpu = int(ct.near_items(p2p.cpu(), kavg, n, leaf).kept.sum())
    wrapper = lambda: ct.near_field(tree.pos_s, tree.mass_s, p2p, n, eps2,
                                    vel_s=tree.vel_s, **kw)
    plain = lambda: ct.near_field_plain(tree.pos_s, tree.mass_s, p2p, n,
                                        eps2, vel_s=tree.vel_s, **kw)
    ms = _device_ms(launch, reps=reps)
    return {"n": n, "leaf": leaf, "kavg": kavg, "eps2": eps2,
            "item_pairs": ct.ITEM_PAIRS,
            "rel_err": {k: _rel_err(g, r) for k, g, r in
                        zip(("acc", "jerk", "pot"), got, ref[:3])},
            "max_abs_err": max(_abs_err(g, r) for g, r in zip(got, ref[:3])),
            "tol": KERNEL_TOL, "overflow": bool(out[3]),
            "repeat_same_bits": same_bits, "ms": ms,
            "wrapper_ms": _device_ms(wrapper, reps=reps),
            "plain_f32_ms": _median_ms(plain, 1, warmup=0),
            "kept_pairs_card": kept_card, "kept_pairs_cpu": kept_cpu,
            "gpairs_per_s": stats["needed_interactions"] / (ms * 1e6),
            **stats, **_near_bound(stats, leaf)}


def phase_near_field():
    """Kernel 3 on a fractal cluster of N_NEAR stars (the tree and pair
    list the tree slice would build): _near_check and the overflow flag
    at kavg = 1; returns the kernels-line record (the slice's shape fills
    its times and bound, phase 5b)."""
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
    tree = tt.build_block_tree(c.pos, c.mass, cfg.tree_leaf, c.vel)
    _, p2p = tt.mac_masks(tree, cfg.tree_theta)
    rec = _near_check(tree, p2p, N_NEAR, cfg)
    overflow_kavg1 = bool(ct.near_field(
        tree.pos_s, tree.mass_s, p2p, N_NEAR, cfg.eps2, leaf=cfg.tree_leaf,
        kavg=1, pot_eps2=1e-30, vel_s=tree.vel_s, with_jerk=True)[3])
    _line("kernel near_field", **rec, overflow_at_kavg1=overflow_kavg1)
    bad = {k: v for k, v in rec["rel_err"].items() if not v < KERNEL_TOL}
    if (bad or rec["overflow"] or not overflow_kavg1
            or not rec["repeat_same_bits"]
            or rec["kept_pairs_card"] != rec["kept_pairs"]
            or rec["kept_pairs_cpu"] != rec["kept_pairs"]):
        _fail(f"near_field: errors {bad}, overflow {rec['overflow']}, "
              f"overflow at kavg=1 {overflow_kavg1}, repeat same bits "
              f"{rec['repeat_same_bits']}, kept pairs card / cpu / mask "
              f"{rec['kept_pairs_card']} / {rec['kept_pairs_cpu']} / "
              f"{rec['kept_pairs']}")
    return {"name": "near_field", "route": "cuda",
            "source": "al26_tpu_torch/csrc/tree.cu",
            "replaces": "al26_tpu/ops/pallas_tree.py:63",
            "launches": 0, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_f32_ms"],
            **{k: rec[k] for k in ("bound_ms", "bound_by", "bound_pipe")},
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
                                  and launched["nbody_predcols_mma"] > 0):
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


def _fast_rows(c, a0, j0, cfg):
    """The subcycle's rows at a tree slice's state: the k_fast stars of
    largest |a| predicted from the force cache to dt / 2; returns (pf, vf,
    ids, tau)."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn

    sel = torch.topk(a0.norm(dim=1), cfg.k_fast).indices.to(torch.int32)
    tau = torch.tensor(0.5 * cfg.dt, dtype=torch.float32, device=a0.device)
    pf, vf = cn.predict_columns(c.pos[sel], c.vel[sel], a0[sel], j0[sel],
                                tau)
    return pf.contiguous(), vf.contiguous(), sel, tau


def _pred_mma_check(pf, vf, sel, pos, vel, a0, j0, mass, tau,
                    eps2) -> dict:
    """Kernel 2c at a main path's shape (the tree slice's K = k_fast rows
    against all N columns) against its f64 plain version, twice (the same
    bits?), and its times (_time_pred_mma)."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn

    d = lambda t: t.double()
    run = lambda: cn.nbody_predcols(pf, vf, sel, pos, vel, a0, j0, mass, tau,
                                    eps2, use_mxu=True)
    got, again = run(), run()
    ref = cn.nbody_predcols_plain(d(pf), d(vf), sel, d(pos), d(vel), d(a0),
                                  d(j0), d(mass), d(tau), eps2, use_mxu=True)
    return {"rel_err": {k: _rel_err(g, r)
                        for k, g, r in zip(("acc", "jerk"), got, ref)},
            "max_abs_err": max(_abs_err(g, r) for g, r in zip(got, ref)),
            "tol": PRED_MMA_TOL, "k": pf.shape[0], "n": pos.shape[0],
            "repeat_same_bits": all(torch.equal(x, y)
                                    for x, y in zip(got, again)),
            "timing": _time_pred_mma(pf, vf, sel, pos, vel, a0, j0, mass,
                                     tau, eps2)}


def _main_path_kernel_checks(state, cache, cfg) -> dict:
    """Each kernel against its f64 plain version at the shapes the N_TREE
    tree slice gives it, on the slice's state after its last step:

      near_field      the state's tree and pair list (theta, leaf,
                      tree_kavg; jerk and the raw potential), every
                      target block (_near_check: also its device time,
                      pair classes, runs and bound at this shape);
      nbody_predcols  K = k_fast rows (the largest |a|) against all N
                      columns predicted from the force cache to dt / 2,
                      the FMA body and the matmul one the path runs;
      nbody_rows      the fractal virial sum's sweep (eps2 = 1e-30,
                      potential) over all N stars, on 2048 random rows.

    Kernels 1 and 2 (FMA bodies) also: the same bits on a repeat, device-
    only times beside the matmul body's at the same shape (_fma_times), the
    f32 plain version's and the bound. Returns {kernel: {"rel_err": {...},
    "max_abs_err": x, "tol": bar, ...}}."""
    import numpy as np
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn
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

    tree = tt.build_block_tree(c.pos, c.mass, cfg.tree_leaf, c.vel)
    _, p2p = tt.mac_masks(tree, cfg.tree_theta)
    out = {"near_field": _near_check(tree, p2p, n, cfg)}

    a0, j0 = cache[0], cache[1]
    pf, vf, sel, tau = _fast_rows(c, a0, j0, cfg)
    cols = (c.pos, c.vel, a0, j0, c.mass)
    pred = lambda: cn.nbody_predcols(pf, vf, sel, *cols, tau, cfg.eps2)
    ref = cn.nbody_predcols_plain(d(pf), d(vf), sel, *map(d, cols), d(tau),
                                  cfg.eps2)
    k = pf.shape[0]
    out["nbody_predcols"] = record(
        ("acc", "jerk"), pred(), ref, PREDCOLS_TOL, k=k, n=n,
        repeat_same_bits=_same_bits(pred),
        **_fma_times(cn.predcols_launcher(pf, vf, sel, *cols, tau,
                                          cfg.eps2)[0],
                     cn.PredcolsMma(*cols, cfg.eps2).launcher(pf, vf, sel,
                                                              tau)[0], 50),
        plain_f32_ms=_median_ms(lambda: cn.nbody_predcols_plain(
            pf, vf, sel, *cols, tau, cfg.eps2), 3, warmup=1),
        **_bound(k * (n - 1), True, 52 * k + 52 * n + 4))
    out["nbody_predcols_mma"] = _pred_mma_check(
        pf, vf, sel, c.pos, c.vel, a0, j0, c.mass, tau, cfg.eps2)

    zeros = torch.zeros_like(c.pos)
    virial = lambda: cn.kernel_acc_jerk_pot(c.pos, zeros, c.mass, 1e-30,
                                            with_jerk=False, use_mxu=False)
    a1, _, p1 = virial()
    rows = torch.as_tensor(np.sort(rng.choice(n, 2048, replace=False)),
                           dtype=torch.int32, device=dev)
    ar, _, pr = cn.nbody_rows_plain(d(c.pos[rows]), d(zeros[rows]), rows,
                                    d(c.pos), d(zeros), d(c.mass), 1e-30,
                                    with_jerk=False)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    sweep = (c.pos, zeros, ids, c.pos, zeros, c.mass, 1e-30)
    out["nbody_rows"] = record(
        ("acc", "pot"), (a1[rows], p1[rows]), (ar, pr), KERNEL_TOL,
        rows=2048, n=n, eps2=1e-30, repeat_same_bits=_same_bits(virial),
        **_fma_times(cn.rows_launcher(*sweep, with_jerk=False)[0],
                     cn.rows_mma_launcher(*sweep, with_jerk=False)[0], 5,
                     warmup=1),
        plain_f32_ms=_median_ms(lambda: cn.nbody_rows_plain(
            *sweep, with_jerk=False), 1, warmup=0),
        **_bound(n * (n - 1), False, _rows_bytes(n, n, False, True)))
    torch.cuda.synchronize()
    return out


def phase_tree_pred_mma():
    """Kernel 2c at the tree slice's shape (K = k_fast = 512 rows against
    N_TREE fractal columns) on the step-start state of a fresh run
    (init_cluster, fresh_cache): `--mma`'s stand-in for phase 5b's check,
    which holds the state after 10 steps."""
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.sim import init_cluster
    from al26_tpu_torch.sim.step import fresh_cache

    cfg = SimConfig(n=N_TREE, model="fractal", rc=1.0, seed=42, dtype="f32",
                    force_impl="tree")
    state, _, cfg = init_cluster(cfg, device=torch.device("cuda"))
    cache = fresh_cache(state, cfg, cfg.integrator, None, "tree")
    c = state.cluster
    pf, vf, sel, tau = _fast_rows(c, cache[0], cache[1], cfg)
    rec = _pred_mma_check(pf, vf, sel, c.pos, c.vel, cache[0], cache[1],
                          c.mass, tau, cfg.eps2)
    _line("kernel mma tree", **rec)
    if not (all(v < rec["tol"] for v in rec["rel_err"].values())
            and rec["repeat_same_bits"]):
        _fail(f"nbody_predcols_mma at K = {cfg.k_fast}, N = {N_TREE}: "
              f"{rec['rel_err']}, repeat same bits "
              f"{rec['repeat_same_bits']}")


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
    # kernel 1's FMA body: the fractal virial sum at init
    for k in ("near_field", "nbody_rows", "nbody_predcols_mma"):
        checks[k + "_launched"] = launches[k] > 0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # after the counts are read: these launches compare, they do not count
    kernel_checks = _main_path_kernel_checks(state, cache, cfg)
    for k, rec in kernel_checks.items():
        checks[k + "_matches_plain"] = all(
            v < rec["tol"] for v in rec["rel_err"].values())
    for k in ("nbody_rows", "nbody_predcols", "nbody_predcols_mma"):
        checks[k + "_repeat_same_bits"] = kernel_checks[k][
            "repeat_same_bits"]
    near = kernel_checks["near_field"]
    checks["near_field_no_overflow"] = not near["overflow"]
    checks["near_field_repeat_same_bits"] = near["repeat_same_bits"]
    checks["near_field_kept_pairs_match_cpu"] = (
        near["kept_pairs_card"] == near["kept_pairs_cpu"]
        == near["kept_pairs"])
    breakdown = _sweep_breakdown(state, cfg)
    _line("tree slice", n=N_TREE, integrator=cfg.integrator,
          k_fast=cfg.k_fast, theta=cfg.tree_theta, leaf=cfg.tree_leaf,
          tree_kavg=cfg.tree_kavg, init_s=t_init, wall_s=wall,
          s_per_myr=wall / (steps * cfg.dt),
          wall_per_step_ms=1e3 * wall / steps,
          substeps_per_step=step_launches["nbody_predcols_mma"] / steps,
          near_field_per_step=step_launches["near_field"] / steps,
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
    rchecks["seeding_sweep_nbody_rows_mma"] = rlaunch["nbody_rows_mma"] > 0
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
    closing sweep), 512 scattered rows across the groups; the same bits on
    a repeat; each mode's device time per launch (_device_ms around 50
    back-to-back launches of the bare launcher, cuda_nbody.rows_launcher:
    the sweep and its ordered split sum) beside its bound from the
    useful pairs; returns the kernels-line record (launches filled from
    phase 5c)."""
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
            launch, _ = cn.rows_launcher(pos, vel, ids, pos, vel, mass, eps2,
                                         **mk, **kw)
            times[mode + "_ms"] = _device_ms(launch)
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
        launch, _ = cn.rows_launcher(rp, rv, sel, pos, vel, mass, eps2,
                                     with_pot=False, **kw)
        times["rows512_ms"] = _device_ms(launch)
        mk = modes["acc_pot"]
        t_plain = _median_ms(lambda: cn.nbody_rows_plain(
            pos, vel, ids, pos, vel, mass, eps2, **mk, **kw), 3, warmup=1)
        pairs = b * n * (n - 1)
        bound = _bound(pairs, False, _rows_bytes(total, total, False, True),
                       rsqrt=2)
        bounds = {"jerk_pot": _bound(pairs, True, _rows_bytes(
                      total, total, True, True), rsqrt=2)["bound_ms"],
                  "acc": _bound(pairs, False, _rows_bytes(
                      total, total, False, False))["bound_ms"],
                  "acc_pot": bound["bound_ms"],
                  "rows512": _bound(512 * (n - 1), True, _rows_bytes(
                      512, total, True, False))["bound_ms"]}
        _line("kernel nbody_rows_group", realizations=b, n=n, eps2=eps2,
              groups_spanned_by_rows=int(torch.unique(
                  sel.long() // n).numel()),
              rel_err={**errs, **errs_rows},
              tol={"full": KERNEL_TOL, "rows": PREDCOLS_TOL},
              max_abs_err=abs_err, **times, acc_pot_plain_f32_ms=t_plain,
              useful_gpairs_per_s=pairs / (times["acc_pot_ms"] * 1e6),
              bound_ms_by_mode=bounds, **bound)
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
          launches=launches,
          group_launches_per_step=launches["nbody_rows_group"] / steps,
          peak_mem_gb=peak_gb,
          final_sweep_rel_err=final_err,
          wind_total=float(c.slr[:, :, :, 0:2].sum()), checks=checks)
    if not all(checks.values()):
        _fail(f"ensemble {b}x{n}: "
              f"{[k for k, v in checks.items() if not v]} failed")
    return launches


def _file_state(path: str):
    """A saved state file as the cluster's numpy dict and its time."""
    from al26_tpu_torch.io.checkpoint import load_state
    from al26_tpu_torch.io.compat import particles_to_cluster
    from al26_tpu_torch.state import cluster_to_numpy
    from al26_tpu_torch.units import myr

    st = load_state(path)
    host = cluster_to_numpy(particles_to_cluster(st.cluster, device="cpu"))
    return host, float(st.metadata.time.value_in(myr))


def _parity(g, r) -> dict:
    """Two final states against each other at the bars of phase 4."""
    import numpy as np

    return {"pos_err_over_bar": float(np.max(
                np.abs(g["pos"] - r["pos"]) / (2e-5 + 2e-4 * np.abs(r["pos"])))),
            "slr_err_over_bar": float(np.max(
                np.abs(g["slr"] - r["slr"]) / (1e-30 + 2e-3 * np.abs(r["slr"])))),
            "mass_exact": bool(np.array_equal(g["mass"], r["mass"])),
            "fields_not_bit_equal": sorted(
                k for k in g if not np.array_equal(g[k], r[k]))}


def phase_cli():
    """The CLI as a user runs it, in a subprocess in a temporary
    directory: n = 1000, t_f = 1 Myr (1000 steps, the reference cadence of
    saves), f32; the files, their counts, the wall time and s/Myr with
    the saves, the invariants of the last state; then a resume from
    checkpoint 50 to the end, whose final state is held against the
    uninterrupted run's at the bars of phase 4."""
    import glob
    import tempfile

    tmp = tempfile.mkdtemp(prefix="al26-cli-")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    cli = [sys.executable, "-m", "al26_tpu_torch.cli"]
    args = ["-n", "1000", "-rc", "1", "-t_f", "1", "--dtype", "f32",
            "--seed", "42", "-f", "smoke", "-v"]

    def call(extra):
        t0 = time.perf_counter()
        r = subprocess.run(cli + extra, cwd=tmp, env=env,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            _fail(f"the CLI exited {r.returncode}: {r.stderr[-2000:]}")
        return r.stdout, wall

    def timings(out):
        """run()'s wall time and phase totals from the -v output."""
        got = {}
        for ln in out.splitlines():
            parts = ln.split()
            if ln.startswith("wall time:"):
                got["run_s"] = float(parts[2])
            elif len(parts) > 2 and parts[1] == "total":
                got[parts[0] + "_s"] = float(parts[2])
        return got

    out, wall = call(args)
    run_t = timings(out)
    states = sorted(glob.glob(os.path.join(tmp, "smoke-state-*.pkl.zst")))
    with open(os.path.join(tmp, "smoke-cluster-yields.csv")) as fh:
        csv_rows = len(fh.readlines()) - 1
    final, t_final = _file_state(states[-1])
    checks = {"time": abs(t_final - 1.0) <= 1e-6, **_host_invariants(final)}
    checks.update({
        "state_files": len(states) == 102,
        "csv_rows": csv_rows == 102,
        "yields_blob": os.path.exists(os.path.join(tmp,
                                                   "smoke-yields.ubj.zst")),
        "yields_frames": os.path.exists(os.path.join(tmp,
                                                     "smoke-yields.ubjf")),
        "writer_line": "# checkpoint writer:" in out,
    })
    out_r, wall_r = call(["-r", "smoke", "-nc", "50", "-v"])
    resumed, t_res = _file_state(states[-1])
    par = _parity(resumed, final)
    checks["resumed_time"] = abs(t_res - 1.0) <= 1e-6
    checks["resume_parity"] = (par["pos_err_over_bar"] <= 1.0
                               and par["slr_err_over_bar"] <= 1.0
                               and par["mass_exact"])
    writer = [ln for ln in out.splitlines() if "checkpoint writer" in ln]
    _line("cli", n=1000, steps=1000, t_f=1.0, dir=tmp,
          writer=writer[0] if writer else None,
          state_files=len(states), csv_rows=csv_rows,
          state_file_bytes=os.path.getsize(states[-1]),
          command_s=wall, **run_t,
          s_per_myr_with_saves=run_t.get("run_s", wall) / 1.0,
          resume_command_s=wall_r, resume=timings(out_r), **par,
          checks=checks)
    if not all(checks.values()):
        _fail(f"cli: {[k for k, v in checks.items() if not v]} failed")


def phase_driver(slice_s_per_myr: float):
    """sim.driver.run in process at N = 32768 (20 steps at the default dt,
    a save after steps 1 and 11 and at the end, plus #0): the launches of
    the matmul kernels (counts set to 0 just before the run, read just
    after), s/Myr with the saves beside phase 5's without them
    (`slice_s_per_myr`), the seconds in the saves, the files and the
    invariants. Returns the launches."""
    import glob
    import tempfile

    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.sim import driver

    tmp = tempfile.mkdtemp(prefix="al26-driver-")
    base = os.path.join(tmp, "drv")
    cfg = SimConfig(n=N_KERNEL, rc=1.0, dtype="f32", final_time=0.2,
                    n_plot=2, steps_per_plot=10, seed=42, filename=base)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = driver.run(cfg, progress=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    steps = 20
    checks, _ = _state_checks(res.state, res.cfg, steps)
    states = sorted(glob.glob(base + "-state-*.pkl.zst"))
    checks.update({
        "state_files": len(states) == 4,
        "rows_mma_launched": launches["nbody_rows_mma"] > 0,
        "predcols_mma_launched": launches["nbody_predcols_mma"] > 0,
        "fma_bodies_idle": not (launches["nbody_rows"]
                                or launches["nbody_predcols"]),
    })
    ph = res.phase_seconds
    _line("driver", n=N_KERNEL, integrator=res.cfg.integrator, steps=steps,
          wall_s=wall, run_s=res.wall_time_s,
          s_per_myr_with_saves=wall / (steps * res.cfg.dt),
          phase5_s_per_myr=slice_s_per_myr,
          physics_s=ph.get("physics"), checkpoint_s=ph.get("checkpoint"),
          writer_thread_s=ph.get("writer"),
          saves_share=ph.get("checkpoint", 0.0) / wall,
          state_file_bytes=os.path.getsize(states[-1]), launches=launches,
          checks=checks)
    if not all(checks.values()):
        _fail(f"driver: {[k for k, v in checks.items() if not v]} failed")
    return launches


def phase_ensemble_driver():
    """sim.driver.run_ensemble: 64 realizations of N = 1000, 20 steps,
    f32, into the pt-grid layout of a temporary root; the 64 folders and
    their files, s/Myr with the saves, the launches, the invariants."""
    import glob
    import tempfile

    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.parallel.ensemble import _take
    from al26_tpu_torch.sim import driver

    tmp = tempfile.mkdtemp(prefix="al26-ens-")
    b, steps = 64, 20
    cfg = SimConfig(n=1000, rc=1.0, dtype="f32", final_time=0.2, n_plot=2,
                    steps_per_plot=10, seed=42, ensemble=b)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs, dirs, _ = driver.run_ensemble(cfg, progress=False, root=tmp,
                                      device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    rcfg = cfg.replace(integrator="leapfrog")
    checks = {}
    for k in range(b):
        ck, _ = _state_checks(_take(bs, k), rcfg, steps)
        for name, ok in ck.items():
            checks[name] = checks.get(name, True) and ok
    counts = [len(glob.glob(os.path.join(d, "pt-*-state-*.pkl.zst")))
              for d in dirs]
    checks["pt_dirs"] = len(dirs) == b and all(
        os.path.basename(d) == f"pt-{k}" for k, d in enumerate(dirs))
    checks["state_files"] = counts == [4] * b
    checks["rows_group_launched"] = launches["nbody_rows_group"] > 0
    _line("ensemble driver", realizations=b, n=1000, steps=steps,
          wall_s=wall, s_per_myr_with_saves=wall / (steps * cfg.dt),
          layout=os.path.relpath(dirs[0], tmp), launches=launches,
          checks=checks)
    if not all(checks.values()):
        _fail(f"ensemble driver: {[k for k, v in checks.items() if not v]}"
              " failed")


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
    if sys.argv[1:] == ["--mma"]:
        phase_kernel_mma()
        phase_tree_pred_mma()
        return 0
    records = phase_kernels()
    mma = phase_kernel_mma()
    records.append(phase_near_field())
    group = phase_group_kernel()
    phase_parity()
    phase_ensemble_parity()
    phase_tree_accuracy()
    phase_tree_parity()
    phase_slice(8192, "hermite4")
    slice_s_per_myr = phase_slice(N_KERNEL, "hermite4_block")
    tree, checked = phase_tree_slice()
    ensembles = [phase_ensemble_slice(*e) for e in ENSEMBLES]
    phase_cli()
    drv = phase_driver(slice_s_per_myr)
    phase_ensemble_driver()
    # launches: kernels 1-3 from the N_TREE tree-tier run, which exercises
    # all three, the error the worst of the kernel phases and that run's
    # shapes; the group window from the 64 x 1000 ensemble
    # the times and bounds at the tree slice's own shapes (kernels 1 and 2:
    # the virial sweep, K = k_fast predicted columns; beside the matmul
    # body's time there)
    for rec in records:
        chk = checked[rec["name"]]
        rec["launches"] = tree[rec["name"]]
        rec["max_abs_err"] = max(rec["max_abs_err"], chk["max_abs_err"])
        rec.update({"plain_ms": chk["plain_f32_ms"], "library_ms": None,
                    **{k: chk[k] for k in ("ms", "mma_ms", "bound_ms",
                                           "bound_by", "bound_pipe")
                       if k in chk}})
    group["launches"] = ensembles[0]["nbody_rows_group"]
    records.append(group)
    # the matmul bodies: launches from the driver at N_KERNEL (phase 6b),
    # the error the worst of phase 3d's and of the tree run's shapes
    for rec in mma:
        rec["launches"] = drv[rec["name"]]
        if rec["name"] in checked:
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     checked[rec["name"]]["max_abs_err"])
    records.extend(mma)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
