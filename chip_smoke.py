#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (al26_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one CUDA card
    python3 chip_smoke.py --mma  # phases 1, 2, 3d and kernel 2c at the
                                 # tree slice's shape, nothing else
    python3 chip_smoke.py --nccl # phases 1, 2, 5 at N = 32768, 5c at
                                 # 64 x 1000 and 7p (needs >= 2 cards for
                                 # the NCCL ranks), nothing else
    python3 chip_smoke.py --substep  # phases 1, 2 and 3s, nothing else

Phases, one result line each (any failure exits non-zero):

  1. device   the card's name and power limit (nvidia-smi), CUDA present,
              TF32 off; the maximum SM clock (nvidia-smi) and the SM
              count, which give the SFU's rsqrt rate of the bounds; a
              report of the host packages the io and analysis layers
              use (zstandard, tqdm, pandas, matplotlib, scipy);
  2. build    nvcc builds csrc/nbody.cu and csrc/tree.cu from this checkout,
              one nvcc each, started together with the host C++ build of
              the native UBJSON codec (io/native/ubjson_native.cpp, by
              io.native_build) (timed; the ptxas lines; the codec's
              library and seconds). Fails if the codec cannot be built
              there (the line says why: no compiler, no Python.h) or is
              not the codec in use;
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
  3s. substep the fused hermite4_block substep (ops.cuda_substep: kernels
              substep_predict and substep_correct around 2c) at K = 256,
              N = 32768 and K = 512, N = 102400 (Plummer, f32): one fused
              substep against the torch loop's (tests/torch_substep_ref.py)
              from the same state after three fused substeps, at the bars
              of tests/test_torch_kernels.py; the two kernels' device time
              a substep by the profiler (50 substeps), beside 2c's and the
              bound (2 K^2 pairs with the jerk, the rows' bytes); the
              torch substep's device time (its kernels' sum) and kernels a
              substep; the host time of a fused and of a torch substep;
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
  5s. stride  the gravity stride on phase 5's N = 32768 run, from the
              same initial bits: gravity_stride = 4, 20 steps as two
              cached chunks of 10 (each 2 strides and 2 plain cached
              steps); s/Myr and substeps per dt beside phase 5's; kernel
              1c launched exactly 1 + 2 x (2 + 2) = 9 times (the fresh
              cache, one closing sweep per stride or plain step); against
              phase 5's state after the same 20 steps: masses exactly,
              the pos RMS difference (pc) and the total SLR's relative
              difference each within 10 % of the JAX package's own for
              the same pair of runs (4.27e-4 pc and 2.09e-2 on the CPU,
              tests/stride_deviation.py), each run's relative energy
              change; then
              kernel 2c at K = 256 and tau = 4 dt on the live state
              against its f64 plain version (bar 5e-4), and the physics
              invariants.

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
  5t. tree stride  the full ladder (gravity_stride = 4, softened_virial)
              from phase 5b's initial state: 16 steps as two cached chunks
              of 8 (4 strides); s/Myr beside phase 5b's, substeps per dt,
              the near-field launches per closing sweep, kernel 2c's
              launches, peak memory, kernel 2c at K = 512 and tau = 4 dt
              on the live state (bar 5e-4), the physics invariants; then
              the same 16 steps under the relative MAC at N = 131072 from
              phase 5b's relative run's initial state (one exact seeding
              sweep, closing sweeps against the stride-start
              accelerations).

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
              the invariants of the last state, the yields codec the run
              named ("native" or it fails); the last yields blob decoded
              through the native and the Python codec (equal, and each
              re-encodes it to its bytes) with each codec's encode and
              decode seconds of that payload; then `-r smoke -nc 50`, its
              final state against the uninterrupted run's at the bars of
              phase 4 (and whether the bits matched);
  6b. driver  sim.driver.run at N = 32768, f32, 20 steps, 4 state files:
              the matmul kernels launched, the FMA bodies not, s/Myr with
              the saves beside phase 5's, the seconds in the saves;
  6d. driver stride  the run of 6b with gravity_stride = 4: 4 state
              files, kernel 1c launched exactly 9 times (save chunks of 1
              and 9 steps: 1 plain step, then 2 strides and 1 plain step),
              s/Myr with the saves beside 6b's;
  6c. ensemble driver  sim.driver.run_ensemble, 64 x 1000, 20 steps: the
              64 pt-<k> folders and their files, s/Myr with the saves.
  6e. analysis  the analysis layer (al26_tpu_torch.plotting) on the files
              of 6b and 6c and on 5b's live state, every float column
              widened to f64: the post-processor's main over 6c's grid
              (64 x 1000 x 2 isotopes x 5 models = 640 000 rows, written
              by io.compression's writer, which the line names), read
              back by the port's reader, every yield_ratio_nodecay equal
              bitwise to numpy's ratio of the last yields row to the
              stable mass; on one 6c state calc_etot (the run's softening
              and eps2 = 0.01), calc_local_densities,
              calc_cluster_half_mass, calc_sn_times and
              calc_global_model_yield (both radius methods) on the card
              against device="cpu", 1e-12 relative; calc_etot and
              calc_local_densities on the card at N = 32768 (6b's last
              file) and N = 409600 (5b after 5 steps), each with its
              seconds and peak memory, the densities of 256 random rows
              against a per-row f64 brute force (a full sort): the
              neighbour sets equal, the values at 1e-12;
              calc_disk_final_enrichment on 6b's yields (seconds); no
              kernel launched.
  6g. golden  the JAX package's golden N = 1k statistics
              (tests/golden/n1k_stats.json) from full 1000-step, 10 Myr
              runs of the port on the card (tests/torch_golden_stats.py):
              the three modes (default, sn_parity, sn_parity_seba) in
              f64, plain torch, each held to the round-off bar
              (tests/golden/n1k_roundoff.json: 10 x the JAX package's own
              distance under one-ulp nudges, at least 1e-12 relative;
              integers and time exact), with its seconds and its worst
              key over its bar; then the default mode in f32, kernel 1c
              every substep: its distance from the golden and 1c's
              launches (no bar; 1c must launch).

The device meshes (torch.distributed; parallel.sharded, ring, tree_mesh
and the ensemble meshes), after 6c:

  7m. mesh virtual  the local body of every mesh path for MESH_D = 4
              ranks in one process on the card, assembled and held
              against the unsplit kernel call on the same inputs: the
              sharded row blocks (1c; 1's FMA body) and the ring's blocks
              (1c) at N = 32768 with the jerk and the raw potential (bars
              3e-4 / 1e-5 of the max, the potential 1e-5); the subcycle's
              K = 256 column slices, K drawn from every shard, each slice
              also against its own f64 FMA-form sum (5e-4); the tree's
              far-field blocks and kernel 3's item shares at phase 5b's
              N = 409600 fractal state (1e-5), with the pairs a rank; kernel
              1b on a (2, 2) split of the 64 x 1000 ensemble (1e-5). Each
              rank's device time at its shape;
  7n. mesh world of one  a world of one over NCCL, through the entry
              points, the counts set to 0 just before each path and read
              just after, each held against its one-device run at the bars
              of phase 4: "sharded" and "ring" from phase 5's initial bits
              (20 steps; 1c, no 2c), the tree mesh at N = 409600 for 5
              steps against 5b's first 5, the stride 4 under the mesh
              against 5s (1c's closing sweeps exactly 9), the driver with
              mesh_shape=(1,) and orbax_dir against 6b (a DCP tree at each
              save, then a resume from step 11's tree), the CLI with
              --mesh_shape 1 against phase 6, the ensemble meshes (1,) and
              (1, 1) against 5c; s/Myr beside each;
  7p. mesh nccl  with two or more cards, min(4, count) NCCL ranks (one
              process a card) run phase 5's run on the (D,) mesh and 5c's
              ensemble on the 1-D ensemble mesh: every rank on the same
              bits, held against phases 5 and 5c; with one card a line
              says the mesh phases ran a world of one.

The run order: 1, 2, 3, 3d, 3s, 3b, 3c, 4, 4d, 4b, 4c, 5, 5s, 5b, 5t, 5c,
6, 6b, 6d, 6c, 6e, 6g, 7m, 7n, 7p.

Then one JSON line with every kernel's launches (kernels 1-3 from phase 5b,
the windowed kernel from the 64 x 1000 run of phase 5c, the matmul kernels
from phase 6b, the fused substep's from phases 5 and 6b), error (the
largest of its comparisons), times (device-only
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
bodies their FP32 work outside the tensor cores. Each kernel's
`mesh_launches` are its launches on phase 7n's mesh paths (2c: 0, the
subcycle rows go through 1c under a mesh), and its error includes phase
7m's. Last the line {"ok": true, "device": {...}}.
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
# the gravity stride's phases (5s, 5t, 6d): the stride, and how far the
# JAX package's own stride-4 run lands from its unstrided one on phase 5's
# N_KERNEL run (the same initial bits, 20 steps as two chunks of 10, f32):
# the pos RMS difference in pc and the total SLR's relative difference
# (JAX_PLATFORMS=cpu python tests/stride_deviation.py --n 32768). Phase 5s
# holds the card's pair of runs to these within STRIDE_REF_TOL relative.
STRIDE = 4
# the mesh phases: virtual ranks (7m), the subcycle's rows a call, and the
# back-to-back calls of a rank's timing
MESH_D = 4
MESH_K = 256
MESH_REPS = 20
# the analysis phase (6e): card against CPU and against the brute force,
# in f64; the rows of the brute force
ANALYSIS_TOL = 1e-12
ANALYSIS_ROWS = 256
STRIDE_REF = {"pos_rms_pc": 4.2728e-4, "slr_total_rel": 2.0874e-2}
STRIDE_REF_TOL = 0.1


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
                                               "pandas", "matplotlib",
                                               "scipy"))


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
    """Both CUDA sources, one nvcc each, and the native UBJSON codec (the
    host C++ compiler, in a thread of its own), started together."""
    import threading

    from al26_tpu_torch.io import native_build, ubjson
    from al26_tpu_torch.ops import cuda_build, cuda_nbody, cuda_tree

    why = native_build.unavailable()
    if why is not None:
        _line("build", codec=f"the native codec cannot be built: {why}")
        _fail(f"the native codec cannot be built here: {why}")
    codec = {}

    def build_codec():
        t = time.perf_counter()
        try:
            codec["library"] = os.path.relpath(native_build.build(), HERE)
        except RuntimeError as e:
            codec["error"] = str(e)
        codec["seconds"] = time.perf_counter() - t

    t0 = time.perf_counter()
    th = threading.Thread(target=build_codec)
    th.start()
    built = cuda_build.build_all()
    th.join()
    cuda_nbody.load()
    cuda_tree.load()
    secs = time.perf_counter() - t0
    if "error" in codec:
        _fail(f"the native codec did not build: {codec['error']}")
    codec["in_use"] = ubjson.codec()
    if codec["in_use"] != "native":
        _fail(f"the native codec is not in use: {codec['in_use']}")
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name, (_, log) in built.items()}
    _line("build", seconds=secs,
          libraries={k: os.path.relpath(p, HERE)
                     for k, (p, _) in built.items()},
          ptxas=ptxas, codec=codec)


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


def _substep_state(n: int, k: int):
    """A Plummer cluster of n stars on the card (f32), its step-start fast
    group of k rows as hermite4_block_advance selects it and kernel 2c's
    rows_at: (cfg, idx, (pf0, vf0, af0, jf0), mass_f, rows_at)."""
    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.sim import init_cluster

    cfg = SimConfig(n=n, rc=1.0, seed=42, dtype="f32", k_fast=k)
    state, _, cfg = init_cluster(cfg, device=torch.device("cuda"))
    c = state.cluster
    a0, j0, _ = cn.kernel_acc_jerk_pot(c.pos, c.vel, c.mass, cfg.eps2)
    crit = torch.sqrt(torch.sum(a0 * a0, -1)
                      / torch.clamp(torch.sum(j0 * j0, -1), min=1e-30))
    idx = torch.topk(crit, k, largest=False, sorted=True).indices
    cols0 = tuple(t[idx] for t in (c.pos, c.vel, a0, j0))
    rows_at = cn.make_pred_force_rows(c.pos, c.vel, a0, j0, c.mass, cfg.eps2)
    return cfg, idx, cols0, c.mass[idx], rows_at


def phase_substep() -> dict:
    """Phase 3s (module docstring). Returns the kernels-line record of the
    fused substep (launches filled from phases 5 and 6b)."""
    import torch

    from al26_tpu_torch.ops import cuda_substep
    from al26_tpu_torch.units import G_INTERNAL

    ref = _load_file("tests/torch_substep_ref.py")
    dev, f32 = torch.device("cuda"), torch.float32
    shapes = []
    for n, k in ((N_KERNEL, 256), (102400, 512)):
        cfg, idx, cols0, mass_f, rows_at = _substep_state(n, k)
        ids = idx.to(torch.int32)
        eps2 = torch.tensor(cfg.eps2, dtype=f32, device=dev)
        h_min = torch.tensor(cfg.dt, dtype=f32, device=dev) / cfg.substeps_max
        # dt far ahead, so that the timed substeps never reach it
        for dt_steps in (1, 1000):
            dt = torch.tensor(dt_steps * cfg.dt, dtype=f32, device=dev)
            sub = cuda_substep.FusedSubstep(*cols0, mass_f, dt, h_min,
                                            cfg.eta_hermite, eps2,
                                            G_INTERNAL)

            def fused():
                sub.predict()
                a1, j1 = rows_at(sub.pfp, sub.vfp, ids, sub.th)
                return a1, sub.correct(a1, j1)

            for _ in range(3):
                fused()
            state = tuple(t.clone() for t in (sub.pf, sub.vf, sub.af,
                                              sub.jf))
            tau = sub.tau.clone()

            def plain():
                return ref.torch_substep(state, tau, cols0, mass_f, ids,
                                         rows_at, dt, h_min, cfg.eta_hermite,
                                         eps2, G_INTERNAL)

            if dt_steps == 1:
                # one substep each way from the same state
                h, th, new, (da, dj), flag = plain()
                a1, flag_f = fused()
                torch.cuda.synchronize()
                err = {
                    "h": abs(float(sub.h) - float(h)) / float(h),
                    "tau": abs(float(sub.tau) - float(th)) / float(th),
                    "flag_equal": bool(flag_f) == bool(flag),
                    "delta_acc": float((sub.af - a1 - da).abs().max()
                                       / new[2].abs().max()),
                    "jerk": float((sub.jf - new[3]).abs().max()
                                  / new[3].abs().max()),
                    "pf1": float((sub.pf - new[0]).abs().max()
                                 / new[0].abs().max()),
                    "vf1": float((sub.vf - new[1]).abs().max()
                                 / new[1].abs().max())}
                ok = (err["h"] <= 1e-6 and err["tau"] <= 1e-6
                      and err["flag_equal"] and err["delta_acc"] <= 2e-5
                      and err["jerk"] <= 2e-5 and err["pf1"] <= 1e-6
                      and err["vf1"] <= 1e-6)
                if not ok:
                    _line("substep", n=n, k=k, errors=err)
                    _fail(f"the fused substep at K = {k}, N = {n} is off "
                          f"the torch substep: {err}")
                continue
            kernels = _kernel_ms(fused)
            own = {name: v for name, v in kernels.items()
                   if name in ("substep_predict", "substep_correct")}
            if set(own) != {"substep_predict", "substep_correct"}:
                _fail(f"the profiler shows no fused kernel: {kernels}")
            plain_kernels = _kernel_ms(plain)
            # rows: s0, s, w read or written in each kernel, 2c's a1, j1
            # and the masses read, the state written (316 bytes a row)
            rec = {"n": n, "k": k, "errors": err,
                   "ms": sum(v["ms"] for v in own.values()),
                   "kernels": kernels,
                   **_bound(2 * k * (k - 1), True, 316 * k),
                   "plain_ms": sum(v["ms"] for v in plain_kernels.values()),
                   "plain_kernels_per_substep": sum(
                       v["per_call"] for v in plain_kernels.values()),
                   "host_ms": _host_ms(fused),
                   "plain_host_ms": _host_ms(plain)}
            _line("substep", **rec)
            shapes.append(rec)
    torch.cuda.synchronize()
    worst = max(max(r["errors"][e] for e in ("delta_acc", "jerk", "pf1",
                                             "vf1"))
                for r in shapes)
    last = shapes[-1]
    return {"name": "substep", "max_rel_err": worst,
            **{key: last[key] for key in ("ms", "bound_ms", "bound_by",
                                          "bound_pipe", "plain_ms")},
            "library_ms": None, "k": last["k"], "n": last["n"]}


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
    state0 = state
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
    return {"s_per_myr": wall / sim_myr, "state0": state0, "aux": aux,
            "cfg": cfg, "state": state, "launches": launches,
            "substeps_per_dt": substeps}


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


def _fast_rows(c, a0, j0, cfg, tau_dt: float = 0.5):
    """The subcycle's rows at a slice's state: the k_fast stars of largest
    |a| predicted from the force cache to tau_dt * dt; returns (pf, vf,
    ids, tau)."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn

    sel = torch.topk(a0.norm(dim=1), cfg.k_fast).indices.to(torch.int32)
    tau = torch.tensor(tau_dt * cfg.dt, dtype=torch.float32,
                       device=a0.device)
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
    launches, the kernel comparisons and both runs' initial states and
    times (phase 5t starts from them)."""
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
    state0 = state                         # phase 5t starts from here
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = fresh_cache(state, cfg, cfg.integrator, None, "tree")
    chunk_states = []
    for _ in range(2):                     # two checkpoint-sized chunks
        state, cache = run_steps_cached(state, cache, aux, cfg, 5, None,
                                        "tree")
        chunk_states.append(state)
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
    rstate0 = rstate
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
    runs = {"geometric": {"state0": state0, "aux": aux, "cfg": cfg,
                          "state5": chunk_states[0],
                          "s_per_myr": wall / (steps * cfg.dt),
                          "substeps_per_dt": step_launches[
                              "nbody_predcols_mma"] / steps,
                          "near_field": step_launches["near_field"],
                          "steps": steps, "peak_mem_gb": peak_gb},
            "relative": {"state0": rstate0, "aux": raux, "cfg": rcfg,
                         "s_per_myr": rwall / (5 * rcfg.dt)}}
    return launches, kernel_checks, runs


def _energy(state, cfg) -> float:
    """Total energy (kinetic + the cfg.eps2-softened potential) in f64,
    plain torch on the card."""
    from al26_tpu_torch.ops.nbody import total_energy

    c = state.cluster
    return float(total_energy(c.pos.double(), c.vel.double(),
                              c.mass.double(), cfg.eps2))


def _pred_mma_at_stride(state, cache, cfg, m: int) -> dict:
    """Kernel 2c at the stride's furthest tau = m * dt: K = k_fast rows
    against all N columns predicted from the live force cache, against
    its f64 plain version (_pred_mma_check, bar PRED_MMA_TOL)."""
    c = state.cluster
    pf, vf, sel, tau = _fast_rows(c, cache[0], cache[1], cfg, tau_dt=m)
    rec = _pred_mma_check(pf, vf, sel, c.pos, c.vel, cache[0], cache[1],
                          c.mass, tau, cfg.eps2)
    return {"tau_dt": m, **rec}


def _pred_mma_ok(rec: dict) -> bool:
    return (all(v < rec["tol"] for v in rec["rel_err"].values())
            and rec["repeat_same_bits"])


def _closing_sweeps(n_steps: int, m: int) -> int:
    """Closing sweeps of run_steps_cached_strided over n_steps: one per
    stride, one per plain step of the remainder."""
    return n_steps // m + n_steps % m


def phase_stride_slice(base: dict) -> dict:
    """Phase 5's N_KERNEL run again from the same initial bits with
    gravity_stride = STRIDE: 20 steps as two cached chunks of 10 (each 2
    strides and 2 plain cached steps); against phase 5's state after the
    same 20 steps: masses exactly; the pos RMS difference and the total
    SLR's relative difference, each within STRIDE_REF_TOL of the JAX
    package's own (STRIDE_REF); each run's relative energy change; kernel
    2c at tau = STRIDE * dt on the live state."""
    import torch

    from al26_tpu_torch.sim.step import (
        fresh_cache, run_steps_cached_strided, stride_active,
    )

    m, steps = STRIDE, 20
    state, aux = base["state0"], base["aux"]
    cfg = base["cfg"].replace(gravity_stride=m)
    c = state.cluster
    if not stride_active(cfg, c.n, c.pos.dtype, c.pos.device, None, "auto"):
        _fail("the stride does not engage on the N_KERNEL slice")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = fresh_cache(state, cfg, cfg.integrator, None, "auto")
    for _ in range(2):                     # two checkpoint-sized chunks
        state, cache = run_steps_cached_strided(state, cache, aux, cfg,
                                                steps // 2, None, "auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    want_rows = 1 + 2 * _closing_sweeps(steps // 2, m)
    checks, host = _state_checks(state, cfg, steps)
    ref = base["state"].cluster
    got = state.cluster
    pos_rms = float((got.pos.double() - ref.pos.double()).pow(2).sum(1)
                    .mean().sqrt())
    slr_got, slr_ref = float(got.slr.double().sum()), \
        float(ref.slr.double().sum())
    slr_rel = abs(slr_got - slr_ref) / abs(slr_ref)
    e0 = _energy(base["state0"], cfg)
    energy = {"stride": (_energy(state, cfg) - e0) / abs(e0),
              "unstrided": (_energy(base["state"], cfg) - e0) / abs(e0)}
    checks.update({
        "rows_mma_launches": launches["nbody_rows_mma"] == want_rows,
        "predcols_mma_launched": launches["nbody_predcols_mma"] > 0,
        "fma_bodies_idle": not (launches["nbody_rows"]
                                or launches["nbody_predcols"]),
        "cache_finite": all(bool(torch.isfinite(x).all()) for x in cache),
        "mass_equal": torch.equal(got.mass, ref.mass),
        "pos_rms_as_reference": abs(pos_rms / STRIDE_REF["pos_rms_pc"] - 1)
        < STRIDE_REF_TOL,
        "slr_total_as_reference": abs(
            slr_rel / STRIDE_REF["slr_total_rel"] - 1) < STRIDE_REF_TOL,
    })
    # after the counts are read: these launches compare, they do not count
    pred = _pred_mma_at_stride(state, cache, cfg, m)
    checks["predcols_mma_at_stride_tau"] = _pred_mma_ok(pred)
    _line("stride slice", n=c.n, stride=m, integrator=cfg.integrator,
          k_fast=cfg.k_fast, steps=steps, wall_s=wall,
          s_per_myr=wall / (steps * cfg.dt),
          phase5_s_per_myr=base["s_per_myr"],
          substeps_per_dt=launches["nbody_predcols_mma"] / steps,
          phase5_substeps_per_dt=base["substeps_per_dt"],
          launches=launches, rows_mma_want=want_rows,
          phase5_launches=base["launches"], pos_rms_pc=pos_rms,
          slr_total_rel=slr_rel, reference=STRIDE_REF,
          reference_tol=STRIDE_REF_TOL, energy_rel_change=energy,
          predcols_mma_at_stride_tau=pred,
          wind_total=float(host["slr"][:, :, 0:2].sum()), checks=checks)
    if not all(checks.values()):
        _fail(f"stride slice: {[k for k, v in checks.items() if not v]} "
              "failed")
    return {"s_per_myr": wall / (steps * cfg.dt), "state": state}


def _tree_stride_run(run: dict, steps: int, **knobs):
    """init state of a phase 5b run -> fresh_cache and steps // 8 cached
    chunks of 8 strided steps on the tree, launches counted from 0 just
    before fresh_cache; returns (state, cache, cfg, wall, launches,
    peak GB)."""
    import torch

    from al26_tpu_torch.sim.step import (
        fresh_cache, run_steps_cached_strided, stride_active,
    )

    state, aux = run["state0"], run["aux"]
    cfg = run["cfg"].replace(**knobs)
    c = state.cluster
    if not stride_active(cfg, c.n, c.pos.dtype, c.pos.device, None, "tree"):
        _fail(f"the stride does not engage on the tree at n = {c.n}")
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = fresh_cache(state, cfg, cfg.integrator, None, "tree")
    for _ in range(steps // 8):            # checkpoint-sized chunks
        state, cache = run_steps_cached_strided(state, cache, aux, cfg, 8,
                                                None, "tree")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (state, cache, cfg, wall, _launches(),
            torch.cuda.max_memory_allocated() / 1e9)


def phase_tree_stride(runs: dict) -> None:
    """The tree with the full ladder (gravity_stride = STRIDE,
    softened_virial) from phase 5b's initial state: 16 steps as two
    cached chunks of 8 (4 strides), s/Myr beside phase 5b's, substeps per
    dt, the launches, peak memory, kernel 2c at tau = STRIDE * dt and
    K = k_fast on the live state; then the same 16 steps under the
    relative MAC at N_NEAR from phase 5b's relative run's initial state
    (the stride-start reference accelerations)."""
    import torch

    m, steps = STRIDE, 16
    base = runs["geometric"]
    state, cache, cfg, wall, launches, peak_gb = _tree_stride_run(
        base, steps, gravity_stride=m, softened_virial=True)
    checks, host = _state_checks(state, cfg, steps)
    checks.update({
        "cache_finite": all(bool(torch.isfinite(x).all()) for x in cache),
        "near_field_launched": launches["near_field"] > 0,
        "predcols_mma_launched": launches["nbody_predcols_mma"] > 0,
        # no init in the window: the FMA virial sum is not on this path,
        # nor (geometric MAC) the exact seeding sweep
        "rows_idle": not (launches["nbody_rows"]
                          or launches["nbody_rows_mma"]),
    })
    pred = _pred_mma_at_stride(state, cache, cfg, m)
    checks["predcols_mma_at_stride_tau"] = _pred_mma_ok(pred)
    _line("tree stride", n=state.cluster.n, stride=m,
          softened_virial=cfg.softened_virial, k_fast=cfg.k_fast,
          theta=cfg.tree_theta, leaf=cfg.tree_leaf, tree_kavg=cfg.tree_kavg,
          steps=steps, wall_s=wall, s_per_myr=wall / (steps * cfg.dt),
          wall_per_step_ms=1e3 * wall / steps,
          phase5b_s_per_myr=base["s_per_myr"],
          substeps_per_dt=launches["nbody_predcols_mma"] / steps,
          phase5b_substeps_per_dt=base["substeps_per_dt"],
          closing_sweeps=1 + 2 * _closing_sweeps(8, m),
          near_field_per_closing_sweep=launches["near_field"]
          / (1 + 2 * _closing_sweeps(8, m)),
          phase5b_near_field_per_step=base["near_field"] / base["steps"],
          launches=launches, peak_mem_gb=peak_gb,
          phase5b_peak_mem_gb=base["peak_mem_gb"],
          predcols_mma_at_stride_tau=pred,
          wind_total=float(host["slr"][:, :, 0:2].sum()), checks=checks)
    if not all(checks.values()):
        _fail(f"tree stride: {[k for k, v in checks.items() if not v]} "
              "failed")
    del state, cache

    rel = runs["relative"]
    rstate, rcache, rcfg, rwall, rlaunch, rpeak = _tree_stride_run(
        rel, steps, gravity_stride=m, softened_virial=True)
    rchecks, _ = _state_checks(rstate, rcfg, steps)
    rchecks.update({
        "cache_finite": all(bool(torch.isfinite(x).all()) for x in rcache),
        "near_field_launched": rlaunch["near_field"] > 0,
        "predcols_mma_launched": rlaunch["nbody_predcols_mma"] > 0,
        # the exact seeding sweep, once; the stride's closing sweeps open
        # against the stride-start accelerations (tree sweeps)
        "seeding_sweep_nbody_rows_mma": rlaunch["nbody_rows_mma"] == 1,
    })
    _line("tree stride relative", n=rstate.cluster.n, stride=m,
          alpha=rcfg.tree_alpha, tree_kavg=rcfg.tree_kavg, steps=steps,
          wall_s=rwall, s_per_myr=rwall / (steps * rcfg.dt),
          phase5b_relative_s_per_myr=rel["s_per_myr"],
          substeps_per_dt=rlaunch["nbody_predcols_mma"] / steps,
          launches=rlaunch, peak_mem_gb=rpeak, checks=rchecks)
    if not all(rchecks.values()):
        _fail(f"relative tree stride: "
              f"{[k for k, v in rchecks.items() if not v]} failed")


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
    bs0 = bs
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
    return {"launches": launches, "state0": bs0, "aux": ba, "cfg": cfg,
            "state": bs, "s_per_myr": wall / (steps * cfg.dt),
            "chunks": chunks}


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


def _load_file(rel: str):
    """A module of the checkout (a script, a test helper) loaded by path,
    so that its directory never goes onto sys.path."""
    import importlib.util

    name = "_smoke_" + os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _codec_payload(path: str, reps: int = 3) -> dict:
    """The yields blob at `path` decoded through the native and the Python
    codec (equal?), then each codec's median encode and decode seconds of
    its payload over `reps` calls (scripts/compression_tests_torch.py:
    codec_times, which fails unless both write the same bytes), and
    whether they re-encode it to the blob's bytes."""
    from al26_tpu_torch.io import compression, ubjson

    with open(path, "rb") as f:
        raw = compression.decompress(f.read())
    try:
        obj = ubjson.native_codec()[1](raw)
        data, times = _load_file("scripts/compression_tests_torch.py"
                                 ).codec_times(obj, reps)
    except RuntimeError as e:
        _fail(f"yields payload: {e}")
    out = {"bytes": len(raw),
           "decodes_equal": obj == ubjson.loadb_python(raw),
           "bytes_equal": data == raw}
    for name, (enc, dec) in times.items():
        out[f"{name}_encode_s"] = enc
        out[f"{name}_decode_s"] = dec
    return out


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
    codec = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
             if ln.startswith("# yields codec:")]
    checks["native_codec"] = codec == ["native"]
    payload = _codec_payload(os.path.join(tmp, "smoke-yields.ubj.zst"))
    checks["payload_decodes_equal"] = payload["decodes_equal"]
    checks["payload_bytes_equal"] = payload["bytes_equal"]
    _line("cli", n=1000, steps=1000, t_f=1.0, dir=tmp,
          writer=writer[0] if writer else None,
          codec=codec[0] if codec else None, yields_payload=payload,
          state_files=len(states), csv_rows=csv_rows,
          state_file_bytes=os.path.getsize(states[-1]),
          command_s=wall, **run_t,
          s_per_myr_with_saves=run_t.get("run_s", wall) / 1.0,
          resume_command_s=wall_r, resume=timings(out_r), **par,
          checks=checks)
    if not all(checks.values()):
        _fail(f"cli: {[k for k, v in checks.items() if not v]} failed")
    return {"final": final, "args": args, "command_s": wall}


def phase_driver(slice_s_per_myr: float, stride: int = 1,
                 unstrided_s_per_myr: float | None = None) -> dict:
    """sim.driver.run in process at N = 32768 (20 steps at the default dt,
    a save after steps 1 and 11 and at the end, plus #0): the launches of
    the matmul kernels (counts set to 0 just before the run, read just
    after), s/Myr with the saves beside phase 5's without them
    (`slice_s_per_myr`), the seconds in the saves, the files and the
    invariants. With `stride` > 1 (phase 6d) the run is strided: kernel
    1c's launches are the fresh cache's plus one closing sweep per stride
    or plain step, and s/Myr stands beside phase 6b's
    (`unstrided_s_per_myr`). Returns the launches and s/Myr."""
    import glob
    import tempfile

    import torch

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.sim import driver

    tmp = tempfile.mkdtemp(prefix="al26-driver-")
    base = os.path.join(tmp, "drv")
    cfg = SimConfig(n=N_KERNEL, rc=1.0, dtype="f32", final_time=0.2,
                    n_plot=2, steps_per_plot=10, seed=42, filename=base,
                    gravity_stride=stride)
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
    want_rows = None
    if stride > 1:
        # save chunks of 1 and 9 steps (cadence saves after steps 1, 11)
        want_rows = 1 + 2 * (_closing_sweeps(1, stride)
                             + _closing_sweeps(9, stride))
        checks["rows_mma_launches"] = launches["nbody_rows_mma"] == want_rows
    ph = res.phase_seconds
    _line("driver" if stride == 1 else "driver stride", n=N_KERNEL,
          integrator=res.cfg.integrator, stride=stride, steps=steps,
          wall_s=wall, run_s=res.wall_time_s,
          s_per_myr_with_saves=wall / (steps * res.cfg.dt),
          phase5_s_per_myr=slice_s_per_myr,
          phase6b_s_per_myr_with_saves=unstrided_s_per_myr,
          rows_mma_want=want_rows,
          physics_s=ph.get("physics"), checkpoint_s=ph.get("checkpoint"),
          writer_thread_s=ph.get("writer"),
          saves_share=ph.get("checkpoint", 0.0) / wall,
          state_file_bytes=os.path.getsize(states[-1]), launches=launches,
          checks=checks)
    if not all(checks.values()):
        _fail(f"driver (stride {stride}): "
              f"{[k for k, v in checks.items() if not v]} failed")
    return {"launches": launches, "state": res.state,
            "s_per_myr": wall / (steps * res.cfg.dt), "base": base,
            "state_files": states}


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
    return {"root": tmp, "dirs": dirs, "n": 1000}


def _f64_particles(p):
    """A Particles table with its float columns widened to f64 (the dtype
    the JAX package's analysis tests compute in)."""
    import numpy as np

    from al26_tpu_torch.io.compat import Particles

    return Particles({k: (v.astype(np.float64)
                          if np.issubdtype(v.dtype, np.floating) else v)
                      for k, v in p.columns().items()})


def _card_vs_cpu(name, fn, checks: dict, errs: dict) -> None:
    """fn(device) on the card and on the CPU: every float at 1e-12
    relative (a zero where the other is zero)."""
    import numpy as np

    got, want = fn("cuda"), fn("cpu")
    got = np.concatenate([np.ravel(np.asarray(g, dtype=np.float64))
                          for g in (got if isinstance(got, tuple)
                                    else (got,))])
    want = np.concatenate([np.ravel(np.asarray(w, dtype=np.float64))
                           for w in (want if isinstance(want, tuple)
                                     else (want,))])
    scale = np.where(want == 0.0, 1.0, np.abs(want))
    errs[name] = float(np.max(np.abs(got - want) / scale)) if got.size else 0.0
    checks[name] = got.shape == want.shape and errs[name] <= ANALYSIS_TOL


def _density_at_size(state, sample: int, seed: int) -> dict:
    """calc_etot and calc_local_densities on the card (f64), each timed
    with its peak memory; on `sample` random rows the densities against a
    per-row f64 brute force (a full sort of each row's squared
    distances): the neighbour sets equal, the values at 1e-12."""
    import numpy as np
    import torch

    from al26_tpu_torch.ops import nbody
    from al26_tpu_torch.plotting import lib

    out = {"n": len(state.cluster)}
    for name, call in (("etot", lambda: lib.calc_etot(state)),
                       ("local_densities",
                        lambda: lib.calc_local_densities(state.cluster))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        val = call()
        torch.cuda.synchronize()
        out[name + "_s"] = time.perf_counter() - t0
        out[name + "_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[name] = val
    rho = out.pop("local_densities")
    out["etot"] = float(out["etot"])
    pos, _, mass = lib._pos_vel_mass(state.cluster, torch.device("cuda"))
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(np.sort(rng.choice(out["n"], sample,
                                              replace=False)),
                           device=pos.device)
    nbr, _ = nbody.nearest_neighbours(pos, rows=rows)
    d2 = torch.sum((pos[None, :, :] - pos[rows][:, None, :]) ** 2, dim=-1)
    d2s, order = torch.sort(d2, dim=1, stable=True)
    brute_nbr = order[:, 1:11]
    brute = (torch.sum(mass[brute_nbr], dim=1)
             / (4.18879020479 * torch.sqrt(d2s[:, 10]) ** 3)).cpu().numpy()
    got = rho[rows.cpu().numpy()]
    out["brute_rows"] = sample
    out["brute_rel_err"] = float(np.max(np.abs(got - brute) / brute))
    out["checks"] = {
        "finite": bool(np.isfinite(rho).all() and np.isfinite(out["etot"])),
        "densities_positive": bool((rho > 0).all()),
        "brute_neighbour_sets": bool(torch.equal(
            torch.sort(nbr, 1).values, torch.sort(brute_nbr, 1).values)),
        "brute_values": out["brute_rel_err"] <= ANALYSIS_TOL,
    }
    _line(f"analysis n={out['n']}", **out)
    if not all(out["checks"].values()):
        _fail(f"analysis n={out['n']}: "
              f"{[k for k, v in out['checks'].items() if not v]} failed")
    return out


def phase_analysis(grid: dict, drv: dict, tree_run: dict) -> None:
    """The analysis layer (al26_tpu_torch.plotting) on the files 6b and 6c
    wrote and on 5b's live state, in f64 (every float column widened):
    the post-processor over 6c's 64 x 1000 grid (640 000 rows, each
    yield_ratio_nodecay against numpy's ratio of the last yields row to
    the stable mass, bitwise); the five snapshot diagnostics on one 6c
    state, card against CPU at 1e-12 relative; calc_etot and
    calc_local_densities at N = 32768 (6b's last file) and N = 409600
    (5b, after 5 steps), timed with their peak memory, the densities on
    256 rows against a brute force; the disc-lifetime interpolation on
    6b's yields. No kernel is launched (the counts stay 0)."""
    import glob

    import numpy as np
    import torch

    from al26_tpu_torch.io import compression
    from al26_tpu_torch.io.compat import State, cluster_to_particles
    from al26_tpu_torch.plotting import lib, postprocess
    from al26_tpu_torch.sim import driver
    from al26_tpu_torch.units import msol, myr

    _reset_launches()
    checks, errs = {}, {}
    out = os.path.join(grid["root"], "all-sims-ratios.pkl.zst")
    t0 = time.perf_counter()
    postprocess.main(grid["root"], out)
    post_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    df = postprocess._read_table(out)
    read_s = time.perf_counter() - t0
    simset = sorted(glob.glob(os.path.join(grid["root"], "pt-*", "pt*", "")))
    sims = sorted(glob.glob(simset[0] + "pt-*/")) if simset else []
    want = []
    for sim in sims:
        y = lib.read_yields(glob.glob(sim + "*-yields.ubj.zst")[0])
        c = lib.read_state(sorted(glob.glob(sim + "*-state-*.zst"))[-1]).cluster
        per_iso = []
        for iso, stable in (("26al", "27al"), ("60fe", "56fe")):
            m_st = np.asarray(getattr(c, "mass_" + stable).value_in(msol),
                              dtype=np.float64)
            last = {ch: np.asarray(getattr(y, f"{ch}_{iso}")[-1],
                                   dtype=np.float64)
                    for ch in ("local", "global", "sne")}
            per_iso.append(np.stack(
                [0.0 + last[m] for m in ("local", "global", "sne")]
                + [0.0 + last["local"] + last["sne"],
                   0.0 + last["global"] + last["sne"]], -1) / m_st[:, None])
        want.append(np.stack(per_iso, 1).reshape(-1))      # star, iso, model
    want = np.concatenate(want) if want else np.zeros(0)
    got = df["yield_ratio_nodecay"].to_numpy()
    checks["table_rows"] = len(df) == len(grid["dirs"]) * grid["n"] * 2 * 5
    checks["table_sims"] = len(sims) == len(grid["dirs"])
    checks["nodecay_bitwise"] = (got.shape == want.shape
                                 and np.array_equal(got, want))
    checks["decay_finite"] = bool(np.isfinite(df["yield_ratio_decay"]).all())

    # the five diagnostics, card against CPU, on one 6c state
    st = lib.read_state(sorted(glob.glob(sims[0] + "*-state-*.zst"))[-1])
    st = State(_f64_particles(st.cluster), st.converter, st.metadata)
    c, md = st.cluster, st.metadata
    t_now = float(md.time.value_in(myr))
    first = _f64_particles(lib.read_state(
        sorted(glob.glob(sims[0] + "*-state-*.zst"))[0]).cluster)
    t0 = time.perf_counter()
    _card_vs_cpu("etot", lambda d: lib.calc_etot(st, device=d), checks, errs)
    _card_vs_cpu("etot_eps2", lambda d: lib.calc_etot(st, eps2=0.01, device=d),
                 checks, errs)
    _card_vs_cpu("local_densities",
                 lambda d: lib.calc_local_densities(c, device=d), checks, errs)
    _card_vs_cpu("half_mass",
                 lambda d: lib.calc_cluster_half_mass(c, device=d), checks,
                 errs)
    _card_vs_cpu("sn_times", lambda d: lib.calc_sn_times(
        first, metadata=md, device=d)[0], checks, errs)
    checks["sn_masses_equal"] = (
        lib.calc_sn_times(first, metadata=md, device="cuda")[1]
        == lib.calc_sn_times(first, metadata=md, device="cpu")[1])
    for method in ("halfmass", "virial"):
        _card_vs_cpu("global_yield_" + method,
                     lambda d: lib.calc_global_model_yield(
                         c, t_now, 0.01, method, metadata=md, device=d),
                     checks, errs)
    small_s = time.perf_counter() - t0

    # at size: 6b's last file, 5b's live state
    big = lib.read_state(drv["state_files"][-1])
    big = State(_f64_particles(big.cluster), big.converter, big.metadata)
    at_size = [_density_at_size(big, ANALYSIS_ROWS, 1)]
    tree_state = State(_f64_particles(cluster_to_particles(
        tree_run["state5"].cluster)), None,
        driver._metadata_from_cfg(tree_run["cfg"]))
    at_size.append(_density_at_size(tree_state, ANALYSIS_ROWS, 2))
    del tree_state

    # the disc-lifetime interpolation on 6b's yields
    y = lib.read_yields(drv["base"] + "-yields.ubj.zst")
    taus = np.asarray(big.cluster.tau_disk.value_in(myr))
    t0 = time.perf_counter()
    y = lib.calc_disk_final_enrichment(y, taus)
    enrich_s = time.perf_counter() - t0
    checks["enrichment_finite"] = all(
        np.isfinite(getattr(y, f"{m}_{i}_final")).all()
        for m in ("global", "local", "sne") for i in ("26al", "60fe"))
    launches = _launches()
    checks["no_kernel_launched"] = not any(launches.values())
    _line("analysis", writer=compression.writer(), table_rows=len(df),
          table_bytes=os.path.getsize(out), postprocess_s=post_s,
          read_back_s=read_s, diagnostics_n1000_s=small_s,
          card_vs_cpu_rel_err=errs, enrichment_n=len(taus),
          enrichment_s=enrich_s,
          **{key: {r["n"]: r[key] for r in at_size}
             for key in ("etot_s", "etot_peak_gb", "local_densities_s",
                         "local_densities_peak_gb")},
          launches=launches, checks=checks)
    if not all(checks.values()):
        _fail(f"analysis: {[k for k, v in checks.items() if not v]} failed")


def _golden_run(tgs, mode: str, dtype: str) -> tuple[dict, float]:
    """One full golden run on the card: its summary and seconds (init to
    the last step, synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, cfg = tgs.run_golden(mode, device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return tgs.summarize(state, cfg), secs


def phase_golden() -> None:
    """The JAX package's golden N = 1k statistics (tests/golden/
    n1k_stats.json) from full 1000-step runs of the port on the card:
    each mode in f64 (plain torch; the kernels run f32 only) held to the
    round-off bar of tests/torch_golden_stats.py, with its seconds and
    its worst key's distance over its bar; then the default mode in f32,
    whose sweeps launch kernel 1c every substep: its distance from the
    golden (relative, each key) and 1c's launches, no bar."""
    tgs = _load_file("tests/torch_golden_stats.py")

    golden, roundoff = tgs.load("n1k_stats"), tgs.load("n1k_roundoff")
    modes, checks = {}, {}
    for mode in tgs.MODES:
        got, secs = _golden_run(tgs, mode, "f64")
        dist = tgs.against_golden(got, golden[mode], roundoff[mode])
        key, ratio = tgs.worst(dist)
        over = {k: db for k, db in dist.items() if db[0] > db[1]}
        modes[mode] = {"seconds": secs, "worst_key": key,
                       "worst_distance_over_bar": ratio,
                       "n_kicked": got["n_kicked"], "over_bar": over}
        checks[f"{mode}_within_bar"] = not over
    _reset_launches()
    got, secs = _golden_run(tgs, "default", "f32")
    launches = _launches()
    want = golden["default"]
    rel = {k: (abs(got[k] - v) / abs(v) if v else abs(got[k]))
           for k, v in want.items()}
    dist = tgs.against_golden(got, want, roundoff["default"])
    key, ratio = tgs.worst(dist)
    f32 = {"seconds": secs, "launches_1c": launches["nbody_rows_mma"],
           "launches": {k: v for k, v in launches.items() if v},
           "ints": {k: (got[k], want[k]) for k in tgs.INT_KEYS},
           "max_rel_distance": max(rel.values()),
           "max_rel_key": max(rel, key=rel.get),
           "worst_distance_over_bar": ratio, "worst_key": key,
           "rel_distance": rel}
    checks["f32_launched_1c"] = f32["launches_1c"] > 0
    _line("golden", n=tgs.N_GOLDEN, steps=1000, f64=modes, f32=f32,
          checks=checks)
    if not all(checks.values()):
        _fail(f"golden: {[k for k, v in checks.items() if not v]} failed")


# --------------------------------------------------------------------------
# the device meshes (parallel.sharded, ring, tree_mesh, the ensemble meshes)
# --------------------------------------------------------------------------

def _local_rows_counter():
    """Wrap parallel.sharded._local_rows_force with a call counter: every
    full mesh sweep (sharded_acc_jerk_pot) is one call on a world of one,
    so the count is the closing sweeps of the run. Returns the counter
    dict; the wrapper stays (it only counts)."""
    from al26_tpu_torch.parallel import sharded

    real = getattr(sharded._local_rows_force, "__wrapped__",
                   sharded._local_rows_force)
    count = {"calls": 0}

    def counted(*a, **kw):
        count["calls"] += 1
        return real(*a, **kw)

    counted.__wrapped__ = real
    sharded._local_rows_force = counted
    return count


def _rank_ms(call) -> dict:
    """A rank's call at its shape: `call_ms`, CUDA events around MESH_REPS
    back-to-back calls over the count (bound by the host work where the
    kernel is short), and `kernel_ms`, the port's kernels' own device time
    in one call by name (torch.profiler)."""
    kernels = _kernel_ms(call, reps=MESH_REPS)
    return {"call_ms": _device_ms(call, reps=MESH_REPS, warmup=2),
            "kernel_ms": {k: v["ms"] for k, v in kernels.items()
                          if "sweep" in k or "near_" in k}}


def phase_mesh_virtual(run5: dict, tree_run: dict, ens_run: dict) -> dict:
    """7m: the local body of every mesh path, for all MESH_D ranks in one
    process on the card, assembled and held against the unsplit kernel
    call on the same inputs: the sharded row blocks (kernel 1c, and 1's
    FMA body) and the ring's row x column blocks (1c) at N_KERNEL with
    the jerk and the raw potential (bars 3e-4 / 1e-5 of the max, the
    potential 1e-5); the subcycle's K = MESH_K column slices with K drawn
    from every shard (1c; each slice also against its own f64 FMA-form
    sum, bar 5e-4); the tree's far-field target blocks and near-field
    item shares (kernel 3) at phase 5b's N_TREE fractal state (1e-5);
    kernel 1b's row slices of a (2, 2) split of the 64 x 1000 ensemble
    (1e-5). Each rank's device time at its shape, and the near field's
    pairs a rank."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.ops import cuda_tree as ct
    from al26_tpu_torch.ops import tree as T
    from al26_tpu_torch.parallel import ensemble as ens
    from al26_tpu_torch.parallel import ring, sharded, tree_mesh
    from al26_tpu_torch.units import G_INTERNAL

    d = MESH_D
    c = run5["state0"].cluster
    eps2 = run5["cfg"].eps2
    pos, vel, mass = c.pos, c.vel, c.mass
    n = pos.shape[0]
    blk = n // d
    errs, times, checks = {}, {}, {}

    def hold(name, got, ref, bars):
        e = {k: _rel_err(g, r) for k, g, r in zip(("acc", "jerk", "pot"),
                                                  got, ref)}
        errs[name] = e
        checks[name] = all(e[k] < bars[k] for k in e)

    bars_mma = {"acc": MMA_TOL, "jerk": MMA_TOL, "pot": KERNEL_TOL}
    bars_fma = {"acc": KERNEL_TOL, "jerk": KERNEL_TOL, "pot": KERNEL_TOL}
    for use_mxu, bars in ((True, bars_mma), (False, bars_fma)):
        parts = [sharded._local_rows_force(r, d, pos, vel, mass, eps2,
                                           pot_eps2=1e-30, use_mxu=use_mxu)
                 for r in range(d)]
        got = [torch.cat(x) for x in zip(*parts)]
        ref = cn.kernel_acc_jerk_pot(pos, vel, mass, eps2, pot_eps2=1e-30,
                                     use_mxu=use_mxu)
        name = "sharded_rows_" + ("mma" if use_mxu else "fma")
        hold(name, got, ref, bars)
        times[name + "_rank_ms"] = _rank_ms(
            lambda: sharded._local_rows_force(0, d, pos, vel, mass, eps2,
                                              pot_eps2=1e-30,
                                              use_mxu=use_mxu))

    rows = []
    for r in range(d):
        sl = slice(r * blk, (r + 1) * blk)
        ids = torch.arange(r * blk, (r + 1) * blk, dtype=torch.int32,
                           device=pos.device)
        parts = [ring._partial_block_force(
            pos[sl], vel[sl], ids, pos[s * blk:(s + 1) * blk],
            vel[s * blk:(s + 1) * blk], mass[s * blk:(s + 1) * blk],
            s * blk, eps2, pot_eps2=1e-30) for s in range(d)]
        rows.append([sum(x) for x in zip(*parts)])
    got = [torch.cat(x) for x in zip(*rows)]
    ref = cn.kernel_acc_jerk_pot(pos, vel, mass, eps2, pot_eps2=1e-30)
    hold("ring_blocks_mma", got, ref, bars_mma)
    times["ring_block_ms"] = _rank_ms(lambda: ring._partial_block_force(
        pos[:blk], vel[:blk], torch.arange(blk, dtype=torch.int32,
                                           device=pos.device),
        pos[blk:2 * blk], vel[blk:2 * blk], mass[blk:2 * blk], blk, eps2,
        pot_eps2=1e-30))

    # the subcycle's rows: MESH_K // d from every shard
    g = torch.Generator().manual_seed(7)
    ids = torch.cat([r * blk + torch.randperm(blk, generator=g)[:MESH_K // d]
                     for r in range(d)]).to(torch.int32).to(pos.device)
    pr, vr = pos[ids.long()], vel[ids.long()]
    slice_errs = {}
    tot = None
    for r in range(d):
        a, j = sharded._partial_rows_force(r, d, pr, vr, ids, pos, vel,
                                           mass, eps2)
        sl = slice(r * blk, (r + 1) * blk)
        ra, rj, _ = cn.nbody_rows_plain(
            pr.double(), vr.double(), sharded.slice_ids(ids, r * blk, blk),
            pos[sl].double(), vel[sl].double(), mass[sl].double(), eps2,
            with_pot=False)
        slice_errs[r] = {"acc": _rel_err(a, ra), "jerk": _rel_err(j, rj)}
        tot = (a.double(), j.double()) if tot is None else (
            tot[0] + a.double(), tot[1] + j.double())
    wa, wj, _ = cn.kernel_acc_jerk_pot_rows(pr, vr, ids, pos, vel, mass,
                                            eps2, with_pot=False)
    errs["column_slices_sum"] = {"acc": _rel_err(tot[0], wa),
                                 "jerk": _rel_err(tot[1], wj)}
    errs["column_slices_each"] = slice_errs
    checks["column_slices_sum"] = all(
        v < PRED_MMA_TOL for v in errs["column_slices_sum"].values())
    checks["column_slices_each"] = all(
        v < PRED_MMA_TOL for e in slice_errs.values() for v in e.values())
    times["column_slice_rank_ms"] = _rank_ms(
        lambda: sharded._partial_rows_force(0, d, pr, vr, ids, pos, vel,
                                            mass, eps2))

    # the tree: phase 5b's initial state, its sweep's settings
    tcfg = tree_run["cfg"]
    tc = tree_run["state0"].cluster
    tn = tc.pos.shape[0]
    tree = T.build_block_tree(tc.pos, tc.mass, tcfg.tree_leaf, tc.vel)
    accepts, p2p = T.mac_masks(tree, tcfg.tree_theta)
    kw = dict(leaf=tcfg.tree_leaf, kavg=tcfg.tree_kavg, pot_eps2=1e-30,
              with_jerk=True)
    near = [tree_mesh._near_field_part(r, d, tree, p2p, tn, tcfg.eps2, **kw)
            for r in range(d)]
    ref = ct.near_field(tree.pos_s, tree.mass_s, p2p, tn, tcfg.eps2,
                        vel_s=tree.vel_s, **kw)
    checks["near_no_overflow"] = not any(bool(x[3]) for x in near + [ref])
    hold("tree_near_items", [sum(x[i] for x in near) for i in range(3)],
         ref[:3], bars_fma)
    far = [tree_mesh._far_field_part(r, d, tree, accepts, tcfg.eps2,
                                     pot_eps2=1e-30, with_jerk=True)
           for r in range(d)]
    ref_far = T._monopole_far_field(tree, accepts, tcfg.eps2, G_INTERNAL,
                                    1e-30, with_jerk=True)
    hold("tree_far_blocks", [torch.cat(x) for x in zip(*far)], ref_far,
         bars_fma)
    pairs = [int(ct.near_items(p2p, tcfg.tree_kavg, tn, tcfg.tree_leaf,
                               part=(r, d)).item[2].sum())
             for r in range(d)]
    times["tree_near_rank_ms"] = [_rank_ms(
        lambda r=r: tree_mesh._near_field_part(r, d, tree, p2p, tn,
                                               tcfg.eps2, **kw))
        for r in range(d)]
    times["tree_near_whole_ms"] = _rank_ms(
        lambda: ct.near_field(tree.pos_s, tree.mass_s, p2p, tn, tcfg.eps2,
                              vel_s=tree.vel_s, **kw))
    del tree, accepts, p2p, near, ref, far, ref_far

    # kernel 1b on a (2, 2) split of the 64 x 1000 ensemble
    ec = ens_run["state0"].cluster
    b, en = ec.mass.shape
    acc_e, pot_e = [], []
    for e in range(2):
        sh = slice(e * b // 2, (e + 1) * b // 2)
        parts = [ens._ensemble2d_local(r, 2, ec.pos[sh], ec.vel[sh],
                                       ec.mass[sh], ens_run["cfg"].eps2,
                                       pot_eps2=1e-30) for r in range(2)]
        acc_e.append(torch.cat([p[0] for p in parts], 1))
        pot_e.append(torch.cat([p[1] for p in parts], 1))
    wa, _, wp = cn.kernel_acc_jerk_pot(
        ec.pos.reshape(-1, 3), ec.vel.reshape(-1, 3), ec.mass.reshape(-1),
        ens_run["cfg"].eps2, with_jerk=False, group_size=en, pot_eps2=1e-30)
    errs["group_2x2"] = {"acc": _rel_err(torch.cat(acc_e).reshape(-1, 3),
                                         wa),
                         "pot": _rel_err(torch.cat(pot_e).reshape(-1), wp)}
    checks["group_2x2"] = all(v < KERNEL_TOL
                              for v in errs["group_2x2"].values())
    sh = slice(0, b // 2)
    times["group_rank_ms"] = _rank_ms(lambda: ens._ensemble2d_local(
        0, 2, ec.pos[sh], ec.vel[sh], ec.mass[sh], ens_run["cfg"].eps2,
        pot_eps2=1e-30))
    _line("mesh virtual", ranks=d, n=n, k=MESH_K, tree_n=tn,
          ensemble=[b, en], rel_err=errs, near_pairs_per_rank=pairs,
          rank_times=times, checks=checks)
    if not all(checks.values()):
        _fail(f"mesh virtual: {[k for k, v in checks.items() if not v]} "
              "failed")
    worst = {
        "nbody_rows_mma": max(errs[k][q] for k in ("sharded_rows_mma",
                                                   "ring_blocks_mma")
                              for q in ("acc", "jerk", "pot")),
        "nbody_rows": max(errs["sharded_rows_fma"].values()),
        "near_field": max(errs["tree_near_items"].values()),
        "nbody_rows_group": max(errs["group_2x2"].values()),
    }
    return {"rel_err": worst, "times": times}


def _mesh_run(state, aux, cfg, mesh, force_impl: str, chunks,
              strided: bool = False):
    """fresh_cache and cached chunks under `mesh` (counts set to 0 just
    before, read just after): (state, wall seconds, launches)."""
    import torch

    from al26_tpu_torch.sim.step import (
        fresh_cache, run_steps_cached, run_steps_cached_strided,
    )

    runner = run_steps_cached_strided if strided else run_steps_cached
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = fresh_cache(state, cfg, cfg.integrator, mesh, force_impl)
    for chunk in chunks:
        state, cache = runner(state, cache, aux, cfg, chunk, mesh,
                              force_impl)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0, _launches()


def _host_parity(got_state, ref_state) -> dict:
    from al26_tpu_torch.state import cluster_to_numpy

    return _parity(cluster_to_numpy(got_state.cluster),
                   cluster_to_numpy(ref_state.cluster))


def _parity_ok(par: dict) -> bool:
    return (par["pos_err_over_bar"] <= 1.0 and par["slr_err_over_bar"] <= 1.0
            and par["mass_exact"])


def phase_mesh_world(run5: dict, stride5: dict, tree_run: dict,
                     ens_run: dict, cli: dict, drv: dict) -> dict:
    """7n: a world of one over NCCL (the process initialises it itself),
    through the entry points a user calls, each path with the counts set
    to 0 just before it and read just after, each held against its
    one-device run of the earlier phases at the bars of phase 4
    (tests/test_force_cache.py's): the sharded and the ring run, 20
    steps from phase 5's initial bits (1c, no 2c: the subcycle rows go
    through the column slices); the tree mesh at N_TREE for 5 steps from
    phase 5b's initial state (kernel 3 and 1c); the gravity stride 4
    under the mesh against phase 5s (1c's closing sweeps exactly 9); the
    driver with mesh_shape=(1,) and orbax_dir at N_KERNEL against phase
    6b (a DCP tree at every save, then a resume from step 11's tree); the
    CLI with --mesh_shape 1 against phase 6; the ensemble meshes (1,) and
    (1, 1) at 64 x 1000 against phase 5c (1b). s/Myr beside each one-
    device run's. Returns the launches of the mesh paths, by kernel."""
    import glob
    import tempfile

    import torch
    import torch.distributed as dist

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.io.orbax_backend import (
        latest_step, load_sharded_state,
    )
    from al26_tpu_torch.parallel import ensemble as ens
    from al26_tpu_torch.parallel.sharded import make_mesh, shard_state_rows
    from al26_tpu_torch.sim import driver

    mesh = make_mesh(1, device="cuda")
    world = {"backend": dist.get_backend(), "size": dist.get_world_size()}
    if world != {"backend": "nccl", "size": 1}:
        _fail(f"the world of one is {world}")
    mesh_launches = {}
    results = {}

    def fold(launches):
        for k, v in launches.items():
            mesh_launches[k] = mesh_launches.get(k, 0) + v

    cfg5, steps = run5["cfg"], 20
    for fi in ("sharded", "ring"):
        st, wall, la = _mesh_run(shard_state_rows(run5["state0"], mesh),
                                 run5["aux"], cfg5, mesh, fi, (10, 10))
        checks, _ = _state_checks(st, cfg5, steps)
        par = _host_parity(st, run5["state"])
        checks.update({"parity_phase5": _parity_ok(par),
                       "rows_mma_launched": la["nbody_rows_mma"] > 0,
                       "no_predcols": not (la["nbody_predcols_mma"]
                                           or la["nbody_predcols"])})
        results[fi] = {"s_per_myr": wall / (steps * cfg5.dt),
                       "phase5_s_per_myr": run5["s_per_myr"],
                       "launches": la, **par, "checks": checks}
        fold(la)

    tcfg = tree_run["cfg"]
    st, wall, la = _mesh_run(shard_state_rows(tree_run["state0"], mesh),
                             tree_run["aux"], tcfg, mesh, "tree", (5,))
    checks, _ = _state_checks(st, tcfg, 5)
    par = _host_parity(st, tree_run["state5"])
    checks.update({"parity_phase5b": _parity_ok(par),
                   "near_field_launched": la["near_field"] > 0,
                   "rows_mma_launched": la["nbody_rows_mma"] > 0,
                   "no_predcols": not la["nbody_predcols_mma"]})
    results["tree"] = {"n": N_TREE, "s_per_myr": wall / (5 * tcfg.dt),
                       "phase5b_s_per_myr": tree_run["s_per_myr"],
                       "launches": la, **par, "checks": checks}
    fold(la)

    scfg = cfg5.replace(gravity_stride=STRIDE)
    sweeps = _local_rows_counter()
    st, wall, la = _mesh_run(shard_state_rows(run5["state0"], mesh),
                             run5["aux"], scfg, mesh, "sharded", (10, 10),
                             strided=True)
    closing = sweeps["calls"]
    want = 1 + 2 * _closing_sweeps(steps // 2, STRIDE)
    checks, _ = _state_checks(st, scfg, steps)
    par = _host_parity(st, stride5["state"])
    checks.update({"parity_phase5s": _parity_ok(par),
                   "closing_sweeps": closing == want,
                   "rows_mma_closing_and_rows": la["nbody_rows_mma"]
                   > closing,
                   "no_predcols": not la["nbody_predcols_mma"]})
    results["stride"] = {"stride": STRIDE, "closing_1c_sweeps": closing,
                         "want": want, "s_per_myr": wall / (steps * scfg.dt),
                         "phase5s_s_per_myr": stride5["s_per_myr"],
                         "launches": la, **par, "checks": checks}
    fold(la)

    # the driver with a DCP tree at every save, then a resume from one
    tmp = tempfile.mkdtemp(prefix="al26-mesh-driver-")
    tree_dir = os.path.join(tmp, "dcp")
    dcfg = SimConfig(n=N_KERNEL, rc=1.0, dtype="f32",
                            final_time=0.2, n_plot=2, steps_per_plot=10,
                            seed=42, filename=os.path.join(tmp, "drv"),
                            mesh_shape=(1,), orbax_dir=tree_dir)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = driver.run(dcfg, progress=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    la = _launches()
    fold(la)
    checks, _ = _state_checks(res.state, res.cfg, steps)
    trees = sorted(int(x) for x in os.listdir(tree_dir) if x.isdigit())
    par = _host_parity(res.state, drv["state"])
    mid, _, _ = load_sharded_state(tree_dir, step=11, template=res.state)
    resumed, _, _ = _mesh_run(mid, res.aux, res.cfg, mesh, "auto", (9,))
    par_r = _host_parity(resumed, res.state)
    checks.update({
        "state_files": len(glob.glob(os.path.join(tmp, "drv-state-*"))) == 4,
        "dcp_trees": trees == [1, 11, 20] and latest_step(tree_dir) == 20,
        "parity_phase6b": _parity_ok(par),
        "dcp_resume_parity": _parity_ok(par_r),
        "rows_mma_launched": la["nbody_rows_mma"] > 0,
        "no_predcols": not la["nbody_predcols_mma"]})
    results["driver"] = {"n": N_KERNEL, "dcp_steps": trees,
                         "s_per_myr_with_saves": wall / (steps * dcfg.dt),
                         "phase6b_s_per_myr_with_saves": drv["s_per_myr"],
                         "checkpoint_s": res.phase_seconds.get("checkpoint"),
                         "launches": la, **par,
                         "resume_from_step_11": par_r, "checks": checks}

    # the CLI as a user runs it, with --mesh_shape 1, against phase 6
    ctmp = tempfile.mkdtemp(prefix="al26-mesh-cli-")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "al26_tpu_torch.cli"]
                       + cli["args"] + ["--mesh_shape", "1"], cwd=ctmp,
                       env=env, capture_output=True, text=True, timeout=600)
    cwall = time.perf_counter() - t0
    if r.returncode != 0:
        _fail(f"the CLI with --mesh_shape 1 exited {r.returncode}: "
              f"{r.stderr[-2000:]}")
    states = sorted(glob.glob(os.path.join(ctmp, "smoke-state-*.pkl.zst")))
    final, t_final = _file_state(states[-1])
    par = _parity(final, cli["final"])
    checks = {"state_files": len(states) == 102,
              "time": abs(t_final - 1.0) <= 1e-6,
              "parity_phase6": _parity_ok(par), **_host_invariants(final)}
    results["cli"] = {"command_s": cwall, "phase6_command_s":
                      cli["command_s"], **par, "checks": checks}

    # the ensemble meshes against phase 5c
    ecfg = ens_run["cfg"]
    esteps = sum(ens_run["chunks"])
    for name, m in (("ensemble_1d", ens.make_ensemble_mesh(1, "cuda")),
                    ("ensemble_2d", ens.make_ensemble2d_mesh(1, 1,
                                                             "cuda"))):
        bs, ba = (ens.shard_ensemble if name == "ensemble_1d"
                  else ens.shard_ensemble_2d)(ens_run["state0"],
                                              ens_run["aux"], m)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "ensemble_1d":
            cache = ens.ensemble_fresh_cache(bs, ecfg)
            for chunk in ens_run["chunks"]:
                bs, cache = ens.ensemble_run_steps_cached(bs, cache, ba,
                                                          ecfg, chunk)
        else:
            cache = ens.ensemble2d_fresh_cache(bs, ecfg, m)
            for chunk in ens_run["chunks"]:
                bs, cache = ens.ensemble_run_steps_2d_cached(bs, cache, ba,
                                                             ecfg, chunk, m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        la = _launches()
        fold(la)
        bs = ens.gather_ensemble(bs, m)
        checks = {}
        for k in range(bs.cluster.mass.shape[0]):
            ck, _ = _state_checks(ens._take(bs, k), ecfg, esteps)
            for key, ok in ck.items():
                checks[key] = checks.get(key, True) and ok
        par = _host_parity(bs, ens_run["state"])
        checks.update({"parity_phase5c": _parity_ok(par),
                       "rows_group_launched": la["nbody_rows_group"] > 0,
                       "only_the_window": not any(
                           v for k, v in la.items()
                           if k != "nbody_rows_group")})
        results[name] = {"s_per_myr": wall / (esteps * ecfg.dt),
                         "phase5c_s_per_myr": ens_run["s_per_myr"],
                         "launches": la, **par, "checks": checks}
    _line("mesh world of one", world=world, mesh_launches=mesh_launches,
          **results)
    bad = [f"{k}.{c}" for k, v in results.items()
           for c, ok in v["checks"].items() if not ok]
    if bad:
        _fail(f"mesh world of one: {bad} failed")
    return mesh_launches


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_rank(out_dir: str) -> int:
    """One rank of phase 7p (run by phase_mesh_nccl as `chip_smoke.py
    --nccl-rank DIR`, torchrun's variables in its environment): phase 5's
    N_KERNEL run, 20 steps as two cached chunks of 10 on the (D,) mesh
    ("sharded"), then the 64 x 1000 ensemble of phase 5c on the 1-D
    ensemble mesh; its final states, times and launches into
    DIR/rank<R>.npz."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.parallel import ensemble as ens
    from al26_tpu_torch.parallel.sharded import (
        local_device, make_mesh, shard_state_rows,
    )
    from al26_tpu_torch.sim import init_cluster
    from al26_tpu_torch.state import cluster_to_numpy

    dev = local_device("cuda")
    world = int(os.environ["WORLD_SIZE"])
    mesh = make_mesh(world, device=dev)
    cfg = SimConfig(n=N_KERNEL, rc=1.0, seed=42, dtype="f32",
                    force_impl="auto")
    state, aux, cfg = init_cluster(cfg, device=dev)
    state = shard_state_rows(state, mesh)
    st, wall, la = _mesh_run(state, aux, cfg, mesh, "sharded", (10, 10))
    out = {f"run.{k}": v for k, v in cluster_to_numpy(st.cluster).items()}
    out.update({"run.s_per_myr": wall / (20 * cfg.dt),
                "run.launches": json.dumps(la)})
    b, en, _, chunks = ENSEMBLES[0]
    bs, ba, cfgs = ens.init_ensemble(SimConfig(n=en, rc=1.0, seed=42,
                                               dtype="f32"), b,
                                     device="cpu")
    emesh = ens.make_ensemble_mesh(world, dev)
    bs, ba = ens.shard_ensemble(bs, ba, emesh)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = ens.ensemble_fresh_cache(bs, cfgs[0])
    for chunk in chunks:
        bs, cache = ens.ensemble_run_steps_cached(bs, cache, ba, cfgs[0],
                                                  chunk)
    torch.cuda.synchronize()
    ewall = time.perf_counter() - t0
    la = _launches()
    bs = ens.gather_ensemble(bs, emesh)
    out.update({f"ens.{k}": v for k, v in cluster_to_numpy(bs.cluster)
                .items()})
    out.update({"ens.s_per_myr": ewall / (sum(chunks) * cfgs[0].dt),
                "ens.launches": json.dumps(la)})
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _nccl_results(tmp: str, d: int, run5: dict, ens_run: dict):
    """(checks, result) of phase 7p from its ranks' DIR/rank<R>.npz:
    every rank on the same bits, rank 0 against phases 5 and 5c at the
    bars of phase 4, the kernels launched on every rank, s/Myr beside."""
    import numpy as np

    from al26_tpu_torch.state import cluster_to_numpy

    outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(d)]
    meta = ("s_per_myr", "launches")
    same = all(np.array_equal(o[k], outs[0][k]) for o in outs[1:]
               for k in outs[0] if not k.endswith(meta))
    part = lambda o, p: {k[len(p):]: v for k, v in o.items()
                         if k.startswith(p) and not k.endswith(meta)}
    par = _parity(part(outs[0], "run."),
                  cluster_to_numpy(run5["state"].cluster))
    par_e = _parity(part(outs[0], "ens."),
                    cluster_to_numpy(ens_run["state"].cluster))
    launches = [json.loads(str(o["run.launches"])) for o in outs]
    elaunches = [json.loads(str(o["ens.launches"])) for o in outs]
    checks = {"ranks_same_bits": same, "parity_phase5": _parity_ok(par),
              "parity_phase5c": _parity_ok(par_e),
              "rows_mma_every_rank": all(la["nbody_rows_mma"] > 0
                                         for la in launches),
              "no_predcols": not any(la["nbody_predcols_mma"]
                                     for la in launches),
              "group_every_rank": all(la["nbody_rows_group"] > 0
                                      for la in elaunches)}
    result = {"s_per_myr": [float(o["run.s_per_myr"]) for o in outs],
              "phase5_s_per_myr": run5["s_per_myr"],
              "ensemble_s_per_myr": [float(o["ens.s_per_myr"])
                                     for o in outs],
              "phase5c_s_per_myr": ens_run["s_per_myr"],
              "launches_per_rank": launches,
              "ensemble_launches_per_rank": elaunches,
              "run": par, "ensemble": par_e}
    return checks, result


def phase_mesh_nccl(run5: dict, ens_run: dict) -> None:
    """7p: with two or more cards, min(4, count) NCCL ranks, one process a
    card (torchrun's environment, set here): phase 5's run on the (D,)
    mesh and the 64 x 1000 ensemble on the 1-D ensemble mesh; every rank
    on the same bits, held against phases 5 and 5c at the bars of phase 4.
    With one card, the line says the mesh phases ran a world of one."""
    import tempfile

    import torch

    count = torch.cuda.device_count()
    if count < 2:
        _line("mesh nccl", cards=count, ranks=1,
              note="one card: the mesh phases ran a world of one (7n) and "
                   "virtual ranks (7m)")
        return
    d = min(4, count)
    tmp = tempfile.mkdtemp(prefix="al26-nccl-")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(d),
               LOCAL_WORLD_SIZE=str(d))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--nccl-rank",
         tmp], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(d)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=900)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    bad = [(r, rc, e) for r, (rc, e) in enumerate(errs) if rc != 0]
    if bad:
        _fail(f"NCCL rank {bad[0][0]} exited {bad[0][1]}: "
              f"{bad[0][2][-3000:]}")
    checks, result = _nccl_results(tmp, d, run5, ens_run)
    _line("mesh nccl", cards=count, ranks=d, command_s=wall, **result,
          checks=checks)
    if not all(checks.values()):
        _fail(f"mesh nccl: {[k for k, v in checks.items() if not v]} "
              "failed")


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

    if sys.argv[1:2] == ["--nccl-rank"]:
        return nccl_rank(sys.argv[2])
    phase_device()
    phase_build()
    if sys.argv[1:] == ["--mma"]:
        phase_kernel_mma()
        phase_tree_pred_mma()
        return 0
    if sys.argv[1:] == ["--substep"]:
        phase_substep()
        return 0
    if sys.argv[1:] == ["--nccl"]:
        run5 = phase_slice(N_KERNEL, "hermite4_block")
        phase_mesh_nccl(run5, phase_ensemble_slice(*ENSEMBLES[0]))
        return 0
    records = phase_kernels()
    mma = phase_kernel_mma()
    substep = phase_substep()
    records.append(phase_near_field())
    group = phase_group_kernel()
    phase_parity()
    phase_ensemble_parity()
    phase_tree_accuracy()
    phase_tree_parity()
    phase_slice(8192, "hermite4")
    run5 = phase_slice(N_KERNEL, "hermite4_block")
    stride5 = phase_stride_slice(run5)
    tree, checked, tree_runs = phase_tree_slice()
    phase_tree_stride(tree_runs)
    tree_run = tree_runs["geometric"]
    del tree_runs
    ensembles = [phase_ensemble_slice(*e) for e in ENSEMBLES]
    cli = phase_cli()
    drv = phase_driver(run5["s_per_myr"])
    phase_driver(run5["s_per_myr"], stride=STRIDE,
                 unstrided_s_per_myr=drv["s_per_myr"])
    grid = phase_ensemble_driver()
    phase_analysis(grid, drv, tree_run)
    phase_golden()
    mesh_err = phase_mesh_virtual(run5, tree_run, ensembles[0])["rel_err"]
    mesh_launches = phase_mesh_world(run5, stride5, tree_run, ensembles[0],
                                     cli, drv)
    phase_mesh_nccl(run5, ensembles[0])
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
    group["launches"] = ensembles[0]["launches"]["nbody_rows_group"]
    records.append(group)
    # the matmul bodies: launches from the driver at N_KERNEL (phase 6b),
    # the error the worst of phase 3d's and of the tree run's shapes
    for rec in mma:
        rec["launches"] = drv["launches"][rec["name"]]
        if rec["name"] in checked:
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     checked[rec["name"]]["max_abs_err"])
    records.extend(mma)
    # the fused substep: its launches in phase 5's N_KERNEL run and in
    # phase 6b's run through sim.driver, one of each kernel a substep
    substep["launches"] = {
        phase: {key: launches[key]
                for key in ("substep_predict", "substep_correct")}
        for phase, launches in (("5", run5["launches"]),
                                ("6b", drv["launches"]))}
    records.append(substep)
    # under a mesh (7m's virtual ranks, 7n's world of one): the worst error
    # of each kernel's local bodies, and its launches on the mesh paths
    for rec in records:
        if rec["name"] in mesh_err:
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     mesh_err[rec["name"]])
        rec["mesh_launches"] = mesh_launches.get(rec["name"], 0)
    print(json.dumps({"kernels": records}), flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
