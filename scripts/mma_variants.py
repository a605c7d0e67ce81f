#!/usr/bin/env python3
"""Time design variants of the matmul bodies (kernels 1c and 2c of
al26_tpu_torch/csrc/nbody.cu) against the source as it stands, in one
process on one CUDA card, so that every comparison shares a card.

    python3 scripts/mma_variants.py [--sass DIR] [--tree] [NAME ...]

Each variant is the source with a few text replacements (VARIANTS below:
each undoes one design element, or tries one); every variant is built by
nvcc at once (the flags of ops/cuda_build.py), loaded in turn through
ops/cuda_nbody.py, held against the f64 plain versions and timed with
chip_smoke.py's device-only timer in the order base, variants, reversed
variants, base. Kernel 1c is the main path's full sweep (jerk + raw
potential) of a Plummer N = 32768 cluster, and its acceleration-only
sweep; kernel 2c is K = 256 rows
against it at tau = dt / 2, with the split planner's choice and with at
least 1, 2 and 8 tiles a block; --tree adds 2c at K = 512 against the
N = 409600 fractal cluster's step-start columns. --sass DIR writes the
base library's SASS there. One JSON line per variant, then a summary.
A replacement that no longer matches the source fails the run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

VARIANTS = {
    # one ordered sum over all splits by the last block (no groups)
    "flat_reduction": [("constexpr int RED_GROUP = 16;",
                        "constexpr int RED_GROUP = 1 << 20;")],
    # the SFU's subnormal fix-up back (rsqrtf)
    "rsqrtf": [("using pair_fma::rsqrt_ftz;",
                "__device__ __forceinline__ float rsqrt_ftz(float x) "
                "{ return rsqrtf(x); }")],
    # the self-pair mask in every tile
    "mask_every_tile": [("else if (id_lo < t0 + TJ && id_hi >= t0)",
                         "else if (true)")],
    # the softening added after d2 in every variant
    "eps2_unfolded": [("float d2 = 0.f, r2;\n"
                       "                    if (POT == POT_SEPARATE) {",
                       "float d2 = 0.f, r2;\n"
                       "                    if (true) {")],
    # a fresh tensor-core accumulator every 8 chunks
    "chain8": [("constexpr int MMA_CHAIN = TJ / 8;",
                "constexpr int MMA_CHAIN = 8;")],
    # the per-pair operands split as C8's (Veltkamp, four FP32 operations)
    "veltkamp_a": [("split_mask(w, awh[e], awl[e]);",
                    "split_tf32(w, awh[e], awl[e]);"),
                   ("split_mask(w * s, ash[e], asl[e]);",
                    "split_tf32(w * s, ash[e], asl[e]);")],
    # 2 blocks an SM (128 registers) for every variant
    "two_blocks": [("constexpr int MMA_MIN_BLOCKS = 3;",
                    "constexpr int MMA_MIN_BLOCKS = 2;")],
    # 4 blocks an SM (64 registers) for the variants without the jerk
    "four_blocks_no_jerk": [
        ("__launch_bounds__(MT, MMA_MIN_BLOCKS)",
         "__launch_bounds__(MT, (WITH_JERK ? MMA_MIN_BLOCKS : 4))")],
    # no overlap: the next tile is fetched and staged after the sweep
    "single_buffer": [
        ("        if (more)\n"
         "            fetch_column<WITH_JERK, PRED>(raw, tid, t0 + TJ + tid, "
         "c_end, a);\n", ""),
        ("        if (more) {\n"
         "            cp_async_wait_all();\n",
         "        __syncthreads();\n"
         "        if (more) {\n"
         "            fetch_column<WITH_JERK, PRED>(raw, tid, t0 + TJ + tid, "
         "c_end, a);\n"
         "            cp_async_wait_all();\n")],
}


def patched(src: str, reps) -> str:
    for old, new in reps:
        if src.count(old) != 1:
            raise RuntimeError(f"replacement does not match once: {old!r}")
        src = src.replace(old, new)
    return src


def build(names, out_dir):
    """{name: (library, ptxas lines of the matmul bodies)}, one nvcc each,
    all at once."""
    from al26_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC, "nbody.cu")) as fh:
        base = fh.read()
    procs = {}
    for name in names:
        src = base if name == "base" else patched(base, VARIANTS[name])
        cu = os.path.join(out_dir, f"nbody_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        lib = os.path.join(out_dir, f"libnbody_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        ptxas = [f"{lines[i][lines[i].index('pair_sweep_mma'):][:40]} "
                 f"{lines[i + 2].split(':')[-1].strip()} | "
                 f"{lines[i + 1].strip()}"
                 for i, ln in enumerate(lines)
                 if "pair_sweep_mma" in ln and i + 2 < len(lines)]
        out[name] = (lib, ptxas)
    return out


def use(lib_path):
    """Bind ops/cuda_nbody.py to one variant's library."""
    from al26_tpu_torch.ops import cuda_build, cuda_nbody as cn

    cn._lib = None
    real = cuda_build.build
    cuda_build.build = lambda name: lib_path
    try:
        cn.load()
    finally:
        cuda_build.build = real
    cn._SLOTS.clear()
    cn.split_plan.cache_clear()


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.sim import init_cluster

    if not torch.cuda.is_available():
        print("mma_variants: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    sass_dir = None
    if "--sass" in args:
        k = args.index("--sass")
        sass_dir = args[k + 1]
        del args[k:k + 2]
    tree = "--tree" in args
    names = [a for a in args if a != "--tree"] or list(VARIANTS)
    cs.phase_device()
    tmp = tempfile.mkdtemp(prefix="al26-mma-variants-")
    libs = build(["base", *names], tmp)
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        sass = subprocess.run(["cuobjdump", "-sass", libs["base"][0]],
                              capture_output=True, text=True)
        with open(os.path.join(sass_dir, "nbody_base.sass"), "w") as fh:
            fh.write(sass.stdout + sass.stderr)

    dev = torch.device("cuda")
    d = lambda t: t.double()
    cfg = SimConfig(n=cs.N_KERNEL, rc=1.0, seed=7, dtype="f32")
    state, _, cfg = init_cluster(cfg, device=dev)
    c = state.cluster
    pos, vel, mass, eps2 = c.pos, c.vel, c.mass, cfg.eps2
    n = cs.N_KERNEL
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ref1 = cn.nbody_rows_plain(d(pos), d(vel), ids, d(pos), d(vel), d(mass),
                               eps2, pot_eps2=1e-30, use_mxu=True)
    a0, j0, _ = cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2)
    rng = np.random.default_rng(3)
    sel = torch.as_tensor(rng.choice(n, 256, replace=False),
                          dtype=torch.int32, device=dev)
    tau = torch.tensor(0.5 * cfg.dt, dtype=torch.float32, device=dev)
    pf, vf = cn.predict_columns(pos[sel], vel[sel], a0[sel], j0[sel], tau)
    pf, vf = pf.contiguous(), vf.contiguous()
    ref2 = cn.nbody_predcols_plain(d(pf), d(vf), sel, d(pos), d(vel), d(a0),
                                   d(j0), d(mass), d(tau), eps2,
                                   use_mxu=True)
    shapes = {"pred256": (pf, vf, sel, pos, vel, a0, j0, mass, tau, eps2)}
    if tree:
        from al26_tpu_torch.sim.step import fresh_cache

        tcfg = SimConfig(n=cs.N_TREE, model="fractal", rc=1.0, seed=42,
                         dtype="f32", force_impl="tree")
        tstate, _, tcfg = init_cluster(tcfg, device=dev)
        cache = fresh_cache(tstate, tcfg, tcfg.integrator, None, "tree")
        tc = tstate.cluster
        tpf, tvf, tsel, ttau = cs._fast_rows(tc, cache[0], cache[1], tcfg)
        shapes["pred512"] = (tpf, tvf, tsel, tc.pos, tc.vel, cache[0],
                             cache[1], tc.mass, ttau, tcfg.eps2)

    def measure(name):
        use(libs[name][0])
        got = cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2,
                            pot_eps2=1e-30, use_mxu=True)
        again = cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2,
                              pot_eps2=1e-30, use_mxu=True)
        g2 = cn.nbody_predcols(pf, vf, sel, pos, vel, a0, j0, mass, tau,
                               eps2, use_mxu=True)
        rec = {"rel_err": {
            "full_acc": cs._rel_err(got[0], ref1[0]),
            "full_jerk": cs._rel_err(got[1], ref1[1]),
            "full_pot": cs._rel_err(got[2], ref1[2]),
            "pred_acc": cs._rel_err(g2[0], ref2[0]),
            "pred_jerk": cs._rel_err(g2[1], ref2[1])},
            "same_bits": all(torch.equal(x, y) for x, y in zip(got, again))}
        launch, _ = cn.rows_mma_launcher(pos, vel, ids, pos, vel, mass, eps2,
                                         pot_eps2=1e-30)
        rec["full32768_ms"] = cs._device_ms(launch)
        launch, _ = cn.rows_mma_launcher(pos, vel, ids, pos, vel, mass, eps2,
                                         with_jerk=False, with_pot=False)
        rec["acc32768_ms"] = cs._device_ms(launch)
        for key, sh in shapes.items():
            for tiles in (None, 1, 2, 8):
                saved = cn._MIN_TILES
                if tiles is not None:
                    cn._MIN_TILES = tiles
                cn.split_plan.cache_clear()
                plan = cn.PredcolsMma(*sh[3:])
                launch, _ = plan.launcher(*sh[:3], sh[8])
                rec[f"{key}_min{tiles or cn._MIN_TILES}_ms"] = \
                    cs._device_ms(launch)
                rec[f"{key}_min{tiles or cn._MIN_TILES}_plan"] = \
                    cn.split_plan(sh[0].shape[0], sh[3].shape[0],
                                cn._mma_slots(dev, True, cn.POT_NONE, True))
                cn._MIN_TILES = saved
                cn.split_plan.cache_clear()
        return rec

    order = ["base", *names, *reversed(names), "base"]
    runs = {}
    for name in order:
        runs.setdefault(name, []).append(measure(name))
    summary = {}
    for name in ["base", *names]:
        recs = runs[name]
        print(json.dumps({"variant": name, "ptxas": libs[name][1],
                          "runs": recs}), flush=True)
        summary[name] = {k: [r[k] for r in recs] for k in recs[0]
                         if k.endswith("_ms")}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
