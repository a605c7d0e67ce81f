#!/usr/bin/env python3
"""Time the kernels that sweep on the shared FMA loop (csrc/pair_fma.cuh)
on the device alone at their paths' shapes: kernel 3 (near_field), kernel
1b (nbody_rows_group) and kernels 1 and 2's FMA bodies (nbody_rows,
nbody_predcols; beside the matmul bodies 1c and 2c at the same shapes).
An earlier tree's kernels against this checkout's, in turns, in one
process on one CUDA card.

    python3 scripts/fma_turns.py [--parent DIR] [--parent-only]
                                 [--kernels near,group,rows,pred]
                                 [--items S,...] [--lanes L,...]
                                 [--min-tiles T,...]
                                 [--variants NAME,...|all] [--no-tree]
                                 [--out FILE]

--parent DIR is an earlier checkout whose kernel 3 has this checkout's C
interface (items, since its redesign) and whose kernels 1, 1b and 2 launch
their sweep and then reduce_partials (the trees before kernels 1 and 2's
redesign). Its csrc/tree.cu and csrc/nbody.cu are built with this
checkout's nvcc flags into al26_tpu_torch/_build/; kernel 3 is bound
through this checkout's ops/cuda_tree.py, kernels 1, 1b and 2 through
their C interface of that time. --parent-only times those alone (kernels
1 and 2 beside this checkout's matmul bodies). --kernels picks the kernels
(all four by default). Subjects of this checkout beside its own plan:
--items, the near field at each item size S (pairs a work item);
--lanes, kernels 1 and 2 at each count L of column lanes a row (the
script replaces cuda_nbody.fma_plan_of); --min-tiles, kernels 1 and 2
with each least number T of tiles a block (cuda_nbody._MIN_TILES);
--variants, every kernel with one design element of the shared loop
undone or changed (VARIANTS: text replacements in a copy of csrc/, built
at once; a replacement that no longer matches the source fails the run).
--no-tree skips the N = 409600 fractal shapes.

Shapes (those of chip_smoke.py):
  * kernel 3, jerk and the raw potential, on the tree and MAC of a
    fractal N = 131072 cluster (phase 3b's) and of the N = 409600 tree
    slice's state after its 10 steps (phase 5b's: init_cluster,
    fresh_cache, two cached chunks of 5 steps);
  * kernel 1b on the initial states of the 64 x 1000 and 8 x 10240
    ensembles: jerk + raw potential, acceleration only, acceleration +
    raw potential (phase 3c's modes), and 512 scattered rows;
  * kernel 1 on Plummer clusters (phase 3's): at N = 32768 the full sweep
    with jerk and the raw potential (pot_eps2 = 1e-30), the
    acceleration-only sweep and 256 scattered rows; at n = 8192 (the
    hermite4 path's size) the full sweep and a substep's jerk-only sweep;
    kernel 2 at K = 256 against the N = 32768 cluster, tau = dt / 2;
  * on the N = 409600 tree slice's initial state, kernel 1's fractal
    virial sum (acceleration and the potential at eps2 = 1e-30; errors on
    2048 rows) and kernel 2 at K = k_fast = 512 against the step-start
    columns (chip_smoke._fast_rows).

Each: CUDA events around back-to-back launches of a bare launcher (its
arguments and outputs prepared once), in the order of the subjects
(parent, this, the forced plans and variants, the matmul body), then
reversed; the largest error against the f64 plain version (of the max);
whether a repeat gives the same bits; the bound (chip_smoke._bound, and
_bound_mma for the matmul body; the near field's from its needed pair
interactions, with its pair classes and run lengths: _near_stats,
_near_bound). One JSON line per shape on stdout, each also appended to
FILE with --out.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

KERNELS = ("near", "group", "rows", "pred")
NEAR_REPS = 20
GROUP_REPS = 50
# --out: a file each result line is appended to as well
_OUT = []

VARIANTS = {
    # rsqrtf, with its subnormal fix-up, for the SFU's ftz rsqrt
    "rsqrtf": {"pair_fma.cuh": [
        ('asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
         "y = rsqrtf(x);")]},
    # the select in every tile
    "mask_every_tile": {
        "tree.cu": [("if (sb == t || col0 + ncols > a.n_true)",
                     "if (true)")],
        "nbody.cu": [("if (uniform && ncols == TJ && (t0 > s_hi || "
                      "t0 + TJ <= s_lo))", "if (false)")]},
    # no staging overlap: the next tile is copied after the sweep
    "single_buffer": {
        "tree.cu": [
            ("            if (j + 1 < n_tiles) stage(j + 1, (j + 1) & 1);\n"
             "            const int sb", "            const int sb"),
            ("            pair_fma::cp_async_wait_all();\n"
             "            __syncthreads();\n        }\n"
             "        if (!live) continue;",
             "            __syncthreads();\n"
             "            if (j + 1 < n_tiles) stage(j + 1, (j + 1) & 1);\n"
             "            pair_fma::cp_async_wait_all();\n"
             "            __syncthreads();\n        }\n"
             "        if (!live) continue;")],
        "nbody.cu": [
            ("        if (more) stage(i + 1, (i + 1) & 1);\n", ""),
            ("        if (more) {\n"
             "            cp_async_wait_all();        // tile i + 1 has "
             "landed\n",
             "        __syncthreads();\n"
             "        if (more) {\n"
             "            stage(i + 1, (i + 1) & 1);\n"
             "            cp_async_wait_all();\n")]},
    # the inner loop unrolled by 4
    "unroll4": {"pair_fma.cuh": [("#pragma unroll 8", "#pragma unroll 4")]},
    # the ordered split sum with half the slab loads in flight
    "slab_unroll2": {"nbody.cu": [
        ("#pragma unroll 4\n    for (int k = k0; k < k1; k += step) {",
         "#pragma unroll 2\n    for (int k = k0; k < k1; k += step) {")]},
}


def _emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    for path in _OUT:
        with open(path, "a") as fh:
            fh.write(line + "\n")


def _g():
    from al26_tpu_torch.units import G_INTERNAL

    return G_INTERNAL


def build_parent(parent: str):
    """The parent's tree.cu and nbody.cu as libraries, one nvcc each, at
    once: (the tree.cu library's path, bound later through this checkout's
    ops/cuda_tree.py, whose C interface kernel 3 has had since its
    redesign; the nbody.cu library, its nbody_rows_launch and
    nbody_predcols_launch bound with the two-launch signatures of the
    trees before kernels 1 and 2's redesign)."""
    from al26_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "parent")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("tree.cu", "nbody.cu"):
        lib = os.path.join(out_dir, f"libparent_{name[:-3]}.so")
        src = os.path.join(parent, "al26_tpu_torch", "csrc", name)
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}:\n{log}")
        libs[name] = lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    nbody = ctypes.CDLL(libs["nbody.cu"])
    nbody.nbody_rows_launch.argtypes = [p, p, p, i, p, p, p, i, f, f, f, i,
                                        i, i, i, p, i, p, p, p, p]
    nbody.nbody_rows_launch.restype = i
    nbody.nbody_predcols_launch.argtypes = [p, p, p, i, p, p, p, p, p, i, p,
                                            f, f, p, i, p, p, p]
    nbody.nbody_predcols_launch.restype = i
    return libs["tree.cu"], nbody


def build_variants(names):
    """{name: {source: library}}: each variant's csrc/ copy with its
    replacements, tree.cu and nbody.cu built by one nvcc each, all at
    once."""
    import shutil

    from al26_tpu_torch.ops import cuda_build

    procs = {}
    for name in names:
        out_dir = os.path.join(cuda_build.BUILD_DIR, "variants", name)
        if os.path.isdir(out_dir):
            shutil.rmtree(out_dir)
        shutil.copytree(cuda_build.CSRC, out_dir)
        for fname, reps in VARIANTS[name].items():
            path = os.path.join(out_dir, fname)
            with open(path) as fh:
                src = fh.read()
            for old, new in reps:
                if src.count(old) != 1:
                    raise RuntimeError(f"variant {name}: {fname} does not "
                                       f"match once: {old!r}")
                src = src.replace(old, new)
            with open(path, "w") as fh:
                fh.write(src)
        for cu in ("tree.cu", "nbody.cu"):
            lib = os.path.join(out_dir, f"lib{cu[:-3]}.so")
            procs[(name, cu)] = (lib, subprocess.Popen(
                [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                 os.path.join(out_dir, cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for (name, cu), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name} {cu}:\n{log}")
        out.setdefault(name, {})[cu] = lib
    return out


def use(libs) -> None:
    """Bind ops/cuda_tree.py and ops/cuda_nbody.py to a variant's
    libraries ({source: library}), or (None) to this checkout's own."""
    from al26_tpu_torch.ops import cuda_build, cuda_nbody as cn
    from al26_tpu_torch.ops import cuda_tree as ct

    real = cuda_build.build
    if libs is not None:
        cuda_build.build = lambda name: libs[name]
    ct._lib = cn._lib = None
    try:
        ct.load()
        cn.load()
    finally:
        cuda_build.build = real


@contextlib.contextmanager
def forced_lanes(lanes: int):
    """cuda_nbody's FMA plan with `lanes` column lanes a row: split_plan at
    that variant's own occupancy (the plan's rule for one lane count)."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn

    real = cn.fma_plan_of

    def plan_of(b, n, device, with_jerk, with_pot, sep_pot, kind):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        bpsm = cn._fma_blocks_per_sm(device, with_jerk, with_pot, sep_pot,
                                     kind)[cn._FMA_LANES.index(lanes)]
        return (lanes, *cn.split_plan(b, n, sms * bpsm))

    cn.fma_plan_of = plan_of
    try:
        yield
    finally:
        cn.fma_plan_of = real


@contextlib.contextmanager
def forced_min_tiles(tiles: int):
    """cuda_nbody's split plans with _MIN_TILES = tiles."""
    from al26_tpu_torch.ops import cuda_nbody as cn

    saved = cn._MIN_TILES
    cn._MIN_TILES = tiles
    cn.split_plan.cache_clear()
    cn.fma_plan.cache_clear()
    try:
        yield
    finally:
        cn._MIN_TILES = saved
        cn.split_plan.cache_clear()
        cn.fma_plan.cache_clear()


def parent_rows_launcher(lib, rp, rv, ids, pos, vel, mass, eps2,
                         group_size=0, with_jerk=True, with_pot=True,
                         pot_eps2=None):
    """The parent's kernel 1 (group_size 0) or 1b in one mode, its sweep
    and then reduce_partials; (launch, (acc, jerk, pot))."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn

    b, n, dev = rp.shape[0], pos.shape[0], pos.device
    splits = cn._splits(b, n, group_size)
    partial = torch.empty((splits, b, 7), dtype=torch.float32, device=dev)
    acc = torch.empty((b, 3), dtype=torch.float32, device=dev)
    jerk = torch.empty_like(acc)
    pot = torch.empty((b,), dtype=torch.float32, device=dev)
    args = (rp.data_ptr(), rv.data_ptr(), ids.data_ptr(), b, pos.data_ptr(),
            vel.data_ptr(), mass.data_ptr(), n, float(eps2),
            float(pot_eps2 or 0.0), float(_g()), int(with_jerk),
            int(with_pot), int(pot_eps2 is not None), group_size,
            partial.data_ptr(), splits, acc.data_ptr(), jerk.data_ptr(),
            pot.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def launch(_keep=(rp, rv, ids, pos, vel, mass, partial, acc, jerk,
                      pot)):
        return lib.nbody_rows_launch(*args)

    return launch, (acc, jerk, pot)


def parent_pred_launcher(lib, pf, vf, ids, pos, vel, a0, j0, mass, tau,
                         eps2):
    """The parent's kernel 2, its sweep and then reduce_partials;
    (launch, (acc, jerk))."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn

    b, n, dev = pf.shape[0], pos.shape[0], pos.device
    splits = cn._splits(b, n)
    partial = torch.empty((splits, b, 7), dtype=torch.float32, device=dev)
    acc = torch.empty((b, 3), dtype=torch.float32, device=dev)
    jerk = torch.empty_like(acc)
    args = (pf.data_ptr(), vf.data_ptr(), ids.data_ptr(), b, pos.data_ptr(),
            vel.data_ptr(), a0.data_ptr(), j0.data_ptr(), mass.data_ptr(), n,
            tau.data_ptr(), float(eps2), float(_g()), partial.data_ptr(),
            splits, acc.data_ptr(), jerk.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def launch(_keep=(pf, vf, ids, pos, vel, a0, j0, mass, tau, partial, acc,
                      jerk)):
        return lib.nbody_predcols_launch(*args)

    return launch, (acc, jerk)


def _asked(ref, kw) -> tuple:
    """The plain outputs (acc, jerk[, pot]) a mode computes, None for the
    others."""
    return tuple(r if nm == "acc" or kw.get(f"with_{nm}", True) else None
                 for nm, r in zip(("acc", "jerk", "pot"), ref))


def _same_bits(launch, outs) -> bool:
    import torch

    first = [o.clone() for o in outs]
    if launch() != 0:
        return False
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, outs))


def _variant_subjects(make, variants) -> list:
    """[(name, make())] with the kernels bound to each variant's
    libraries."""
    out = []
    for name, libs in variants.items():
        use(libs)
        out.append((name, make()))
        use(None)
    return out


def run_shape(label, kernel, cands, ref, reps, warmup=3, rows=None,
              pairs=None, **extra) -> None:
    """Check every subject (name, (launch, outputs)) against `ref` (the
    f64 plain outputs, None where not compared; on the rows `rows` only,
    where given), time them in turns and emit the line."""
    import torch

    import chip_smoke as cs

    keep = [k for k, r in enumerate(ref) if r is not None]
    names = [("acc", "jerk", "pot")[k] for k in keep]
    errs, same, subjects = {}, {}, {}
    for name, (launch, outs) in cands:
        if launch() != 0:
            raise RuntimeError(f"{label}: {name} failed to launch")
        torch.cuda.synchronize()
        outs = [outs[k] for k in keep]
        got = outs if rows is None else [o[rows.long()] for o in outs]
        errs[name] = {nm: cs._rel_err(g, ref[k])
                      for nm, g, k in zip(names, got, keep)}
        same[name] = _same_bits(launch, outs)
        subjects[name] = launch
    times = {}
    for name in list(subjects) + list(reversed(list(subjects))):
        times.setdefault(name, []).append(
            cs._device_ms(subjects[name], reps=reps, warmup=warmup))
    if pairs is not None:
        extra["gpairs_per_s"] = {k: pairs / (min(v) * 1e6)
                                 for k, v in times.items()}
    _emit({"shape": label, "kernel": kernel, "ms": times, "rel_err": errs,
           "repeat_same_bits": same, **extra})


def _bounds(pairs, with_jerk, sep_pot, nbytes) -> dict:
    """The FMA body's bound, the matmul body's as mma_bound_*, and the
    pairs (run_shape's rates)."""
    import chip_smoke as cs

    mma = cs._bound_mma(pairs, with_jerk, sep_pot, nbytes)
    return {**cs._bound(pairs, with_jerk, nbytes, rsqrt=2 if sep_pot else 1),
            "mma_bound_ms": mma["bound_ms"],
            "mma_bound_pipe": mma["bound_pipe"], "pairs": pairs}


def near_shape(label, tree, p2p, n_true, eps2, leaf, kavg, parent, args,
               variants) -> None:
    """Kernel 3 on one tree and MAC."""
    import chip_smoke as cs
    from al26_tpu_torch.ops import cuda_build
    from al26_tpu_torch.ops import cuda_tree as ct

    stats = cs._near_stats(p2p, n_true, leaf)
    d = lambda t: t.double()
    kw = dict(leaf=leaf, kavg=kavg, pot_eps2=1e-30, with_jerk=True)
    ref = ct.near_field_plain(d(tree.pos_s), d(tree.mass_s), p2p, n_true,
                              eps2, vel_s=d(tree.vel_s), **kw)[:3]
    make = lambda: ct.near_field_launcher(tree.pos_s, tree.mass_s, p2p,
                                          n_true, eps2, vel_s=tree.vel_s,
                                          **kw)
    cands = []
    if parent is not None:
        use({"tree.cu": parent, "nbody.cu": cuda_build.build("nbody.cu")})
        cands.append(("parent", make()))
        use(None)
    if not args.parent_only:
        saved = ct.ITEM_PAIRS
        for s in args.items or [saved]:
            ct.ITEM_PAIRS = s
            cands.append((f"S{s}", make()))
        ct.ITEM_PAIRS = saved
        cands += _variant_subjects(make, variants)
    run_shape(label, "near_field", cands, ref, NEAR_REPS,
              pairs=stats["needed_interactions"], n=n_true, leaf=leaf,
              kavg=kavg, eps2=eps2, **stats, **cs._near_bound(stats, leaf))


def group_shapes(b, n, parent, args, variants) -> None:
    """Kernel 1b on the initial state of a b x n ensemble, in each mode."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from al26_tpu_torch.ops import cuda_nbody as cn

    dev = torch.device("cuda")
    bs, _, cfgs = cs._ensemble(b, n, dev)
    eps2, total = cfgs[0].eps2, b * n
    c = bs.cluster
    pos, vel = c.pos.reshape(total, 3), c.vel.reshape(total, 3)
    mass = c.mass.reshape(total)
    ids = torch.arange(total, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(5)
    sel = torch.as_tensor(np.sort(rng.choice(total, 512, replace=False)),
                          dtype=torch.int32, device=dev)
    sel = sel[torch.as_tensor(rng.permutation(512), device=dev)]
    d = lambda t: t.double()
    modes = {"jerk_pot": dict(pot_eps2=1e-30),
             "acc": dict(with_jerk=False, with_pot=False),
             "acc_pot": dict(with_jerk=False, pot_eps2=1e-30),
             "rows512": dict(with_pot=False)}
    for mode, mk in modes.items():
        rows = ids if mode != "rows512" else sel
        rp, rv = pos[rows.long()].contiguous(), vel[rows.long()].contiguous()
        inputs = (rp, rv, rows, pos, vel, mass, eps2)
        ref = cn.nbody_rows_plain(d(rp), d(rv), rows, d(pos), d(vel),
                                  d(mass), eps2, group_size=n, **mk)
        make = lambda: cn.rows_launcher(*inputs, group_size=n, **mk)
        cands = []
        if parent is not None:
            cands.append(("parent", parent_rows_launcher(
                parent, *inputs, group_size=n, **mk)))
        if not args.parent_only:
            cands.append(("this", make()))
            cands += _variant_subjects(make, variants)
        pairs = b * n * (n - 1) if mode != "rows512" else 512 * (n - 1)
        with_jerk = mk.get("with_jerk", True)
        run_shape(f"{b}x{n} {mode}", "nbody_rows_group", cands,
                  _asked(ref, mk), GROUP_REPS, pairs=pairs,
                  splits=cn._splits(rows.shape[0], total, n),
                  **cs._bound(pairs, with_jerk,
                              cs._rows_bytes(rows.shape[0], total,
                                             with_jerk,
                                             mk.get("with_pot", True)),
                              rsqrt=2 if mk.get("pot_eps2") else 1))


def fma_shape(label, kind, inputs, kw, ref, parent, args, variants, reps,
              bounds, warmup=3, rows=None) -> None:
    """Kernel 1 (kind "rows") or 2 ("pred") at one shape: the parent's,
    this checkout's at its own plan, at each forced plan and in each
    variant, and the matmul body."""
    from al26_tpu_torch.ops import cuda_nbody as cn

    b, n, dev = inputs[0].shape[0], inputs[3].shape[0], inputs[0].device
    if kind == "rows":
        make = lambda: cn.rows_launcher(*inputs, **kw)
        flags = (kw.get("with_jerk", True), kw.get("with_pot", True),
                 kw.get("pot_eps2") is not None, cn.KIND_ROWS)
        mma = cn.rows_mma_launcher(*inputs, **kw)
        old = parent_rows_launcher
    else:
        make = lambda: cn.predcols_launcher(*inputs, **kw)
        flags = (True, False, False, cn.KIND_PRED)
        mma = cn.PredcolsMma(*inputs[3:8], kw["eps2"]).launcher(
            *inputs[:3], inputs[8])
        old = parent_pred_launcher
    cands, plans = [], {}
    if parent is not None:
        cands.append(("parent", old(parent, *inputs, **kw)))
    if not args.parent_only:
        runs = ([("this", contextlib.nullcontext())]
                + [(f"this_L{k}", forced_lanes(k)) for k in args.lanes]
                + [(f"this_T{t}", forced_min_tiles(t))
                   for t in args.min_tiles])
        for name, ctx in runs:
            with ctx:
                cands.append((name, make()))
                plans[name] = cn.fma_plan_of(b, n, dev, *flags)
        cands += _variant_subjects(make, variants)
    cands.append(("mma", mma))
    run_shape(label, "nbody_rows" if kind == "rows" else "nbody_predcols",
              cands, _asked(ref, kw), reps, warmup, rows, plans=plans,
              **bounds)


def plummer_shapes(parent, args, variants) -> None:
    """Kernels 1 and 2 at phase 3's shapes: N = 32768 and n = 8192."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.sim import init_cluster

    dev = torch.device("cuda")
    d = lambda t: t.double()
    kernels = args.kernels
    for n in (cs.N_KERNEL, 8192):
        if "rows" not in kernels and n != cs.N_KERNEL:
            continue
        cfg = SimConfig(n=n, rc=1.0, seed=7, dtype="f32")
        state, _, cfg = init_cluster(cfg, device=dev)
        c = state.cluster
        pos, vel, mass, eps2 = c.pos, c.vel, c.mass, cfg.eps2
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        cols = (pos, vel, ids, pos, vel, mass)
        modes = ({"full": dict(pot_eps2=1e-30),
                  "acc": dict(with_jerk=False, with_pot=False)}
                 if n == cs.N_KERNEL else
                 {"full": dict(pot_eps2=1e-30), "force": dict(with_pot=False)})
        for mode, mk in modes.items():
            if "rows" not in kernels:
                break
            ref = cn.nbody_rows_plain(d(pos), d(vel), ids, d(pos), d(vel),
                                      d(mass), eps2, **mk)
            wj, wp = mk.get("with_jerk", True), mk.get("with_pot", True)
            fma_shape(f"{mode}{n}", "rows", cols, dict(eps2=eps2, **mk), ref,
                      parent, args, variants,
                      20 if n == cs.N_KERNEL else 50,
                      _bounds(n * (n - 1), wj, "pot_eps2" in mk,
                              cs._rows_bytes(n, n, wj, wp)))
        if n != cs.N_KERNEL:
            continue
        rng = np.random.default_rng(3)
        sel = torch.as_tensor(rng.choice(n, 256, replace=False),
                              dtype=torch.int32, device=dev)
        rp, rv = pos[sel].contiguous(), vel[sel].contiguous()
        if "rows" in kernels:
            ref = cn.nbody_rows_plain(d(rp), d(rv), sel, d(pos), d(vel),
                                      d(mass), eps2, with_pot=False)
            fma_shape("rows256", "rows", (rp, rv, sel, pos, vel, mass),
                      dict(eps2=eps2, with_pot=False), ref, parent, args,
                      variants, 50,
                      _bounds(256 * (n - 1), True, False,
                              cs._rows_bytes(256, n, True, False)))
        if "pred" in kernels:
            # kernel 2 at K = 256, as phase 3 builds its rows
            a0, j0, _ = cn.nbody_rows(pos, vel, ids, pos, vel, mass, eps2)
            tau = torch.tensor(0.5 * cfg.dt, dtype=torch.float32, device=dev)
            pf, vf = cn.predict_columns(pos[sel], vel[sel], a0[sel], j0[sel],
                                        tau)
            pf = (pf + 1e-4 * torch.as_tensor(rng.normal(size=(256, 3)),
                                              dtype=torch.float32,
                                              device=dev)).contiguous()
            vf = vf.contiguous()
            ref = cn.nbody_predcols_plain(d(pf), d(vf), sel, d(pos), d(vel),
                                          d(a0), d(j0), d(mass), d(tau),
                                          eps2)
            fma_shape("pred256", "pred",
                      (pf, vf, sel, pos, vel, a0, j0, mass, tau),
                      dict(eps2=eps2), ref, parent, args, variants, 50,
                      _bounds(256 * (n - 1), True, False,
                              52 * 256 + 52 * n + 4))


def tree_shapes(parent_tree, parent_nbody, args, variants) -> None:
    """The N = 409600 tree slice: kernels 1 and 2 on its initial state,
    kernel 3 after its 10 steps, and one tree sweep's breakdown."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_nbody as cn
    from al26_tpu_torch.ops import tree as tt
    from al26_tpu_torch.sim import init_cluster
    from al26_tpu_torch.sim.step import fresh_cache, run_steps_cached

    dev = torch.device("cuda")
    d = lambda t: t.double()
    n = cs.N_TREE
    cfg = SimConfig(n=n, model="fractal", rc=1.0, seed=42, dtype="f32",
                    force_impl="tree")
    state, aux, cfg = init_cluster(cfg, device=dev)
    cache = fresh_cache(state, cfg, cfg.integrator, None, "tree")
    c = state.cluster
    if "rows" in args.kernels:
        zeros = torch.zeros_like(c.pos)
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        rows = torch.as_tensor(np.sort(np.random.default_rng(11).choice(
            n, 2048, replace=False)), dtype=torch.int32, device=dev)
        ref = cn.nbody_rows_plain(d(c.pos[rows]), d(zeros[rows]), rows,
                                  d(c.pos), d(zeros), d(c.mass), 1e-30,
                                  with_jerk=False)
        fma_shape(f"virial{n}", "rows",
                  (c.pos, zeros, ids, c.pos, zeros, c.mass),
                  dict(eps2=1e-30, with_jerk=False), ref, parent_nbody,
                  args, variants, 5,
                  _bounds(n * (n - 1), False, False,
                          cs._rows_bytes(n, n, False, True)),
                  warmup=1, rows=rows)
        del zeros
    if "pred" in args.kernels:
        a0, j0 = cache[0], cache[1]
        pf, vf, sel, tau = cs._fast_rows(c, a0, j0, cfg)
        k = pf.shape[0]
        ref = cn.nbody_predcols_plain(d(pf), d(vf), sel, d(c.pos), d(c.vel),
                                      d(a0), d(j0), d(c.mass), d(tau),
                                      cfg.eps2)
        fma_shape(f"pred{k}", "pred",
                  (pf, vf, sel, c.pos, c.vel, a0, j0, c.mass, tau),
                  dict(eps2=cfg.eps2), ref, parent_nbody, args, variants, 50,
                  _bounds(k * (n - 1), True, False, 52 * k + 52 * n + 4))
    if "near" not in args.kernels:
        return
    for _ in range(2):
        state, cache = run_steps_cached(state, cache, aux, cfg, 5, None,
                                        "tree")
    c = state.cluster
    tree = tt.build_block_tree(c.pos, c.mass, cfg.tree_leaf, c.vel)
    _, p2p = tt.mac_masks(tree, cfg.tree_theta)
    near_shape(f"tree slice {n} after 10 steps", tree, p2p, n, cfg.eps2,
               cfg.tree_leaf, cfg.tree_kavg, parent_tree, args, variants)
    _emit({"shape": f"tree slice {n} sweep",
           **cs._sweep_breakdown(state, cfg)})


def main() -> int:
    ints = lambda s: [int(x) for x in s.split(",")]
    ap = argparse.ArgumentParser(
        description="Kernels 3, 1b, 1 and 2 (the shared FMA loop) on the "
                    "device alone, an earlier tree's against this one's in "
                    "turns.")
    ap.add_argument("--parent", metavar="DIR")
    ap.add_argument("--parent-only", action="store_true")
    ap.add_argument("--kernels", type=lambda s: s.split(","),
                    default=list(KERNELS))
    ap.add_argument("--items", type=ints, default=[])
    ap.add_argument("--lanes", type=ints, default=[])
    ap.add_argument("--min-tiles", type=ints, default=[])
    ap.add_argument("--variants", default="")
    ap.add_argument("--no-tree", action="store_true")
    ap.add_argument("--out", metavar="FILE")
    args = ap.parse_args()
    unknown = set(args.kernels) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}; of {KERNELS}")
    import torch

    if not torch.cuda.is_available():
        print("fma_turns: no CUDA device", file=sys.stderr)
        return 2
    import al26_tpu_torch  # noqa: F401  (TF32 off before anything runs)
    import chip_smoke as cs
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_build
    from al26_tpu_torch.ops import tree as tt
    from al26_tpu_torch.sim import init_cluster

    if args.out:
        _OUT.append(args.out)
    cs.phase_device()
    parent_tree, parent_nbody = (build_parent(args.parent) if args.parent
                                 else (None, None))
    names = (list(VARIANTS) if args.variants == "all"
             else [v for v in args.variants.split(",") if v])
    variants = (build_variants(names)
                if names and not args.parent_only else {})
    cuda_build.build_all()
    dev = torch.device("cuda")

    if "near" in args.kernels:
        # kernel 3 on phase 3b's fractal N = 131072 tree
        cfg = SimConfig(n=cs.N_NEAR, model="fractal", rc=1.0, seed=7,
                        dtype="f32", force_impl="tree")
        state, _, cfg = init_cluster(cfg, device=dev)
        c = state.cluster
        tree = tt.build_block_tree(c.pos, c.mass, cfg.tree_leaf, c.vel)
        _, p2p = tt.mac_masks(tree, cfg.tree_theta)
        near_shape(f"fractal {cs.N_NEAR}", tree, p2p, cs.N_NEAR, cfg.eps2,
                   cfg.tree_leaf, cfg.tree_kavg, parent_tree, args,
                   variants)
        del state, c, tree, p2p
    if "group" in args.kernels:
        for b, n, _, _ in cs.ENSEMBLES:
            group_shapes(b, n, parent_nbody, args, variants)
    if {"rows", "pred"} & set(args.kernels):
        plummer_shapes(parent_nbody, args, variants)
    if not args.no_tree and {"near", "rows", "pred"} & set(args.kernels):
        tree_shapes(parent_tree, parent_nbody, args, variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
