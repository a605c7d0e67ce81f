#!/usr/bin/env python3
"""Time kernel 3 (near_field) and kernel 1b (nbody_rows_group) on the
device alone at their paths' shapes: an earlier tree's kernels against
this checkout's, in turns, in one process on one CUDA card.

    python3 scripts/near_group_turns.py [--parent DIR] [--parent-only]
                                        [--items S,S,...] [--no-slice]
                                        [--variants NAME,NAME,...|all]
                                        [--out FILE]

--parent DIR is a checkout of a tree whose kernels predate the redesign
(kernel 3: one CTA per target block over every listed pair; kernel 1b:
the group branch of the plain sweep). Its csrc/tree.cu and csrc/nbody.cu
are built with this checkout's nvcc flags into al26_tpu_torch/_build/
and bound through their C interface of that time. --parent-only times
those alone: this checkout's kernels are neither built nor launched.
--items tries this checkout's near field at each item size S (pairs a
work item; the wrapper's ITEM_PAIRS otherwise). --no-slice skips the
N = 409600 tree slice's state. --variants adds this checkout's kernels
with one design element of the shared FMA loop undone or changed
(VARIANTS: text replacements in a copy of csrc/, built at once, each
bound in turn through ops/cuda_tree.py and ops/cuda_nbody.py); a
replacement that no longer matches the source fails the run.

Shapes (those of chip_smoke.py):
  * kernel 3, jerk and the raw potential, on the tree and MAC of a
    fractal N = 131072 cluster (phase 3b's) and of the N = 409600 tree
    slice's state after its 10 steps (phase 5b's: init_cluster,
    fresh_cache, two cached chunks of 5 steps);
  * kernel 1b on the initial states of the 64 x 1000 and 8 x 10240
    ensembles: jerk + raw potential, acceleration only, acceleration +
    raw potential (phase 3c's modes), and 512 scattered rows.

Each: CUDA events around back-to-back launches of a bare launcher (its
arguments and outputs prepared once), in the order parent, this, this,
parent; the largest error against the f64 plain version (of the max);
whether a repeat gives the same bits. The near field's lines also carry
its pair classes, run lengths, the needed pair interactions and the bound
(chip_smoke._near_stats, _near_bound). One JSON line per shape on
stdout, each also appended to FILE with --out.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

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
            ("        if (i + 1 < n_tiles) stage(i + 1, (i + 1) & 1);\n"
             "        const int t0 = c_begin + i * TJ;\n"
             "        const int ncols = min(TJ, c_end - t0);\n"
             "        const pair_fma::Tile&",
             "        const int t0 = c_begin + i * TJ;\n"
             "        const int ncols = min(TJ, c_end - t0);\n"
             "        const pair_fma::Tile&"),
            ("        cp_async_wait_all();\n        __syncthreads();\n    }\n"
             "    if (live) {\n"
             "        float* out = partial + ((size_t)blockIdx.y * b + row)"
             " * NSUM;\n        out[0] = s.ax;",
             "        __syncthreads();\n"
             "        if (i + 1 < n_tiles) stage(i + 1, (i + 1) & 1);\n"
             "        cp_async_wait_all();\n        __syncthreads();\n    }\n"
             "    if (live) {\n"
             "        float* out = partial + ((size_t)blockIdx.y * b + row)"
             " * NSUM;\n        out[0] = s.ax;")]},
    # the inner loop unrolled by 4
    "unroll4": {"pair_fma.cuh": [("#pragma unroll 8", "#pragma unroll 4")]},
}


def _emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    for path in _OUT:
        with open(path, "a") as fh:
            fh.write(line + "\n")


def build_parent(parent: str):
    """The parent's tree.cu and nbody.cu as libraries, one nvcc each, at
    once; their entry points bound with the signatures of that tree."""
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
        libs[name] = ctypes.CDLL(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tree = libs["tree.cu"]
    tree.near_field_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, f, f, f,
                                       i, i, p, p, p, p]
    tree.near_field_launch.restype = i
    nbody = libs["nbody.cu"]
    nbody.nbody_rows_launch.argtypes = [p, p, p, i, p, p, p, i, f, f, f, i,
                                        i, i, i, p, i, p, p, p, p]
    nbody.nbody_rows_launch.restype = i
    return tree, nbody


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


def parent_near_launcher(lib, tree, p2p, n_true, eps2, leaf, kavg):
    """The parent's kernel 3 (jerk, raw potential) on one tree: the pair
    list as per-target runs of every listed pair; (launch, outputs)."""
    import torch

    from al26_tpu_torch.ops import tree as tt

    b = p2p.shape[0]
    ti, sj, ok, _ = tt.pack_pair_list(p2p, kavg)
    count = torch.zeros(b, dtype=torch.int32, device=p2p.device)
    count.index_add_(0, ti.long(), ok.to(torch.int32))
    start = (torch.cumsum(count, 0, dtype=torch.int32) - count).contiguous()
    src = sj.contiguous()
    pos = tree.pos_s.float().contiguous()
    vel = tree.vel_s.float().contiguous()
    mass = tree.mass_s.float().contiguous()
    acc = torch.empty((b, leaf, 3), dtype=torch.float32, device=p2p.device)
    jerk = torch.empty_like(acc)
    pot = torch.empty((b, leaf), dtype=torch.float32, device=p2p.device)
    threads = min(256, -(-leaf // 32) * 32)
    stream = torch.cuda.current_stream().cuda_stream
    args = (pos.data_ptr(), vel.data_ptr(), mass.data_ptr(), src.data_ptr(),
            start.data_ptr(), count.data_ptr(), b, leaf, int(n_true),
            threads, float(eps2), 1e-30, float(_g()), 1, 1, acc.data_ptr(),
            jerk.data_ptr(), pot.data_ptr(), stream)
    keep = (pos, vel, mass, src, start, count, acc, jerk, pot)

    def launch(_keep=keep):
        return lib.near_field_launch(*args)

    return launch, (acc, jerk, pot)


def parent_group_launcher(lib, rp, rv, ids, pos, vel, mass, eps2, gs, mode):
    """The parent's kernel 1b in one mode; (launch, outputs)."""
    import torch

    from al26_tpu_torch.ops import cuda_nbody as cn

    b, n = rp.shape[0], pos.shape[0]
    splits = cn._splits(b, n, gs)
    partial = torch.empty((splits, b, 7), dtype=torch.float32,
                          device=pos.device)
    acc = torch.empty((b, 3), dtype=torch.float32, device=pos.device)
    jerk = torch.empty_like(acc)
    pot = torch.empty((b,), dtype=torch.float32, device=pos.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (rp.data_ptr(), rv.data_ptr(), ids.data_ptr(), b, pos.data_ptr(),
            vel.data_ptr(), mass.data_ptr(), n, float(eps2),
            float(mode.get("pot_eps2") or 0.0), float(_g()),
            int(mode.get("with_jerk", True)), int(mode.get("with_pot", True)),
            int(mode.get("pot_eps2") is not None), gs, partial.data_ptr(),
            splits, acc.data_ptr(), jerk.data_ptr(), pot.data_ptr(), stream)

    def launch(_keep=(rp, rv, ids, pos, vel, mass, partial, acc, jerk,
                      pot)):
        return lib.nbody_rows_launch(*args)

    return launch, (acc, jerk, pot)


def _g():
    from al26_tpu_torch.units import G_INTERNAL

    return G_INTERNAL


def _errors(got, ref, names):
    import chip_smoke as cs

    return {k: cs._rel_err(g, r) for k, g, r in zip(names, got, ref)
            if r is not None}


def _turns(subjects: dict, reps: int) -> dict:
    """{name: [ms, ms]}: each subject's device time per launch, in the
    order of the subjects, then reversed."""
    import chip_smoke as cs

    order = list(subjects) + list(reversed(list(subjects)))
    out = {}
    for name in order:
        out.setdefault(name, []).append(cs._device_ms(subjects[name],
                                                      reps=reps))
    return out


def _same_bits(launch, outs) -> bool:
    import torch

    first = [o.clone() for o in outs if o is not None]
    if launch() != 0:
        return False
    torch.cuda.synchronize()
    return all(torch.equal(a, b)
               for a, b in zip(first, [o for o in outs if o is not None]))


def near_shape(label, tree, p2p, n_true, eps2, leaf, kavg, parent, items,
               current, variants):
    import torch

    import chip_smoke as cs
    from al26_tpu_torch.ops import cuda_tree as ct

    stats = cs._near_stats(p2p, n_true, leaf)
    d = lambda t: t.double()
    ref = ct.near_field_plain(d(tree.pos_s), d(tree.mass_s), p2p, n_true,
                              eps2, leaf=leaf, kavg=kavg, pot_eps2=1e-30,
                              vel_s=d(tree.vel_s), with_jerk=True)
    subjects, errs, same = {}, {}, {}
    names = ("acc", "jerk", "pot")
    if parent is not None:
        launch, outs = parent_near_launcher(parent, tree, p2p, n_true, eps2,
                                            leaf, kavg)
        if launch() != 0:
            raise RuntimeError("the parent's near field failed to launch")
        torch.cuda.synchronize()
        errs["parent"] = _errors(outs, ref[:3], names)
        same["parent"] = _same_bits(launch, outs)
        subjects["parent"] = launch
    if current:
        saved = ct.ITEM_PAIRS
        for s in items or [saved]:
            ct.ITEM_PAIRS = s
            launch, outs = ct.near_field_launcher(
                tree.pos_s, tree.mass_s, p2p, n_true, eps2, leaf=leaf,
                kavg=kavg, pot_eps2=1e-30, vel_s=tree.vel_s, with_jerk=True)
            if launch() != 0:
                raise RuntimeError(f"the near field failed at S = {s}")
            torch.cuda.synchronize()
            errs[f"S{s}"] = _errors(outs[:3], ref[:3], names)
            same[f"S{s}"] = _same_bits(launch, outs[:3])
            subjects[f"S{s}"] = launch
        ct.ITEM_PAIRS = saved
    for name, libs in variants.items():
        use(libs)
        launch, outs = ct.near_field_launcher(
            tree.pos_s, tree.mass_s, p2p, n_true, eps2, leaf=leaf,
            kavg=kavg, pot_eps2=1e-30, vel_s=tree.vel_s, with_jerk=True)
        use(None)
        if launch() != 0:
            raise RuntimeError(f"the near field failed in variant {name}")
        torch.cuda.synchronize()
        errs[name] = _errors(outs[:3], ref[:3], names)
        same[name] = _same_bits(launch, outs[:3])
        subjects[name] = launch
    times = _turns(subjects, NEAR_REPS)
    _emit({"shape": label, "kernel": "near_field", "n": n_true,
           "leaf": leaf, "kavg": kavg, "eps2": eps2, "ms": times,
           "rel_err": errs, "repeat_same_bits": same, **stats,
           **cs._near_bound(stats, leaf),
           "gpairs_per_s": {k: stats["needed_interactions"] / (min(v) * 1e6)
                            for k, v in times.items()}})


def group_shapes(b, n, parent, current, variants):
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
        ref = cn.nbody_rows_plain(d(rp), d(rv), rows, d(pos), d(vel),
                                  d(mass), eps2, group_size=n, **mk)
        keep = [0] + ([1] if mk.get("with_jerk", True) else []) + (
            [2] if mk.get("with_pot", True) else [])
        names = [("acc", "jerk", "pot")[i] for i in keep]
        subjects, errs, same = {}, {}, {}
        cands = []
        if parent is not None:
            cands.append(("parent", parent_group_launcher(
                parent, rp, rv, rows, pos, vel, mass, eps2, n, mk)))
        if current:
            cands.append(("this", cn.rows_launcher(
                rp, rv, rows, pos, vel, mass, eps2, group_size=n, **mk)))
        for name, libs in variants.items():
            use(libs)
            cands.append((name, cn.rows_launcher(
                rp, rv, rows, pos, vel, mass, eps2, group_size=n, **mk)))
            use(None)
        for name, (launch, outs) in cands:
            if launch() != 0:
                raise RuntimeError(f"{name} group kernel failed to launch")
            torch.cuda.synchronize()
            errs[name] = _errors([outs[i] for i in keep],
                                 [ref[i] for i in keep], names)
            same[name] = _same_bits(launch, [outs[i] for i in keep])
            subjects[name] = launch
        times = _turns(subjects, GROUP_REPS)
        pairs = b * n * (n - 1) if mode != "rows512" else 512 * (n - 1)
        with_jerk = mk.get("with_jerk", True)
        bound = cs._bound(pairs, with_jerk,
                          cs._rows_bytes(rows.shape[0], total, with_jerk,
                                         mk.get("with_pot", True)),
                          rsqrt=2 if mk.get("pot_eps2") else 1)
        _emit({"shape": f"{b}x{n} {mode}", "kernel": "nbody_rows_group",
               "splits": cn._splits(rows.shape[0], total, n), "ms": times,
               "rel_err": errs, "repeat_same_bits": same,
               "useful_gpairs_per_s": {k: pairs / (min(v) * 1e6)
                                       for k, v in times.items()},
               **bound})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("near_group_turns: no CUDA device", file=sys.stderr)
        return 2
    import al26_tpu_torch  # noqa: F401  (TF32 off before anything runs)
    import chip_smoke as cs
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.ops import cuda_build
    from al26_tpu_torch.ops import tree as tt
    from al26_tpu_torch.sim import init_cluster
    from al26_tpu_torch.sim.step import fresh_cache, run_steps_cached

    args = sys.argv[1:]
    parent_dir = None
    if "--parent" in args:
        k = args.index("--parent")
        parent_dir = args[k + 1]
        del args[k:k + 2]
    items = []
    if "--items" in args:
        k = args.index("--items")
        items = [int(s) for s in args[k + 1].split(",")]
        del args[k:k + 2]
    names = []
    if "--variants" in args:
        k = args.index("--variants")
        names = (list(VARIANTS) if args[k + 1] == "all"
                 else args[k + 1].split(","))
        del args[k:k + 2]
    if "--out" in args:
        k = args.index("--out")
        _OUT.append(args[k + 1])
        del args[k:k + 2]
    current = "--parent-only" not in args
    cs.phase_device()
    parent = (build_parent(parent_dir) if parent_dir is not None
              else (None, None))
    variants = build_variants(names) if current and names else {}
    if current:
        cuda_build.build_all()
    dev = torch.device("cuda")

    # kernel 3 on phase 3b's fractal N = 131072 tree
    cfg = SimConfig(n=cs.N_NEAR, model="fractal", rc=1.0, seed=7,
                    dtype="f32", force_impl="tree")
    state, _, cfg = init_cluster(cfg, device=dev)
    c = state.cluster
    tree = tt.build_block_tree(c.pos, c.mass, cfg.tree_leaf, c.vel)
    _, p2p = tt.mac_masks(tree, cfg.tree_theta)
    near_shape(f"fractal {cs.N_NEAR}", tree, p2p, cs.N_NEAR, cfg.eps2,
               cfg.tree_leaf, cfg.tree_kavg, parent[0], items, current,
               variants)
    del state, tree, p2p

    # kernel 1b on both ensembles
    for b, n, _, _ in cs.ENSEMBLES:
        group_shapes(b, n, parent[1], current, variants)

    if "--no-slice" not in args:
        # kernel 3 on the N = 409600 tree slice's state after its steps
        cfg = SimConfig(n=cs.N_TREE, model="fractal", rc=1.0, seed=42,
                        dtype="f32", force_impl="tree")
        state, aux, cfg = init_cluster(cfg, device=dev)
        cache = fresh_cache(state, cfg, cfg.integrator, None, "tree")
        for _ in range(2):
            state, cache = run_steps_cached(state, cache, aux, cfg, 5, None,
                                            "tree")
        c = state.cluster
        tree = tt.build_block_tree(c.pos, c.mass, cfg.tree_leaf, c.vel)
        _, p2p = tt.mac_masks(tree, cfg.tree_theta)
        near_shape(f"tree slice {cs.N_TREE} after 10 steps", tree, p2p,
                   cs.N_TREE, cfg.eps2, cfg.tree_leaf, cfg.tree_kavg,
                   parent[0], items, current, variants)
        _emit({"shape": f"tree slice {cs.N_TREE} sweep",
               **cs._sweep_breakdown(state, cfg)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
