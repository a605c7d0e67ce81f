"""Run driver: checkpointed simulation loop + resume (the port of
al26_tpu/sim/driver.py).

Mirrors the reference `main()` control flow (al26_nbody.py:1612-1766):
initialise (or reload) -> initial checkpoint #0 -> loop with a save every
`steps_per_plot` iterations -> final checkpoint. Between saves the physics
runs on the run's device through sim.step's runners (the force cache
threaded across checkpoint chunks); the host touches data only at
checkpoint boundaries, where the state is copied to the host on the
driver thread (state.cluster_to_numpy) and serialised by a background
writer (io.async_writer), which never sees a CUDA tensor.

Save cadence parity: the reference saves on iterations where
n_iter % steps_per_plot == 0 (al26_nbody.py:1754-1758), i.e. after steps
1, 11, 21, ... — 100 checkpoints plus the initial one. We keep that cadence
and additionally write a final checkpoint at exactly t_f (the reference only
does so when float accumulation overshoots t_f and triggers a clamped
zero-length step, al26_nbody.py:820-825 — writing it always is strictly
more useful and format-identical).

The files are the JAX package's (io.checkpoint): either package resumes
the other's runs. `device` (default "cuda") is where the run computes; a
"cuda" run on a machine without a card raises, it never falls back to the
CPU.

Device meshes (torch.distributed, one rank per device; launched with
`torchrun --nproc_per_node D`, where "cuda" means cuda:LOCAL_RANK): a
single run with mesh_shape=(D,) splits its pairwise work by rows over the
D ranks (parallel.sharded; every rank holds the whole state), and an
ensemble runs on the 1-D ensemble mesh (the world, when it divides the
realizations) or, with mesh_shape=(E, R), on the 2-D (ens x rows) mesh
(parallel.ensemble). Only rank 0 writes a single run's reference-format
files and shows progress; on an ensemble mesh each realization's files
are written by the rank that runs it (rank 0 of its rows group). With
orbax_dir every save also writes the SimState as a DCP tree first
(io.orbax_backend), which every rank takes part in. All ranks meet a
barrier before they return.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import SimConfig
from ..io import checkpoint as ckpt
from ..io import compression, ubjson
from ..io.compat import (Args, Converter, Metadata, Quantity,
                         cluster_to_particles, particles_to_cluster)
from ..io.yields_store import Yields
from ..parallel.sharded import local_device
from ..state import SimState, cluster_to_numpy
from ..units import myr
from ..utils.timing import (PhaseTimers, count, enabled, maybe_start_trace,
                            maybe_stop_trace, span)
from .init import SimAux, init_cluster


def run_device(device) -> torch.device:
    """The run's device, "cuda" meaning cuda:LOCAL_RANK; a CUDA device
    must exist (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' asked for, but torch finds no CUDA device; "
            "run on the CPU explicitly (device='cpu', --device cpu)")
    return local_device(device)


def _lead() -> bool:
    """Is this process rank 0 (or the only process)? Read before the
    process group exists too, from torchrun's RANK."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", 0)) == 0


def _barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier()


def _run_mesh(cfg: SimConfig, n_total: int, device):
    """The 1-D row mesh of a single run with cfg.mesh_shape (None
    without); the star count must divide across it."""
    if not cfg.mesh_shape:
        return None
    from ..parallel.sharded import make_mesh

    n_dev = int(np.prod(cfg.mesh_shape))
    if n_total % n_dev != 0:
        raise ValueError(
            f"mesh_shape={cfg.mesh_shape}: star count {n_total} must "
            f"divide across {n_dev} devices (pad n or change the mesh)")
    return make_mesh(n_dev, device=device)


@dataclass
class RunResult:
    state: SimState
    aux: SimAux
    cfg: SimConfig
    metadata: Metadata
    yields: Yields
    wall_time_s: float
    # seconds per driver phase: "physics" (the step chunks), "checkpoint"
    # (the driver thread's share of the saves: the host copy, the hand-off,
    # the final flush) and "writer" (the writer thread's serialisation)
    phase_seconds: dict = field(default_factory=dict)


def _metadata_from_cfg(cfg: SimConfig) -> Metadata:
    args = Args(**cfg.to_dict(),
                final_time_myr=cfg.final_time)
    md = Metadata(args, cfg.final_time, filename=cfg.filename)
    return md


def _yields_mode(cfg, final: bool) -> str:
    """Frames mode appends one O(N) frame per save and only writes the
    reference-format blob at the final save (io.yields_store docstring)."""
    if not getattr(cfg, "yields_frames", False):
        return "rewrite"
    return "both" if final else "frames"


def _host_copy(state: SimState):
    """(cluster as numpy, time in Myr): the device-to-host copy of a save,
    made on the driver thread. With tracing on, the wait for the device's
    queued work is a span of its own (an explicit synchronize; the copies
    would wait for it anyway); each copy is one count of
    host_reads.driver.host_copy."""
    if enabled() and state.time.is_cuda:
        with span("driver.save.device_wait"):
            torch.cuda.synchronize(state.time.device)
    with span("driver.save.host_copy"):
        cluster, t_myr = cluster_to_numpy(state.cluster), float(state.time)
    count("host_reads.driver.host_copy", len(cluster) + 1)
    return cluster, t_myr


def _save(base, metadata, converter, yields, cluster_np, t_myr, cfg,
          increment=True, verbose=False, final=False):
    metadata.update(t_myr, increment_checkpoint=increment)
    if getattr(cfg, "validate", True):
        from ..utils.validate import validate_cluster_dict

        validate_cluster_dict(cluster_np, t_myr,
                              cfg.low_mass_min, cfg.low_mass_max)
    particles = cluster_to_particles(cluster_np)
    yields.update_state(t_myr, particles)
    ckpt.save_checkpoint(
        base, metadata.most_recent_checkpoint, particles, converter,
        yields, metadata, verbose=verbose,
        yields_mode=_yields_mode(cfg, final),
    )


def _append_trajectory(rows: np.ndarray,
                       path: str = "interloper_trajectory.dat") -> None:
    """Append per-step interloper rows, reference format
    (al26_nbody.py:1030-1037): t_sim, t_agb, x, y, z, bary_dist — written
    only once the AGB clock is positive. (The reference accidentally writes
    its y coordinate into the z column, al26_nbody.py:1034; we write the
    real z.)"""
    active = rows[rows[:, 1] > 0.0]
    if len(active) == 0:
        return
    with open(path, "a") as f:
        for r in active:
            f.write("{:.3e},{:.3e},{:.3e},{:.3e},{:.3e},{:.3e}\n".format(*r))


def _drop_stale_state_files(base: str, k: int) -> None:
    """Delete state files numbered ABOVE the resumed checkpoint. A -nc K
    resume truncates the CSV/frames/blob to t_K, but the higher-numbered
    state files of the abandoned timeline would survive — and a LATER
    plain resume picks the global max (most_recent_checkpoint), silently
    restarting from the stale timeline while the yields artifacts track
    the new one."""
    import glob
    import re

    rx = re.compile(re.escape(base) + r"-state-(\d+)\.pkl\.zst$")
    for f in glob.glob(base + "-state-*"):
        m = rx.search(f)
        if m and int(m.group(1)) > k:
            os.remove(f)


def _reset_trajectory(resume_t: Optional[float],
                      path: str = "interloper_trajectory.dat") -> None:
    """Trajectory-file analogue of the CSV/frames truncation. Cold run:
    remove a stale file from a previous run in this cwd. Resume: drop rows
    with t_sim >= the resumed checkpoint time — STRICT, unlike the CSV's
    boundary-keeping truncation, because each row carries the PREVIOUS
    step's time (step._traj_row uses s_old.time), so the resumed run's
    first step re-emits the row AT t_resume. Rows are written at %.3e (4
    significant digits); the compare happens in that quantised domain."""
    if resume_t is None:
        if os.path.exists(path):
            os.remove(path)
        return
    if not os.path.exists(path):
        return
    t_cut = float(f"{resume_t:.3e}")
    eps = 1e-9 * max(1.0, abs(t_cut))
    with open(path) as f:
        lines = f.readlines()
    keep = []
    for ln in lines:
        try:
            t = float(ln.split(",", 1)[0])
        except ValueError:
            keep.append(ln)
            continue
        if t < t_cut - eps:
            keep.append(ln)
    if len(keep) != len(lines):
        with open(path, "w") as f:
            f.writelines(keep)


def _bound_resumed_yields(yields: Yields, base: str, cfg: SimConfig,
                          t_myr: float) -> None:
    """Prepare a resumed yields store for writing: truncate the CSV's
    stale future rows (resume from an earlier checkpoint, -nc K; all
    modes), then in frames mode truncate stale future frames, seed the
    framed file from the blob history when only the reference-format
    blob exists (e.g. a reference-written run), and drop the per-star
    history from RAM (io.yields_store bounded mode)."""
    yields.truncate_csv(t_myr)
    if not getattr(cfg, "yields_frames", False):
        # rewrite mode restored the FULL history from the blob: a -nc
        # resume must drop the future snapshots here too, or update_state
        # appends the re-simulated ones after them and every rewrite
        # emits a non-monotonic time series
        yields.truncate_memory(t_myr)
        return
    frames_path = ckpt.yields_frames_filename(base)
    if os.path.exists(frames_path):
        yields.truncate_frames(frames_path, t_myr)
    else:
        # blob-only resume: a -nc resume from an earlier checkpoint must
        # not seed the framed file with the blob's FUTURE snapshots
        yields.truncate_memory(t_myr)
        yields.backfill_frames(frames_path)
    yields.bound()


def load_run(base: str, n_checkpoint: Optional[int] = None,
             override_cfg: Optional[SimConfig] = None,
             data_dir: Optional[str] = None, device="cuda"):
    """Resume from checkpoint files (al26_nbody.py:1647-1656, 1734-1737) —
    the port's, the JAX package's or the reference's — onto `device`.
    Returns (state, aux, cfg, metadata, yields, converter). `data_dir`
    reaches the aux rebuild (AGB wind tables) — an interloper run started
    with a custom table directory must resume from the SAME tables."""
    from .init import build_aux, resolve_integrator

    device = run_device(device)
    if n_checkpoint is None:
        n_checkpoint = ckpt.most_recent_checkpoint(base)
    particles, converter, yields, metadata = ckpt.load_checkpoint(
        base, n_checkpoint
    )
    metadata.update_access_time()
    cfg = override_cfg or SimConfig.from_checkpoint_dict(vars(metadata.args))
    dtype = torch.float64 if cfg.dtype == "f64" else torch.float32
    cluster = particles_to_cluster(particles, dtype=dtype, device=device)
    host = cluster_to_numpy(cluster)
    if not isinstance(converter, Converter):
        # reference-written file: the AMUSE nbody_to_si converter loads as
        # an opaque stub — rebuild ours so the next save can re-pickle it
        converter = Converter(cfg.rc, float(host["mass"].sum()))
    t_myr = float(metadata.time.value_in(myr))
    state = SimState(
        cluster=cluster,
        time=torch.tensor(t_myr, dtype=dtype, device=device),
        step_count=torch.tensor(round(t_myr / cfg.dt), dtype=torch.int32,
                                device=device),
    )
    # resolve the integrator knobs exactly like a cold start: our
    # checkpoints store the resolved values (a no-op), but reference-
    # written metadata carries no integrator/k_fast/leapfrog_n_sub keys
    cfg = resolve_integrator(cfg, float(host["mass"].sum()))
    aux = build_aux(cfg, host["m0"], dtype, data_dir,
                    host["is_interloper"], device=device)
    return state, aux, cfg, metadata, yields, converter


def _extend(cfg: SimConfig, extend_t: float, t_now: float, steps_done: int,
            metas) -> SimConfig:
    """`-r X -t_f T`: extend the resumed run to ~T on the ORIGINAL step
    grid (SimConfig.extended_to) and write the new schedule into each
    stored args, so the NEXT resume continues the extended run."""
    cfg = cfg.extended_to(extend_t)
    if cfg.n_steps <= steps_done:
        # a target at/behind the resumed time would be a silent no-op —
        # refuse loudly; the -nc path IS the truncation tool
        raise ValueError(
            f"-t_f {extend_t} does not extend this resume: the "
            f"checkpoint is already at t = {t_now} Myr. To shorten a run, "
            f"resume from an earlier checkpoint with -nc instead"
        )
    for md in metas:
        md.args.final_time = cfg.final_time
        md.args.n_plot = cfg.n_plot
        md.args.dt_override = cfg.dt_override
        md.t_f = Quantity(cfg.final_time, myr)
    if abs(cfg.final_time - extend_t) > 1e-9 * max(1.0, extend_t):
        print(f"# extend: final time snapped to the save grid: "
              f"{extend_t} -> {cfg.final_time} Myr")
    return cfg


def run(cfg: SimConfig, progress: bool = True,
        data_dir: Optional[str] = None, device="cuda") -> RunResult:
    """Full checkpointed run (cold start or resume) on `device`; under
    cfg.mesh_shape, this rank's part of the mesh run (module docstring)."""
    t_wall0 = time.time()
    started = maybe_start_trace()
    device = run_device(device)
    lead = _lead()
    if lead:
        print(f"# checkpoint writer: {compression.writer()}")
        print(f"# yields codec: {ubjson.codec()}")

    with span("driver.init"):
        # capture BEFORE load_run replaces cfg with the checkpoint's restored
        # config (reference semantics, al26_nbody.py:1647) — whose own reload
        # field is empty
        reload_base = cfg.reload
        extend_t = cfg.extend_final_time
        fresh_verbose = cfg.verbose
        if extend_t is not None and not reload_base:
            raise ValueError(
                "extend_final_time is a resume directive: set reload too "
                "(a cold start takes its schedule from final_time/n_plot)"
            )
        if reload_base:
            state, aux, cfg, metadata, yields, converter = load_run(
                reload_base, cfg.n_checkpoint, data_dir=data_dir, device=device
            )
            # -v is a property of the INVOCATION, not the stored run
            cfg = cfg.replace(verbose=fresh_verbose)
            if extend_t is not None:
                cfg = _extend(cfg, extend_t, float(state.time),
                              int(state.step_count), [metadata])
            # the stored run's mesh; every rank has read the files before
            # rank 0 truncates them
            mesh = _run_mesh(cfg, state.cluster.n, device)
            _barrier(mesh)
            # continue writing at the PATH the user pointed at, not at
            # metadata.filename (which records only the original base NAME)
            base = reload_base
            if lead:
                _bound_resumed_yields(yields, base, cfg, float(state.time))
                # a -nc K resume rewrites checkpoints K+1... — drop the
                # abandoned timeline's higher-numbered state files now
                _drop_stale_state_files(base, metadata.most_recent_checkpoint)
                if cfg.orbax_dir:
                    # same for the DCP tree, or its latest_step resumes the
                    # abandoned timeline
                    from ..io.orbax_backend import drop_steps_above

                    drop_steps_above(cfg.orbax_dir, int(state.step_count))
        else:
            mesh = _run_mesh(cfg, cfg.n + int(cfg.interloper), device)
            # a backend the mesh (or its absence) refuses, before any file
            from .step import _check_backend

            _check_backend(mesh, cfg.force_impl)
            state, aux, cfg = init_cluster(cfg, data_dir, device=device)
            metadata = _metadata_from_cfg(cfg)
            base = metadata.filename
            host, t0 = _host_copy(state)
            converter = Converter(cfg.rc, float(host["mass"].sum()))
            yields = Yields(base, bounded=bool(getattr(cfg, "yields_frames",
                                                       False)))
            # initial checkpoint #0 (al26_nbody.py:1741-1745)
            if lead:
                _save(base, metadata, converter, yields, host, t0, cfg,
                      increment=False, verbose=cfg.verbose)
        if mesh is not None:
            from ..parallel.sharded import shard_state_rows

            state = shard_state_rows(state, mesh)

    n_done = int(state.step_count)
    n_steps = cfg.n_steps
    spp = cfg.steps_per_plot

    bar = None
    if progress and lead:
        try:
            from tqdm import tqdm
            bar = tqdm(total=cfg.final_time, desc="Simulation", unit="Myr",
                       initial=float(state.time))
        except ImportError:
            pass

    timers = PhaseTimers()
    write_traj = cfg.interloper and cfg.interloper_trajectory
    if write_traj and lead:
        # cold run: clear a previous run's rows in this cwd; resume: drop
        # rows beyond the resumed checkpoint
        _reset_trajectory(float(state.time) if reload_base else None)

    # thread the force cache across checkpoint chunks so even a chunk's
    # first step reuses the previous chunk's closing O(N^2) evaluation
    from .step import (
        _cacheable, _resolve_integ, fresh_cache, run_steps, run_steps_cached,
        run_steps_cached_strided, run_steps_traj, run_steps_traj_cached,
        stride_active,
    )

    c = state.cluster
    use_cache = _cacheable(cfg, c.n, c.pos.dtype, c.pos.device, mesh,
                           cfg.force_impl)
    # the stride's interior physics steps have no per-step row collection,
    # so trajectory runs stay unstrided (and cached)
    use_stride = (not write_traj) and stride_active(
        cfg, c.n, c.pos.dtype, c.pos.device, mesh, cfg.force_impl)
    cache = [None]

    def seed_cache(s):
        if cache[0] is None:
            cache[0] = fresh_cache(s, cfg, _resolve_integ(cfg, s.cluster.n),
                                   mesh, cfg.force_impl)

    def advance_steps(s, n):
        if write_traj:
            if use_cache:
                seed_cache(s)
                s, cache[0], rows = run_steps_traj_cached(
                    s, cache[0], aux, cfg, n, mesh, cfg.force_impl)
            else:
                s, rows = run_steps_traj(s, aux, cfg, n, mesh,
                                         cfg.force_impl)
            if lead:
                _append_trajectory(rows.cpu().numpy())
            return s
        if use_cache:
            seed_cache(s)
            runner = run_steps_cached_strided if use_stride \
                else run_steps_cached
            s, cache[0] = runner(s, cache[0], aux, cfg, n, mesh,
                                 cfg.force_impl)
            return s
        return run_steps(s, aux, cfg, n, mesh, cfg.force_impl)

    # background checkpoint writer: host serialisation overlaps the next
    # chunk's device compute (ordering-preserving; errors re-raised here)
    writer = None
    if getattr(cfg, "async_saves", True):
        from ..io.async_writer import AsyncCheckpointWriter

        writer = AsyncCheckpointWriter()

    def do_save(s, increment=True, final=False):
        if cfg.orbax_dir:
            # the DCP tree first, on every rank
            from ..io.orbax_backend import save_sharded_state

            save_sharded_state(cfg.orbax_dir, int(s.step_count), s, cfg)
        if not lead:
            return
        # the device-to-host copy on THIS thread: the writer thread only
        # ever sees numpy arrays
        host, t_myr = _host_copy(s)

        def job():
            with timers.phase("writer"):
                _save(base, metadata, converter, yields, host, t_myr, cfg,
                      increment=increment, verbose=cfg.verbose, final=final)
        if writer is not None:
            writer.submit(job)
        else:
            job()

    try:
        k = n_done
        saved_final = False
        while k < n_steps:
            # one step, then save (reference cadence: save after steps
            # 1, 11, ...)
            if k % spp == 0:
                with timers.phase("physics"):
                    state = advance_steps(state, 1)
                k += 1
                with timers.phase("checkpoint"):
                    # a cadence save landing exactly on the last step IS
                    # the final save — a second one would duplicate the
                    # t_f snapshot in the CSV/frames/blob
                    saved_final = k == n_steps
                    do_save(state, final=saved_final)
            else:
                chunk = min(spp - (k % spp), n_steps - k)
                with timers.phase("physics"):
                    state = advance_steps(state, chunk)
                k += chunk
            if bar is not None:
                count("host_reads.driver.progress")
                bar.n = round(float(state.time), 6)
                bar.refresh()

        # final checkpoint at exactly t_f (skipped when the loop's last
        # cadence save already was it, or when a resume of an ALREADY
        # COMPLETE run took zero steps — its final artifacts exist)
        with timers.phase("checkpoint"):
            if not saved_final and k > n_done:
                do_save(state, final=True)
            if writer is not None:
                writer.close()
                writer = None
    finally:
        if writer is not None:  # unwinding on an exception: stop the worker
            try:
                writer.close()
            except RuntimeError:
                pass
    if bar is not None:
        bar.close()
    if started:
        maybe_stop_trace()
    if cfg.verbose and lead:
        print("phase timings:")
        print(timers.report())
    _barrier(mesh)

    return RunResult(
        state=state, aux=aux, cfg=cfg, metadata=metadata, yields=yields,
        wall_time_s=time.time() - t_wall0, phase_seconds=dict(timers.totals),
    )


def load_ensemble(tag_root: str, n_checkpoint: Optional[int] = None,
                  data_dir: Optional[str] = None, device="cuda"):
    """Reload every realization of a pt-grid ensemble (the directories
    run_ensemble writes) onto `device`: returns (states, auxes, cfgs,
    metas, yieldses, converters, sim_dirs), realizations sorted by their
    pt-<k> index.

    Extends the reference's single-run resume semantics
    (al26_nbody.py:1647-1656) across the ensemble axis."""
    import glob
    import re

    cand = sorted(glob.glob(os.path.join(tag_root, "**", "pt-*", ""),
                            recursive=True))
    rx = re.compile(r"pt-(\d+)[/\\]?$")
    sim_dirs = sorted(
        (d for d in cand
         if rx.search(d) and glob.glob(os.path.join(d, "*-state-*"))),
        key=lambda d: int(rx.search(d).group(1)),
    )
    if not sim_dirs:
        raise IOError(f"no pt-<k> realization folders under {tag_root!r}")
    states, auxes, cfgs, metas, yieldses, converters = [], [], [], [], [], []
    for d in sim_dirs:
        state_file = sorted(glob.glob(os.path.join(d, "*-state-*")))[0]
        base = re.sub(r"-state-\d+\.pkl\.zst$", "", state_file)
        s, a, c, md, ys, conv = load_run(base, n_checkpoint,
                                         data_dir=data_dir, device=device)
        states.append(s)
        auxes.append(a)
        cfgs.append(c)
        metas.append(md)
        yieldses.append(ys)
        converters.append(conv)
    integs = {(c.integrator, c.leapfrog_n_sub) for c in cfgs}
    if len(integs) != 1:
        raise ValueError(
            f"ensemble realizations disagree on integrator config: {integs}"
        )
    return states, auxes, cfgs, metas, yieldses, converters, sim_dirs


def _ensemble_mesh(cfg: SimConfig, n_real: int, n_stars: int, device):
    """(kind, mesh) of an ensemble run: ("2d", the (ens x rows) mesh) for
    a 2-tuple cfg.mesh_shape, ("1d", the ensemble mesh over the world)
    when the process group spans several ranks, else (None, None)."""
    from ..parallel.ensemble import make_ensemble2d_mesh, make_ensemble_mesh

    if cfg.mesh_shape and len(cfg.mesh_shape) != 2:
        # an explicit mesh request must not be silently ignored: ensembles
        # take the 2-D (ens x rows) form only
        raise ValueError(
            f"mesh_shape={cfg.mesh_shape} with --ensemble: use a 2-tuple "
            "'E,R' (realizations across E ranks, each realization's force "
            "sweep row-split across R), or unset it for the ensemble mesh "
            "over all ranks")
    if cfg.mesh_shape:
        n_ens, n_rows = cfg.mesh_shape
        if n_real % n_ens != 0 or n_stars % n_rows != 0:
            raise ValueError(
                f"mesh_shape={cfg.mesh_shape}: ensemble size {n_real} must "
                f"divide across {n_ens} and star count {n_stars} across "
                f"{n_rows}")
        return "2d", make_ensemble2d_mesh(n_ens, n_rows, device=device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        world = dist.get_world_size()
        if n_real % world != 0:
            raise ValueError(
                f"ensemble size {n_real} must divide across the {world} "
                "ranks of the ensemble mesh")
        return "1d", make_ensemble_mesh(world, device=device)
    return None, None


def run_ensemble(cfg: SimConfig, progress: bool = True,
                 data_dir: Optional[str] = None, root: str = ".",
                 device="cuda"):
    """Run `cfg.ensemble` independent cluster realizations as ONE batched
    system on `device` (parallel.ensemble: on the kernel path a flattened,
    block-diagonal sweep with the force cache), writing each realization's
    checkpoint files into the reference's grid folder layout
    `pt-<rc>-<n>/pt-<rc>-<n>/pt-<k>/` (the layout plotting/postprocess.py
    walks). With cfg.reload set (a tag directory or any root containing
    the pt-<k> folders), every realization resumes from its most recent
    checkpoint (or cfg.n_checkpoint). On an ensemble mesh (_ensemble_mesh)
    each rank steps its share of the realizations and writes their
    folders (on the 2-D mesh, rank 0 of each rows group). Returns
    (batch_state, sim_dirs, wall seconds); the whole batch on every rank."""
    from ..parallel.ensemble import (
        ensemble2d_fresh_cache, ensemble_cacheable, ensemble_fresh_cache,
        ensemble_run_steps, ensemble_run_steps_2d,
        ensemble_run_steps_2d_cached, ensemble_run_steps_cached,
        gather_ensemble, init_ensemble, shard_ensemble, stack_ensemble,
    )
    from ..parallel.sharded import axis_rank

    t_wall0 = time.time()
    device = run_device(device)
    lead = _lead()
    if lead:
        print(f"# checkpoint writer: {compression.writer()}")
        print(f"# yields codec: {ubjson.codec()}")
    if cfg.gravity_stride > 1 or cfg.softened_virial or cfg.k_ultra:
        # the opt-in perf ladder is a single-run capability; the ensemble
        # path runs BHTree-parity leapfrog with the raw-potential virial
        # radius. Raise rather than silently drop an explicit opt-in.
        raise ValueError(
            "the perf-ladder flags (--gravity_stride / --softened_virial "
            "/ --k_ultra) apply to single runs only; ensembles resolve to "
            "BHTree-parity leapfrog with the raw-potential virial radius "
            "(docs/precision.md)"
        )
    if cfg.force_impl == "tree":
        raise ValueError(
            "force_impl='tree' is a single-run backend; ensembles use "
            "the group-masked fused sweeps (see docs/precision.md)"
        )
    extend_t = cfg.extend_final_time
    fresh_verbose = cfg.verbose
    if extend_t is not None and not cfg.reload:
        raise ValueError(
            "extend_final_time is a resume directive: set reload too "
            "(a cold start takes its schedule from final_time/n_plot)"
        )
    if cfg.reload:
        states, auxes, cfgs, metas, yieldses, converters, sim_dirs = (
            load_ensemble(cfg.reload, cfg.n_checkpoint, data_dir, "cpu")
        )
        n_real = len(sim_dirs)
        cfg = cfgs[0].replace(verbose=fresh_verbose)
        kind, mesh = _ensemble_mesh(cfg, n_real,
                                    states[0].cluster.mass.shape[0], device)
        batch_state, batch_aux = stack_ensemble(
            states, auxes, device="cpu" if mesh is not None else device)
        t0 = float(batch_state.time[0])
        if extend_t is not None:
            cfg = _extend(cfg, extend_t, t0, int(round(t0 / cfg.dt)), metas)
        k_step = int(round(t0 / cfg.dt))
        save_initial = False
    else:
        n_real = cfg.ensemble
        kind, mesh = _ensemble_mesh(cfg, n_real, cfg.n + int(cfg.interloper),
                                    device)
        batch_state, batch_aux, cfgs = init_ensemble(
            cfg, n_real, data_dir,
            device="cpu" if mesh is not None else device)
        cfg = cfgs[0]
        tag = f"pt-{cfg.rc}-{cfg.n}"
        sim_dirs, metas, yieldses, converters = [], [], [], []
        masses = batch_state.cluster.mass.cpu().numpy()
        for k in range(n_real):
            d = os.path.join(root, tag, tag, f"pt-{k}")
            sim_dirs.append(d)
            md = _metadata_from_cfg(cfgs[k].replace(filename=f"pt-{k}"))
            metas.append(md)
            yieldses.append(Yields(
                os.path.join(d, md.filename),
                bounded=bool(getattr(cfg, "yields_frames", False)),
            ))
            converters.append(Converter(cfg.rc, float(masses[k].sum())))
        k_step = 0
        save_initial = True
    # the realizations this rank runs ([k0, k0 + len)) and those whose
    # files it writes
    share = range(n_real)
    writes = True
    if mesh is not None:
        e, n_ens = axis_rank(mesh, "ens")
        per = n_real // n_ens
        share = range(e * per, (e + 1) * per)
        writes = kind == "1d" or axis_rank(mesh, "rows")[0] == 0
        batch_state, batch_aux = shard_ensemble(batch_state, batch_aux,
                                                mesh)
        # every rank has read the files before their owners write them
        dist.barrier()
    owned = share if writes else range(0)
    for k in owned:
        base_k = os.path.join(sim_dirs[k], metas[k].filename)
        if save_initial:
            os.makedirs(sim_dirs[k], exist_ok=True)
        else:
            _bound_resumed_yields(yieldses[k], base_k, cfg,
                                  float(batch_state.time[k - share.start]))
            _drop_stale_state_files(base_k, metas[k].most_recent_checkpoint)

    # thread the force cache across checkpoint chunks (block-diagonal on
    # one device and on the 1-D mesh; (acc, pot) on the 2-D mesh, where
    # leapfrog makes the closing evaluation exact)
    if kind == "2d":
        use_cache = getattr(cfg, "force_cache", True)
    else:
        use_cache = ensemble_cacheable(batch_state, cfg)
    ens_cache = [None]

    def advance_ens(bs, n):
        if kind == "2d":
            if not use_cache:
                return ensemble_run_steps_2d(bs, batch_aux, cfg, n, mesh)
            if ens_cache[0] is None:
                ens_cache[0] = ensemble2d_fresh_cache(bs, cfg, mesh)
            bs, ens_cache[0] = ensemble_run_steps_2d_cached(
                bs, ens_cache[0], batch_aux, cfg, n, mesh)
            return bs
        if use_cache:
            if ens_cache[0] is None:
                ens_cache[0] = ensemble_fresh_cache(bs, cfg)
            bs, ens_cache[0] = ensemble_run_steps_cached(
                bs, ens_cache[0], batch_aux, cfg, n)
            return bs
        return ensemble_run_steps(bs, batch_aux, cfg, n)

    def _save_all_sync(host, times, increment=True, final=False):
        # the SAME per-run save protocol as run(), per realization
        for k in owned:
            i = k - share.start
            _save(os.path.join(sim_dirs[k], metas[k].filename), metas[k],
                  converters[k], yieldses[k],
                  {f: a[i] for f, a in host.items()}, float(times[i]), cfg,
                  increment=increment, final=final)

    writer = None
    if getattr(cfg, "async_saves", True) and writes:
        from ..io.async_writer import AsyncCheckpointWriter

        writer = AsyncCheckpointWriter()

    def save_all(bs, increment=True, final=False):
        if not writes:
            return
        # ONE host copy per field per save, on the driver thread
        host = cluster_to_numpy(bs.cluster)
        times = bs.time.cpu().numpy()
        job = lambda: _save_all_sync(host, times, increment, final)
        if writer is not None:
            writer.submit(job)
        else:
            job()

    try:
        if save_initial:
            save_all(batch_state, increment=False)

        bar = None
        if progress and lead:
            try:
                from tqdm import tqdm
                bar = tqdm(total=cfg.final_time, desc=f"Ensemble x{n_real}",
                           unit="Myr", initial=round(k_step * cfg.dt, 6))
            except ImportError:
                pass

        spp = cfg.steps_per_plot
        k_start = k_step
        saved_final = False
        while k_step < cfg.n_steps:
            if k_step % spp == 0:
                batch_state = advance_ens(batch_state, 1)
                k_step += 1
                # same final-save dedup as run()
                saved_final = k_step == cfg.n_steps
                save_all(batch_state, final=saved_final)
            else:
                chunk = min(spp - (k_step % spp), cfg.n_steps - k_step)
                batch_state = advance_ens(batch_state, chunk)
                k_step += chunk
            if bar is not None:
                bar.n = round(k_step * cfg.dt, 6)
                bar.refresh()
        if not saved_final and k_step > k_start:
            save_all(batch_state, final=True)
        if writer is not None:
            writer.close()
            writer = None
        if bar is not None:
            bar.close()
    finally:
        if writer is not None:
            try:
                writer.close()
            except RuntimeError:
                pass
    if mesh is not None:
        batch_state = gather_ensemble(batch_state, mesh)
        dist.barrier()
    return batch_state, sim_dirs, time.time() - t_wall0
