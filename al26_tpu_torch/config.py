"""Simulation configuration.

The reference configures a run through ~20 argparse flags plus module-level
globals (al26_nbody.py:53-79, 1768-1821). Here every knob lives in one frozen
dataclass that is (a) hashable, and (b) serialized into every checkpoint the
same way the reference pickles its argparse namespace inside `Metadata`
(al26_nbody.py:91).

Field for field (names, defaults, order) this is `al26_tpu.config.SimConfig`,
so `to_dict` / `from_dict` round-trip between the two packages.
`force_impl="pallas"` keeps its name and means "the direct-sum kernel path"
(here the CUDA kernels of `ops.cuda_nbody`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SimConfig:
    # -- cluster ----------------------------------------------------------
    n: int = 1000                      # number of stars               (ref: -n)
    rc: float = 1.0                    # cluster radius, pc            (ref: -rc)
    model: str = "plummer"             # "plummer" | "fractal"         (ref: -m)
    fractal_dimension: float = 2.0     # fractal model dimension       (ref: -d)
    star_min_mass: float = 0.01        # IMF lower cut, Msun           (ref: --star_min_mass)
    star_max_mass: float = 150.0       # IMF upper cut, Msun           (ref: --star_max_mass)
    no_massive_star_requirement: bool = False  # skip >=13 Msun re-roll (ref flag)

    # -- discs ------------------------------------------------------------
    disk_radius: float = 100.0         # protoplanetary disc radius, AU (ref: -rd)
    disk_lifetime_mean: float = 2.885  # Myr, Exp() mean (al26_nbody.py:1233)

    # -- time -------------------------------------------------------------
    final_time: float = 10.0           # Myr                           (ref: -t_f)
    n_plot: int = 100                  # checkpoints per run   (al26_nbody.py:54)
    steps_per_plot: int = 10           # substeps per save     (al26_nbody.py:55)
    extend_final_time: Optional[float] = None  # Myr; with reload only: run
    #   the RESUMED simulation on to ~this time (the reference reads -t_f
    #   from the fresh invocation on every reload, al26_nbody.py:1638,786,
    #   so `-r X -t_f 20` extends a finished 10 Myr run). The reference
    #   recomputes dt = t_f/(n_plot*spp) from the NEW t_f — silently
    #   changing the physics timestep mid-run; here time lives on the
    #   step grid (time = step_count * dt), so extension keeps the
    #   ORIGINAL dt and grows n_plot instead (extended_to), landing
    #   final_time on the nearest whole save interval. The CLI maps an
    #   explicit `-t_f` alongside `-r` to this field; a bare `-r X`
    #   continues the stored schedule (deliberate divergence: the
    #   reference would silently re-default an extended run to 10 Myr).
    dt_override: Optional[float] = None  # Myr; set by extended_to so an
    #   extension keeps the stored timestep BIT-exactly: the dt property
    #   otherwise derives final_time/(n_plot*spp), and no float
    #   final_time choice guarantees that division reproduces the
    #   original dt to the last ulp for non-dyadic schedules. Persisted
    #   into the checkpoint args so later resumes stay on the same grid.

    # -- physics constants --------------------------------------------
    r_bub_local_wind: float = 0.1      # pc (al26_nbody.py:77)
    r_bub_local_sne: float = 1.0       # pc (al26_nbody.py:78, currently unused
    #                                     by the ref SN loop, kept for parity)
    high_mass_threshold: float = 13.0  # Msun (al26_nbody.py:1211)
    low_mass_min: float = 0.1          # Msun (al26_nbody.py:1213)
    low_mass_max: float = 3.0          # Msun (al26_nbody.py:1213)
    half_life_26al: float = 0.717      # Myr  (al26_nbody.py:1048)
    half_life_60fe: float = 2.600      # Myr  (al26_nbody.py:1049; note the
    #                                     data CSV says 2.62 — the reference
    #                                     hard-codes 2.600 in the decay step,
    #                                     we preserve that behaviour)
    mass_frac_27al: float = 8.500e-6   # stable 27Al per stellar mass (:1555)
    mass_frac_56fe: float = 1.828e-4   # stable 56Fe per stellar mass (:1567)
    sn_parity_mode: bool = False       # True: gate wind/SN sources on
    #   CURRENT mass >= high_mass_threshold exactly like the reference
    #   (al26_nbody.py:945-948 via get_high_mass_star_indices:1194-1216).
    #   Whether the gate then PASSES depends on mass_tracks: with the
    #   default LC18 vel=300 rotating anchors every 13-25 Msun
    #   progenitor's pre-SN mass sits below the 13 Msun gate (the flag
    #   would suppress ALL SNe), so pair it with mass_tracks="seba" —
    #   the reference-outcome combination, where SeBa's weak winds keep
    #   ~every 13-25 Msun progenitor above the gate at collapse (the CLI
    #   selects it automatically; see ops/deposition.py:sn_injection and
    #   docs/stellar_model.md). Default False: candidacy is INITIAL-mass
    #   based, so a massive star whose strong post-MS wind drops it below
    #   13 Msun still sheds wind and still explodes.
    mass_tracks: Optional[str] = None  # stellar mass-track family
    #   (models.stellar.evolution.TRACKS): "lc18" (vel=300 rotating, the
    #   yield tables' reduction), "lc18_vel150", "lc18_vel0"
    #   (non-rotating), or "seba" (calibrated on the SeBa event dumps
    #   the reference repo ships — weak winds, heavy pre-SN masses,
    #   reference SN outcomes; solar Z only). None resolves at init
    #   (sim.init.init_cluster, like resolve_integrator): "seba" when
    #   sn_parity_mode is set — the reference-outcome pairing, for
    #   LIBRARY callers too, not just the CLI — else "lc18". An explicit
    #   "lc18" + sn_parity_mode keeps rule-parity (SNe gated away).
    #   Round-3 checkpoints (no mass_tracks key) restore as explicit
    #   "lc18" so resumes never change physics mid-run
    #   (from_checkpoint_dict; plain from_dict stays constructor-
    #   equivalent so fresh library dicts resolve like SimConfig(**d)).
    #   Yield TABLES stay the reference's vel=300 reduction regardless
    #   (fit-data.py) unless yields_vel says otherwise.
    yields_vel: int = 300              # rotation velocity of the LC18
    #   YIELD-table reduction (300 = the reference's fixed fit-data.py
    #   selection, used with every track family by default — the
    #   reference itself pairs vel=300 yields with SeBa tracks). 0/150
    #   select the -vel<V> suffixed tables for a fully self-consistent
    #   non-rotating/150 km/s configuration alongside
    #   mass_tracks="lc18_vel0"/"lc18_vel150" (models/yields.py).

    # -- gravity ----------------------------------------------------------
    integrator: str = "auto"           # "auto" | "hermite4" |
    #                                     "hermite4_block" | "leapfrog"
    #   auto resolves at init (sim.init.resolve_integrator): hermite4
    #   (ph4-parity, shared adaptive timestep) up to 8192 stars,
    #   hermite4_block beyond (more accurate than the reference's default
    #   BHTree leapfrog AND the fastest large-N path); flattened ensembles
    #   resolve to BHTree-parity leapfrog at the ensemble boundary
    #   (parallel.ensemble.init_ensemble) — see docs/precision.md.
    leapfrog_n_sub: Optional[int] = None  # substeps per outer step; None =
    #   BHTree parity: internal dt = 1/64 N-body time unit, resolved at
    #   init from the realised cluster mass (rounded to a power of two).
    softening: Optional[float] = None  # pc, Plummer softening length.
    #   None = BHTree parity: the reference's default gravity code is AMUSE
    #   BHTree whose default epsilon_squared is 0.125 nbody-length^2, i.e.
    #   eps = sqrt(0.125) * Rc (al26_nbody.py:59,1712-1714).
    eta_hermite: float = 0.14          # Aarseth accuracy parameter (dimensionless)
    k_fast: Optional[int] = None       # hermite4_block fast-group size;
    #   None resolves at init (sim.init.resolve_integrator) to
    #   max(256, min(512, n // 128)) — e.g. 512 at n=102400; the energy
    #   drift is flat in k (docs/precision.md)
    k_ultra: int = 0                   # hermite4_block third tier: the
    #   k_ultra fastest rows subcycle at the shared minimum while the rest
    #   of the fast group steps at its OWN shared-minimum pace. 0 =
    #   two-level (default).
    substeps_max: int = 4096           # static bound on internal substeps/outer step
    gravity_stride: int = 1            # run ONE hermite4_block force
    #   advance per `gravity_stride` physics steps; the interior steps read
    #   predictor-sampled positions (fast group: subcycle-captured). All
    #   SLR physics still runs every dt — only the full O(N^2) sweep is
    #   strided. 1 = exact reference cadence (default). Engages on a
    #   cache-capable hermite4_block single run (sim.step.stride_active);
    #   ensembles refuse it.
    softened_virial: bool = False      # compute the virial radius (global
    #   wind-bubble size) from the BHTree-SOFTENED potential instead of the
    #   reference's raw one (AMUSE virial_radius, al26_nbody.py:767-770).
    #   Saves the kernel sweep's second rsqrt per pair. Cost: r_vir grows
    #   6-18% (softened U is shallower), diluting the GLOBAL mixing
    #   channel by up to ~1.6x in volume; dynamics + local channel are
    #   unchanged (docs/precision.md).
    force_cache: bool = True           # carry each step's closing force
    #   evaluation into the next step's opening one (mass-delta-corrected;
    #   sim/step.py) — ONE full O(N^2) sweep per step instead of two, on
    #   the kernel path. Exact for leapfrog; P(EC) semantics for the
    #   Hermite integrators (the opening eval is the last substep's
    #   predicted-state one; docs/precision.md). False = re-evaluate
    #   every step (the reference's behavior, al26_nbody.py:871-876).
    dtype: str = "f64"                 # "f32" | "f64" compute precision

    natal_kicks: bool = False          # apply a Maxwellian natal kick to the
    #   remnant at each SN — the reference's kick block exists but is
    #   commented out (al26_nbody.py:846-865), so False is reference parity
    #   and True is a strict superset. Kick vectors are pre-drawn at init
    #   (sim.init._draw_kicks) for reproducibility; applied at the END of
    #   the SN step (the remnant's new velocity takes effect from the next
    #   step's advance). With hermite4_block the per-step force cache is
    #   disabled (the cached jerk is velocity-dependent); leapfrog keeps it.
    kick_sigma_kms: float = 265.0      # Hobbs et al. (2005) pulsar-kick
    #   Maxwellian dispersion (km/s per Cartesian component)

    # -- interloper (AGB flyby) --------------------------------------
    interloper: bool = False           # (ref: -i)
    interloper_mass: float = 3.0       # Msun (ref: -mi)
    interloper_bubble_radius: float = 0.1   # pc (ref: -rbi)
    interloper_radius: Optional[float] = None      # pc (ref: -ri, random if None)
    interloper_distance: Optional[float] = None    # pc (ref: -di, 2*rc if None)
    interloper_velocity: Optional[float] = None    # km/s (ref: -vi, random if None)
    interloper_offset_time: float = 0.0  # Myr (ref: -ti)
    interloper_trajectory: bool = False  # (ref: -trji)

    # -- run control -------------------------------------------------
    filename: str = ""                 # base output name (ref: -f)
    reload: str = ""                   # checkpoint base name to resume (ref: -r)
    n_checkpoint: Optional[int] = None # checkpoint number (ref: -nc)
    seed: int = 0                      # master PRNG seed (new: the reference
    #                                     uses numpy global RNG; we record the
    #                                     seed for reproducibility)
    verbose: bool = False              # (ref: -v)
    yields_frames: bool = True         # append one zstd frame per save to
    #   <base>-yields.ubjf (O(N) per save) instead of rewriting the whole
    #   reference blob every save (O(k) data per save, O(k^2) per run,
    #   al26_nbody.py:242-264). The reference-format <base>-yields.ubj.zst
    #   is still written at the run's FINAL save so the reference
    #   post-processing reads completed runs unchanged; resume prefers the
    #   framed file. --yields_rewrite restores the reference behaviour.
    async_saves: bool = True           # write checkpoints on a background
    #   thread (io.async_writer) so host serialisation overlaps the next
    #   chunk's device compute; ordering/content identical to synchronous
    #   saves (single FIFO worker, flushed before run() returns). A failed
    #   save (incl. checkpoint-time validation) raises on the driver thread
    #   at the next save or at the end-of-run flush. --sync_saves disables.
    validate: bool = True              # invariant checks at checkpoints
    #   (utils/validate.py; the reference's analogue is the per-step
    #   particle-key assertion, al26_nbody.py:781-783)
    metallicity: float = 0.02          # stellar evolution Z (al26_nbody.py:467)

    # -- parallel ----------------------------------------------------
    ensemble: int = 1                  # cluster realizations
    mesh_shape: Optional[tuple] = None # device mesh (one rank a device,
    #   torch.distributed) splitting a single large run's force sweeps by
    #   rows (None = one device; parallel.sharded). With --ensemble > 1 a
    #   2-tuple (E, R) means an ens x rows mesh instead: realizations
    #   across E ranks, EACH realization's force sweep split across R
    #   (parallel.ensemble.ensemble_step_2d — for ensembles with fewer
    #   members than devices)
    orbax_dir: Optional[str] = None    # when set, ALSO write the SimState
    #   as a torch.distributed.checkpoint tree at every save
    #   (io.orbax_backend; the JAX package's orbax trees are not read).
    #   Reference-format files keep being written for the analysis
    #   pipeline.
    force_impl: str = "auto"           # pairwise force backend:
    #   "auto" (the CUDA kernels on a CUDA device in f32, else plain
    #   torch), "pallas" (the direct-sum kernel path: ops.cuda_nbody, the
    #   name kept so config dicts stay interchangeable with al26_tpu) |
    #   "default" | "tree" (the opt-in Barnes-Hut tier, ops.tree: near
    #   field through the kernel of ops.cuda_tree on a CUDA device in f32)
    #   — see sim.step._build_force_fn; under a mesh "sharded" (the
    #   default of "auto") | "ring" | "tree" (parallel.sharded, .ring,
    #   .tree_mesh).
    tree_theta: float = 0.75           # Barnes-Hut opening angle (the
    #   reference BHTree default, al26_nbody.py:59,1712-1714) for the
    #   conservative geometric block-level MAC.
    tree_mac: str = "geometric"        # "geometric" (BHTree-parity
    #   opening angle tree_theta) | "relative": the Springel 2005 relative
    #   criterion — a node is accepted when its worst-case monopole
    #   truncation error is < tree_alpha x the target block's reference
    #   acceleration (the force cache's opening evaluation). Runs only
    #   through the force cache on hermite4_block: the cache-seeding sweep
    #   is exact, and an uncached sim.step.step raises ValueError.
    tree_alpha: float = 3e-3           # relative-MAC tolerance (per-node
    #   truncation error bound as a fraction of |a|)
    tree_leaf: int = 256               # stars per Morton leaf block
    tree_kavg: int = 0                 # near-field budget: pair-list
    #   length = tree_kavg * n_blocks. 0 = auto-size at init from the
    #   initial cluster's measured partner counts (x2 slack,
    #   sim.init._auto_tree_kavg); overflow at runtime poisons the forces
    #   with NaN on the device instead of silently truncating them.

    @property
    def eps2(self) -> float:
        """Softening length squared (pc^2). Defaults to BHTree parity."""
        if self.softening is None:
            return 0.125 * self.rc * self.rc
        return self.softening * self.softening

    @property
    def dt(self) -> float:
        """Fixed outer timestep: t_f / (n_plot * steps_per_plot)
        (al26_nbody.py:786), or the bit-exact stored grid after a run
        extension (dt_override, see extended_to)."""
        if self.dt_override is not None:
            return self.dt_override
        return self.final_time / (self.n_plot * self.steps_per_plot)

    @property
    def n_steps(self) -> int:
        return self.n_plot * self.steps_per_plot

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def extended_to(self, t_new: float) -> "SimConfig":
        """Extend (or shrink) the run schedule to ~`t_new` Myr KEEPING
        the current timestep: n_plot changes by whole save intervals at
        the original dt, and final_time lands on the nearest step-grid
        point. The original dt is pinned via dt_override — recomputing
        it from the new final_time would drift by an ulp for non-dyadic
        schedules, and time = step_count * dt must stay on the stored
        grid exactly. The reference instead recomputes dt from the fresh
        -t_f on every reload (al26_nbody.py:786,1638) — same capability,
        but without silently changing the physics timestep mid-run. The
        returned cfg clears extend_final_time: it is a one-shot resume
        directive, not part of the stored schedule."""
        if t_new <= 0.0:
            raise ValueError(f"extend_final_time={t_new}: must be > 0 Myr")
        dt = self.dt
        interval = dt * self.steps_per_plot
        n_plot_new = max(1, round(t_new / interval))
        return self.replace(n_plot=n_plot_new,
                            final_time=n_plot_new * interval,
                            dt_override=dt,
                            extend_final_time=None)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        """Constructor-equivalent: a missing key gets the field default,
        so a fresh user dict behaves exactly like SimConfig(**d) — in
        particular a missing mass_tracks stays None and resolves against
        sn_parity_mode at init. Restoring a CHECKPOINT-written dict goes
        through from_checkpoint_dict instead."""
        known = {f.name for f in dataclasses.fields(cls)}
        clean = {k: v for k, v in d.items() if k in known}
        if isinstance(clean.get("mesh_shape"), list):
            clean["mesh_shape"] = tuple(clean["mesh_shape"])
        return cls(**clean)

    @classmethod
    def from_checkpoint_dict(cls, d: dict) -> "SimConfig":
        """Restore a config serialized INTO a checkpoint (resume path).
        Round-3 checkpoints predate mass_tracks: they ran the lc18
        family, so restore it EXPLICITLY — a None would re-resolve
        against sn_parity_mode at init and change physics mid-resume.
        (A dict that genuinely carries None — an unresolved fresh cfg
        round-tripped before init — keeps it; resume re-resolves like a
        cold start, matching what that run would have done.)"""
        if "mass_tracks" not in d:
            d = dict(d)
            d["mass_tracks"] = "lc18"
        return cls.from_dict(d)
