"""Command-line interface of the PyTorch/CUDA port.

Flag for flag al26_tpu/cli.py (the reference argparse block,
al26_nbody.py:1768-1821, plus --seed, --dtype, --integrator, --ensemble
and the rest of the JAX package's extras: same names, dests, defaults and
choices), plus `--device` (default cuda: where the run computes, the
port's counterpart of JAX_PLATFORMS; a cuda run on a machine without a
card raises, it never falls back to the CPU). Run as
`python -m al26_tpu_torch.cli ...` or via the `al26-nbody-torch` console
entry point. A device mesh (--mesh_shape D, --force_impl
sharded|ring|tree, an ensemble's E,R) runs one rank per device:
`torchrun --nproc_per_node D -m al26_tpu_torch.cli --mesh_shape D ...`
(--device cuda then means cuda:LOCAL_RANK); a plain process runs a mesh
of one device.
"""
from __future__ import annotations

import argparse
import sys


def _mesh_shape(text: str) -> tuple:
    try:
        return tuple(int(x) for x in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"mesh_shape must be comma-separated ints, got {text!r}"
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Calculate orbital trajectories and Al26 enrichment of "
                    "a stellar cluster (PyTorch/CUDA port)"
    )
    p.add_argument("-n", default=None, type=int,
                   help="Number of stars in cluster")
    p.add_argument("-rc", default=None, type=float,
                   help="Cluster radius (pc)")
    p.add_argument("-r", "--reload", type=str, default="",
                   help="Base name of files to RELOAD")
    p.add_argument("-nc", "--n_checkpoint", type=int, default=None,
                   help="Which checkpoint file to load, defaults to highest number")
    p.add_argument("-m", "--model", type=str, default="plummer",
                   help="Which model to use, defaults to Plummer sphere, can also use fractal model")
    p.add_argument("-d", "--fractal_dimension", type=float, default=2.0,
                   help="Dimension parameter for fractal model")
    p.add_argument("-rd", "--disk_radius", type=float, default=100,
                   help="Protoplanetary disk radius, typically 100 AU")
    p.add_argument("--adaptive_timestep", action="store_true",
                   help="(accepted for reference parity; the Hermite "
                        "integrator is always adaptive internally)")
    p.add_argument("-f", "--filename", type=str, default="",
                   help='Base name for files to SAVE, i.e. "<filename>-yields.csv"; '
                        'defaults to "sim-YY-MM-DD-HH-MM-SS"')
    p.add_argument("--no_massive_star_requirement", action="store_true",
                   help="Do not require the formation of a massive star in the cluster (no re-rolls)")
    p.add_argument("--star_min_mass", type=float, default=0.01,
                   help="Minimum star mass (Msun)")
    p.add_argument("--star_max_mass", type=float, default=150.0,
                   help="Maximum star mass (Msun)")
    # interloper
    p.add_argument("-i", "--interloper", action="store_true",
                   help="Throw an interloping AGB star into the simulation")
    p.add_argument("-mi", "--interloper_mass", type=float, default=3.0,
                   help="Mass of the interloping star, needs to be a valid mass")
    p.add_argument("-rbi", "--interloper_bubble_radius", type=float, default=0.1,
                   help="Bubble size of interloping stars stellar wind (pc)")
    p.add_argument("-ri", "--interloper_radius", type=float, default=None,
                   help="Interloper closest approach radius (pc); random in [0, rc) if unset")
    p.add_argument("-di", "--interloper_distance", type=float, default=None,
                   help="Interloper initial distance; 2*rc if unset")
    p.add_argument("-vi", "--interloper_velocity", type=float, default=None,
                   help="Interloper velocity towards the cluster (km/s); random in [0, 100) if unset")
    p.add_argument("-ti", "--interloper_offset_time", type=float, default=0.0,
                   help="Time until interloper enters AGB phase (Myr)")
    p.add_argument("-trji", "--interloper_trajectory", action="store_true",
                   help="Write AGB position to text file, interloper_trajectory.dat")
    p.add_argument("-t_f", "--final_time", type=float, default=None,
                   help="Final time to simulate to in Myr (default 10). "
                        "With -r: extend the resumed run to ~this time "
                        "on the stored step grid (the reference "
                        "re-reads -t_f on reload, al26_nbody.py:1638); "
                        "omit it to continue the stored schedule. To "
                        "shorten a run, resume from an earlier "
                        "checkpoint with -nc")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print additional statements")
    # TPU-native extras
    p.add_argument("--seed", type=int, default=0,
                   help="Master PRNG seed (recorded in checkpoints)")
    p.add_argument("--dtype", type=str, default="f64", choices=("f32", "f64"),
                   help="Compute precision (use f32 on the card: the CUDA "
                        "kernels run in f32)")
    p.add_argument("--integrator", type=str, default="auto",
                   choices=("auto", "hermite4", "hermite4_block", "leapfrog"),
                   help="N-body integrator (auto: hermite4 <= 8192 stars, "
                        "hermite4_block two-group block timesteps beyond — "
                        "the fastest AND most accurate large-N path; "
                        "ensembles auto-resolve to BHTree-parity leapfrog)")
    p.add_argument("--softening", type=float, default=None,
                   help="Plummer softening length (pc); default: BHTree parity "
                        "sqrt(0.125)*rc")
    p.add_argument("--ensemble", type=int, default=1,
                   help="Number of vmapped cluster realizations (with "
                        "--reload: resume every pt-<k> realization found "
                        "under the reload directory)")
    p.add_argument("--mesh_shape", type=_mesh_shape, default=None,
                   metavar="D[,D...]",
                   help="Device mesh for splitting ONE large run's force "
                        "sweeps by rows across devices, one rank each "
                        "(torchrun --nproc_per_node D), e.g. '4' (star "
                        "count must divide across the devices). With "
                        "--ensemble > 1, a 2-tuple 'E,R' lays realizations "
                        "across E ranks and splits each realization's "
                        "force sweep across R")
    p.add_argument("--force_impl", type=str, default="auto",
                   choices=("auto", "pallas", "sharded", "ring", "default",
                            "tree"),
                   help="Pairwise force backend (auto: the CUDA direct-sum "
                        "kernels on a card in f32, plain torch otherwise; "
                        "pallas = the kernels; sharded / ring = the "
                        "row-split / ring-streamed sweeps under a mesh; "
                        "tree = opt-in "
                        "Barnes-Hut monopole tier (the reference BHTree's "
                        "algorithmic class; leapfrog at small N, "
                        "block-timestep Hermite over tree acc+jerk above "
                        "8192 — for N >~ 2e5)")
    p.add_argument("--tree_theta", type=float, default=0.75,
                   help="Barnes-Hut opening angle for --force_impl tree "
                        "(0.75 = the reference BHTree default)")
    p.add_argument("--tree_mac", type=str, default="geometric",
                   choices=("geometric", "relative"),
                   help="Tree multipole acceptance criterion: geometric "
                        "(BHTree-parity opening angle) or relative "
                        "(Springel 2005: per-node truncation error < "
                        "tree_alpha x |a| from the force cache; "
                        "hermite4_block only — the strong choice for "
                        "centrally concentrated clusters)")
    p.add_argument("--tree_alpha", type=float, default=3e-3,
                   help="Relative-MAC error tolerance (--tree_mac "
                        "relative)")
    p.add_argument("--tree_leaf", type=int, default=256,
                   help="Stars per Morton leaf block (--force_impl tree)")
    p.add_argument("--tree_kavg", type=int, default=0,
                   help="Near-field pair budget per block (--force_impl "
                        "tree); 0 = auto-size at init from measured "
                        "partner counts x2 slack")
    p.add_argument("--eta", dest="eta_hermite", type=float, default=0.14,
                   help="Hermite accuracy parameter (smaller = more "
                        "substeps)")
    p.add_argument("--gravity_stride", type=int, default=1,
                   help="Physics steps per full force advance (cached "
                        "hermite4_block single runs, direct sum or tree): "
                        "interior steps use predictor-sampled positions; "
                        "1 = exact reference cadence (accuracy: "
                        "docs/precision.md)")
    p.add_argument("--softened_virial", action="store_true",
                   help="compute the virial radius (global wind bubble) "
                        "from the softened potential: ~17%% faster N=1e5 "
                        "steps, but r_vir grows 6-18%% so the global "
                        "channel dilutes (local channel and dynamics "
                        "unchanged; default keeps reference parity)")
    p.add_argument("--k_ultra", type=int, default=0,
                   help="hermite4_block third timestep tier: the k_ultra "
                        "fastest stars subcycle at the shared minimum while "
                        "the rest of the fast group steps at its own pace "
                        "(0 = two-level default; pays off in dense "
                        "clusters, see docs/precision.md)")
    p.add_argument("--leapfrog_n_sub", type=int, default=None,
                   help="Leapfrog substeps per outer step; default: BHTree "
                        "parity (1/64 N-body time unit)")
    p.add_argument("--no_force_cache", dest="force_cache",
                   action="store_false",
                   help="Disable the cross-step force cache (two full "
                        "O(N^2) sweeps per step like the reference instead "
                        "of one; see SimConfig.force_cache)")
    p.add_argument("--no_validate", dest="validate", action="store_false",
                   help="Disable state invariant checks at checkpoints")
    p.add_argument("--orbax_dir", type=str, default=None,
                   help="Also write the device state as a "
                        "torch.distributed.checkpoint tree at every save "
                        "(every rank takes part; the resume path of mesh "
                        "runs; it does not read the JAX package's orbax "
                        "trees)")
    p.add_argument("--yields_rewrite", dest="yields_frames",
                   action="store_false",
                   help="Rewrite the whole reference-format yields blob at "
                        "every save (the reference's O(k^2) behaviour) "
                        "instead of the appendable framed store")
    p.add_argument("--sync_saves", dest="async_saves", action="store_false",
                   help="Write checkpoints synchronously on the driver "
                        "thread (default: a background writer thread "
                        "overlaps saves with device compute)")
    p.add_argument("--natal_kicks", action="store_true",
                   help="Apply Maxwellian natal kicks to SN remnants (the "
                        "reference carries this code commented out, "
                        "al26_nbody.py:846-865; off = reference parity)")
    p.add_argument("--sn_parity_mode", action="store_true",
                   help="Gate wind/SN sources on CURRENT mass like the "
                        "reference's step-start high-mass list "
                        "(al26_nbody.py:767,945-948) instead of the "
                        "default initial-mass validity (docs/PARITY.md). "
                        "Unless --mass_tracks is given explicitly, this "
                        "also selects mass_tracks=seba so the gate passes "
                        "at collapse like the reference's SeBa runs")
    p.add_argument("--mass_tracks", type=str, default=None,
                   choices=("lc18", "lc18_vel150", "lc18_vel0", "seba"),
                   help="Stellar mass-track family "
                        "(models.stellar.evolution.TRACKS): lc18 = the "
                        "rotating vel=300 models the yield tables come "
                        "from (default); lc18_vel0/150 = the non-rotating "
                        "/ 150 km/s LC18 sets; seba = tracks calibrated "
                        "on the SeBa event dumps the reference repo ships "
                        "(weak winds, heavy pre-SN masses — the "
                        "reference-outcome choice, solar Z only)")
    p.add_argument("--kick_sigma", dest="kick_sigma_kms", type=float,
                   default=265.0,
                   help="Natal-kick dispersion per component, km/s "
                        "(Hobbs et al. 2005)")
    from .models.yields import LC18_VELS
    p.add_argument("--yields_vel", type=int, default=300,
                   choices=LC18_VELS,
                   help="Rotation velocity of the LC18 YIELD-table "
                        "reduction (km/s). 300 = the reference's fixed "
                        "fit-data.py selection (default for every track "
                        "family, as the reference pairs vel=300 yields "
                        "with SeBa tracks); 0/150 pair self-consistently "
                        "with --mass_tracks lc18_vel0/lc18_vel150")
    p.add_argument("--metallicity", type=float, default=0.02,
                   help="Stellar-evolution metallicity Z in [1e-4, 0.03] "
                        "(Hurley+2000 lifetime fits; the reference's SeBa "
                        "is hard-wired to 0.02, al26_nbody.py:483). Also "
                        "selects the nearest LC18 [Fe/H] yield-table set "
                        "(0/-1/-2/-3)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device the run computes on: cuda (default; raises "
                        "without a card, never falls back) or cpu")
    return p


def config_from_args(args: argparse.Namespace):
    from .config import SimConfig

    if args.n is None or args.rc is None:
        if args.reload == "":
            raise SystemExit(
                "Input arguments need to either be loading a checkpoint or "
                "defining a simulation"
            )
    d = vars(args).copy()
    d.pop("adaptive_timestep", None)
    d.pop("device", None)
    # -t_f is dual-purpose like the reference's (al26_nbody.py:1638 reads
    # it from the fresh invocation on reload): on a cold start it IS the
    # schedule (default 10 Myr); alongside -r an EXPLICIT value extends
    # the resumed run (extend_final_time), while omitting it continues
    # the stored schedule instead of the reference's silent re-default.
    if d.get("reload") and d.get("final_time") is not None:
        d["extend_final_time"] = d["final_time"]
    if d.get("final_time") is None:
        d["final_time"] = 10.0
    if d.get("reload"):
        # physics/config comes from the CHECKPOINT on resume (run()
        # restores it wholesale); of the fresh flags only -t_f / -v /
        # -nc act. Say so instead of letting e.g. a fresh
        # --sn_parity_mode look like it changed the resumed physics.
        if d.get("sn_parity_mode") or d.get("mass_tracks"):
            print("# -r: physics flags are ignored on resume — the "
                  "checkpoint's recorded config is restored (fresh "
                  "-t_f / -v / -nc still apply)")
    elif d.get("mass_tracks") is None and d.get("sn_parity_mode"):
        # the resolution itself lives at init (sim.init.init_cluster,
        # so library callers get it too); the CLI just says so up front
        print("# --sn_parity_mode: mass_tracks resolves to seba "
              "(reference-outcome SN gating; override with "
              "--mass_tracks)")
    return SimConfig.from_dict(d)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.ensemble > 1:
        from .sim.driver import run_ensemble

        _, sim_dirs, wall = run_ensemble(cfg, device=args.device)
        print("!!! Finished !!!")
        print(f"{len(sim_dirs)} realizations in {sim_dirs[0]} ...")
        if cfg.verbose:
            print(f"wall time: {wall:.1f} s")
        _close_world()
        return 0
    from .sim.driver import run

    result = run(cfg, device=args.device)
    print("!!! Finished !!!")
    if cfg.verbose:
        print(f"wall time: {result.wall_time_s:.1f} s")
    _close_world()
    return 0


def _close_world() -> None:
    """End the process group a mesh run initialised."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
