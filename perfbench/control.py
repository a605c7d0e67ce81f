"""Readings that set a cell's limits: the program's compared numbers over many
seeds, and the control's (the reference in the program's place, computed in
the next precision below the configuration's: f32 with TF32 products).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control 1,2,3]

Each seed: the cell's set-up, a window of --seconds at the cell's own load,
then the comparison of the program's samples (and, for the seeds listed
under --control, the control's numbers on the same samples). One JSON line
a seed: {"seed", "program": {number: value}, "control": {...}}. Needs a
CUDA card, like run.py; the benchmark's own runs never run the control.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.harness import check, main, spec  # noqa: E402
from perfbench.harness.traffic import make_cell  # noqa: E402
from perfbench.reference import forcelaw  # noqa: E402


def readings(cell_spec, seed: int, seconds: float, control: bool, device,
             overrides=None) -> dict:
    forcelaw.resolve(cell_spec.config["sim"])
    cell = make_cell(cell_spec.config, cell_spec.traffic, seed, device,
                     overrides)
    try:
        cell.setup()
        main.run_window(cell, seconds)
        prog, info, _ = check.compare(cell_spec, cell, device)
        out = {"seed": seed,
               "program": {**{k: v["value"] for k, v in prog.items()},
                           **info}}
        if control:
            ctl, info, _ = check.compare(cell_spec, cell, device,
                                         control=True)
            out["control"] = {**{k: v["value"] for k, v in ctl.items()},
                              **info}
    finally:
        cell.close()
    return out


def run(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell_spec = spec.load_cell(a.workload)
    ctl = {int(s) for s in a.control.split(",") if s}
    for s in (int(x) for x in a.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell_spec, s, a.seconds, s in ctl, "cuda")
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
