"""Visual check of cluster initial conditions on al26_tpu_torch (the
port's counterpart of benchmarks/cluster_ics.py): Plummer and fractal
realizations side by side.

    python scripts/cluster_ics_torch.py [out.png] [n] [--device cuda]

The draws come from numpy (np.random.default_rng(0)), as in the JAX
package's script; the fractal virialisation's potential sum runs on
--device (default cuda; cpu where there is no card). The figure is drawn
where matplotlib is installed; the draws' radii are printed either way.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# `python scripts/cluster_ics_torch.py` puts scripts/ (not the repo root)
# on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRACTAL_DIMS = (1.6, 2.6)


def draws(n: int = 2000, device="cuda") -> dict:
    """{"plummer": pos, "fractal D=1.6": pos, "fractal D=2.6": pos}, in
    the JAX script's order of draws from one default_rng(0)."""
    from al26_tpu_torch.models.fractal import fractal_positions_velocities
    from al26_tpu_torch.models.plummer import plummer_positions_velocities

    rng = np.random.default_rng(0)
    out = {"plummer": plummer_positions_velocities(rng, n, 1.0, n * 0.5)[0]}
    for d in FRACTAL_DIMS:
        out[f"fractal D={d}"] = fractal_positions_velocities(
            rng, n, 1.0, n * 0.5, d, device=device)[0]
    return out


def main(outname: str = "cluster-ics.png", n: int = 2000,
         device="cuda") -> dict:
    pos = draws(int(n), device)
    for name, p in pos.items():
        r = np.sqrt((p ** 2).sum(-1))
        print(f"{name:>14}: n={len(p)} median r {np.median(r):.4f} pc")
    try:
        import matplotlib
    except ImportError:
        return pos
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(pos), figsize=(4 * len(pos), 4))
    for ax, (name, p) in zip(axes, pos.items()):
        ax.scatter(p[:, 0], p[:, 1], s=1)
        ax.set_title(name.replace("plummer", "Plummer")
                     .replace("fractal", "Fractal"))
        ax.set_aspect("equal")
        ax.set_xlim(-3, 3)
        ax.set_ylim(-3, 3)
    plt.savefig(outname, dpi=130, bbox_inches="tight")
    print("wrote", outname)
    return pos


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outname", nargs="?", default="cluster-ics.png")
    ap.add_argument("n", nargs="?", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.outname, a.n, a.device)
