"""Disc-lifetime distribution check on al26_tpu_torch (the port's
counterpart of benchmarks/disc_lifetimes.py): a histogram of the draws
against the analytic exponential pdf with mean 2.885 Myr.

    python scripts/disc_lifetimes_torch.py [out.png] [n] [--device cuda]

The draws come from numpy (np.random.default_rng(0)), as in the JAX
package's script; their histogram is taken on --device (default cuda;
cpu where there is no card). The figure is drawn where matplotlib is
installed; the mean and the largest distance of the histogram from the
pdf are printed either way.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

# `python scripts/disc_lifetimes_torch.py` puts scripts/ (not the repo
# root) on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BINS, T_MAX = 100, 20.0


def lifetimes(n: int = 100_000) -> np.ndarray:
    """The JAX script's draws: n lifetimes from default_rng(0)."""
    from al26_tpu_torch.models.discs import draw_disk_lifetimes

    return draw_disk_lifetimes(np.random.default_rng(0), n)


def histogram(tau: np.ndarray, device="cuda"):
    """(bin centres, density) of the draws over [0, T_MAX) in BINS bins,
    normalised like matplotlib's density=True, and the pdf there."""
    from al26_tpu_torch.models.discs import DISK_LIFETIME_MEAN_MYR

    t = torch.as_tensor(tau, dtype=torch.float64, device=device)
    counts = torch.histc(t, bins=BINS, min=0.0, max=T_MAX).cpu().numpy()
    width = T_MAX / BINS
    dens = counts / (counts.sum() * width)
    centres = (np.arange(BINS) + 0.5) * width
    pdf = np.exp(-centres / DISK_LIFETIME_MEAN_MYR) / DISK_LIFETIME_MEAN_MYR
    return centres, dens, pdf


def main(outname: str = "disc-lifetimes.png", n: int = 100_000,
         device="cuda") -> np.ndarray:
    from al26_tpu_torch.models.discs import DISK_LIFETIME_MEAN_MYR

    tau = lifetimes(int(n))
    centres, dens, pdf = histogram(tau, device)
    print(f"mean {tau.mean():.3f} Myr; histogram against the pdf: largest "
          f"distance {np.abs(dens - pdf).max():.4f} /Myr")
    try:
        import matplotlib
    except ImportError:
        return tau
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.linspace(0, T_MAX, 400)
    plt.figure(figsize=(5, 3.5))
    plt.bar(centres, dens, width=T_MAX / BINS, alpha=0.6, label="draws")
    plt.plot(x, np.exp(-x / DISK_LIFETIME_MEAN_MYR) / DISK_LIFETIME_MEAN_MYR,
             "k-", label=f"Exp({DISK_LIFETIME_MEAN_MYR} Myr)")
    plt.xlabel("Disc lifetime (Myr)")
    plt.ylabel("pdf")
    plt.legend()
    plt.savefig(outname, dpi=130, bbox_inches="tight")
    print("wrote", outname, f"(mean {tau.mean():.3f} Myr)")
    return tau


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outname", nargs="?", default="disc-lifetimes.png")
    ap.add_argument("n", nargs="?", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.outname, a.n, a.device)
