"""2x2 CDF figure of 26Al/27Al and 60Fe/56Fe yield ratios vs solar-system
values: the `plotting/plot_slr_statistics.py` equivalent. Run in a
directory whose sub-directories each hold one sim's output files (the
port's copy of al26_tpu/plotting/plot_slr_statistics.py).

    python -m al26_tpu_torch.plotting.plot_slr_statistics [outname] [root]
"""
from __future__ import annotations

import sys
from glob import glob

import numpy as np

from ..units import msol
from .lib import calc_cdf, read_state

SOLAR_26AL_27AL = 5.85e-5   # plot_slr_statistics.py:79
SOLAR_60FE_56FE = 1e-6      # plot_slr_statistics.py:81


def main(outname: str = "cdf", root: str = ".") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.ticker as mticker

    fig = plt.figure(figsize=(6, 6))
    axes = fig.subplots(2, 2, sharey=True, sharex=True)
    sims = sorted(glob(f"{root}/*/"))
    # floor at 0.3: GnBu(0.0) is near-white — the first (or only) sim's
    # curves would be invisible on the white background
    cmaps = np.linspace(0.3, 1, max(len(sims), 1))

    for i, sim in enumerate(sims):
        # everything plotted comes from the final STATE file (a sim that
        # crashed before its final yields blob still has per-star SLR
        # reservoirs there)
        state_files = sorted(glob(sim + "*-state-*.zst"))
        if not state_files:
            continue
        color = matplotlib.colormaps["GnBu"](cmaps[i])
        cluster = read_state(state_files[-1]).cluster

        def ratios(iso, stable):
            m_stable = np.asarray(getattr(cluster, f"mass_{stable}").value_in(msol))
            out = {}
            for ch in ("local", "global", "sne"):
                out[ch] = np.asarray(
                    getattr(cluster, f"mass_{iso}_{ch}").value_in(msol)
                ) / m_stable
            return out

        r_al = ratios("26al", "27al")
        r_fe = ratios("60fe", "56fe")
        for ax, r in [
            (axes[0, 0], r_al["global"] + r_al["sne"]),
            (axes[0, 1], r_fe["global"] + r_fe["sne"]),
            (axes[1, 0], r_al["local"] + r_al["sne"]),
            (axes[1, 1], r_fe["local"] + r_fe["sne"]),
        ]:
            x, y = calc_cdf(r)
            ax.plot(x, y, c=color,
                    linestyle="dashed" if ax in (axes[1, 0], axes[1, 1]) else "solid")

    for row in axes:
        for ax in row:
            ax.set_xscale("log")
            ax.set_ylim(0, 1)
            ax.set_xlim(1e-12, 1e-2)
            ax.xaxis.set_minor_locator(
                mticker.LogLocator(numticks=999, subs="auto"))
            ax.grid(True, which="both", linestyle=":", alpha=0.3)
    for i in range(2):
        axes[i, 0].set_ylabel("CDF")
        axes[i, 0].axvline(x=SOLAR_26AL_27AL, c="k", linestyle="dotted")
        axes[i, 1].axvline(x=SOLAR_60FE_56FE, c="k", linestyle="dotted")
    axes[1, 0].set_xlabel(r"$^{26}$Al/$^{27}$Al")
    axes[1, 1].set_xlabel(r"$^{60}$Fe/$^{56}$Fe")
    axes[0, 0].set_title(r"$^{26}$Al global model")
    axes[0, 1].set_title(r"$^{60}$Fe global model")
    axes[1, 0].set_title(r"$^{26}$Al local model")
    axes[1, 1].set_title(r"$^{60}$Fe local model")
    plt.savefig(outname + ".pdf", bbox_inches="tight")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
