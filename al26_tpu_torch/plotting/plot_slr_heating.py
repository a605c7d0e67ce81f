"""CDF of radiogenic disc heating rates: `plotting/plot_slr_heating.py`
equivalent (the port's copy of al26_tpu/plotting/plot_slr_heating.py).
Heating from 26Al + 60Fe enrichment (al26_plot.py:187-198).

    python -m al26_tpu_torch.plotting.plot_slr_heating [outname] [root]
"""
from __future__ import annotations

import sys
from glob import glob

import numpy as np

from ..units import msol
from .lib import calc_cdf, calc_current_heating_rate, read_state


def main(outname: str = "heating-cdf", root: str = ".") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_g, ax_l) = plt.subplots(1, 2, figsize=(8, 4), sharey=True)
    sims = sorted(glob(f"{root}/*/"))
    # floor at 0.3: GnBu(0.0) is near-white (plot_slr_statistics.py)
    cmaps = np.linspace(0.3, 1, max(len(sims), 1))
    for i, sim in enumerate(sims):
        state_files = sorted(glob(sim + "*-state-*.zst"))
        if not state_files:
            continue
        color = matplotlib.colormaps["GnBu"](cmaps[i])
        cluster = read_state(state_files[-1]).cluster
        m27 = np.asarray(cluster.mass_27al.value_in(msol))
        m56 = np.asarray(cluster.mass_56fe.value_in(msol))
        for ax, model, style in ((ax_g, "global", "solid"),
                                 (ax_l, "local", "dashed")):
            z_al = (np.asarray(getattr(cluster, f"mass_26al_{model}").value_in(msol))
                    + np.asarray(cluster.mass_26al_sne.value_in(msol))) / m27
            z_fe = (np.asarray(getattr(cluster, f"mass_60fe_{model}").value_in(msol))
                    + np.asarray(cluster.mass_60fe_sne.value_in(msol))) / m56
            q = calc_current_heating_rate(z_al, z_fe)
            x, y = calc_cdf(q[q > 0])
            if len(x):
                ax.plot(x, y, c=color, linestyle=style)
    for ax, title in ((ax_g, "global model"), (ax_l, "local model")):
        ax.set_xscale("log")
        ax.set_ylim(0, 1)
        ax.set_xlabel("Q (relative heating rate)")
        ax.set_title(title)
        ax.grid(True, which="both", linestyle=":", alpha=0.3)
    ax_g.set_ylabel("CDF")
    plt.savefig(outname + ".pdf", bbox_inches="tight")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
