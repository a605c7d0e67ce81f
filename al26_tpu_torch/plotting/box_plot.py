"""Boxplots of maximum enrichment by (Rc, N): `plotting/box-plot.py`
equivalent, driven from the tidy table postprocess.py writes (the port's
copy of al26_tpu/plotting/box_plot.py; the table is read through
io.compression, with or without `zstandard`).

    python -m al26_tpu_torch.plotting.box_plot [table] [outname]
"""
from __future__ import annotations

import sys

import numpy as np


def main(table: str = "all-sims-ratios.pkl.zst",
         outname: str = "box-plot") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from .postprocess import _read_table

    df = _read_table(table)
    # per (nstars, rc, sim, isotope, model): max yield ratio across stars
    grouped = (
        df.groupby(["nstars", "rc", "sim_number", "isotope", "model"])
        ["yield_ratio_decay"].max().reset_index()
    )
    isos = sorted(grouped.isotope.unique())
    models = ["local+sne", "global+sne"]
    fig, axes = plt.subplots(len(isos), len(models),
                             figsize=(5 * len(models), 4 * len(isos)),
                             squeeze=False, sharey="row")
    for i, iso in enumerate(isos):
        for j, model in enumerate(models):
            sub = grouped[(grouped.isotope == iso) & (grouped.model == model)]
            labels, data = [], []
            for (n, rc), g in sub.groupby(["nstars", "rc"]):
                labels.append(f"N={n}\nRc={rc}")
                vals = np.asarray(g.yield_ratio_decay)
                data.append(np.log10(np.maximum(vals, 1e-30)))
            ax = axes[i][j]
            if data:
                # set tick labels separately: boxplot(tick_labels=...)
                # needs matplotlib >= 3.9 and the dependency is unpinned
                ax.boxplot(data)
                ax.set_xticks(range(1, len(labels) + 1), labels)
            ax.set_title(f"{iso} {model}")
            ax.set_ylabel(r"$\log_{10}$ max yield ratio")
    plt.tight_layout()
    plt.savefig(outname + ".pdf", bbox_inches="tight")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
