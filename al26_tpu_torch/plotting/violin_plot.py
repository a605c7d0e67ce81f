"""Violin plots of yield-ratio distributions by (Rc, N).

The reference ships `plotting/violin-plot.py` as an empty placeholder; this
implements the intended figure from the postprocess table (the port's copy
of al26_tpu/plotting/violin_plot.py; the table is read through
io.compression, with or without `zstandard`).

    python -m al26_tpu_torch.plotting.violin_plot [table] [outname]
"""
from __future__ import annotations

import sys

import numpy as np


def main(table: str = "all-sims-ratios.pkl.zst",
         outname: str = "violin-plot") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from .postprocess import _read_table

    df = _read_table(table)
    df = df[df.yield_ratio_decay > 0]
    isos = sorted(df.isotope.unique())
    fig, axes = plt.subplots(1, len(isos), figsize=(5 * len(isos), 4),
                             squeeze=False)
    for i, iso in enumerate(isos):
        sub = df[(df.isotope == iso) & (df.model == "global+sne")]
        labels, data = [], []
        for (n, rc), g in sub.groupby(["nstars", "rc"]):
            labels.append(f"N={n}, Rc={rc}")
            data.append(np.log10(np.asarray(g.yield_ratio_decay)))
        ax = axes[0][i]
        if data:
            ax.violinplot(data, showmedians=True)
            ax.set_xticks(range(1, len(labels) + 1), labels, rotation=45)
        ax.set_title(f"{iso} global+sne")
        ax.set_ylabel(r"$\log_{10}$ yield ratio")
    plt.tight_layout()
    plt.savefig(outname + ".pdf", bbox_inches="tight")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
