"""Render one state file as a 3D position plot: `plotting/plot_3d_pos.py`
equivalent (the port's copy of al26_tpu/plotting/plot_3d_pos.py).

    python -m al26_tpu_torch.plotting.plot_3d_pos <state-file> [out]
"""
from __future__ import annotations

import sys

from .lib import plot_positions, read_state


def main(state_file: str, outname: str = "positions") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    state = read_state(state_file)
    plot_positions(state.cluster, state.metadata)
    plt.savefig(outname + ".png", dpi=150, bbox_inches="tight")


if __name__ == "__main__":
    if not 1 <= len(sys.argv) - 1 <= 2:
        sys.exit("usage: python -m al26_tpu_torch.plotting.plot_3d_pos "
                 "<state_file> [outname]")
    main(*sys.argv[1:])
