"""Cumulative 26Al wind yield vs stellar age for a grid of massive stars,
on al26_tpu_torch (the port's counterpart of scripts/wind_ratio.py).

Equivalent of the reference's root wind-ratio.py / limongi-chieffi-2018/
wind-ratio.py analysis scripts (SeBa-driven there): for each initial mass,
integrate wind_ratio * mdot(t) over time and plot/print the cumulative SLR
release alongside the lifetime total from the LC18 tables.

    python scripts/wind_ratio_torch.py [out.pdf] [mass_tracks] [yields_vel]
        [--device cuda]

Prints the table of scripts/wind_ratio.py; mass_tracks selects the
stellar track family (lc18 default, or e.g. seba), yields_vel the LC18
yield-table reduction (300 by default, as cfg.yields_vel). The rates are
evaluated in f64 on --device (default cuda; cpu where there is no card).
The figure is drawn where matplotlib is installed.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

# `python scripts/wind_ratio_torch.py` puts scripts/ (not the repo root)
# on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MASSES = (20.0, 25.0, 30.0, 40.0, 60.0)
SAMPLES = 2048


def wind_table(mass_tracks: str = "lc18", yields_vel: int | str = 300,
               device="cuda") -> dict:
    """{m0: (t_cc, wind yield of the table, total wind loss, ages,
    cumulative 26Al wind release)} for each mass of MASSES: the rates at
    SAMPLES ages from 0 to just before the SN, integrated by trapezoids."""
    from al26_tpu_torch.models.stellar import evolution as st
    from al26_tpu_torch.models.yields import calc_slr_yield, read_slrs

    al = read_slrs(vel=int(yields_vel))["Al26"]
    out = {}
    for m in MASSES:
        m0 = torch.tensor(m, dtype=torch.float64, device=device)
        t_cc = float(st.t_sn(m0, tracks=mass_tracks))
        wy = calc_slr_yield(m, al.wind_mass, al.wind_yield)
        twl = float(st.total_wind_loss(m0, tracks=mass_tracks))
        ratio = wy / twl if twl > 0 else 0.0
        ts = np.linspace(0.0, t_cc * 0.99999, SAMPLES)
        rates = st.wind_mdot(m0, torch.as_tensor(ts, device=device),
                             tracks=mass_tracks).cpu().numpy() * ratio
        cum = np.concatenate([[0.0], np.cumsum(
            0.5 * (rates[1:] + rates[:-1]) * np.diff(ts))])
        out[m] = (t_cc, wy, twl, ts, cum)
    return out


def main(outname: str = "wind-ratio.pdf", mass_tracks: str = "lc18",
         yields_vel: int | str = 300, device="cuda") -> dict:
    table = wind_table(mass_tracks, yields_vel, device)
    print(f"{'mass':>6} {'t_SN (Myr)':>11} {'wind 26Al (Msun)':>17} "
          f"{'ratio of table':>15}")
    for m, (t_cc, wy, _, _, cum) in table.items():
        print(f"{m:6.1f} {t_cc:11.2f} {cum[-1]:17.4e} {cum[-1] / wy:15.3f}")
    try:
        import matplotlib
    except ImportError:
        return table
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(5, 3.5))
    for m, (_, _, _, ts, cum) in table.items():
        plt.semilogy(ts, np.maximum(cum, 1e-12), label=rf"{int(m)} $M_\odot$")
    plt.xlabel("Age (Myr)")
    plt.ylabel(r"Cumulative $^{26}$Al wind yield ($M_\odot$)")
    plt.legend()
    plt.grid(which="both", linestyle=":", alpha=0.3)
    plt.savefig(outname, bbox_inches="tight")
    print("wrote", outname)
    return table


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outname", nargs="?", default="wind-ratio.pdf")
    ap.add_argument("mass_tracks", nargs="?", default="lc18")
    ap.add_argument("yields_vel", nargs="?", default=300)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.outname, a.mass_tracks, a.yields_vel, a.device)
