"""Ensemble post-processor (the port's copy of
al26_tpu/plotting/postprocess.py, the `plotting/postprocess.py`
equivalent).

Walks a grid of simulation folders (`./pt-*/pt-*/pt-*/` by default, the
reference's layout, postprocess.py:59-67), loads each sim's last yields +
first/last state, applies disc-lifetime interpolation and emits one tidy
pandas table of per-star yield ratios -> `all-sims-ratios.pkl.zst`.

Output schema matches the reference exactly (postprocess.py:44-54):
nstars, rc, sim_number, star, initial_mass, mass, isotope,
model in {local, global, sne, local+sne, global+sne},
yield_ratio_nodecay, yield_ratio_decay.

The table is pickled here and, for a `.zst` path, written through
io.compression: level-8 zstd where the `zstandard` package imports,
stored zstd frames where it does not. `pd.read_pickle(out)` reads either
wherever `zstandard` is installed; `_read_table` reads either anywhere.

    python -m al26_tpu_torch.plotting.postprocess [root] [out]
"""
from __future__ import annotations

import pickle
import sys
from glob import glob

import numpy as np

from ..io.compression import compress, decompress
from ..units import msol, myr
from .lib import calc_disk_final_enrichment, read_state, read_yields

ISOTOPES = ["26al", "60fe"]
STABLE = ["27al", "56fe"]
MODELS = ["local", "global", "sne", "local+sne", "global+sne"]


def process_sim(sim_dir: str, sim_number: int, proc_data: dict) -> None:
    blobs = sorted(glob(sim_dir + "*yields*ubj.zst"))
    # a run that crashed before its final save has only the framed store
    # (read_yields handles both; the reference only ever has the blob)
    yields_fname = (blobs or sorted(glob(sim_dir + "*-yields.ubjf")))[-1]
    state_fnames = sorted(glob(sim_dir + "*-state-*.zst"))
    sim_yield = read_yields(yields_fname)
    final_state = read_state(state_fnames[-1])
    first_state = read_state(state_fnames[0])
    metadata = final_state.metadata
    cluster = final_state.cluster

    nstars = metadata.args.n
    rc = metadata.args.rc
    lifetimes = np.asarray(cluster.tau_disk.value_in(myr))
    sim_yield = calc_disk_final_enrichment(sim_yield, lifetimes)
    initial_masses = np.asarray(first_state.cluster.mass.value_in(msol))
    masses = np.asarray(cluster.mass.value_in(msol))

    for star_number in range(len(masses)):
        for iso_index, isotope in enumerate(ISOTOPES):
            stable_attr = "mass_" + STABLE[iso_index]
            stable_yield = float(
                getattr(cluster, stable_attr).value_in(msol)[star_number]
            )
            for model in MODELS:
                nodecay = 0.0
                decay = 0.0
                for submodel in model.split("+"):
                    key = f"{submodel}_{isotope}"
                    nodecay += float(getattr(sim_yield, key)[-1, star_number])
                    decay += float(
                        getattr(sim_yield, key + "_final")[star_number]
                    )
                proc_data["nstars"].append(nstars)
                proc_data["rc"].append(rc)
                proc_data["sim_number"].append(sim_number)
                proc_data["star"].append(star_number)
                proc_data["initial_mass"].append(float(initial_masses[star_number]))
                proc_data["mass"].append(float(masses[star_number]))
                proc_data["isotope"].append(isotope)
                proc_data["model"].append(model)
                proc_data["yield_ratio_nodecay"].append(nodecay / stable_yield)
                proc_data["yield_ratio_decay"].append(decay / stable_yield)


def _read_table(path: str):
    """The table `main` wrote: unpickled after zstd decoding for a `.zst`
    path (stored frames decode without `zstandard`)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if path.endswith(".zst"):
        data = decompress(data)
    return pickle.loads(data)


def main(root: str = ".", out: str = "all-sims-ratios.pkl.zst") -> None:
    import pandas as pd

    proc_data = {k: [] for k in [
        "nstars", "rc", "sim_number", "star", "initial_mass", "mass",
        "isotope", "model", "yield_ratio_nodecay", "yield_ratio_decay",
    ]}
    simsets = sorted(glob(f"{root}/pt-*/pt*/"))
    if not simsets:
        # also accept a flat directory of sims
        simsets = [root + "/"]
    for simset in simsets:
        sims = sorted(glob(simset + "pt-*/")) or sorted(glob(simset))
        for sim_number, sim in enumerate(sims):
            has_yields = (glob(sim + "*yields*ubj.zst")
                          or glob(sim + "*-yields.ubjf"))
            has_states = glob(sim + "*-state-*.zst")
            if not (has_yields and has_states):
                if has_yields or has_states:
                    # say what was dropped: silently under-counting
                    # realizations reads as "all sims aggregated"
                    print(f"skipping incomplete sim dir {sim!r} "
                          f"(yields={bool(has_yields)}, "
                          f"states={bool(has_states)})")
                continue
            process_sim(sim, sim_number, proc_data)
    df = pd.DataFrame.from_dict(proc_data)
    data = pickle.dumps(df, protocol=pickle.HIGHEST_PROTOCOL)
    if out.endswith(".zst"):
        data = compress(data)
    with open(out, "wb") as fh:
        fh.write(data)
    print("Finished processing!")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
