"""State invariant checks — the failure-detection subsystem (the port's
copy of al26_tpu/utils/validate.py).

The reference's only runtime guards are a per-step particle-key consistency
assertion (al26_nbody.py:781-783) and an unbounded-memory warning in a
docstring (:173). Here the driver validates the full state dict at every
checkpoint boundary (the data is already on host) and aborts with a precise
message instead of silently writing corrupt checkpoints.
"""
from __future__ import annotations

import numpy as np


class StateValidationError(RuntimeError):
    pass


def validate_cluster_dict(d: dict, t_myr: float,
                          low_mass_min: float = 0.1,
                          low_mass_max: float = 3.0) -> None:
    """Raise StateValidationError on non-finite or physically impossible
    values. `d` is the numpy dict from state.cluster_to_numpy; the disc-
    bearing window must match the run's cfg (al26_nbody.py:1213 defaults)."""
    problems = []
    for key in ("pos", "vel", "mass", "mdot", "slr", "slr_final", "agb_raw"):
        a = d[key]
        bad = ~np.isfinite(a)
        if bad.any():
            idx = np.argwhere(bad)[0]
            problems.append(
                f"{key} has {int(bad.sum())} non-finite values "
                f"(first at index {idx.tolist()})"
            )
    if (d["mass"] < 0).any():
        problems.append("negative stellar mass")
    if (d["mdot"] < 0).any():
        problems.append("negative wind mass-loss rate")
    if (d["slr"] < -1e-30).any():
        problems.append("negative SLR reservoir")
    if (d["tau_disk"] < 0).any():
        problems.append("negative disc lifetime")
    # disc death is monotonic: a dead disc's mask can never resurrect, and
    # only low-mass stars carry live discs
    alive = d["disk_alive"]
    lm = ((d["mass"] >= low_mass_min) & (d["mass"] <= low_mass_max)
          & ~d["is_interloper"])
    if (alive & ~lm).any():
        problems.append("disk_alive set on a non-disc-bearing star")
    if problems:
        raise StateValidationError(
            f"state validation failed at t={t_myr:.4f} Myr: "
            + "; ".join(problems)
        )
