"""Shared helpers for the stellar-model calibration modules (torch port of
al26_tpu.models.stellar.common).

Single source for the package data root and the one interpolation
convention the stellar modules use: log-log linear between anchors,
clamped at the grid ends. Torch has no `interp`, so `interp` below is the
one linear interpolation of the package, with `np.interp`'s end clamping;
`loglog_interp` and the AGB-rate lookup in `sim.step._agb_rates` both use it.
"""
from __future__ import annotations

import os

import numpy as np
import torch

# <repo>/al26_tpu/data — the tables stay in the JAX package and are read by
# path; this file lives at <repo>/al26_tpu_torch/models/stellar/common.py
DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "al26_tpu", "data",
)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """`np.interp(x, xp, fp)` on tensors: piecewise-linear through the
    increasing knots `xp`, clamped to `fp[0]` / `fp[-1]` outside them.

    Written as `jnp.interp` computes it (searchsorted on the right side,
    then `fp[i-1] + (x - xp[i-1]) / dx * df`), in the promoted dtype of
    the three inputs, so the two packages agree to the last bit where the
    elementwise arithmetic does."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, xp.dtype),
                                fp.dtype)
    x, xp, fp = x.to(dtype), xp.to(dtype), fp.to(dtype)
    i = torch.searchsorted(xp, x.contiguous(), right=True)
    i = i.clamp(1, xp.shape[0] - 1)
    x0 = xp[i - 1]
    f0 = fp[i - 1]
    dx = xp[i] - x0
    df = fp[i] - f0
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np_dtype).eps))
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def loglog_interp(m0, log_m, log_y):
    """exp(interp(log m0)) over (log_m, log_y) anchors, clamped to the
    grid ends. Tensor or numpy input; anchors are host-side numpy arrays.

    Computed in f64 whatever m0's dtype: the anchors are f64, and the JAX
    package's clip against their numpy-f64 endpoints promotes an f32 m0 to
    f64 under x64 as well. The linear-space clip also sanitizes
    nonpositive m0 (a padded zero-mass slot evaluated under a mask would
    otherwise take log(0) = -inf)."""
    m0 = torch.as_tensor(m0)
    dev = m0.device
    x = torch.log(torch.clamp(m0.to(torch.float64),
                              float(np.exp(log_m[0])),
                              float(np.exp(log_m[-1]))))
    xp = torch.as_tensor(np.asarray(log_m, np.float64), device=dev)
    fp = torch.as_tensor(np.asarray(log_y, np.float64), device=dev)
    return torch.exp(interp(x, xp, fp))
