"""The hermite4_block fast-group substep around kernel 2c, fused into two
hand-written CUDA kernels (csrc/nbody.cu: `substep_predict`,
`substep_correct`; their note there says what they replace and what
bounds them).

The two-tier predicted-columns subcycle of
`ops.integrators.hermite4_block_advance` runs, a substep:

    predict()             the step size h over the K fast rows, th = tau + h
                          (the f32 offset kernel 2c reads), the fast rows'
                          predictor over h and the fast columns' step-start
                          prediction to th: one launch;
    rows_at(pfp, vfp, ids, th)   kernel 2c, launched as before through
                          cuda_nbody.make_pred_force_rows / PredcolsMma;
    correct(a1, j1)       the exact fast-column override
                          (integrators._fast_override_delta) added to 2c's
                          (a1, j1), the Hermite corrector, the fast rows'
                          state in place, tau = th and the flag th < dt
                          that the loop reads back: one launch.

The torch loop in ops.integrators is the plain version: it runs wherever
`engages` is false (CPU tensors, other dtypes), and the card tests hold
these kernels to it. `FusedSubstep` checks device, dtype, shape and
contiguity, and raises on anything else; on a CUDA tensor nothing falls
back. `cuda_nbody.LAUNCHES` counts the launches under "substep_predict"
and "substep_correct".
"""
from __future__ import annotations

import torch

from . import cuda_nbody
from .cuda_nbody import _check, _count, _ptr

# tau, h, th, flag
_SCALARS = 4


def engages(pf0: torch.Tensor) -> bool:
    """Does the fused substep run for these fast rows: CUDA f32."""
    return pf0.device.type == "cuda" and pf0.dtype is torch.float32


class FusedSubstep:
    """One advance's fused substeps: the step-start fast rows
    (pf0, vf0, af0, jf0 [K, 3], mass_f [K]), dt and h_min (0-dim), all f32
    on one CUDA device, checked once; their state, predictions and scalars
    made here. Each substep is then `predict()`, kernel 2c on
    (`pfp`, `vfp`) at `th`, and `correct(a1, j1)`, which returns the flag
    tensor th < dt (1.0 or 0.0) for the loop's host read. `pf`, `vf`,
    `af`, `jf` are the subcycled fast rows (views, updated in place by
    each `correct`); `tau` and `h` the current substep's (0-dim views)."""

    def __init__(self, pf0, vf0, af0, jf0, mass_f, dt, h_min, eta: float,
                 eps2, g: float):
        k, device, f32 = pf0.shape[0], pf0.device, torch.float32
        for name, t in (("pf0", pf0), ("vf0", vf0), ("af0", af0),
                        ("jf0", jf0)):
            _check(name, t, (k, 3), f32, device)
        _check("mass_f", mass_f, (k,), f32, device)
        _check("dt", dt, (), f32, device)
        _check("h_min", h_min, (), f32, device)
        if device.type != "cuda":
            raise ValueError(f"the fused substep runs on CUDA tensors, got "
                             f"{device}")
        if k == 0:
            raise ValueError("the fused substep needs at least one fast row")
        # a device eps2 is read by the kernel (no host read here)
        eps2_t = None
        if isinstance(eps2, torch.Tensor):
            eps2_t, eps2 = eps2.to(device=device, dtype=f32).reshape(()), 0.0
        self.k = k
        self._s0 = torch.stack((pf0, vf0, af0, jf0))
        self._s = self._s0.clone()
        self._w = torch.empty_like(self._s0)
        self._sc = torch.zeros(_SCALARS, dtype=f32, device=device)
        self.pf, self.vf, self.af, self.jf = self._s.unbind(0)
        self.pfp, self.vfp = self._w[0], self._w[1]
        self.tau, self.h, self.th, self._flag = self._sc.unbind(0)
        self._device = device
        lib = cuda_nbody.load()
        stream = torch.cuda.current_stream(device).cuda_stream
        self._predict = lib.substep_predict_launch
        self._predict_args = (
            self._s0.data_ptr(), self._s.data_ptr(), self._w.data_ptr(),
            self._sc.data_ptr(), dt.data_ptr(), h_min.data_ptr(),
            float(eta), k, stream)
        self._correct = lib.substep_correct_launch
        self._correct_args = (
            self._w.data_ptr(), self._s.data_ptr(), self._sc.data_ptr(),
            mass_f.data_ptr())
        self._correct_tail = (dt.data_ptr(), _ptr(eps2_t), float(eps2),
                              float(g), k, stream)
        # the caller's tensors the launches' pointers name
        self._keep = (mass_f, dt, h_min, eps2_t)

    def predict(self) -> None:
        """h, th, (pfp, vfp) and the fast columns' prediction: one
        launch."""
        _count(self._predict(*self._predict_args), "substep_predict")

    def correct(self, a1, j1) -> torch.Tensor:
        """The override delta, the corrector and the flag, from kernel 2c's
        (a1, j1) [K, 3]: one launch. Returns the flag tensor."""
        k, dev, f32 = self.k, self._device, torch.float32
        if not (a1.dtype is f32 and j1.dtype is f32
                and a1.shape == (k, 3) and j1.shape == (k, 3)
                and a1.device == dev and j1.device == dev
                and a1.is_contiguous() and j1.is_contiguous()):
            _check("a1", a1, (k, 3), f32, dev)
            _check("j1", j1, (k, 3), f32, dev)
        _count(self._correct(*self._correct_args, a1.data_ptr(),
                             j1.data_ptr(), *self._correct_tail),
               "substep_correct")
        return self._flag
