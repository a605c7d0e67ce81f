"""One substep of the torch loop that ops/integrators.py runs for the
two-tier predicted-columns subcycle of hermite4_block_advance, op for op:
the plain version that the fused CUDA substep (ops/cuda_substep.py) is
held to on the card (tests/test_torch_kernels.py) and timed beside
(chip_smoke.py). tests/test_torch_integrators_deposition.py holds this
function to the loop itself on the CPU. Imports no JAX."""
import torch

from al26_tpu_torch.ops.integrators import _fast_override_delta, _min_crit


def torch_substep(state, tau, cols0, mass_f, ids, rows_at, dt, h_min,
                  eta, eps2, g):
    """One substep from the fast rows' `state` (pf, vf, af, jf) at `tau`,
    the step-start fast rows `cols0` (pf0, vf0, af0, jf0) and `rows_at`
    (kernel 2, make_pred_force_rows). Returns (h, th, (pf1, vf1, a1, j1),
    (da, dj), th < dt): the step, the new offset, the new state, the
    fast-column override and the loop's flag."""
    pf, vf, af, jf = state
    pf0, vf0, af0, jf0 = cols0
    h = eta * torch.sqrt(_min_crit(af, jf))
    h = torch.minimum(torch.maximum(h, h_min), dt - tau)
    h2 = h * h
    pfp = pf + h * vf + 0.5 * h2 * af + (h2 * h / 6.0) * jf
    vfp = vf + h * af + 0.5 * h2 * jf
    th = tau + h
    a1, j1 = rows_at(pfp, vfp, ids, th)
    th2 = th * th
    pf_pred = (pf0 + th * vf0 + 0.5 * th2 * af0
               + (th2 * th / 6.0) * jf0)
    vf_pred = vf0 + th * af0 + 0.5 * th2 * jf0
    da, dj = _fast_override_delta(pfp, vfp, pfp, vfp, pf_pred, vf_pred,
                                  mass_f, eps2, g)
    a1 = a1 + da
    j1 = j1 + dj
    vf1 = vf + 0.5 * h * (af + a1) + (h2 / 12.0) * (jf - j1)
    pf1 = pf + 0.5 * h * (vf + vf1) + (h2 / 12.0) * (af - a1)
    return h, th, (pf1, vf1, a1, j1), (da, dj), th < dt
