"""The fused hermite4_block substep (al26_tpu_torch.ops.cuda_substep) on
the CPU: where the integrator engages it and where the torch loop runs
instead, the wrapper's argument checks, and the torch substep of
tests/torch_substep_ref.py (the plain version the kernels are held to on
the card, tests/test_torch_kernels.py) against the loop it restates. The
kernels themselves run only on a card."""
import pytest
import torch

from al26_tpu_torch.ops import cuda_nbody as cn
from al26_tpu_torch.ops import cuda_substep
from al26_tpu_torch.ops import integrators as ti
from al26_tpu_torch.ops.nbody import _row_block_acc_jerk_pot, acc_jerk_pot
from al26_tpu_torch.utils import timing
from torch_substep_ref import torch_substep

torch.set_num_threads(1)

EPS2 = 1e-4
K = 12


def _cluster(n=64, seed=5, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    pos = torch.randn(n, 3, generator=g, dtype=dtype)
    vel = 0.3 * torch.randn(n, 3, generator=g, dtype=dtype)
    mass = torch.rand(n, generator=g, dtype=dtype) + 0.5
    return pos, vel, mass


def _factory(mass):
    """A predicted-columns factory on the plain row block (any device and
    dtype): rows against every column predicted to tau."""
    def make(p0, v0, a0, j0):
        def rows_at(pr, vr, ids, tau):
            t2 = tau * tau
            pc = p0 + tau * v0 + 0.5 * t2 * a0 + (t2 * tau / 6.0) * j0
            vc = v0 + tau * a0 + 0.5 * t2 * j0
            a, j, _ = _row_block_acc_jerk_pot(pr, vr, pc, vc, mass, EPS2,
                                              ti.G_INTERNAL, ids,
                                              with_pot=False)
            return a, j
        return rows_at
    return make


def _fused_counts():
    return (timing.snapshot_and_reset()["counts"],
            cn.LAUNCHES["substep_predict"], cn.LAUNCHES["substep_correct"])


def test_torch_substep_ref_is_the_loop():
    """tests/torch_substep_ref.torch_substep, looped from the step-start
    fast rows until its flag drops, lands on the torch loop's fast rows
    bit for bit after as many substeps (f64, CPU)."""
    pos, vel, mass = _cluster()
    dt = torch.tensor(0.05, dtype=torch.float64)
    eta, max_sub = 0.05, 4096
    a0, j0, _ = acc_jerk_pot(pos, vel, mass, EPS2)
    timing.snapshot_and_reset()
    pos_c, vel_c = ti.hermite4_block_advance(
        pos, vel, mass, dt, K, eta=eta, eps2=EPS2, max_substeps=max_sub,
        init_eval=(a0, j0), force_rows_at_factory=_factory(mass))
    counts = timing.snapshot_and_reset()["counts"]

    crit = torch.sqrt(torch.sum(a0 * a0, -1)
                      / torch.clamp(torch.sum(j0 * j0, -1), min=1e-30))
    idx = torch.topk(crit, K, largest=False, sorted=True).indices
    cols0 = (pos[idx], vel[idx], a0[idx], j0[idx])
    rows_at = _factory(mass)(pos, vel, a0, j0)
    state, tau, iters = cols0, torch.zeros((), dtype=torch.float64), 0
    while bool(tau < dt):
        _, tau, state, _, _ = torch_substep(
            state, tau, cols0, mass[idx], idx, rows_at, dt, dt / max_sub,
            eta, EPS2, ti.G_INTERNAL)
        iters += 1
    assert iters >= 3
    assert counts["integrator.substeps"] == iters
    assert counts.get("integrator.fused_substeps", 0) == 0
    assert torch.equal(pos_c[idx], state[0])
    assert torch.equal(vel_c[idx], state[1])


@pytest.mark.parametrize("case", ["cpu", "three_tier", "no_factory",
                                  "engaged_on_cpu"])
def test_fused_substep_dispatch(case, monkeypatch):
    """CPU tensors, the three-tier variant (k_ultra > 0) and a call without
    force_rows_at_factory run the torch loop and leave the fused counters
    at 0, the last two even where the fused path would engage (here by a
    patched `engages`); where it engages on a CPU tensor the wrapper
    raises instead of falling back."""
    pos, vel, mass = _cluster(dtype=torch.float32)
    dt = torch.tensor(0.05, dtype=torch.float32)
    kw = {"force_rows_at_factory": _factory(mass)}
    if case != "cpu":
        monkeypatch.setattr(cuda_substep, "engages", lambda pf0: True)
    if case == "three_tier":
        kw["k_ultra"] = 4
    elif case == "no_factory":
        kw = {}
    timing.snapshot_and_reset()
    before = _fused_counts()[1:]
    if case == "engaged_on_cpu":
        with pytest.raises(ValueError, match="CUDA"):
            ti.hermite4_block_advance(pos, vel, mass, dt, K, eta=0.05,
                                      eps2=EPS2, **kw)
        return
    ti.hermite4_block_advance(pos, vel, mass, dt, K, eta=0.05, eps2=EPS2,
                              **kw)
    counts, pred, corr = _fused_counts()
    assert counts["integrator.substeps"] >= 3
    assert counts.get("integrator.fused_substeps", 0) == 0
    assert (pred, corr) == before


def _args(**over):
    """FusedSubstep's arguments, f32 on the CPU, with `over` replaced."""
    g = torch.Generator().manual_seed(1)
    args = {name: torch.randn(K, 3, generator=g)
            for name in ("pf0", "vf0", "af0", "jf0")}
    args.update(mass_f=torch.rand(K, generator=g) + 0.5,
                dt=torch.tensor(0.05), h_min=torch.tensor(0.05 / 4096),
                eta=0.14, eps2=torch.tensor(EPS2), g=ti.G_INTERNAL)
    args.update(over)
    return args


@pytest.mark.parametrize("over,err,match", [
    ({}, ValueError, "CUDA tensors"),
    ({"vf0": torch.zeros(K, 3, dtype=torch.float64)}, TypeError, "vf0"),
    ({"mass_f": torch.zeros(K, dtype=torch.int32)}, TypeError, "mass_f"),
    ({"af0": torch.zeros(K + 1, 3)}, ValueError, "af0 has shape"),
    ({"dt": torch.tensor([0.05])}, ValueError, "dt has shape"),
    ({"jf0": torch.zeros(3, K).t()}, ValueError, "jf0 must be contiguous"),
    ({"h_min": torch.zeros((), device="meta")}, ValueError, "h_min is on"),
])
def test_fused_substep_checks_arguments(over, err, match):
    """The wrapper raises on a wrong dtype, shape, contiguity or device
    before it builds or launches anything (on the CPU: every argument
    right but the device)."""
    with pytest.raises(err, match=match):
        cuda_substep.FusedSubstep(**_args(**over))
