"""The port's direct-sum kernel module (al26_tpu_torch.ops.cuda_nbody)
against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; the JAX side
runs its Pallas kernels as tests/test_pallas.py does (interpret mode,
chosen automatically off-TPU). Inputs come from numpy seeds. Tolerances
are test_pallas.py's own: 1e-5 of the max against the FMA body
(use_mxu=False), 3e-4 against the default matmul reduction
(use_mxu=True), 2e-5 for the predicted-columns path.

`test_kernels_match_plain_on_card` holds each CUDA kernel against its
plain version on a card; it skips where torch finds no CUDA device. The
JAX side is imported by a fixture, so on a machine with the card and no
JAX the card test runs alone (tests/conftest.py imports JAX, hence
`--noconftest`):

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu
"""
import functools
import gc
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from al26_tpu_torch.ops import cuda_nbody as cn
from al26_tpu_torch.ops.integrators import _fast_override_delta
from al26_tpu_torch.units import G_INTERNAL

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel module (Pallas, interpret mode here)."""
    import jax.numpy as jnp

    from al26_tpu.ops import pallas_nbody
    from al26_tpu.ops.integrators import _fast_override_delta as override

    return SimpleNamespace(J=jnp.asarray, pk=pallas_nbody, override=override)


def _system(n, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32) + offset,
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0.1, 2.0, n).astype(np.float32))


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


T = torch.as_tensor


@pytest.mark.parametrize("n", [100, 512, 777])
@pytest.mark.parametrize("use_mxu", [False, True])
def test_full_sweep_matches_pallas(jx, n, use_mxu):
    """Full sweep with jerk, eps2-softened potential (the Pallas default
    sweep), off-centre as test_pallas_matches_dense stresses it."""
    pos, vel, mass = _system(n, offset=4.0)
    a1, j1, p1 = jx.pk.pallas_acc_jerk_pot(jx.J(pos), jx.J(vel), jx.J(mass),
                                           1e-3, use_mxu=use_mxu)
    a2, j2, p2 = cn.kernel_acc_jerk_pot(T(pos), T(vel), T(mass), 1e-3,
                                        use_mxu=use_mxu)
    tol = 3e-4 if use_mxu else 1e-5
    assert _rel(a2, a1) < tol
    assert _rel(j2, j1) < tol
    assert _rel(p2, p1) < 1e-5
    assert a2.dtype == torch.float32 and p2.shape == (n,)


@pytest.mark.parametrize("use_mxu", [False, True])
def test_sweep_without_jerk_matches_pallas(jx, use_mxu):
    """The leapfrog sweep: acceleration only; the port returns the jerk as
    zeros (as the Pallas FMA body does; its matmul body leaves a
    meaningless jerk there)."""
    pos, vel, mass = _system(300, seed=2)
    a1, j1, _ = jx.pk.pallas_acc_jerk_pot(jx.J(pos), jx.J(vel), jx.J(mass),
                                          1e-3, with_jerk=False,
                                          use_mxu=use_mxu)
    a2, j2, _ = cn.kernel_acc_jerk_pot(T(pos), T(vel), T(mass), 1e-3,
                                       with_jerk=False, use_mxu=use_mxu)
    assert _rel(a2, a1) < (3e-4 if use_mxu else 1e-5)
    assert not j2.any()
    if not use_mxu:
        assert not np.asarray(j1).any()
    if use_mxu:                      # the factory takes the default
        acc_fn = cn.make_pallas_acc(T(mass), 1e-3)
        np.testing.assert_array_equal(acc_fn(T(pos)).numpy(), a2.numpy())


@pytest.mark.parametrize("use_mxu", [False, True])
def test_pot_eps2_fused_sweep_matches_pallas(jx, use_mxu):
    """pot_eps2=1e-30: softened forces plus the raw potential in one sweep
    (the step's opening/closing sweep)."""
    pos, vel, mass = _system(400, seed=15)
    eps2 = 0.125
    a1, j1, p1 = jx.pk.pallas_acc_jerk_pot(jx.J(pos), jx.J(vel), jx.J(mass),
                                           eps2, pot_eps2=1e-30,
                                           use_mxu=use_mxu)
    a2, j2, p2 = cn.kernel_acc_jerk_pot(T(pos), T(vel), T(mass), eps2,
                                        pot_eps2=1e-30, use_mxu=use_mxu)
    tol = 3e-4 if use_mxu else 1e-5
    assert _rel(a2, a1) < tol
    assert _rel(j2, j1) < tol
    assert _rel(p2, p1) < 1e-5


def test_scattered_rows_with_padding_match_pallas(jx):
    """Unordered row subsets mask their own self pair; a padding row (id
    -1) masks no pair, in both packages."""
    pos, vel, mass = _system(300, seed=9)
    ids = np.asarray([7, 3, 299, -1, 150, 42, 0, 255, -1], np.int32)
    rows = np.where(ids[:, None] >= 0, pos[np.maximum(ids, 0)], 0.5)
    vrows = np.where(ids[:, None] >= 0, vel[np.maximum(ids, 0)], 0.0)
    rows, vrows = rows.astype(np.float32), vrows.astype(np.float32)
    a1, j1, p1 = jx.pk.pallas_acc_jerk_pot_rows(
        jx.J(rows), jx.J(vrows), jx.J(ids), jx.J(pos), jx.J(vel),
        jx.J(mass), eps2=1e-3, use_mxu=False)
    a2, j2, p2 = cn.kernel_acc_jerk_pot_rows(
        T(rows), T(vrows), T(ids), T(pos), T(vel), T(mass), 1e-3,
        use_mxu=False)
    assert _rel(a2, a1) < 1e-5
    assert _rel(j2, j1) < 1e-5
    assert _rel(p2, p1) < 1e-5


@pytest.mark.parametrize("use_mxu", [False, True])
def test_small_row_call_matches_pallas(jx, use_mxu):
    """A <= 64-row call (the k_ultra tier; Pallas picks a 64-row tile)
    through make_pallas_force_rows."""
    pos, vel, mass = _system(500, seed=5)
    ids = np.random.default_rng(6).choice(500, 40, replace=False).astype(
        np.int32)
    ff_j = jx.pk.make_pallas_force_rows(jx.J(mass), 1e-3)
    if not use_mxu:
        def ff_j(pr, vr, i, pa, va):
            a, j, _ = jx.pk.pallas_acc_jerk_pot_rows(
                pr, vr, i, pa, va, jx.J(mass), eps2=1e-3,
                use_mxu=False, tile_i=64)
            return a, j
    a1, j1 = ff_j(jx.J(pos[ids]), jx.J(vel[ids]), jx.J(ids), jx.J(pos),
                  jx.J(vel))
    ff_t = cn.make_pallas_force_rows(T(mass), 1e-3)
    if not use_mxu:
        def ff_t(pr, vr, i, pa, va):
            a, j, _ = cn.kernel_acc_jerk_pot_rows(pr, vr, i, pa, va, T(mass),
                                                  1e-3, use_mxu=False)
            return a, j
    a2, j2 = ff_t(T(pos[ids]), T(vel[ids]), T(ids), T(pos), T(vel))
    tol = 3e-4 if use_mxu else 1e-5
    assert _rel(a2, a1) < tol
    assert _rel(j2, j1) < tol


def test_predcols_plus_override_matches_pallas(jx):
    """Kernel 2 + the K x K source-linearity delta against the JAX
    package's predicted-columns kernel + its delta, on the inputs of
    test_pred_cols_kernel_matches_explicit_columns."""
    n, k = 700, 64
    pos, vel, mass = _system(n, seed=3)
    pos = pos * 2.0 + 1.5
    rng = np.random.default_rng(4)
    a0 = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    j0 = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    fast = rng.choice(n, size=k, replace=False).astype(np.int32)
    tau = np.float32(0.0037)
    eps2 = 1e-3
    pfp = (pos[fast] + rng.normal(size=(k, 3)) * 1e-3).astype(np.float32)
    vfp = (vel[fast] + rng.normal(size=(k, 3)) * 1e-3).astype(np.float32)
    t2 = tau * tau
    pf_pred = pos[fast] + tau * vel[fast] + 0.5 * t2 * a0[fast] \
        + (t2 * tau / 6.0) * j0[fast]
    vf_pred = vel[fast] + tau * a0[fast] + 0.5 * t2 * j0[fast]

    rows_j = jx.pk.make_pred_force_rows(
        jx.J(pos), jx.J(vel), jx.J(a0), jx.J(j0), jx.J(mass), eps2=eps2,
        use_mxu=False, tile_i=64)
    a1, j1 = rows_j(jx.J(pfp), jx.J(vfp), jx.J(fast), jx.J(tau))
    da1, dj1 = jx.override(jx.J(pfp), jx.J(vfp), jx.J(pfp), jx.J(vfp),
                           jx.J(pf_pred), jx.J(vf_pred), jx.J(mass[fast]),
                           eps2, G_INTERNAL)
    rows_t = cn.make_pred_force_rows(T(pos), T(vel), T(a0), T(j0), T(mass),
                                     eps2, use_mxu=False)
    a2, j2 = rows_t(T(pfp), T(vfp), T(fast), T(tau))
    da2, dj2 = _fast_override_delta(T(pfp), T(vfp), T(pfp), T(vfp),
                                    T(pf_pred), T(vf_pred), T(mass[fast]),
                                    eps2, G_INTERNAL)
    assert _rel(a2 + da2, np.asarray(a1 + da1)) < 2e-5
    assert _rel(j2 + dj2, np.asarray(j1 + dj1)) < 2e-5
    assert _rel(da2, da1) < 2e-5


@functools.lru_cache(maxsize=None)
def _plummer(n, k):
    """A Plummer cluster of n stars from init_cluster on the card (f32)
    and its config with k_fast = k."""
    from al26_tpu_torch import SimConfig
    from al26_tpu_torch.sim import init_cluster

    cfg = SimConfig(n=n, rc=1.0, seed=42, dtype="f32", k_fast=k)
    state, _, cfg = init_cluster(cfg, device=torch.device("cuda"))
    c = state.cluster
    return c.pos, c.vel, c.mass, cfg


def _fast_group(pos, vel, mass, cfg, k):
    """The step-start fast group as hermite4_block_advance selects it
    (kernel 1c's forces): (idx, the rows (pf0, vf0, af0, jf0), a0, j0)."""
    a0, j0, _ = cn.kernel_acc_jerk_pot(pos, vel, mass, cfg.eps2)
    crit = torch.sqrt(torch.sum(a0 * a0, -1)
                      / torch.clamp(torch.sum(j0 * j0, -1), min=1e-30))
    idx = torch.topk(crit, k, largest=False, sorted=True).indices
    return idx, tuple(t[idx] for t in (pos, vel, a0, j0)), a0, j0


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(256, 32768), (512, 102400)])
def test_fused_substep_matches_torch_substep_on_card(k, n):
    """One substep of the fused kernels (ops.cuda_substep) against the
    torch loop's (tests/torch_substep_ref.py) from the same state: the
    fast rows of a Plummer cluster after three fused substeps, f32, kernel
    2c between. Bars: h and tau to 1e-6 relative (the torch loop's rounding
    order from the same state, which gives its bits on an H100); the flag
    exactly; the override delta to 2e-5 of the total force's max (the
    predicted-columns bar: the K-column sums are taken in another order);
    (pf1, vf1) to 1e-6 of their max (a few f32 ulps: only a1 differs, by
    the delta's rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from al26_tpu_torch.ops import cuda_substep
    from torch_substep_ref import torch_substep

    pos, vel, mass, cfg = _plummer(n, k)
    dev, f32 = pos.device, torch.float32
    dt = torch.tensor(cfg.dt, dtype=f32, device=dev)
    eps2 = torch.tensor(cfg.eps2, dtype=f32, device=dev)
    h_min = dt / cfg.substeps_max
    idx, cols0, a0, j0 = _fast_group(pos, vel, mass, cfg, k)
    ids, mass_f = idx.to(torch.int32), mass[idx]
    rows_at = cn.make_pred_force_rows(pos, vel, a0, j0, mass, cfg.eps2)
    sub = cuda_substep.FusedSubstep(*cols0, mass_f, dt, h_min,
                                    cfg.eta_hermite, eps2, G_INTERNAL)

    def fused_substep():
        sub.predict()
        a1, j1 = rows_at(sub.pfp, sub.vfp, ids, sub.th)
        return a1, sub.correct(a1, j1).clone()

    before = dict(cn.LAUNCHES)
    for _ in range(3):
        fused_substep()
    state = tuple(t.clone() for t in (sub.pf, sub.vf, sub.af, sub.jf))
    tau = sub.tau.clone()
    h, th, new, (da, dj), flag = torch_substep(
        state, tau, cols0, mass_f, ids, rows_at, dt, h_min, cfg.eta_hermite,
        eps2, G_INTERNAL)
    a1, flag_f = fused_substep()
    torch.cuda.synchronize()
    assert float(tau) > 0 and bool(flag)
    # four fused substeps; 2c once more for the torch substep
    launched = {key: cn.LAUNCHES[key] - before[key] for key in before}
    assert launched["substep_predict"] == launched["substep_correct"] == 4
    assert launched["nbody_predcols_mma"] == 5
    assert abs(float(sub.h) - float(h)) <= 1e-6 * float(h)
    assert abs(float(sub.tau) - float(th)) <= 1e-6 * float(th)
    assert bool(flag_f) == bool(flag)
    delta = sub.af - a1
    assert float((delta - da).abs().max()) <= 2e-5 * float(
        new[2].abs().max())
    assert float((sub.jf - new[3]).abs().max()) <= 2e-5 * float(
        new[3].abs().max())
    for got, want in ((sub.pf, new[0]), (sub.vf, new[1])):
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


def _gap(got, ref, start) -> float:
    """rms over stars of |got - ref| over the rms of |ref - start| (ref
    the f64 run: its change over the run)."""
    d = (got.double() - ref).norm(dim=-1)
    s = (ref - start.double()).norm(dim=-1)
    return float(d.pow(2).mean().sqrt() / s.pow(2).mean().sqrt())


def _block_run(pos, vel, mass, cfg, k, steps, m=1):
    """`steps` hermite4_block advances of m dt each (m > 1 with the
    gravity stride's m - 1 interior samples), as sim.step's cached runner
    makes them: the closing sweep reused as the next opening one, eps2 a
    device scalar. f32: kernel 1c and the predicted-columns factory (the
    fused substep wherever it engages); f64: the plain torch sweeps and
    row blocks. Returns (pos, vel, samples, substeps of each advance,
    fused substeps, launches)."""
    from al26_tpu_torch.ops import integrators as ti
    from al26_tpu_torch.ops import nbody
    from al26_tpu_torch.utils import timing

    dev, dtype = pos.device, pos.dtype
    dt = torch.tensor(m * cfg.dt, dtype=dtype, device=dev)
    eps2 = torch.tensor(cfg.eps2, dtype=dtype, device=dev)
    factory = rows = None
    if dtype is torch.float32:
        def sweep(p, v):
            return cn.kernel_acc_jerk_pot(p, v, mass, cfg.eps2)

        def factory(p, v, a0, j0):
            return cn.make_pred_force_rows(p, v, a0, j0, mass, cfg.eps2)

        rows = cn.make_pallas_force_rows(mass, cfg.eps2)
    else:
        def sweep(p, v):
            return nbody.acc_jerk_pot(p, v, mass, cfg.eps2)
    a, j, _ = sweep(pos, vel)
    before = dict(cn.LAUNCHES)
    timing.snapshot_and_reset()
    subs, fused, samples = [], 0, None
    for _ in range(steps):
        out = ti.hermite4_block_advance(
            pos, vel, mass, dt, k, eta=cfg.eta_hermite, eps2=eps2,
            max_substeps=cfg.substeps_max * m, force_rows_fn=rows,
            init_eval=(a, j), final_eval_fn=sweep, interior_samples=m - 1,
            force_rows_at_factory=factory)
        pos, vel, (a, j, _) = out[:3]
        samples = out[3] if m > 1 else None
        counts = timing.snapshot_and_reset()["counts"]
        subs.append(counts["integrator.substeps"])
        fused += counts.get("integrator.fused_substeps", 0)
    torch.cuda.synchronize()
    launches = {key: cn.LAUNCHES[key] - v for key, v in before.items()}
    return pos, vel, samples, subs, fused, launches


def _fused_against_torch_and_f64(pos, vel, mass, cfg, k, steps, m,
                                 monkeypatch):
    """_block_run fused, then with the fused path switched off (the torch
    loop on the same f32 kernels), then in f64; the gaps of each f32 run
    to the f64 one, and the runs."""
    from al26_tpu_torch.ops import cuda_substep

    runs = {"fused": _block_run(pos, vel, mass, cfg, k, steps, m)}
    with monkeypatch.context() as mp:
        mp.setattr(cuda_substep, "engages", lambda pf0: False)
        runs["torch"] = _block_run(pos, vel, mass, cfg, k, steps, m)
    ref = _block_run(pos.double(), vel.double(), mass.double(), cfg, k,
                     steps, m)
    gaps = {}
    for name, run in runs.items():
        gaps[name] = [_gap(run[0], ref[0], pos), _gap(run[1], ref[1], vel)]
        if m > 1:
            gaps[name] += [_gap(run[2][0], ref[2][0], pos[None]),
                           _gap(run[2][1], ref[2][1], vel[None])]
    fused, plain = runs["fused"], runs["torch"]
    total = sum(fused[3])
    assert total > 0
    assert fused[4] == total
    assert (fused[5]["substep_predict"] == fused[5]["substep_correct"]
            == fused[5]["nbody_predcols_mma"] == total)
    assert plain[4] == 0 and plain[5]["substep_predict"] == 0
    assert plain[5]["nbody_predcols_mma"] == sum(plain[3])
    return gaps, fused[3], plain[3]


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(256, 32768), (512, 102400)])
def test_fused_block_steps_hold_to_f64_on_card(k, n, monkeypatch):
    """Ten hermite4_block steps of a Plummer cluster, fused and torch
    substeps (both f32, kernels 1c and 2c), each against the torch path in
    f64 on the card: the fused run's position and velocity gaps at most
    1.5 times the f32 torch run's. The substep counts are not asserted
    equal: each step's are at most one apart (rounding can move where the
    last substep lands). Every fused substep is one count of
    integrator.fused_substeps, one launch of each fused kernel and one of
    kernel 2c; the torch run launches no fused kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    pos, vel, mass, cfg = _plummer(n, k)
    gaps, fs, ts = _fused_against_torch_and_f64(pos, vel, mass, cfg, k, 10,
                                                1, monkeypatch)
    assert all(f <= 1.5 * t for f, t in zip(gaps["fused"], gaps["torch"])), \
        gaps
    assert all(abs(a - b) <= 1 for a, b in zip(fs, ts)), (fs, ts)


@pytest.mark.gpu
def test_fused_strided_advance_holds_to_f64_on_card(monkeypatch):
    """The gravity stride's advance (interior_samples = 3 over 4 dt, the
    crossing capture between the fused kernels), two strides at
    N = 32768, K = 256, held as the steps above: the final state's and the
    interior samples' gaps to f64, the counts and the launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    pos, vel, mass, cfg = _plummer(32768, 256)
    gaps, fs, ts = _fused_against_torch_and_f64(pos, vel, mass, cfg, 256, 2,
                                                4, monkeypatch)
    assert all(f <= 1.5 * t for f, t in zip(gaps["fused"], gaps["torch"])), \
        gaps
    assert all(abs(a - b) <= 1 for a, b in zip(fs, ts)), (fs, ts)


@pytest.mark.parametrize("mode", [
    dict(eps2=1e-3), dict(eps2=0.125), dict(eps2=0.125, pot_eps2=1e-30),
    dict(eps2=1e-3, with_jerk=False), dict(eps2=0.125, with_pot=False)])
def test_matmul_plain_is_the_fma_sum_in_f64(mode):
    """The matmul reduction's plain version (centring, Sw / Sws against
    C8, the row recovery, the potential through the product at eps2 >=
    1e-2) is the FMA sum's algebra: in f64 the two agree to ~1e-10 of the
    max, off-centre, on scattered rows with a padding row, and for kernel
    2's predicted columns."""
    rng = np.random.default_rng(8)
    pos = T(rng.normal(size=(300, 3)) + 4.0)
    vel = T(rng.normal(size=(300, 3)))
    mass = T(rng.uniform(0.1, 2.0, 300))
    ids = T(np.asarray([5, 250, -1, 17, 99], np.int32))
    rows = T(np.where(ids.numpy()[:, None] >= 0,
                      pos.numpy()[np.maximum(ids.numpy(), 0)], 3.5))
    vrows = vel[ids.long().clamp(min=0)]
    got = cn.nbody_rows_plain(rows, vrows, ids, pos, vel, mass,
                              use_mxu=True, **mode)
    want = cn.nbody_rows_plain(rows, vrows, ids, pos, vel, mass, **mode)
    for g, w in zip(got, want):
        if w.abs().max() > 0:
            assert _rel(g, w) < 1e-10
        else:
            assert not g.any()
    a0, j0 = 0.1 * vel.flip(0), 0.05 * pos.flip(0)
    tau = T(0.004, dtype=torch.float64)
    got = cn.nbody_predcols_plain(rows, vrows, ids, pos, vel, a0, j0, mass,
                                  tau, mode["eps2"], use_mxu=True)
    want = cn.nbody_predcols_plain(rows, vrows, ids, pos, vel, a0, j0, mass,
                                   tau, mode["eps2"])
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-10


def test_predcols_matmul_matches_pallas(jx):
    """Kernel 2's matmul body + the K x K delta against the JAX package's
    (use_mxu=True, its default) at test_pallas.py's bar, 5e-4 of the
    max; the port centres once per step (make_pred_force_rows)."""
    n, k = 700, 64
    pos, vel, mass = _system(n, seed=3, offset=3.0)
    rng = np.random.default_rng(4)
    a0 = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    j0 = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    fast = rng.choice(n, size=k, replace=False).astype(np.int32)
    tau = np.float32(0.0037)
    pfp = (pos[fast] + rng.normal(size=(k, 3)) * 1e-3).astype(np.float32)
    vfp = (vel[fast] + rng.normal(size=(k, 3)) * 1e-3).astype(np.float32)
    rows_j = jx.pk.make_pred_force_rows(
        jx.J(pos), jx.J(vel), jx.J(a0), jx.J(j0), jx.J(mass), eps2=1e-3,
        tile_i=64)
    a1, j1 = rows_j(jx.J(pfp), jx.J(vfp), jx.J(fast), jx.J(tau))
    rows_t = cn.make_pred_force_rows(T(pos), T(vel), T(a0), T(j0), T(mass),
                                     1e-3)
    a2, j2 = rows_t(T(pfp), T(vfp), T(fast), T(tau))
    assert _rel(a2, a1) < 5e-4
    assert _rel(j2, j1) < 5e-4
    before = dict(cn.LAUNCHES)
    rows_t(T(pfp), T(vfp), T(fast), T(tau))
    assert cn.LAUNCHES == before            # CPU tensors: plain versions


def test_wrappers_check_arguments():
    """dtype, shape and contiguity are checked before any launch; the
    matmul mode has no group windows: the kernel wrapper refuses the
    pair, the entry point forces the mode off under group_size > 0 (as
    pallas_nbody.py:382 does) and a bad centre is refused; the group
    windows run their plain version on the CPU."""
    pos, vel, mass = (T(a) for a in _system(64, seed=1))
    ids = torch.arange(64, dtype=torch.int32)
    with pytest.raises(TypeError):
        cn.nbody_rows(pos.double(), vel, ids, pos, vel, mass, 1e-3)
    with pytest.raises(ValueError):
        cn.nbody_rows(pos, vel, ids, pos[:32], vel, mass, 1e-3)
    with pytest.raises(ValueError):
        cn.nbody_rows(pos.t().contiguous().t(), vel, ids, pos, vel, mass,
                      1e-3)
    with pytest.raises(ValueError, match="group"):
        cn.nbody_rows(pos, vel, ids, pos, vel, mass, 1e-3, group_size=32,
                      use_mxu=True)
    forced = cn.kernel_acc_jerk_pot(pos, vel, mass, 1e-3, group_size=32,
                                    use_mxu=True)
    fma = cn.kernel_acc_jerk_pot(pos, vel, mass, 1e-3, group_size=32,
                                 use_mxu=False)
    for x, y in zip(forced, fma):
        assert torch.equal(x, y)
    tau = torch.tensor(0.01)
    with pytest.raises(ValueError):
        cn.nbody_predcols(pos[:8], vel[:8], ids[:8], pos, vel, pos, vel,
                          mass, tau, 1e-3, use_mxu=True,
                          centre=torch.zeros(3))
    before = dict(cn.LAUNCHES)
    cn.kernel_acc_jerk_pot(pos, vel, mass, 1e-3)
    cn.kernel_acc_jerk_pot(pos, vel, mass, 1e-3, group_size=32)
    assert cn.LAUNCHES == before      # the CPU path launches nothing
    assert not cn.use_kernel(64, torch.float32, "cpu")
    assert cn.use_kernel(64, torch.float32, "cuda")
    assert not cn.use_kernel(64, torch.float64, "cuda")


@pytest.mark.parametrize("b,n,slots", [
    (32768, 32768, 396), (131072, 131072, 396), (256, 32768, 396),
    (512, 409600, 396), (512, 409600, 264), (257, 257, 396),
    (65536, 65536, 396), (100, 40000, 396), (3, 5, 396), (100, 1, 396),
    (128, 1025, 8), (8192, 8192, 528)])
def test_mma_plan_covers_columns_in_whole_tiles(b, n, slots):
    """The split planner of the matmul bodies and of kernels 1 and 2's
    FMA bodies: splits of whole 256-column tiles cover [0, n) exactly
    once, only the last split ends in a ragged tile, a block walks at
    least _MIN_TILES tiles where n has them, and
    there are never more splits than tiles (B below one row block, N
    below one tile and N = 1 included)."""
    splits, per = cn.split_plan(b, n, slots)
    tiles = -(-n // cn._TJ)
    assert 1 <= splits <= tiles
    assert per >= min(cn._MIN_TILES, tiles)
    cps = per * cn._TJ
    ranges = [(s * cps, min(n, (s + 1) * cps)) for s in range(splits)]
    covered = np.zeros(n, np.int64)
    for lo, hi in ranges:
        assert lo < hi and lo % cn._TJ == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()
    ragged = [hi for lo, hi in ranges if (hi - lo) % cn._TJ]
    assert ragged in ([], [n])
    # the fewest splits among the plans within the slack of the best
    # makespan: one split fewer (at its own tile count) is slower
    row_blocks = -(-b // cn._TB)
    span = -(-row_blocks * splits // slots) * per
    if splits > 1:
        per1 = -(-tiles // (splits - 1))
        span1 = -(-row_blocks * -(-tiles // per1) // slots) * per1
        assert span1 > span or per1 < cn._MIN_TILES


@pytest.mark.parametrize("bpsm", [(8, 2), (6, 1)])
@pytest.mark.parametrize("b,n", [
    (256, 32768), (512, 409600), (32768, 32768), (409600, 409600),
    (8192, 8192), (256, 4099), (512, 1000), (1, 300), (3, 5), (100, 1)])
def test_fma_plan_covers_columns_in_whole_tiles(b, n, bpsm):
    """Kernels 1 and 2's FMA plan on a 132-SM card at the paths' shapes
    (256 and 512 fast rows, full sweeps of 8192, 32768 and 409600 rows)
    and ragged ones: its splits of whole 256-column tiles cover [0, n)
    exactly once with at least two tiles a block where n has them; they
    are split_plan's at the chosen lane count's slots; the lanes are the
    fewest that keep _FMA_MIN_WARPS warps an SM resident (a fast group's
    two row blocks take four lanes, the tree slice's four row blocks and a
    full sweep one)."""
    sms = 132
    lanes, splits, per = cn.fma_plan(b, n, sms, bpsm)
    tiles = -(-n // cn._TJ)
    assert lanes in cn._FMA_LANES
    assert 1 <= splits <= tiles and per >= min(cn._MIN_TILES, tiles)
    cps = per * cn._TJ
    covered = np.zeros(n, np.int64)
    for s in range(splits):
        lo, hi = s * cps, min(n, (s + 1) * cps)
        assert lo < hi and lo % cn._TJ == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()
    slots = dict(zip(cn._FMA_LANES, bpsm))
    assert (splits, per) == cn.split_plan(b, n, sms * slots[lanes])
    row_blocks = -(-b // cn._TB)

    def warps(count):
        s, _ = cn.split_plan(b, n, sms * slots[count])
        return min(row_blocks * s / sms, slots[count]) * 4 * count

    fewer = [c for c in cn._FMA_LANES if c < lanes]
    assert all(warps(c) < cn._FMA_MIN_WARPS for c in fewer)
    if warps(lanes) < cn._FMA_MIN_WARPS:
        assert warps(lanes) == max(warps(c) for c in cn._FMA_LANES)
    if (b, n) == (256, 32768):
        assert lanes == 4
    if (b, n) == (512, 409600) or b >= 8192:
        assert lanes == 1


@pytest.mark.parametrize("x", [
    1.0, -1.0, 3.14159265, -2.718281828, 1e-30, 6.1e5, -1.2345678e-12,
    0.0, -0.0, 1e-40, -3e-44, 1.17549435e-38, 3.0e38])
def test_mask_split_is_exact(x):
    """The matmul bodies' split of a per-pair weight (csrc/nbody.cu
    split_mask): hi = x with its low 13 mantissa bits cleared is a TF32
    value, lo = x - hi is exact in f32 with at most 13 significant bits,
    and keeping lo's top 11 bits (what the tensor core reads) errs by
    under 2^-21 |x| (2^-136 for a subnormal x): on normal, subnormal,
    zero and negative inputs."""
    x32 = np.float32(x)
    hi = (np.array(x32).view(np.uint32) & np.uint32(0xFFFFE000)).view(
        np.float32)
    lo = np.float32(x32 - hi)
    assert np.float64(hi) + np.float64(lo) == np.float64(x32)   # exact
    assert (np.array(hi).view(np.uint32) & 0x1FFF) == 0         # TF32
    assert abs(np.float64(hi)) <= abs(np.float64(x32))
    assert lo == 0 or np.sign(lo) == np.sign(x32)
    if lo != 0:
        m, _ = np.frexp(np.float64(lo))
        assert (m * 2.0 ** 13) == np.round(m * 2.0 ** 13)       # <= 13 bits
    lo_tf32 = (np.array(lo).view(np.uint32) & np.uint32(0xFFFFE000)).view(
        np.float32)
    err = abs(np.float64(hi) + np.float64(lo_tf32) - np.float64(x32))
    # a subnormal x: its low 13 stored bits, under 2^-136 in all
    assert err <= max(2.0 ** -21 * abs(np.float64(x32)), 2.0 ** -136)


@pytest.mark.parametrize("use_mxu", [False, True])
def test_pred_rows_at_outputs_are_not_rewritten(use_mxu):
    """make_pred_force_rows's rows_at (the subcycle's per-substep call)
    returns fresh tensors: a call at a second tau leaves the first call's
    results as they were, and each equals a fresh factory's call."""
    n, k = 300, 32
    pos, vel, mass = (T(a) for a in _system(n, seed=21))
    rng = np.random.default_rng(22)
    a0 = T((rng.normal(size=(n, 3)) * 0.1).astype(np.float32))
    j0 = T((rng.normal(size=(n, 3)) * 0.05).astype(np.float32))
    ids = T(rng.choice(n, k, replace=False).astype(np.int32))
    rows = pos[ids.long()] + 1e-3
    vrows = vel[ids.long()]
    rows_at = cn.make_pred_force_rows(pos, vel, a0, j0, mass, 1e-3,
                                      use_mxu=use_mxu)
    first = rows_at(rows, vrows, ids, T(0.002))
    kept = [t.clone() for t in first]
    second = rows_at(rows, vrows, ids, T(0.004))
    for t, c in zip(first, kept):
        assert torch.equal(t, c)
    for tau, got in ((0.002, first), (0.004, second)):
        fresh = cn.make_pred_force_rows(pos, vel, a0, j0, mass, 1e-3,
                                        use_mxu=use_mxu)(rows, vrows, ids,
                                                         T(tau))
        for g_, f_ in zip(got, fresh):
            assert torch.equal(g_, f_)
    assert not torch.equal(first[0], second[0])


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Kernels 1 and 2's FMA bodies against their f64 plain versions on
    the card, at the bars above: ragged and tiny shapes (n < 256, b = 1),
    a contiguous full sweep and a row subset at eps2 = 0 and 1e-30 (no
    coincident stars), rows whose ids sit at tile edges (0, 255, 256,
    n - 1), padding rows (id -1) that fill whole warps, kernel 2 at
    K = 512 and 256; every call twice, with the same bits, and one launch
    counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    d = lambda t: t.double()

    def check(key, fn, ref_fn, bar):
        before = cn.LAUNCHES[key]
        got, again = fn(), fn()
        assert cn.LAUNCHES[key] == before + 2
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        for g_, r_ in zip(got, ref_fn()):
            if r_.abs().max() > 0:
                assert _rel(g_.cpu(), r_.cpu()) < bar
            else:
                assert not g_.any()

    for n, b in ((777, 777), (4099, 4099), (4099, 256), (5, 3), (200, 1),
                 (65536, 512)):
        pos, vel, mass = (T(a, device=dev) for a in _system(n, seed=n,
                                                             offset=1.0))
        rng = np.random.default_rng(n + b)
        if b == n and n != 777:
            ids = np.arange(n)                      # contiguous
        elif n == 4099:                             # ids at tile edges
            edges = [0, 255, 256, n - 1]
            rest = rng.choice(np.setdiff1d(np.arange(n), edges), b - 4,
                              replace=False)
            ids = np.concatenate([edges, rest])
        else:
            ids = rng.choice(n, b, replace=False)
        ids = torch.as_tensor(ids, dtype=torch.int32, device=dev)
        rp, rv = pos[ids.long()].contiguous(), vel[ids.long()].contiguous()
        cases = [(rp, rv, ids)]
        if b >= 128:
            # rows 64..127 padding: two whole warps with no own id
            pid = ids.clone()
            pid[64:128] = -1
            pp = rp.clone()
            pp[64:128] = 0.5
            cases.append((pp, rv, pid))
        eps2s = (1e-3, 0.0, 1e-30) if n == 4099 else (1e-3,)
        for eps2 in eps2s:
            for k, (xp, xv, xi) in enumerate(cases):
                if eps2 < 1e-3 and k > 0:
                    continue                        # padding rows coincide
                for kw in ({}, {"pot_eps2": 1e-30}, {"with_jerk": False},
                           {"with_pot": False}):
                    check("nbody_rows",
                          lambda: cn.nbody_rows(xp, xv, xi, pos, vel, mass,
                                                eps2, **kw),
                          lambda: cn.nbody_rows_plain(d(xp), d(xv), xi,
                                                      d(pos), d(vel),
                                                      d(mass), eps2, **kw),
                          1e-5)
        a0 = 0.1 * torch.randn_like(pos)
        j0 = 0.05 * torch.randn_like(pos)
        tau = torch.tensor(0.0037, device=dev)
        for xp, xv, xi in cases:
            check("nbody_predcols",
                  lambda: cn.nbody_predcols(xp, xv, xi, pos, vel, a0, j0,
                                            mass, tau, 1e-3),
                  lambda: cn.nbody_predcols_plain(d(xp), d(xv), xi, d(pos),
                                                  d(vel), d(a0), d(j0),
                                                  d(mass), d(tau), 1e-3),
                  2e-5)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_mma_kernels_match_plain_on_card():
    """The matmul reductions (nbody_rows_mma, nbody_predcols_mma) against
    their f64 plain decomposition on a card, at the JAX package's bars
    (3e-4 of the max, 5e-4 for kernel 2, 1e-4 for a potential through the
    product, 1e-5 for an explicit one), ragged and tiny shapes, off-centre,
    launches of one split and of many (kernel 2 at K = 512 among them);
    three calls give the same bits (the split tickets are reset by every
    launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")

    def same_bits(fn):
        got = fn()
        for _ in range(2):
            assert all(torch.equal(x, y) for x, y in zip(got, fn()))
        return got

    one_split = many_splits = False
    for n, b in ((777, 777), (4099, 256), (5, 3), (257, 257), (65536, 512),
                 (409, 1)):
        pos, vel, mass = (T(a, device=dev) for a in _system(n, seed=n,
                                                             offset=4.0))
        ids = torch.as_tensor(
            np.random.default_rng(n).choice(n, b, replace=False),
            dtype=torch.int32, device=dev)
        rp, rv = pos[ids].contiguous(), vel[ids].contiguous()
        before = cn.LAUNCHES["nbody_rows_mma"]
        for eps2, kw, pot_bar in ((1e-3, {}, 1e-5),
                                  (0.125, {}, 1e-4),
                                  (0.125, {"pot_eps2": 1e-30}, 1e-5),
                                  (1e-3, {"with_jerk": False}, 1e-5),
                                  (1e-3, {"with_pot": False}, None)):
            got = same_bits(lambda: cn.nbody_rows(
                rp, rv, ids, pos, vel, mass, eps2, use_mxu=True, **kw))
            ref = cn.nbody_rows_plain(rp.double(), rv.double(), ids,
                                      pos.double(), vel.double(),
                                      mass.double(), eps2, use_mxu=True,
                                      **kw)
            for g_, r_, bar in zip(got, ref, (3e-4, 3e-4, pot_bar)):
                if r_.abs().max() > 0:
                    assert _rel(g_.cpu(), r_.cpu()) < bar
                else:
                    assert not g_.any()
        assert cn.LAUNCHES["nbody_rows_mma"] == before + 15
        a0 = 0.1 * torch.randn_like(pos)
        j0 = 0.05 * torch.randn_like(pos)
        tau = torch.tensor(0.0037, device=dev)
        got = same_bits(lambda: cn.nbody_predcols(
            rp, rv, ids, pos, vel, a0, j0, mass, tau, 1e-3, use_mxu=True))
        ref = cn.nbody_predcols_plain(rp.double(), rv.double(), ids,
                                      pos.double(), vel.double(),
                                      a0.double(), j0.double(),
                                      mass.double(), tau.double(), 1e-3,
                                      use_mxu=True)
        for g_, r_ in zip(got, ref):
            assert _rel(g_.cpu(), r_.cpu()) < 5e-4
        # a bare launcher outlives its plan: the plan's centre, columns
        # and scratch stay allocated while blocks freed since are refilled
        launch, outs = cn.PredcolsMma(pos, vel, a0, j0, mass, 1e-3).launcher(
            rp, rv, ids, tau)
        gc.collect()
        junk = [torch.full((m,), -1.0, device=dev)
                for m in (6, 512, 4096, 1 << 16, 1 << 20) for _ in range(4)]
        for _ in range(2):
            assert launch() == 0
            assert all(torch.equal(x, y) for x, y in zip(outs, got))
        del junk
        splits, _ = cn.split_plan(b, n, cn._mma_slots(dev, True,
                                                     cn.POT_NONE, True))
        one_split |= splits == 1
        many_splits |= splits > 1
    assert one_split and many_splits
    torch.cuda.synchronize()


def test_build_helper_names_reuses_and_needs_nvcc(tmp_path, monkeypatch):
    """ops.cuda_build: one library per source, named after the source's
    hash; an existing library is reused without nvcc; a missing library
    and no nvcc anywhere raise RuntimeError (no fallback)."""
    from al26_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    paths = {name: cuda_build.library_path(name) for name in cuda_build.LIBS}
    assert set(paths) == {"nbody.cu", "tree.cu"}
    assert len(set(paths.values())) == 2
    assert all(os.path.dirname(p) == str(tmp_path) for p in paths.values())
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))    # no bin/nvcc there
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("tree.cu")
    open(paths["tree.cu"], "wb").close()          # a built library
    assert cuda_build.build("tree.cu") == paths["tree.cu"]
    assert cuda_build.build_all(("tree.cu",)) == {
        "tree.cu": (paths["tree.cu"], "")}        # reused: no nvcc output
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all()                    # nbody.cu is missing


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """ops.cuda_build names each library after its source AND the shared
    headers (csrc/*.cuh, the FMA loop both sources include): an edited
    header renames both libraries, so a stale one is never reused; an
    edited source renames only its own."""
    import shutil

    from al26_tpu_torch.ops import cuda_build

    real = {name: cuda_build.library_path(name) for name in cuda_build.LIBS}
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    copied = {name: cuda_build.library_path(name) for name in cuda_build.LIBS}
    assert copied == real                     # the content names them
    for name in cuda_build.LIBS:
        assert '#include "pair_fma.cuh"' in (csrc / name).read_text()
    header = csrc / "pair_fma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {name: cuda_build.library_path(name)
              for name in cuda_build.LIBS}
    assert all(edited[k] != copied[k] for k in copied)
    tree = csrc / "tree.cu"
    tree.write_text(tree.read_text() + "\n")
    again = {name: cuda_build.library_path(name) for name in cuda_build.LIBS}
    assert again["tree.cu"] != edited["tree.cu"]
    assert again["nbody.cu"] == edited["nbody.cu"]


@pytest.mark.gpu
def test_fractal_virial_sum_follows_dtype_on_card():
    """The fractal ICs' virial sum on a card: kernel 1 in f32 (one launch,
    within the kernel bar of the f64 sum), the plain sweep in f64 (no
    launch, the CPU's f64 sum to round-off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from al26_tpu_torch.models import fractal

    rng = np.random.default_rng(4)
    pos = rng.normal(size=(3000, 3))
    mass = rng.uniform(0.1, 2.0, 3000)
    want = fractal._potential_energy(pos, mass, device="cpu",
                                     dtype=torch.float64)
    before = cn.LAUNCHES["nbody_rows"]
    u64 = fractal._potential_energy(pos, mass, device="cuda",
                                    dtype=torch.float64)
    assert cn.LAUNCHES["nbody_rows"] == before
    assert abs(u64 - want) < 1e-12 * abs(want)
    u32 = fractal._potential_energy(pos, mass, device="cuda",
                                    dtype=torch.float32)
    assert cn.LAUNCHES["nbody_rows"] == before + 1
    assert abs(u32 - want) < 1e-5 * abs(want)
