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


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card, at the
    bars above (f64 plain reference), with ragged and tiny shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for n, b in ((777, 777), (4099, 256), (5, 3)):
        pos, vel, mass = (T(a, device=dev) for a in _system(n, seed=n,
                                                             offset=1.0))
        ids = torch.as_tensor(
            np.random.default_rng(n).choice(n, b, replace=False),
            dtype=torch.int32, device=dev)
        rp, rv = pos[ids].contiguous(), vel[ids].contiguous()
        before = cn.LAUNCHES["nbody_rows"]
        for kw in ({}, {"pot_eps2": 1e-30}, {"with_jerk": False},
                   {"with_pot": False}):
            got = cn.nbody_rows(rp, rv, ids, pos, vel, mass, 1e-3, **kw)
            ref = cn.nbody_rows_plain(rp.double(), rv.double(), ids,
                                      pos.double(), vel.double(),
                                      mass.double(), 1e-3, **kw)
            for g_, r_ in zip(got, ref):
                if r_.abs().max() > 0:
                    assert _rel(g_.cpu(), r_.cpu()) < 1e-5
                else:
                    assert not g_.any()
        assert cn.LAUNCHES["nbody_rows"] == before + 4
        a0 = 0.1 * torch.randn_like(pos)
        j0 = 0.05 * torch.randn_like(pos)
        tau = torch.tensor(0.0037, device=dev)
        got = cn.nbody_predcols(rp, rv, ids, pos, vel, a0, j0, mass, tau,
                                1e-3)
        ref = cn.nbody_predcols_plain(rp.double(), rv.double(), ids,
                                      pos.double(), vel.double(),
                                      a0.double(), j0.double(),
                                      mass.double(), tau.double(), 1e-3)
        for g_, r_ in zip(got, ref):
            assert _rel(g_.cpu(), r_.cpu()) < 2e-5
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_mma_kernels_match_plain_on_card():
    """The matmul reductions (nbody_rows_mma, nbody_predcols_mma) against
    their f64 plain decomposition on a card, at the JAX package's bars
    (3e-4 of the max, 5e-4 for kernel 2, 1e-4 for a potential through the
    product, 1e-5 for an explicit one), ragged and tiny shapes, off-centre;
    a repeat gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for n, b in ((777, 777), (4099, 256), (5, 3)):
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
            got = cn.nbody_rows(rp, rv, ids, pos, vel, mass, eps2,
                                use_mxu=True, **kw)
            again = cn.nbody_rows(rp, rv, ids, pos, vel, mass, eps2,
                                  use_mxu=True, **kw)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            ref = cn.nbody_rows_plain(rp.double(), rv.double(), ids,
                                      pos.double(), vel.double(),
                                      mass.double(), eps2, use_mxu=True,
                                      **kw)
            for g_, r_, bar in zip(got, ref, (3e-4, 3e-4, pot_bar)):
                if r_.abs().max() > 0:
                    assert _rel(g_.cpu(), r_.cpu()) < bar
                else:
                    assert not g_.any()
        assert cn.LAUNCHES["nbody_rows_mma"] == before + 10
        a0 = 0.1 * torch.randn_like(pos)
        j0 = 0.05 * torch.randn_like(pos)
        tau = torch.tensor(0.0037, device=dev)
        got = cn.nbody_predcols(rp, rv, ids, pos, vel, a0, j0, mass, tau,
                                1e-3, use_mxu=True)
        ref = cn.nbody_predcols_plain(rp.double(), rv.double(), ids,
                                      pos.double(), vel.double(),
                                      a0.double(), j0.double(),
                                      mass.double(), tau.double(), 1e-3,
                                      use_mxu=True)
        for g_, r_ in zip(got, ref):
            assert _rel(g_.cpu(), r_.cpu()) < 5e-4
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
