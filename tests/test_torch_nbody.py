"""The port's reference force (al26_tpu_torch.ops.nbody) against the JAX
package's, in f64 on the CPU, to 1e-12: dense and row-chunked forces,
the diagnostics, and the force cache's mass-delta correction (dense and
row-chunked)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from al26_tpu.ops import nbody as jn
from al26_tpu_torch.ops import nbody as tn

torch.set_num_threads(1)

RTOL = 1e-12


def _system(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
            rng.uniform(0.1, 2.0, n))


def _close(got, ref, rtol=RTOL):
    """Agreement to rtol of the max |ref| (elementwise for large values,
    absolute at the scale of the field for values that cancel)."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref))) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("eps2", [0.0, 0.05])
def test_dense_forces_match(eps2):
    pos, vel, mass = _system(200, 1)
    a1, j1, p1 = jn.acc_jerk_pot_dense(jnp.asarray(pos), jnp.asarray(vel),
                                       jnp.asarray(mass), eps2)
    a2, j2, p2 = tn.acc_jerk_pot_dense(torch.as_tensor(pos),
                                       torch.as_tensor(vel),
                                       torch.as_tensor(mass), eps2)
    _close(a2, a1)
    _close(j2, j1)
    _close(p2, p1)
    a3, p3 = jn.acc_pot_dense(jnp.asarray(pos), jnp.asarray(mass), eps2)
    a4, p4 = tn.acc_pot_dense(torch.as_tensor(pos), torch.as_tensor(mass),
                              eps2)
    _close(a4, a3)
    _close(p4, p3)


def test_chunked_forces_match():
    """Row-chunked sweep with a ragged last block (n not a multiple of
    block), and the dispatcher above its dense threshold."""
    pos, vel, mass = _system(300, 2)
    J = lambda a: jnp.asarray(a)
    T = torch.as_tensor
    for out_j, out_t in (
        (jn.acc_jerk_pot_chunked(J(pos), J(vel), J(mass), 0.01, block=128),
         tn.acc_jerk_pot_chunked(T(pos), T(vel), T(mass), 0.01, block=128)),
        (jn.acc_jerk_pot(J(pos), J(vel), J(mass), 0.01),
         tn.acc_jerk_pot(T(pos), T(vel), T(mass), 0.01)),
    ):
        for x, y in zip(out_t, out_j):
            _close(x, y)
    # the row block with a separately softened potential and no jerk
    ids = np.asarray([5, 0, 299, 17])
    rj = jn._row_block_acc_jerk_pot(J(pos[ids]), J(vel[ids]), J(pos),
                                    J(vel), J(mass), 0.125, 1.0,
                                    jnp.asarray(ids), pot_eps2=1e-30,
                                    with_jerk=False)
    rt = tn._row_block_acc_jerk_pot(T(pos[ids]), T(vel[ids]), T(pos),
                                    T(vel), T(mass), 0.125, 1.0,
                                    T(ids), pot_eps2=1e-30,
                                    with_jerk=False)
    for x, y in zip(rt, rj):
        _close(x, y)


def test_diagnostics_match():
    pos, vel, mass = _system(2100, 3)   # potential_energy goes chunked
    J = lambda a: jnp.asarray(a)
    T = torch.as_tensor
    _close(tn.virial_radius(T(pos), T(mass)),
           jn.virial_radius(J(pos), J(mass)))
    _close(tn.potential_chunked(T(pos[:500]), T(mass[:500]), 0.01,
                                block=128),
           jn.potential_chunked(J(pos[:500]), J(mass[:500]), 0.01,
                                block=128))
    _close(tn.total_energy(T(pos[:300]), T(vel[:300]), T(mass[:300]), 0.1),
           jn.total_energy(J(pos[:300]), J(vel[:300]), J(mass[:300]), 0.1))
    _close(tn.center_of_mass(T(pos), T(mass)),
           jn.center_of_mass(J(pos), J(mass)))
    _close(tn.half_mass_radius(T(pos), T(mass)),
           jn.half_mass_radius(J(pos), J(mass)))
    p, v, m = pos[:200], vel[:200], mass[:200]
    lm, hm = m < 1.0, m > 1.8
    _close(tn.min_intercept_time(T(p), T(v), T(lm), T(hm)),
           jn.min_intercept_time(J(p), J(v), J(lm), J(hm)))
    _close(tn.local_densities(T(p), T(m)), jn.local_densities(J(p), J(m)))


@pytest.mark.parametrize("kw", [{}, {"jerk_none": True},
                                {"pot_softened": True}, {"group_size": 25}])
@pytest.mark.parametrize("block", [0, 32])
def test_mass_delta_correction_matches(kw, block):
    """Dense (block=0) and row-chunked (block=32, ragged at n=100) against
    the JAX package's dense correction; padding slots (dm = 0)."""
    kw = dict(kw)
    rng = np.random.default_rng(11)
    n = 100
    pos, vel = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    acc, jerk = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    pot = rng.normal(size=n)
    src = np.asarray([3, 17, 40, 77, 0], np.int32)
    dm = np.asarray([-0.5, 1.2, -0.05, -0.3, 0.0])
    jerk_none = kw.pop("jerk_none", False)
    J = jnp.asarray
    T = torch.as_tensor
    ref = jn.mass_delta_correction(J(acc), None if jerk_none else J(jerk),
                                   J(pot), J(pos), J(vel), J(src), J(dm),
                                   0.05, block=0, **kw)
    got = tn.mass_delta_correction(T(acc), None if jerk_none else T(jerk),
                                   T(pot), T(pos), T(vel), T(src), T(dm),
                                   0.05, block=block, **kw)
    _close(got[0], ref[0])
    _close(got[2], ref[2])
    if jerk_none:
        assert got[1] is None
    else:
        _close(got[1], ref[1])


def test_mass_delta_correction_auto_chunks():
    """Above 2^23 N x M terms the correction chunks by itself; the result
    is the dense one."""
    rng = np.random.default_rng(5)
    n, m = 9000, 1000            # 9e6 > 2^23 pair terms
    T = torch.as_tensor
    pos, vel = T(rng.normal(size=(n, 3))), T(rng.normal(size=(n, 3)))
    acc, pot = T(rng.normal(size=(n, 3))), T(rng.normal(size=n))
    src = T(rng.choice(n, m, replace=False).astype(np.int32))
    dm = T(rng.normal(size=m) * 1e-3)
    auto = tn.mass_delta_correction(acc, None, pot, pos, vel, src, dm, 0.05)
    dense = tn.mass_delta_correction(acc, None, pot, pos, vel, src, dm,
                                     0.05, block=0)
    _close(auto[0], dense[0], rtol=1e-14)
    _close(auto[2], dense[2], rtol=1e-14)


def test_mass_delta_correction_raw_pot_close_pair_f32():
    """In f32 a target within ~1e-4 pc of a source that lost mass: the
    raw-potential correction is +G |dm| / d, not the G |dm| * 1e15 that
    the form r2 - eps2 gives once d2 drops below half an ulp of eps2 (it
    turned the virial radius negative on the card at N = 409600)."""
    pos = np.array([[0.7, -0.3, 0.2], [0.7 + 3e-5, -0.3 - 2e-5, 0.2],
                    [-1.0, 0.5, 0.4]])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    src = torch.as_tensor([0], dtype=torch.int32)
    dm = f32([-0.01])
    zeros = f32(np.zeros((3, 3)))
    _, _, pot = tn.mass_delta_correction(zeros, None, f32(np.zeros(3)),
                                         f32(pos), zeros, src, dm, 0.125)
    p32 = f32(pos).double().numpy()
    d = np.linalg.norm(p32[1:] - p32[0], axis=1)
    want = tn.G_INTERNAL * 0.01 / d
    assert pot[0] == 0.0                                 # the self pair
    np.testing.assert_allclose(pot[1:].double().numpy(), want, rtol=1e-5)
