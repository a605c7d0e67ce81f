"""The port's stellar evolution (al26_tpu_torch.models.stellar) against the
JAX package's, in f64 over dense initial-mass x age grids, for every
mass-track family and Z in {0.02, 0.004}, to 1e-12 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from al26_tpu.models.stellar import evolution as je
from al26_tpu.models.stellar import hurley2000 as jh
from al26_tpu_torch.models.stellar import common as tc
from al26_tpu_torch.models.stellar import evolution as te
from al26_tpu_torch.models.stellar import hurley2000 as th

torch.set_num_threads(1)

M0 = np.geomspace(0.08, 150.0, 97)
AGE = np.linspace(0.0, 45.0, 61)
CASES = [(tr, z) for tr in je.TRACKS for z in (0.02, 0.004)
         if not (tr == "seba" and z != 0.02)]


def _close(got, ref, rtol=1e-12):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-300)


def test_track_families_match():
    assert te.TRACKS == je.TRACKS
    # "seba" is solar-Z only in both packages
    with pytest.raises(ValueError):
        te.check_tracks("seba", 0.004)
    with pytest.raises(ValueError):
        je.check_tracks("seba", 0.004)


@pytest.mark.parametrize("tracks,z", CASES)
def test_evolution_matches_jax(tracks, z):
    m0 = np.repeat(M0, len(AGE))
    t = np.tile(AGE, len(M0))
    J, T = jnp.asarray, torch.as_tensor
    mass_j, mdot_j = je.evolve(J(m0), J(t), z=z, tracks=tracks)
    mass_t, mdot_t = te.evolve(T(m0), T(t), z=z, tracks=tracks)
    _close(mass_t, mass_j)
    _close(mdot_t, mdot_j)
    # the precomputed-table form the step uses
    tbl_t = te.phase_table(T(M0), z=z, tracks=tracks)
    tbl_j = je.phase_table(J(M0), z=z, tracks=tracks)
    for a, b in zip(tbl_t, tbl_j):
        _close(a, b)
    for age in (0.0, 3.3, 12.0):
        mt, rt = te.evolve_from_table(tbl_t, T(M0),
                                      T(age, dtype=torch.float64))
        mj, rj = je.evolve_from_table(tbl_j, J(M0), J(age))
        _close(mt, mj)
        _close(rt, rj)
    _close(te.wind_mdot(T(m0), T(t), z=z, tracks=tracks),
           je.wind_mdot(J(m0), J(t), z=z, tracks=tracks))
    _close(te.t_sn(T(M0), z=z, tracks=tracks),
           je.t_sn(J(M0), z=z, tracks=tracks))
    _close(te.total_wind_loss(T(M0), z=z, tracks=tracks),
           je.total_wind_loss(J(M0), z=z, tracks=tracks))


def test_f32_masses_promote_to_f64_like_jax():
    """An f32 m0 gives an f64 phase table in both packages (the JAX
    package promotes through its f64 anchors under x64; the port states
    the promotion) with the same values."""
    m0 = M0.astype(np.float32)
    tbl_t = te.phase_table(torch.as_tensor(m0), z=0.02, tracks="lc18")
    tbl_j = je.phase_table(jnp.asarray(m0), z=0.02, tracks="lc18")
    for a, b in zip(tbl_t, tbl_j):
        assert a.dtype == (torch.bool if b.dtype == bool else torch.float64)
        _close(a, b)


def test_hurley_fits_and_agb_phase_match():
    J, T = jnp.asarray, torch.as_tensor
    m = np.geomspace(0.5, 120.0, 50)
    for z in (0.02, 0.004, 1e-4):
        _close(th.t_bgb(T(m), z), jh.t_bgb(J(m), z))
        _close(th.t_ms(T(m), z), jh.t_ms(J(m), z))
        _close(th.t_sn(T(m), z), jh.t_sn(J(m), z))
    m_agb = np.linspace(2.5, 7.5, 21)
    t = np.linspace(50.0, 500.0, 21)
    _close(te.agb_mdot(T(m_agb), T(t)), je.agb_mdot(J(m_agb), J(t)))
    _close(te.agb_t_start(T(m_agb)), je.agb_t_start(J(m_agb)))


def test_interp_is_np_interp():
    """The port's one linear interpolation has np.interp's end clamping."""
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(-3, 3, 17))
    fp = rng.normal(size=17)
    x = np.concatenate([rng.uniform(-5, 5, 200), xp, [xp[0], xp[-1]]])
    got = tc.interp(torch.as_tensor(x), torch.as_tensor(xp),
                    torch.as_tensor(fp))
    np.testing.assert_allclose(got.numpy(), np.interp(x, xp, fp),
                               rtol=1e-14, atol=1e-14)
