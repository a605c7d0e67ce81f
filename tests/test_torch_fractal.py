"""The port's fractal initial conditions (al26_tpu_torch.models.fractal)
against the JAX package's (al26_tpu.models.fractal), from the same numpy
seeds: the box-splitting draws are host numpy in both packages, and the
virial scaling's potential energy runs on the CPU in f64 here (the JAX
package's chunked sweep under x64), so positions and velocities agree to
1e-12 relative.
"""
import numpy as np
import pytest
import torch

from al26_tpu.config import SimConfig as JaxConfig
from al26_tpu.models import fractal as jfractal
from al26_tpu.sim import init_cluster as jax_init
from al26_tpu.state import cluster_to_numpy as jax_to_numpy
from al26_tpu.units import G_INTERNAL
from al26_tpu_torch.config import SimConfig
from al26_tpu_torch.models import fractal as tfractal
from al26_tpu_torch.sim import init_cluster
from al26_tpu_torch.state import cluster_to_numpy

torch.set_num_threads(1)


@pytest.mark.parametrize("n,dim,seed", [
    (300, 2.0, 1), (1000, 1.6, 4), (2500, 2.6, 9),
])
def test_fractal_positions_velocities_match_jax(n, dim, seed):
    m_tot = 0.6 * n
    pj, vj = jfractal.fractal_positions_velocities(
        np.random.default_rng(seed), n, 1.0, m_tot, dim)
    pt, vt = tfractal.fractal_positions_velocities(
        np.random.default_rng(seed), n, 1.0, m_tot, dim, device="cpu")
    assert pt.shape == (n, 3) and pt.dtype == np.float64
    np.testing.assert_allclose(pt, np.asarray(pj), rtol=1e-12,
                               atol=1e-12 * np.abs(pj).max())
    np.testing.assert_allclose(vt, np.asarray(vj), rtol=1e-12,
                               atol=1e-12 * np.abs(vj).max())
    # the virial radius is Rc and Q = 0.5, from an independent numpy sum
    m = np.full(n, m_tot / n)
    d = np.sqrt(((pt[:, None] - pt[None]) ** 2).sum(-1))
    iu = np.triu_indices(n, 1)
    u = -G_INTERNAL * np.sum(m[iu[0]] * m[iu[1]] / d[iu])
    assert abs(-G_INTERNAL * m_tot**2 / (2.0 * u) - 1.0) < 1e-10
    t_kin = 0.5 * np.sum(m * (vt * vt).sum(1))
    assert abs(t_kin / -u - 0.5) < 1e-10


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_potential_energy_matches_pair_sum(dtype, tol):
    """The virial sum runs in the run's dtype (an f32 run's U carries f32
    round-off, as the JAX package's does under its ambient precision)."""
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(700, 3))
    mass = rng.uniform(0.1, 2.0, 700)
    d = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1) + 1e-30)
    np.fill_diagonal(d, np.inf)
    want = -0.5 * G_INTERNAL * np.sum(mass[:, None] * mass[None] / d)
    got = tfractal._potential_energy(pos, mass, device="cpu", dtype=dtype)
    assert abs(got - want) < tol * abs(want)
    if dtype == torch.float32:
        assert got != tfractal._potential_energy(pos, mass, device="cpu",
                                                 dtype=torch.float64)


def test_init_cluster_fractal_matches_jax():
    kw = dict(n=600, rc=1.0, seed=11, model="fractal", dtype="f64")
    js, _, jcfg = jax_init(JaxConfig(**kw))
    ts, _, tcfg = init_cluster(SimConfig(**kw), device="cpu")
    j, t = jax_to_numpy(js.cluster), cluster_to_numpy(ts.cluster)
    for k in ("pos", "vel"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-12,
                                   atol=1e-12 * np.abs(j[k]).max())
    for k in ("mass", "m0", "tau_disk", "disk_alive", "is_interloper"):
        np.testing.assert_array_equal(t[k], j[k])
    assert tcfg.to_dict() == jcfg.to_dict()
