"""The port's integrators and deposition physics against the JAX package,
in f64 on the CPU: each integrator to 1e-12 after one outer step, each
deposition function, the composed post-advance physics against the JAX
step's and against the independent numpy transcription of the
reference's step (tests/reference_step_numpy.py, in the manner of
tests/test_step_transcription.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_step_numpy as ref
from al26_tpu.config import SimConfig as JaxConfig
from al26_tpu.ops import deposition as jd
from al26_tpu.ops import integrators as ji
from al26_tpu.sim import init_cluster as jax_init
from al26_tpu.sim.step import physics_after_advance as jax_physics
from al26_tpu.state import cluster_to_numpy as jax_to_numpy
from al26_tpu_torch.config import SimConfig
from al26_tpu_torch.ops import deposition as td
from al26_tpu_torch.ops import integrators as ti
from al26_tpu_torch.ops.nbody import virial_radius
from al26_tpu_torch.sim import init_cluster
from al26_tpu_torch.sim.init import build_aux
from al26_tpu_torch.sim.step import physics_after_advance
from al26_tpu_torch.state import (
    CH_GLOBAL, CH_LOCAL, CH_SNE, aux_from_numpy, cluster_to_numpy,
    state_from_numpy,
)

torch.set_num_threads(1)

J = jnp.asarray


def T(a, **kw):
    """numpy or Python value to a tensor; a Python float becomes f64 (as
    jnp.asarray makes it under x64), not torch's default f32."""
    if isinstance(a, float):
        return torch.tensor(a, dtype=torch.float64)
    return torch.as_tensor(a, **kw)


def _close(got, want, rtol=1e-12):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _cluster(n=96, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.5
    mass = rng.uniform(0.1, 2.0, n) * 0.1
    return pos, vel, mass


EPS2 = 0.01
DT = 0.05


def test_leapfrog_matches():
    pos, vel, mass = _cluster()
    pj, vj = ji.leapfrog_advance(J(pos), J(vel), J(mass), J(DT), n_sub=8,
                                 eps2=EPS2)
    pt, vt = ti.leapfrog_advance(T(pos), T(vel), T(mass), T(DT), n_sub=8,
                                 eps2=EPS2)
    _close(pt, pj)
    _close(vt, vj)


@pytest.mark.parametrize("cached", [False, True])
def test_hermite4_matches(cached):
    """The shared adaptive step (several substeps over DT); `cached` routes
    every substep through force_pot_fn and returns the closing eval."""
    from al26_tpu.ops.nbody import acc_jerk_pot_dense as jf
    from al26_tpu_torch.ops.nbody import acc_jerk_pot_dense as tf

    pos, vel, mass = _cluster(seed=1)
    kw_j = kw_t = {}
    if cached:
        kw_j = {"force_pot_fn": lambda p, v: jf(p, v, J(mass), EPS2)}
        kw_t = {"force_pot_fn": lambda p, v: tf(p, v, T(mass), EPS2)}
    oj = ji.hermite4_advance(J(pos), J(vel), J(mass), J(DT), eps2=EPS2,
                             **kw_j)
    ot = ti.hermite4_advance(T(pos), T(vel), T(mass), T(DT), eps2=EPS2,
                             **kw_t)
    _close(ot[0], oj[0])
    _close(ot[1], oj[1])
    if cached:
        for x, y in zip(ot[2], oj[2]):
            _close(x, y)


@pytest.mark.parametrize("k_ultra,samples", [(0, 0), (8, 0), (0, 2),
                                             (8, 2)])
def test_hermite4_block_matches(k_ultra, samples):
    """Two-tier and three-tier (k_ultra) block steps, with and without the
    gravity-stride interior samples; the fast group is selected smallest
    criterion first in both packages."""
    pos, vel, mass = _cluster(seed=2)
    oj = ji.hermite4_block_advance(J(pos), J(vel), J(mass), J(DT), 24,
                                   eps2=EPS2, k_ultra=k_ultra,
                                   interior_samples=samples)
    ot = ti.hermite4_block_advance(T(pos), T(vel), T(mass), T(DT), 24,
                                   eps2=EPS2, k_ultra=k_ultra,
                                   interior_samples=samples)
    _close(ot[0], oj[0])
    _close(ot[1], oj[1])
    if samples:
        _close(ot[2][0], oj[2][0])
        _close(ot[2][1], oj[2][1])


def test_block_predicted_columns_path_matches():
    """The predicted-columns subcycle (force_rows_at_factory + the
    override delta) through plain row sweeps, against the JAX package
    with the same dense factory."""
    from al26_tpu.ops.nbody import _row_block_acc_jerk_pot as jrow
    from al26_tpu_torch.ops.nbody import _row_block_acc_jerk_pot as trow

    pos, vel, mass = _cluster(seed=3)

    def factory(rowfn, tmass):
        def make(p0, v0, a0, j0):
            def rows_at(pr, vr, ids, tau):
                t2 = tau * tau
                pc = p0 + tau * v0 + 0.5 * t2 * a0 + (t2 * tau / 6.0) * j0
                vc = v0 + tau * a0 + 0.5 * t2 * j0
                a, j, _ = rowfn(pr, vr, pc, vc, tmass, EPS2, 1.0, ids,
                                with_pot=False)
                return a, j
            return rows_at
        return make

    # g = 1 inside the rows, G through the integrator: the same algebra
    # on both sides
    oj = ji.hermite4_block_advance(J(pos), J(vel), J(mass), J(DT), 16,
                                   eps2=EPS2, g=1.0,
                                   force_rows_at_factory=factory(jrow,
                                                                 J(mass)))
    ot = ti.hermite4_block_advance(T(pos), T(vel), T(mass), T(DT), 16,
                                   eps2=EPS2, g=1.0,
                                   force_rows_at_factory=factory(trow,
                                                                 T(mass)))
    _close(ot[0], oj[0])
    _close(ot[1], oj[1])


def _dep_inputs(n=80, h=6, seed=5):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 0.2
    vel = rng.normal(size=(n, 3))
    r_disk = rng.uniform(1e-4, 1e-3, n)
    lm = rng.uniform(size=n) < 0.7
    hm_idx = np.concatenate([rng.choice(n, h - 2, replace=False), [0, 0]])
    hm_idx = hm_idx.astype(np.int32)
    hm_valid = np.ones(h, bool)
    hm_valid[-2:] = False                     # padded slots repeat index 0
    mdot = rng.uniform(0.0, 1e-3, n)
    mdot[hm_idx[:2]] = 0.0                    # two collapses
    wind_ratio = rng.uniform(1e-6, 1e-4, (n, 2))
    sn_yield = rng.uniform(1e-5, 1e-4, (n, 2))
    kicked = np.zeros(n, bool)
    kicked[hm_idx[1]] = True                  # one already processed
    return dict(pos=pos, vel=vel, r_disk=r_disk, lm=lm, hm_idx=hm_idx,
                hm_valid=hm_valid, mdot=mdot, wind_ratio=wind_ratio,
                sn_yield=sn_yield, kicked=kicked)


def test_deposition_functions_match():
    d = _dep_inputs()
    for local, rb in ((False, 1.3), (True, 0.1)):
        args = ("pos", "vel", "r_disk", "lm", "hm_idx", "hm_valid", "mdot",
                "wind_ratio")
        wj = jd.wind_deposition(*(J(d[k]) for k in args), J(rb), J(0.01),
                                local=local)
        wt = td.wind_deposition(*(T(d[k]) for k in args),
                                T(rb), T(0.01), local=local)
        _close(wt, wj)
    args = ("pos", "r_disk", "lm", "hm_idx", "hm_valid", "mdot", "kicked",
            "sn_yield")
    ij, kj = jd.sn_injection(*(J(d[k]) for k in args))
    it, kt = td.sn_injection(*(T(d[k]) for k in args))
    _close(it, ij)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    _close(td.eta_disk_sne(T(d["r_disk"]), T(d["vel"][:, 0])),
           jd.eta_disk_sne(J(d["r_disk"]), J(d["vel"][:, 0])))


def test_interloper_decay_condense_match():
    rng = np.random.default_rng(8)
    n = 60
    p_old = rng.normal(size=(n, 3)) * 0.3
    p_new = p_old + rng.normal(size=(n, 3)) * 0.05
    p_new[5] = p_old[5]                       # no relative motion
    r_disk = rng.uniform(1e-4, 1e-3, n)
    lm = rng.uniform(size=n) < 0.8
    for exact in (True, False):
        oj = jd.interloper_deposition(J(p_old), J(p_new), J(r_disk), J(lm),
                                      -1, J(2e-6), J(3e-7), 0.1, J(0.1),
                                      J(0.01), exact_chord=exact)
        ot = td.interloper_deposition(
            T(p_old), T(p_new), T(r_disk), T(lm), -1, T(2e-6), T(3e-7),
            0.1, T(0.1), T(0.01), exact_chord=exact)
        _close(ot, oj)
    _close(td.chord_fraction(T(p_old), T(p_new), T(p_old[::-1].copy()),
                             T(p_new[::-1].copy()), 0.4),
           jd.chord_fraction(J(p_old), J(p_new), J(p_old[::-1]),
                             J(p_new[::-1]), 0.4))
    slr = rng.uniform(0, 1e-9, (n, 2, 4))
    slr_final = rng.uniform(0, 1e-9, (n, 2, 4))
    for agb in (False, True):
        _close(td.apply_decay(T(slr), 0.01, 0.717, 2.6, agb),
               jd.apply_decay(J(slr), J(0.01), 0.717, 2.6, agb))
        tau = rng.uniform(0, 2, n)
        alive = rng.uniform(size=n) < 0.9
        sj, aj = jd.condense(J(slr), J(slr_final), agb, J(tau), J(alive),
                             J(lm), J(1.0))
        st, at = td.condense(T(slr), T(slr_final), agb, T(tau), T(alive),
                             T(lm), T(1.0))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_physics_after_advance_matches_jax_step():
    """One composed post-advance step from the same bits in both packages,
    with the interloper, natal kicks and an SN inside the step."""
    from al26_tpu.models.stellar import evolution as jst

    kw = dict(n=64, rc=0.5, seed=21, dtype="f64", interloper=True,
              interloper_velocity=30.0, interloper_radius=0.05,
              natal_kicks=True)
    js, ja, jcfg = jax_init(JaxConfig(**kw))
    _, _, tcfg = init_cluster(SimConfig(**kw), device="cpu")
    m0 = np.asarray(js.cluster.m0)
    t_sn = float(np.min(np.asarray(jst.t_sn(J(m0[:-1])))))
    k0 = int(t_sn / jcfg.dt)                  # the SN falls in step k0+1
    js = dataclasses.replace(js, time=J(k0 * jcfg.dt),
                             step_count=J(k0, jnp.int32))
    # the interloper's AGB clock 2 Myr into its table, and its path
    # through a disc-bearing star's neighbourhood during the step
    jcfg = jcfg.replace(interloper_offset_time=k0 * jcfg.dt - 2.0)
    tcfg = tcfg.replace(interloper_offset_time=k0 * jcfg.dt - 2.0)
    rng = np.random.default_rng(0)
    pos_old = np.array(js.cluster.pos)
    pos = pos_old + rng.normal(size=pos_old.shape) * 0.01
    disc_star = int(np.flatnonzero(np.asarray(js.cluster.disk_alive))[0])
    pos_old[-1] = pos_old[disc_star] + [0.05, 0.02, 0.0]
    pos[-1] = pos[disc_star] + [-0.05, 0.02, 0.0]
    vel = np.asarray(js.cluster.vel) + rng.normal(size=pos_old.shape) * 0.1
    out_j = jax.jit(jax_physics, static_argnums=2)(
        js, ja, jcfg, J(pos_old), J(pos), J(vel), J(0.8))

    ts = state_from_numpy(jax_to_numpy(js.cluster), np.asarray(js.time),
                          np.asarray(js.step_count), dtype=torch.float64,
                          device="cpu")
    aux_np = {f: np.asarray(getattr(ja, f))
              for f in ("hm_idx", "hm_slot_valid", "msrc_idx", "msrc_valid",
                        "agb_grid_t", "agb_grid_rates", "kick_vel")}
    aux_np["stellar_tbl"] = [np.asarray(a) for a in ja.stellar_tbl]
    ta = aux_from_numpy(aux_np, device="cpu")
    out_t = physics_after_advance(ts, ta, tcfg, T(pos_old), T(pos), T(vel),
                                  T(0.8))
    a, b = jax_to_numpy(out_j.cluster), cluster_to_numpy(out_t.cluster)
    assert np.asarray(out_j.cluster.kicked).sum() > 0   # the SN fired
    assert a["agb_raw"].sum() > 0                       # the flyby deposited
    for k in a:
        if a[k].dtype == bool:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            _close(b[k], a[k])
    assert float(out_t.time) == float(out_j.time)
    assert int(out_t.step_count) == int(out_j.step_count)


N_REF = 32
STEPS_REF = 50
T0 = 7.2


@pytest.mark.parametrize("tracks", ["lc18", "seba"])
def test_physics_matches_reference_transcription(tracks):
    """test_step_transcription's window on the port: frozen positions, the
    reference's current-mass gate (sn_parity_mode), 50 steps from 7.2 Myr;
    every reservoir, flag and mass against the numpy transcription."""
    from al26_tpu_torch.models.stellar import evolution as st

    cfg = SimConfig(n=N_REF, rc=0.5, final_time=10.0, seed=11, dtype="f64",
                    no_massive_star_requirement=True, sn_parity_mode=True,
                    mass_tracks=tracks)
    state, _, cfg = init_cluster(cfg, device="cpu")
    m0 = state.cluster.m0.numpy().copy()
    m0[0], m0[1], m0[2], m0[3] = 60.0, 25.0, 20.0, 14.0
    k0 = int(round(T0 / cfg.dt))
    t0 = k0 * cfg.dt
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    mass0, mdot0 = (a.numpy() for a in st.evolve(f64(m0), f64(t0),
                                                 tracks=tracks))
    kicked0 = st.t_sn(f64(m0), tracks=tracks).numpy() < t0
    rng = np.random.default_rng(7)
    wind_ratio = np.zeros((N_REF, 2))
    sn_yield = np.zeros((N_REF, 2))
    hm = m0 >= 13.0
    wind_ratio[hm] = rng.uniform(1e-6, 1e-4, size=(hm.sum(), 2))
    sn_yield[hm] = rng.uniform(1e-5, 1e-4, size=(hm.sum(), 2))
    tau = state.cluster.tau_disk.numpy().copy()
    lm_idx = np.flatnonzero((mass0 >= cfg.low_mass_min)
                            & (mass0 <= cfg.low_mass_max))
    tau[lm_idx[:5]] = np.linspace(T0 + 0.05, T0 + 0.45, 5)
    tau[lm_idx[5:]] = 20.0
    c = state.cluster.replace(
        m0=f64(m0), mass=f64(mass0), mdot=f64(mdot0), kicked=T(kicked0),
        wind_ratio=f64(wind_ratio), sn_yield=f64(sn_yield), tau_disk=f64(tau))
    state = state.replace(cluster=c, time=f64(t0),
                          step_count=torch.tensor(k0, dtype=torch.int32))
    aux = build_aux(cfg, m0, torch.float64, device="cpu")

    sim = {"pos": c.pos.numpy().copy(), "vel": c.vel.numpy().copy(),
           "mass": mass0.copy(), "m0": m0.copy(),
           "r_disk": c.r_disk.numpy().copy(), "tau_disk": tau.copy(),
           "disk_alive": c.disk_alive.numpy().copy(),
           "kicked": kicked0.copy(),
           "wind_ratio_26al": wind_ratio[:, 0],
           "wind_ratio_60fe": wind_ratio[:, 1],
           "sn_yield_26al": sn_yield[:, 0], "sn_yield_60fe": sn_yield[:, 1],
           "evolve": lambda m, t: tuple(
               a.numpy() for a in st.evolve(f64(m), f64(t), tracks=tracks))}
    for iso in ("26al", "60fe"):
        for ch in ("local", "global", "sne"):
            sim[f"mass_{iso}_{ch}"] = np.zeros(N_REF)
            sim[f"mass_{iso}_{ch}_final"] = np.zeros(N_REF)
    rv_ref = [ref.reference_step(sim, t0 + (k + 1) * cfg.dt, cfg.dt)
              for k in range(STEPS_REF)]

    s, rv = state, []
    for _ in range(STEPS_REF):
        r = virial_radius(s.cluster.pos, s.cluster.mass)
        rv.append(float(r))
        s = physics_after_advance(s, aux, cfg, s.cluster.pos, s.cluster.pos,
                                  s.cluster.vel, r)
    np.testing.assert_allclose(rv, rv_ref, rtol=1e-12)
    oc = s.cluster
    slr, slr_final = oc.slr.numpy(), oc.slr_final.numpy()
    for iso, s_i in (("26al", 0), ("60fe", 1)):
        for ch, c_i in (("local", CH_LOCAL), ("global", CH_GLOBAL),
                        ("sne", CH_SNE)):
            np.testing.assert_allclose(slr[:, s_i, c_i],
                                       sim[f"mass_{iso}_{ch}"],
                                       rtol=1e-12, atol=1e-22)
            np.testing.assert_allclose(slr_final[:, s_i, c_i],
                                       sim[f"mass_{iso}_{ch}_final"],
                                       rtol=1e-12, atol=1e-22)
    np.testing.assert_array_equal(oc.kicked.numpy(), sim["kicked"])
    np.testing.assert_array_equal(oc.disk_alive.numpy(), sim["disk_alive"])
    np.testing.assert_allclose(oc.mass.numpy(), sim["mass"], rtol=1e-14)
    # the window exercised its branches: the 25 Msun SN is gated away on
    # lc18 (pre-SN mass below 13 Msun) and fires on seba
    assert sim["kicked"][0]
    assert sim["kicked"][1] == (tracks == "seba")
    assert (slr[:, 0, CH_SNE].sum() > 0.0) == (tracks == "seba")
