"""The port's single-device ensembles (al26_tpu_torch.parallel.ensemble)
and kernel 1's block-diagonal group windows against the JAX package.

Inputs come from numpy seeds (or the JAX package's own init_ensemble
output, carried over with state_from_numpy / aux_from_numpy) for both
packages. The JAX side runs as its own tests run it: Pallas in interpret
mode, chosen automatically off-TPU, and use_pallas monkeypatched to True
where tests/test_parallel.py patches it.

  * the group windows (plain version here) against
    pallas_acc_jerk_pot(_rows)(..., group_size=gs): tests/test_pallas.py's
    bars (rtol 2e-4 / atol 1e-7 for full sweeps, 2e-5 / 1e-8 for rows);
  * mass_delta_correction(group_size=n): 1e-12 in f64;
  * init_ensemble / stack_ensemble: exact (fields the stellar fits compute
    to a few ulp, as tests/test_torch_config_state.py);
  * ensemble_run_steps in f64 (vmapped and flat plain paths): 1e-12;
  * the flat kernel route (use_kernel patched: the wrappers run their
    plain group-masked versions) in f32: the bars of
    tests/test_parallel.py's flat-ensemble tests.

`test_group_window_matches_plain_on_card` holds the CUDA window against
its plain version on a card and skips where torch finds none:

    python -m pytest --noconftest tests/test_torch_ensemble.py -m gpu
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from al26_tpu_torch.config import SimConfig
from al26_tpu_torch.ops import cuda_nbody as cn
from al26_tpu_torch.ops.nbody import acc_jerk_pot_dense
from al26_tpu_torch.parallel import ensemble as ens
from al26_tpu_torch.state import (
    aux_from_numpy, cluster_to_numpy, state_from_numpy,
)

torch.set_num_threads(1)

T = torch.as_tensor
_AUX = ("hm_idx", "hm_slot_valid", "msrc_idx", "msrc_valid", "agb_grid_t",
        "agb_grid_rates", "kick_vel")
# fields that pass through the stellar fits (exp/log/pow): a few ulp apart
# between XLA's CPU compiler and torch (tests/test_torch_config_state.py)
_FIT_FIELDS = {"mdot"}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel, force and ensemble modules."""
    import jax.numpy as jnp

    from al26_tpu.config import SimConfig as JaxConfig
    from al26_tpu.ops import nbody, pallas_nbody
    from al26_tpu.parallel import ensemble
    from al26_tpu.state import cluster_to_numpy as to_numpy

    return SimpleNamespace(J=jnp.asarray, pk=pallas_nbody, nbody=nbody,
                           ens=ensemble, Config=JaxConfig, to_numpy=to_numpy)


def _system(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0.1, 2.0, n).astype(np.float32))


def _port_batch(jx, bs, ba, dtype):
    """The port's copy of a JAX batched (state, aux), same bits."""
    ts = state_from_numpy(jx.to_numpy(bs.cluster), np.asarray(bs.time),
                          np.asarray(bs.step_count), dtype=dtype,
                          device="cpu")
    aux_np = {f: np.asarray(getattr(ba, f)) for f in _AUX}
    aux_np["stellar_tbl"] = [np.asarray(a) for a in ba.stellar_tbl]
    return ts, aux_from_numpy(aux_np, device="cpu")


def _both_ensembles(jx, b, **kw):
    """JAX init_ensemble and the port's copy of its bits, with both
    packages' resolved configs."""
    bs, ba, jcfgs = jx.ens.init_ensemble(jx.Config(**kw), b)
    dtype = torch.float64 if jcfgs[0].dtype == "f64" else torch.float32
    ts, ta = _port_batch(jx, bs, ba, dtype)
    return (bs, ba, jcfgs[0]), (ts, ta, SimConfig.from_dict(
        jcfgs[0].to_dict()))


def _allclose(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# kernel 1's group windows (plain version on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"pot_eps2": 1e-30, "with_jerk": False}])
def test_group_window_matches_pallas(jx, kw):
    """gs = 700, B = 3: groups straddle the column tiles of both
    packages. Against the Pallas group window and against each group's
    own dense f64 sweep (test_pallas_group_window_matches_per_group_dense's
    bars)."""
    gs, b = 700, 3
    pos, vel, mass = _system(gs * b, seed=11)
    a1, j1, p1 = jx.pk.pallas_acc_jerk_pot(jx.J(pos), jx.J(vel), jx.J(mass),
                                           1e-3, group_size=gs, **kw)
    a2, j2, p2 = cn.kernel_acc_jerk_pot(T(pos), T(vel), T(mass), 1e-3,
                                        group_size=gs, **kw)
    for got, want in ((a2, a1), (j2, j1), (p2, p1)):
        _allclose(got, want, 2e-4, 1e-7)
    for k in range(b):
        sl = slice(k * gs, (k + 1) * gs)
        ad, jd, pd = cn.nbody_rows_plain(
            *(T(x[sl]).double() for x in (pos, vel)),
            torch.arange(gs, dtype=torch.int32),
            *(T(x[sl]).double() for x in (pos, vel, mass)), 1e-3, **kw)
        for got, want in ((a2[sl], ad), (j2[sl], jd), (p2[sl], pd)):
            _allclose(got, want, 2e-4, 1e-7)


def test_group_window_scattered_rows_match_pallas(jx):
    """A scattered row subset spanning all three groups (the window comes
    from the row ids), with a padding row (id -1, zeros in both packages):
    against the Pallas rows and against the port's own full sweep
    (test_pallas_group_window_scattered_rows's bars)."""
    gs, b = 600, 3
    pos, vel, mass = _system(gs * b, seed=13)
    ids = np.asarray([5, 1700, 599, 600, 1234, -1, 0, 1799], np.int32)
    rows = np.where(ids[:, None] >= 0, pos[np.maximum(ids, 0)], 0.5)
    vrows = np.where(ids[:, None] >= 0, vel[np.maximum(ids, 0)], 0.0)
    rows, vrows = rows.astype(np.float32), vrows.astype(np.float32)
    a1, j1, p1 = jx.pk.pallas_acc_jerk_pot_rows(
        jx.J(rows), jx.J(vrows), jx.J(ids), jx.J(pos), jx.J(vel),
        jx.J(mass), eps2=1e-3, group_size=gs)
    a2, j2, p2 = cn.kernel_acc_jerk_pot_rows(
        T(rows), T(vrows), T(ids), T(pos), T(vel), T(mass), 1e-3,
        group_size=gs)
    for got, want in ((a2, a1), (j2, j1), (p2, p1)):
        _allclose(got, want, 2e-5, 1e-8)
    assert not a2[5].any() and not j2[5].any() and p2[5] == 0
    af, jf, pf = cn.kernel_acc_jerk_pot(T(pos), T(vel), T(mass), 1e-3,
                                        group_size=gs)
    live = ids >= 0
    sel = T(ids[live]).long()
    for got, want in ((a2[live], af[sel]), (j2[live], jf[sel]),
                      (p2[live], pf[sel])):
        _allclose(got, want, 2e-5, 1e-8)


@pytest.mark.parametrize("with_jerk,pot_softened,block", [
    (True, False, None), (False, True, None), (True, False, 40),
])
def test_mass_delta_correction_group_matches_jax(jx, with_jerk,
                                                 pot_softened, block):
    """The flattened ensemble's cache correction: sources of three groups
    of 50, each target corrected only by its own group's sources, dense and
    row-blocked, f64."""
    rng = np.random.default_rng(21)
    b, n = 3, 50
    pos = rng.normal(size=(b * n, 3))
    vel = rng.normal(size=(b * n, 3))
    acc, jerk = rng.normal(size=(b * n, 3)), rng.normal(size=(b * n, 3))
    pot = rng.normal(size=b * n)
    src = np.asarray([3, 17, 60, 99, 120, 149, 0], np.int32)
    dm = rng.uniform(-0.5, 0.0, src.shape[0])
    dm[-1] = 0.0                              # a padding slot
    jerk_j = jx.J(jerk) if with_jerk else None
    out_j = jx.nbody.mass_delta_correction(
        jx.J(acc), jerk_j, jx.J(pot), jx.J(pos), jx.J(vel), jx.J(src),
        jx.J(dm), 0.125, group_size=n, pot_softened=pot_softened,
        block=block or 0)
    out_t = ens.mass_delta_correction(
        T(acc), T(jerk) if with_jerk else None, T(pot), T(pos), T(vel),
        T(src), T(dm), 0.125, group_size=n, pot_softened=pot_softened,
        block=block)
    assert (out_t[1] is None) == (not with_jerk)
    for got, want in zip(out_t, out_j):
        if want is not None:
            _allclose(got, want, 1e-12, 1e-12)
    # a target in group 0 is untouched by the sources of groups 1 and 2
    only0 = ens.mass_delta_correction(
        T(acc), None, T(pot), T(pos), T(vel), T(src[:2]), T(dm[:2]), 0.125,
        group_size=n)
    np.testing.assert_array_equal(only0[0][n:].numpy(), acc[n:])


# ---------------------------------------------------------------------------
# init_ensemble / stack_ensemble
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,want_integ", [
    ({}, "leapfrog"),                          # "auto" -> leapfrog
    ({"integrator": "leapfrog"}, "leapfrog"),  # n_sub unset -> shared
    ({"integrator": "leapfrog", "leapfrog_n_sub": 4}, "leapfrog"),
    ({"integrator": "hermite4"}, "hermite4"),  # explicit choice kept
])
def test_init_ensemble_matches_jax(jx, extra, want_integ):
    """The same realizations, padded slots and resolved configs as the JAX
    package's init_ensemble: one shared leapfrog substep count for "auto"
    and an unset n_sub, an explicit n_sub and an explicit integrator kept
    (tests/test_parallel.py's boundary tests)."""
    kw = dict(n=32, rc=1.0, final_time=10.0, seed=2, dtype="f32",
              no_massive_star_requirement=True, **extra)
    b = 3
    bs, ba, jcfgs = jx.ens.init_ensemble(jx.Config(**kw), b)
    ts, ta, tcfgs = ens.init_ensemble(SimConfig(**kw), b, device="cpu")
    assert [c.to_dict() for c in tcfgs] == [c.to_dict() for c in jcfgs]
    assert {c.integrator for c in tcfgs} == {want_integ}
    n_subs = {c.leapfrog_n_sub for c in tcfgs}
    assert len(n_subs) == 1 and n_subs.pop() >= 1
    if "leapfrog_n_sub" in extra:
        assert tcfgs[0].leapfrog_n_sub == 4
    a, t = jx.to_numpy(bs.cluster), cluster_to_numpy(ts.cluster)
    assert a.keys() == t.keys()
    for k in a:
        assert t[k].shape == a[k].shape and t[k].dtype == a[k].dtype, k
        if k in _FIT_FIELDS:
            np.testing.assert_allclose(t[k], a[k], rtol=4e-16, err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], a[k], err_msg=k)
    np.testing.assert_array_equal(ts.time.numpy(), np.asarray(bs.time))
    np.testing.assert_array_equal(ts.step_count.numpy(),
                                  np.asarray(bs.step_count))
    for f in _AUX:
        x, y = np.asarray(getattr(ba, f)), getattr(ta, f).numpy()
        assert y.shape == x.shape and y.dtype == x.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    for x, y in zip(ba.stellar_tbl, ta.stellar_tbl):
        assert y.shape == x.shape and y.numpy().dtype == np.asarray(x).dtype
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=4e-15)


def test_stack_ensemble_pads_slots():
    """Realizations with different massive-star counts: slots padded with
    index 0 and validity False, kicks with zeros, on the asked device; the
    stellar table stacked field by field."""
    from al26_tpu_torch.sim import init_cluster

    cfg = SimConfig(n=300, seed=4, dtype="f64")
    runs = [init_cluster(cfg.replace(seed=s), device="cpu")
            for s in (4, 5, 8)]       # 1, 2, 1 massive; 1, 2, 2 sources
    widths = [a.hm_idx.shape[0] for _, a, _ in runs]
    widths_m = [a.msrc_idx.shape[0] for _, a, _ in runs]
    assert len(set(widths)) > 1 or len(set(widths_m)) > 1
    bs, ba = ens.stack_ensemble([s for s, _, _ in runs],
                                [a for _, a, _ in runs], device="cpu")
    assert ba.hm_idx.shape == (3, max(widths))
    assert ba.msrc_idx.shape == (3, max(widths_m))
    assert bs.cluster.pos.shape == (3, 300, 3) and bs.time.shape == (3,)
    for k, (s, a, _) in enumerate(runs):
        w, wm = widths[k], widths_m[k]
        np.testing.assert_array_equal(ba.hm_idx[k, :w], a.hm_idx)
        assert not ba.hm_idx[k, w:].any() and not ba.hm_slot_valid[k, w:].any()
        assert not ba.kick_vel[k, w:].any()
        np.testing.assert_array_equal(ba.msrc_idx[k, :wm], a.msrc_idx)
        assert not ba.msrc_valid[k, wm:].any()
        for x, y in zip(ba.stellar_tbl, a.stellar_tbl):
            np.testing.assert_array_equal(x[k].numpy(), y.numpy())
        np.testing.assert_array_equal(bs.cluster.m0[k], s.cluster.m0)


# ---------------------------------------------------------------------------
# the steps: plain paths in f64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flat,extra", [
    (False, {"integrator": "leapfrog", "leapfrog_n_sub": 4}),
    (True, {"integrator": "leapfrog", "leapfrog_n_sub": 4}),
    (True, {"integrator": "hermite4_block", "k_fast": 8}),
])
def test_ensemble_run_steps_f64_matches_jax(jx, flat, extra):
    """5 steps of 4 realizations from the same bits: the per-realization
    step (flat=False) and the flattened advance on its plain path
    (per-realization dense forces, the group-masked dense fast rows)."""
    b = 4 if extra["integrator"] == "leapfrog" else 3
    (bs, ba, jcfg), (ts, ta, tcfg) = _both_ensembles(
        jx, b, n=32, rc=1.0, final_time=10.0, seed=100, dtype="f64",
        no_massive_star_requirement=True, **extra)
    out_j = jx.to_numpy(jx.ens.ensemble_run_steps(bs, ba, jcfg, 5,
                                                  flat=flat).cluster)
    before = dict(cn.LAUNCHES)
    out_t = ens.ensemble_run_steps(ts, ta, tcfg, 5, flat=flat)
    assert cn.LAUNCHES == before
    assert out_t.cluster.pos.shape == (b, 32, 3)
    np.testing.assert_array_equal(out_t.step_count.numpy(), 5)
    t_out = cluster_to_numpy(out_t.cluster)
    for k in ("pos", "vel", "mass", "slr", "slr_final"):
        _allclose(t_out[k], out_j[k], 1e-12,
                  1e-12 * float(np.abs(out_j[k]).max()))


# ---------------------------------------------------------------------------
# the flat kernel route, plain versions on the CPU, f32
# ---------------------------------------------------------------------------

@pytest.fixture
def kernel_route(jx, monkeypatch):
    """use_kernel / use_pallas forced on: the port's wrappers run their
    plain group-masked versions on CPU tensors, the JAX package its
    Pallas kernels in interpret mode."""
    monkeypatch.setattr(cn, "use_kernel", lambda n, dtype, device: True)
    monkeypatch.setattr(jx.pk, "use_pallas", lambda n, dtype: True)


@pytest.mark.parametrize("extra", [
    {"integrator": "leapfrog", "leapfrog_n_sub": 4},
    {"integrator": "hermite4_block", "k_fast": 8},
])
def test_flat_kernel_route_matches_jax(jx, kernel_route, extra):
    """The flat cached path through the group windows: the opening sweep,
    leapfrog substeps or hermite4_block's scattered fast rows, the closing
    sweep and the group-masked cache correction, 5 steps of 3
    realizations against the JAX package's flat path (bars of
    tests/test_parallel.py: positions the block integrator's rtol 1e-4 /
    atol 1e-7, reservoirs the flat-vs-vmapped rtol 1e-6); masses exact."""
    (bs, ba, jcfg), (ts, ta, tcfg) = _both_ensembles(
        jx, 3, n=32, rc=1.0, final_time=10.0, seed=300, dtype="f32",
        no_massive_star_requirement=True, **extra)
    assert ens.ensemble_cacheable(ts, tcfg)
    before = dict(cn.LAUNCHES)
    out_t = ens.ensemble_run_steps(ts, ta, tcfg, 5)
    assert cn.LAUNCHES == before                 # CPU tensors: plain
    js = jx.ens.ensemble_run_steps(bs, ba, jcfg, 5)
    out_j, t_out = jx.to_numpy(js.cluster), cluster_to_numpy(out_t.cluster)
    assert t_out["pos"].dtype == np.float32
    _allclose(t_out["pos"], out_j["pos"], 1e-4, 1e-7)
    _allclose(t_out["slr"], out_j["slr"], 1e-6, 1e-30)
    np.testing.assert_array_equal(t_out["mass"], out_j["mass"])
    np.testing.assert_array_equal(out_t.time.numpy(), np.asarray(js.time))


def test_flat_kernel_route_no_cross_talk(kernel_route):
    """Realization 1 of a flat run on the group windows equals a lone run
    of its seed on the single-cluster kernel path: the windows keep
    realizations from feeling each other (test_ensemble_flat_no_cross_talk's
    bars)."""
    from al26_tpu_torch.sim import init_cluster, run_steps

    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=200, dtype="f32",
                    integrator="leapfrog", leapfrog_n_sub=4,
                    no_massive_star_requirement=True)
    bs, ba, cfgs = ens.init_ensemble(cfg, 3, device="cpu")
    out = ens.ensemble_run_steps(bs, ba, cfgs[0], 5, flat=True)
    s1, a1, c1 = init_cluster(cfg.replace(seed=201), device="cpu")
    ref = run_steps(s1, a1, c1, 5, force_impl="pallas")
    _allclose(out.cluster.pos[1], ref.cluster.pos, 1e-8, 1e-10)
    _allclose(out.cluster.slr[1], ref.cluster.slr, 1e-6, 1e-30)


def test_flat_cache_threads_across_chunks(kernel_route):
    """ensemble_run_steps_cached over two chunks of 2 equals one chunk of
    4, bit for bit (the checkpoint-boundary threading)."""
    cfg = SimConfig(n=24, rc=1.0, final_time=1.0, seed=12, dtype="f32",
                    star_max_mass=3.0, no_massive_star_requirement=True)
    bs, ba, cfgs = ens.init_ensemble(cfg, 2, device="cpu")
    cfg = cfgs[0]
    cache = ens.ensemble_fresh_cache(bs, cfg)
    s1, cache = ens.ensemble_run_steps_cached(bs, cache, ba, cfg, 2)
    s1, cache = ens.ensemble_run_steps_cached(s1, cache, ba, cfg, 2)
    s2, _ = ens.ensemble_run_steps_cached(
        bs, ens.ensemble_fresh_cache(bs, cfg), ba, cfg, 4)
    for k in ("pos", "vel", "slr", "mass"):
        np.testing.assert_array_equal(getattr(s1.cluster, k).numpy(),
                                      getattr(s2.cluster, k).numpy())


def test_cache_gate(monkeypatch):
    """force_cache=False turns the flat cache off, as sim.step._cacheable
    does; off the kernel path there is no cache either."""
    cfg = SimConfig(n=24, rc=1.0, final_time=1.0, seed=5, dtype="f32",
                    integrator="leapfrog", leapfrog_n_sub=2,
                    no_massive_star_requirement=True)
    bs, _, cfgs = ens.init_ensemble(cfg, 2, device="cpu")
    assert not ens.ensemble_cacheable(bs, cfgs[0])      # CPU: plain path
    monkeypatch.setattr(cn, "use_kernel", lambda n, dtype, device: True)
    assert ens.ensemble_cacheable(bs, cfgs[0])
    assert not ens.ensemble_cacheable(bs, cfgs[0].replace(force_cache=False))
    assert not ens.ensemble_cacheable(bs, cfgs[0].replace(
        integrator="hermite4"))
    assert not ens.ensemble_cacheable(bs, cfgs[0].replace(
        integrator="hermite4_block", k_fast=8, natal_kicks=True))


@pytest.mark.parametrize("name", [
    "make_ensemble_mesh", "make_ensemble2d_mesh", "shard_ensemble",
    "shard_ensemble_2d", "ensemble2d_acc_pot", "ensemble_step_2d",
    "ensemble2d_fresh_cache", "ensemble_run_steps_2d_cached",
    "ensemble_run_steps_2d",
])
def test_mesh_entry_points_raise(name):
    """The mesh entry points are ported (tests/test_torch_parallel.py
    holds them against the JAX meshes in gloo worlds of 2 and 4). Here
    each runs in a world of one on the CPU, next to the one-device path
    it must equal: 2 leapfrog realizations of 24 stars, f64."""
    cfg = SimConfig(n=24, rc=1.0, final_time=1.0, seed=4,
                    no_massive_star_requirement=True)
    bs, ba, cfgs = ens.init_ensemble(cfg, 2, device="cpu")
    cfg = cfgs[0]
    m1 = ens.make_ensemble_mesh(device="cpu")
    m2 = ens.make_ensemble2d_mesh(1, 1, device="cpu")
    c = bs.cluster
    if name == "make_ensemble_mesh":
        assert m1.mesh_dim_names == ("ens",) and m1.size() == 1
    elif name == "make_ensemble2d_mesh":
        assert m2.mesh_dim_names == ("ens", "rows") and m2.size() == 1
    elif name in ("shard_ensemble", "shard_ensemble_2d"):
        s, a = getattr(ens, name)(bs, ba, m1 if name == "shard_ensemble"
                                  else m2)
        assert torch.equal(s.cluster.pos, c.pos)
        assert torch.equal(a.hm_idx, ba.hm_idx)
    elif name in ("ensemble2d_acc_pot", "ensemble2d_fresh_cache"):
        acc, pot = (ens.ensemble2d_acc_pot(c.pos, c.vel, c.mass, m2,
                                           cfg.eps2, pot_eps2=1e-30)
                    if name == "ensemble2d_acc_pot"
                    else ens.ensemble2d_fresh_cache(bs, cfg, m2))
        for k in range(2):
            a, _, _ = acc_jerk_pot_dense(c.pos[k], c.vel[k], c.mass[k],
                                         cfg.eps2)
            np.testing.assert_allclose(acc[k].numpy(), a.numpy(),
                                       rtol=1e-12, atol=1e-12)
            assert acc.shape == (2, 24, 3) and pot.shape == (2, 24)
    else:
        want = ens.ensemble_run_steps(bs, ba, cfg, 2)
        if name == "ensemble_step_2d":
            got = ens.ensemble_step_2d(ens.ensemble_step_2d(bs, ba, cfg, m2),
                                       ba, cfg, m2)
        elif name == "ensemble_run_steps_2d":
            got = ens.ensemble_run_steps_2d(bs, ba, cfg, 2, m2)
        else:
            cache = ens.ensemble2d_fresh_cache(bs, cfg, m2)
            got, _ = ens.ensemble_run_steps_2d_cached(bs, cache, ba, cfg, 2,
                                                      m2)
        np.testing.assert_allclose(got.cluster.pos.numpy(),
                                   want.cluster.pos.numpy(), rtol=1e-12,
                                   atol=1e-12)
        assert torch.equal(got.step_count, want.step_count)


def test_port_imports_no_jax():
    """No module of the port and not chip_smoke.py imports jax or the JAX
    package."""
    import os
    import re

    import al26_tpu_torch

    root = os.path.dirname(os.path.dirname(al26_tpu_torch.__file__))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.dirname(al26_tpu_torch.__file__)):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    bad = re.compile(r"^\s*(import|from)\s+(jax|al26_tpu)(\.|\s|$)", re.M)
    offenders = [f for f in files if bad.search(open(f).read())]
    assert len(files) > 20 and offenders == []


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_group_window_matches_plain_on_card():
    """The CUDA group window against its f64 plain version: full sweeps of
    contiguous groups (gs not a multiple of the 256-column tile, groups
    smaller and larger than a 128-row block), every (jerk, potential)
    mode, and scattered rows spanning several groups with padding rows;
    the same bits on a repeat, launches counted under nbody_rows_group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for gs, b in ((700, 3), (100, 9), (1000, 4), (5, 7)):
        n = gs * b
        pos, vel, mass = (T(a, device=dev) for a in _system(n, seed=gs))
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        before = dict(cn.LAUNCHES)
        for kw in ({}, {"pot_eps2": 1e-30}, {"with_jerk": False},
                   {"with_pot": False}):
            got = cn.nbody_rows(pos, vel, ids, pos, vel, mass, 1e-3,
                                group_size=gs, **kw)
            ref = cn.nbody_rows_plain(pos.double(), vel.double(), ids,
                                      pos.double(), vel.double(),
                                      mass.double(), 1e-3, group_size=gs,
                                      **kw)
            for g_, r_ in zip(got, ref):
                if r_.abs().max() > 0:
                    assert float((g_.double() - r_).abs().max()
                                 / r_.abs().max()) < 1e-5
                else:
                    assert not g_.any()
        assert cn.LAUNCHES["nbody_rows_group"] == (
            before["nbody_rows_group"] + 4)
        assert cn.LAUNCHES["nbody_rows"] == before["nbody_rows"]
        again = cn.nbody_rows(pos, vel, ids, pos, vel, mass, 1e-3,
                              group_size=gs)
        first = cn.nbody_rows(pos, vel, ids, pos, vel, mass, 1e-3,
                              group_size=gs)
        assert all(torch.equal(x, y) for x, y in zip(again, first))
        sel = np.random.default_rng(gs).choice(n, min(n, 300),
                                               replace=False)
        sel = np.concatenate([sel, [-1, -1]]).astype(np.int32)
        sid = T(sel, device=dev)
        safe = sid.clamp(min=0).long()
        rp, rv = pos[safe].contiguous(), vel[safe].contiguous()
        got = cn.nbody_rows(rp, rv, sid, pos, vel, mass, 1e-3,
                            group_size=gs)
        ref = cn.nbody_rows_plain(rp.double(), rv.double(), sid,
                                  pos.double(), vel.double(), mass.double(),
                                  1e-3, group_size=gs)
        for g_, r_ in zip(got, ref):
            assert float((g_.double() - r_).abs().max()
                         / r_.abs().max()) < 2e-5
            assert not g_[-2:].any()
    torch.cuda.synchronize()
