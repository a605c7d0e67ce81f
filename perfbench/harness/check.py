"""The comparison that decides `correct`: what the timed path produced,
against the plain reference of perfbench/reference, at the timed sizes.

Stepping cells ("steps", "ensemble"): for each sampled step of the window
(harness/traffic.py: drawn from the seed, and the window's last), the
reference follows the program from the program's state at the step's start
(an N-body step in f32 cannot be reproduced from the initial state by any
other code), in f64, stage by stage:

  pos_gap, vel_gap  the advance: max over stars of |program - reference|
                    over the rms of the reference's change in the step;
  mass_gap          the stellar masses: max relative gap;
  mdot_gap          the wind rates: max gap over the largest rate;
  slr_gap           the SLR reservoirs after deposition, decay and
                    condensation, from the program's advanced positions and
                    velocities: for each isotope and channel, max gap over
                    the largest reservoir of that isotope and channel;
  slr_final_gap     the same of the discs' final snapshots;
  vel_rms_gap       the rms over stars of the velocity gap, over the same;
  flags_wrong       stars whose SN flag or disc-alive flag differ (count).

A threshold the reference finds within rounding of its input (a massive
star at the 0.1 pc bubble's edge, a disc dying at t + dt, a supernova at
t + dt: physics.after_advance's amb_* masks) leaves that outcome to the
program: the entries it decides are left out of the gaps and counted as
`ambiguous`. Only the numbers the cell's limits file names are compared;
the others are reported beside them.

Campaign runs ("cli"): for each sampled run (drawn from the seed among the
window's runs, and its last), read back from its files with readers of the
benchmark's own (reference/files.py):

  start_wrong       save 0 against the fields the reference derives from
                    the initial masses (disc masses, stable isotopes, disc
                    radius, wind rate at age 0, lifetime wind loss; zero
                    reservoirs; discs on the 0.1-3 Msun stars, no SN yet):
                    the values off by more than START_TOL of themselves
                    (start_gap: the largest relative gap);
  saves_wrong       saves missing of the 102, and saves whose time is off
                    the schedule (save j after step 10 (j - 1) + 1) by more
                    than TIME_TOL of a step (time_gap: the largest);
  pos_gap ... flags_wrong
                    from a sampled save to the next (10 steps), the
                    reference stepping the earlier save on in f64;
  yields_gap        the yields blob's last snapshot against the last
                    save's reservoirs (bytes read back: exact).

`control=True` puts the reference, computed in f32 with TF32 products (the
next precision below the configuration's f32 with TF32 off), in the
program's place: its numbers are the upper readings of the limits.

The reference and the control compute by the configuration's force law
(reference/forcelaw.py: the direct sum, or a module found by the
configuration's force_impl); run.py and control.py resolve it in set-up.
"""
from __future__ import annotations

import glob
import math
import os
from contextlib import contextmanager

import numpy as np
import torch

from ..reference import files, physics
from .traffic import seed_rng

NUMBERS_STEP = ("pos_gap", "vel_gap", "vel_rms_gap", "mass_gap",
                "mdot_gap", "slr_gap", "slr_final_gap", "flags_wrong",
                "ambiguous")
START_TOL = 1e-5
TIME_TOL = 1e-3
BIG = 1e30
FIELDS = ("pos", "vel", "mass", "m0", "mdot", "r_disk", "tau_disk", "slr",
          "slr_final", "wind_ratio", "sn_yield")
FLAGS = ("kicked", "disk_alive", "is_interloper")
AMB = ("amb_local", "amb_death", "amb_sn")


@contextmanager
def precision(control: bool):
    """f64 for the reference; f32 with TF32 products for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        yield torch.float32 if control else torch.float64
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _cluster(state, k, device, dtype=torch.float64):
    """Realization k (None: the only one) of a program state as a dict of
    tensors on `device`, and its step count."""
    c = state.cluster
    pick = (lambda t: t) if k is None else (lambda t: t[k])
    out = {f: pick(getattr(c, f)).to(device=device, dtype=dtype)
           for f in FIELDS}
    out.update({f: pick(getattr(c, f)).to(device) for f in FLAGS})
    return out, int(pick(state.step_count))


def _with_dtype(c: dict, dtype):
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in c.items()}


class Gaps:
    """Running maxima of the compared numbers over samples."""

    def __init__(self, names):
        self.v = {n: 0.0 for n in names}

    def put(self, name: str, value: float) -> None:
        if not math.isfinite(value):
            value = BIG
        self.v[name] = max(self.v[name], float(value))


def _rel_max(diff, scale) -> float:
    d = float(diff.abs().max()) if diff.numel() else 0.0
    s = float(scale)
    if s > 0:
        return d / s
    return 0.0 if d == 0 else BIG


def _channel_gap(got, ref, skip) -> float:
    """max over isotopes and channels of max |got - ref| over the largest
    |ref| of that isotope and channel, where `skip` [N, C] is False;
    [N, S, C] tensors."""
    diff = torch.where(skip[:, None, :], 0.0, got - ref)
    out = 0.0
    for s in range(ref.shape[1]):
        for ch in range(ref.shape[2]):
            out = max(out, _rel_max(diff[:, s, ch],
                                    ref[:, s, ch].abs().max()))
    return out


def _skips(ref: dict, n_ch: int):
    """[N, C] entries of slr and slr_final that a threshold decided within
    rounding (physics.after_advance's amb_* masks), and the flags to skip."""
    local, death, sn = ref["amb_local"], ref["amb_death"], ref["amb_sn"]
    skip = torch.zeros(local.shape[0], n_ch, dtype=torch.bool,
                       device=local.device)
    skip[:, physics.CH_LOCAL] |= local
    skip[:, physics.CH_SNE] |= sn
    return skip, skip | death[:, None], death, sn


def _compare_fields(g: Gaps, before, got: dict, ref: dict) -> None:
    """The numbers of one step or one save interval, over clusters:
    `before`, `got` and `ref` map field names to lists of tensors (ref also
    the amb_* masks of the reference's physics)."""
    cat = lambda d, k: torch.cat([t.reshape(-1, *t.shape[1:]) for t in d[k]])
    for f in ("pos", "vel"):
        moved = cat(ref, f) - cat(before, f)
        rms = torch.sqrt((moved * moved).sum(-1).mean())
        diff = torch.sqrt(((cat(got, f) - cat(ref, f)) ** 2).sum(-1))
        g.put(f + "_gap", _rel_max(diff, rms))
        if f == "vel":
            g.put("vel_rms_gap", float(torch.sqrt((diff * diff).mean())
                                       / rms) if rms > 0 else BIG)
    m_ref = cat(ref, "mass")
    g.put("mass_gap", float(((cat(got, "mass") - m_ref).abs()
                             / m_ref.clamp_min(1e-30)).max()))
    md_ref = cat(ref, "mdot")
    g.put("mdot_gap", _rel_max(cat(got, "mdot") - md_ref,
                               md_ref.abs().max()))
    n_ch = ref["slr"][0].shape[-1]
    parts = [_skips({k: ref[k][i] for k in ("amb_local", "amb_death",
                                             "amb_sn")}, n_ch)
             for i in range(len(ref["slr"]))]
    skip = torch.cat([p[0] for p in parts])
    skip_final = torch.cat([p[1] for p in parts])
    death = torch.cat([p[2] for p in parts])
    sn = torch.cat([p[3].expand(p[2].shape[0]) for p in parts])
    g.put("slr_gap", _channel_gap(cat(got, "slr"), cat(ref, "slr"), skip))
    g.put("slr_final_gap", _channel_gap(cat(got, "slr_final"),
                                        cat(ref, "slr_final"), skip_final))
    wrong = int(((cat(got, "kicked") != cat(ref, "kicked")) & ~sn).sum())
    wrong += int(((cat(got, "disk_alive") != cat(ref, "disk_alive"))
                  & ~death).sum())
    g.put("flags_wrong", wrong)
    g.put("ambiguous", int(skip.any(1).sum()) + int(death.sum()))


def _resolved(sim: dict, clusters: list, ensemble: bool) -> dict:
    n = clusters[0]["pos"].shape[0]
    m_total = float(np.mean([float(c["m0"].sum()) for c in clusters]))
    return physics.resolve(sim, n, m_total, ensemble)


def _stepper(cell_spec, cell, device, control: bool, samples):
    sim = cell_spec.config["sim"]
    ensemble = cell_spec.traffic["kind"] == "ensemble"
    g = Gaps(NUMBERS_STEP)
    for _, before, after in samples:
        b = before.cluster.mass.shape[0] if ensemble else None
        ks = range(b) if ensemble else [None]
        cb = [_cluster(before, k, device) for k in ks]
        ca = [_cluster(after, k, device) for k in ks]
        rp = _resolved(sim, [c for c, _ in cb], ensemble)
        bef, got, ref = ({f: [] for f in FIELDS + FLAGS + AMB}
                         for _ in range(3))
        for (c0, sc), (c1, _) in zip(cb, ca):
            r_vir = rp["law"].virial_radius(c0["pos"], c0["mass"])
            pos_r, vel_r = physics.advance(c0, rp)
            if control:
                with precision(True) as dt32:
                    c32 = _with_dtype(c0, dt32)
                    rv32 = rp["law"].virial_radius(c32["pos"], c32["mass"])
                    p32, v32 = physics.advance(c32, rp)
                    phys = physics.after_advance(c32, rp, sc, p32, v32,
                                                 rv32)
                c1 = {**{k: (v.double() if v.is_floating_point() else v)
                         for k, v in phys.items()},
                      "pos": p32.double(), "vel": v32.double()}
            phys_r = physics.after_advance(c0, rp, sc, c1["pos"], c1["vel"],
                                           r_vir)
            for f in FIELDS + FLAGS:
                if f in phys_r:
                    ref[f].append(phys_r[f])
                    got[f].append(c1[f])
                    bef[f].append(c0[f])
            for f in AMB:
                ref[f].append(phys_r[f])
            for f, v in (("pos", pos_r), ("vel", vel_r)):
                ref[f].append(v)
                got[f].append(c1[f])
                bef[f].append(c0[f])
        _compare_fields(g, bef, got, ref)
    return g, len(samples)


def _save_files(path: str) -> list:
    return sorted(glob.glob(os.path.join(path, "run-state-*.pkl.zst")))


def _save_cluster(cols: dict, device) -> dict:
    f = lambda k: torch.as_tensor(np.asarray(cols[k], np.float64),
                                  device=device)
    b = lambda k: torch.as_tensor(np.asarray(cols[k], bool), device=device)
    isos, chans = ("26al", "60fe"), ("local", "global", "sne", "agb")
    slr = lambda suffix: torch.stack([torch.stack(
        [f(f"mass_{i}_{c}{suffix}") for c in chans], -1) for i in isos], -2)
    return {"pos": torch.stack([f("x"), f("y"), f("z")], -1),
            "vel": torch.stack([f("vx"), f("vy"), f("vz")], -1),
            "mass": f("mass"), "m0": f("initial_mass"), "mdot": f("mdot"),
            "r_disk": f("r_disk"), "tau_disk": f("tau_disk"),
            "slr": slr(""), "slr_final": slr("_final"),
            "wind_ratio": torch.stack([f("wind_ratio_26al"),
                                       f("wind_ratio_60fe")], -1),
            "sn_yield": torch.stack([f("sn_yield_26al"),
                                     f("sn_yield_60fe")], -1),
            "kicked": b("kicked"), "disk_alive": b("disk_alive"),
            "is_interloper": b("is_interloper")}


def _save_time(meta) -> float:
    t = meta.time
    state = t.state if isinstance(t, files.Record) else t
    if isinstance(state, tuple):
        state = state[1]
    return float(state["value"] if isinstance(state, dict) else state)


def _save_step(j: int, sim: dict) -> int:
    """The step after which save j is written: 0 (the initial state), then
    after steps 1, 11, 21, ... (al26_nbody.py's cadence), and the last save
    at the final step."""
    spp, n_plot = sim["steps_per_plot"], sim["n_plot"]
    if j == 0:
        return 0
    return (j - 1) * spp + 1 if j <= n_plot else n_plot * spp


def _ref_steps(c: dict, rp: dict, step0: int, n: int, control: bool):
    """n whole reference steps from cluster c (f64, or the control)."""
    amb = None
    with precision(control) as dtype:
        c = _with_dtype(c, dtype)
        for k in range(n):
            pos, vel, phys = physics.step(c, rp, step0 + k)
            got = {f: phys.pop(f) for f in AMB}
            amb = got if amb is None else {f: amb[f] | got[f] for f in AMB}
            c = {**c, **phys, "pos": pos, "vel": vel}
    return {**_with_dtype(c, torch.float64), **(amb or {})}


def _start(cols0: dict, c0: dict, rp: dict, g: Gaps) -> None:
    """Save 0 against the fields the reference derives from the initial
    masses: start_wrong counts the values off by more than START_TOL of
    themselves (f32 storage of an f64 formula is ~6e-8 of it), nonzero
    reservoirs and wrong flags; start_gap is the largest relative gap.

    The program derives the fields from each star's drawn mass in f64 and
    stores that mass rounded to f32, so the mass behind a value lies within
    half an f32 ulp of the stored one. Where the reference's own value
    changes by more than START_TOL across one ulp either side (the wind
    rate just above 8 Msun, where it starts, moves ~1500 times faster
    than the mass), that change is the value's tolerance."""
    m0 = np.asarray(cols0["initial_mass"], np.float64)
    ulp = np.spacing(np.abs(m0).astype(np.float32)).astype(np.float64)
    want = physics.initial(m0, rp)
    side = [physics.initial(m0 + k * ulp, rp) for k in (-1, 1)]
    wrong, gap = 0, 0.0
    for f, v in want.items():
        d = np.abs(np.asarray(cols0[f], np.float64) - v)
        tol = np.maximum.reduce([START_TOL * np.abs(v)]
                                + [np.abs(o[f] - v) for o in side])
        wrong += int(np.sum(d > tol))
        gap = max(gap, float(np.max(d / np.maximum(np.abs(v), 1e-300))))
    wrong += int((c0["slr"] != 0).sum()) + int((c0["slr_final"] != 0).sum())
    lm = (c0["m0"] >= rp["lm"][0]) & (c0["m0"] <= rp["lm"][1])
    wrong += int((c0["disk_alive"] != lm).sum()) + int(c0["kicked"].sum())
    g.put("start_wrong", wrong)
    g.put("start_gap", gap)


def _cli(cell_spec, cell, device, control: bool, samples):
    sim = cell_spec.config["sim"]
    names = ("start_wrong", "start_gap", "saves_wrong", "time_gap") \
        + NUMBERS_STEP + ("yields_gap",)
    g = Gaps(names)
    expected = sim["n_plot"] + 2
    for seed, path in samples:
        saves = _save_files(path)
        wrong = max(expected - len(saves), 0)
        if len(saves) < 2:
            g.put("saves_wrong", wrong)
            continue
        cols0, _ = files.read_state(saves[0])
        c0 = _save_cluster(cols0, device)
        rp = physics.resolve(sim, c0["pos"].shape[0],
                             float(c0["m0"].sum()), False)
        _start(cols0, c0, rp, g)
        states = [files.read_state(f) for f in saves]
        for j, (_, meta) in enumerate(states):
            off = abs(_save_time(meta) - _save_step(j, sim) * rp["dt"]) \
                / rp["dt"]
            g.put("time_gap", off)
            wrong += int(off > TIME_TOL)
        g.put("saves_wrong", wrong)
        rng = seed_rng(seed, 2)
        picks = rng.choice(len(saves) - 1, min(cell.check_intervals,
                                               len(saves) - 1),
                           replace=False)
        for j in sorted(int(x) for x in picks):
            s0, s1 = _save_step(j, sim), _save_step(j + 1, sim)
            c_a = _save_cluster(states[j][0], device)
            c_b = _save_cluster(states[j + 1][0], device)
            ref = _ref_steps(c_a, rp, s0, s1 - s0, False)
            got = (_ref_steps(c_a, rp, s0, s1 - s0, True) if control
                   else c_b)
            _compare_fields(
                g, {f: [c_a[f]] for f in c_a}, {f: [got[f]] for f in got},
                {f: [ref[f]] for f in ref})
        cols_last = states[-1][0]
        with open(os.path.join(path, "run-yields.ubj.zst"), "rb") as fh:
            blob = files.ubjson_decode(files.zstd_decode(fh.read()))
        gap = 0.0
        for iso in ("26al", "60fe"):
            for ch in ("local", "global", "sne"):
                for suffix, series in (("", blob[f"{ch}_{iso}"][-1]),
                                       ("_final",
                                        blob[f"{ch}_{iso}_final"])):
                    v = np.asarray(cols_last[f"mass_{iso}_{ch}{suffix}"],
                                   np.float64)
                    gap = max(gap, _rel_max(
                        torch.as_tensor(np.asarray(series, np.float64) - v),
                        max(np.abs(v).max(), 1e-300)))
        g.put("yields_gap", gap)
    return g, len(samples)


def compare(cell_spec, cell, device, control: bool = False, samples=None):
    """(compared, info, failed): the numbers the cell's limits file names,
    each {"value", "limit"}; the other numbers, {name: value}, read but not
    compared; 1 if a compared number is over its limit, else 0. `samples`
    replaces the cell's samples() (a traced run's, drawn before the
    program's own stretches)."""
    kind = cell_spec.traffic["kind"]
    samples = cell.samples() if samples is None else samples
    with torch.no_grad():
        if kind == "cli":
            g, n = _cli(cell_spec, cell, device, control, samples)
        else:
            g, n = _stepper(cell_spec, cell, device, control, samples)
    if n == 0:
        return {}, {}, 0
    lim = cell_spec.limits
    out = {k: {"value": v, "limit": float(lim[k])}
           for k, v in g.v.items() if k in lim}
    info = {k: v for k, v in g.v.items() if k not in lim}
    failed = int(any(c["value"] > c["limit"] for c in out.values()))
    return out, info, failed
