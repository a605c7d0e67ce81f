"""The port's span-and-counter recorder (al26_tpu_torch.utils.timing) on
the CPU: the no-op object with tracing off, nesting, parents and self time
with it on, spans and counters from several threads, the integrators'
substep and host-read counts against their loops, the run driver's spans,
and the operator's trace written through AL26_TORCH_TRACE_DIR."""
import glob
import json
import os
import sys
import threading
import time

import pytest
import torch

from al26_tpu_torch import SimConfig
from al26_tpu_torch.ops import integrators as ti
from al26_tpu_torch.sim import driver
from al26_tpu_torch.utils import timing

torch.set_num_threads(1)


@pytest.fixture
def rec():
    """The recorder emptied, tracing on; off and emptied again after."""
    timing.snapshot_and_reset()
    timing.enable()
    try:
        yield timing
    finally:
        timing.disable()
        timing.snapshot_and_reset()


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_span_off_is_one_shared_noop():
    timing.disable()
    timing.snapshot_and_reset()
    a, b = timing.span("x"), timing.span("y")
    assert a is b
    with a:
        with b:
            pass

    @timing.spanned("z")
    def f(v):
        return v + 1

    assert f(1) == 2
    assert timing.snapshot_and_reset()["spans"] == {}


def test_nesting_parents_and_self_time(rec):
    with rec.span("outer"):
        _busy(0.002)
        with rec.span("inner"):
            _busy(0.004)
        with rec.span("inner"):
            with rec.span("leaf"):
                _busy(0.002)
    snap = rec.snapshot_and_reset()["spans"]
    assert {k: v["calls"] for k, v in snap.items()} == {
        "outer": 1, "inner": 2, "leaf": 1}
    o, i, lf = snap["outer"], snap["inner"], snap["leaf"]
    assert set(o["children_s"]) == {"inner"}
    assert o["children_s"]["inner"] == pytest.approx(i["total_s"])
    assert o["self_s"] == pytest.approx(o["total_s"] - i["total_s"])
    assert i["self_s"] == pytest.approx(i["total_s"] - lf["total_s"])
    assert lf["self_s"] == lf["total_s"] >= 0.002
    assert i["total_s"] >= 0.006 and o["self_s"] >= 0.002
    assert rec.snapshot_and_reset() == {"spans": {}, "counts": {}}


def test_profiler_ranges_only_while_profiling(rec):
    """A span opens its "al26::" range only while a profiler runs."""
    from torch.profiler import ProfilerActivity, profile

    with rec.span("a") as sp:
        assert sp.range is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("b") as sp:
            assert sp.range is not None
    names = {e.key for e in prof.key_averages()}
    assert timing.PREFIX + "b" in names and timing.PREFIX + "a" not in names
    assert set(rec.snapshot_and_reset()["spans"]) == {"a", "b"}


def test_other_threads_parent_nothing_here(rec):
    """A span of another thread, opened while one of this thread is open,
    is no child of it: its parent is the innermost span of its own
    thread."""
    def work():
        with rec.span("job"):
            with rec.span("part"):
                _busy(0.002)

    with rec.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    snap = rec.snapshot_and_reset()["spans"]
    assert snap["main"]["children_s"] == {}
    assert snap["main"]["self_s"] == snap["main"]["total_s"]
    assert set(snap["job"]["children_s"]) == {"part"}


def test_threads_lose_no_span_or_count(rec):
    """More threads than cores, a short switch interval: every span and
    count lands."""
    n_threads, n_each = 2 * (os.cpu_count() or 1) + 2, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    timers = timing.PhaseTimers()

    def work():
        for _ in range(n_each):
            with rec.span("s"):
                rec.count("c")
            with timers.phase("p"):
                pass

    try:
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = rec.snapshot_and_reset()
    assert snap["counts"]["c"] == n_threads * n_each
    assert snap["spans"]["s"]["calls"] == n_threads * n_each
    assert snap["spans"]["driver.p"]["calls"] == n_threads * n_each
    assert timers.counts["p"] == n_threads * n_each


def test_phase_timers_totals_and_span():
    timers = timing.PhaseTimers()
    assert not hasattr(timers, "last")
    timing.disable()
    with timers.phase("physics"):
        _busy(0.001)
    assert timers.counts["physics"] == 1
    assert timers.totals["physics"] >= 0.001
    timing.snapshot_and_reset()
    timing.enable()
    try:
        with timers.phase("physics"):
            pass
    finally:
        timing.disable()
    snap = timing.snapshot_and_reset()["spans"]
    assert snap["driver.physics"]["calls"] == 1
    assert timers.counts["physics"] == 2
    assert "physics" in timers.report()


def _cluster(n=48, seed=3):
    g = torch.Generator().manual_seed(seed)
    pos = torch.randn(n, 3, generator=g, dtype=torch.float64)
    vel = 0.3 * torch.randn(n, 3, generator=g, dtype=torch.float64)
    mass = torch.rand(n, generator=g, dtype=torch.float64) + 0.5
    return pos, vel, mass


def _counted(fn, calls, key=lambda *a: 0):
    def wrapped(*a):
        k = key(*a)
        calls[k] = calls.get(k, 0) + 1
        return fn(*a)
    return wrapped


@pytest.mark.parametrize("case", ["hermite4", "block", "block3", "leapfrog"])
def test_integrator_counts_match_loops(rec, case):
    """integrator.substeps counts the loop iterations, host_reads.integrator
    the bool read-backs: each `while` test (iterations + 1) and, in the
    three-tier loop, the mid tier's flag once an iteration."""
    from al26_tpu_torch.ops.nbody import _row_block_acc_jerk_pot, acc_jerk_pot

    pos, vel, mass = _cluster()
    dt = torch.tensor(0.05, dtype=torch.float64)
    calls = {}
    if case == "hermite4":
        def force(p, v):
            a, j, _ = acc_jerk_pot(p, v, mass, 1e-4)
            return a, j
        ti.hermite4_advance(pos, vel, mass, dt, eta=0.05, eps2=1e-4,
                            force_fn=_counted(force, calls))
        iters = calls[0] - 1            # one opening evaluation
        reads = iters + 1
    elif case == "leapfrog":
        ti.leapfrog_advance(pos, vel, mass, dt, n_sub=5, eps2=1e-4)
        iters, reads = 5, 0
    else:
        k_ultra = 4 if case == "block3" else 0

        def rows(pr, vr, ids, p_all, v_all):
            a, j, _ = _row_block_acc_jerk_pot(pr, vr, p_all, v_all, mass,
                                              1e-4, 1.0, ids, with_pot=False)
            return a, j
        ti.hermite4_block_advance(
            pos, vel, mass, dt, 12, eta=0.05, eps2=1e-4, k_ultra=k_ultra,
            force_rows_fn=_counted(rows, calls,
                                   key=lambda pr, *a: pr.shape[0]))
        if k_ultra:
            iters = calls[k_ultra]          # the ultra rows: each iteration
            reads = 2 * iters + 1
        else:
            iters = calls[12]
            reads = iters + 1
    assert iters >= 3
    snap = rec.snapshot_and_reset()
    assert snap["counts"].get("integrator.substeps", 0) == iters
    assert snap["counts"].get("host_reads.integrator", 0) == reads
    assert snap["spans"]["integrator.substep"]["calls"] == iters
    if reads:
        assert snap["spans"]["integrator.host_read"]["calls"] == reads


def _run_tiny(tmp_path, async_saves=True):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        return driver.run(SimConfig(n=16, rc=1.0, final_time=0.04, n_plot=4,
                                    seed=3, dtype="f32", filename="tiny",
                                    async_saves=async_saves),
                          progress=False, device="cpu")
    finally:
        os.chdir(cwd)


def test_driver_spans(rec, tmp_path):
    res = _run_tiny(tmp_path)
    assert set(res.phase_seconds) == {"physics", "checkpoint", "writer"}
    snap = rec.snapshot_and_reset()
    sp, counts = snap["spans"], snap["counts"]
    assert sp["driver.init"]["calls"] == 1
    assert "driver.save.host_copy" in sp["driver.init"]["children_s"]
    saves = sp["driver.save.host_copy"]["calls"]
    assert saves == 6                   # save 0, 4 cadence saves, the final
    ck = sp["driver.checkpoint"]
    assert {"driver.save.host_copy", "io.writer.submit_wait",
            "io.writer.close_wait"} <= set(ck["children_s"])
    # the writer thread's jobs, none of them under a main-thread span
    assert sp["io.writer.job"]["calls"] == saves - 1
    assert set(sp["io.writer.job"]["children_s"]) == {"driver.writer"}
    assert all("io.writer.job" not in v["children_s"] for v in sp.values())
    steps = res.cfg.n_steps
    assert sp["step.advance"]["calls"] == sp["step.physics"]["calls"] == steps
    fields = len(res.state.cluster.__dataclass_fields__)
    assert counts["host_reads.driver.host_copy"] == saves * (fields + 1)
    # no synchronize on the CPU
    assert "driver.save.device_wait" not in sp


def test_trace_dir_writes_al26_ranges(tmp_path, monkeypatch):
    """AL26_TORCH_TRACE_DIR: the CLI starts and stops the trace (the
    driver inside it leaves it running), the Chrome trace holds the
    program's spans as al26:: ranges, and the snapshot file its counters.
    The run is cut to 4 steps and 3 saves."""
    from al26_tpu_torch import cli

    real_run = driver.run

    def short_run(cfg, device):
        return real_run(cfg.replace(n_plot=2, steps_per_plot=2),
                        progress=False, device=device)

    timing.disable()
    out = tmp_path / "trace"
    monkeypatch.setenv("AL26_TORCH_TRACE_DIR", str(out))
    monkeypatch.setattr(driver, "run", short_run)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-n", "16", "-rc", "1", "-t_f", "0.02", "-f", "tr",
                     "--device", "cpu"]) == 0
    assert not timing.enabled()
    (trace,) = glob.glob(str(out / "al26-trace-*.json"))
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    for want in ("cli.main", "driver.init", "driver.physics",
                 "driver.checkpoint", "step.advance", "integrator.substep",
                 "integrator.host_read", "step.physics", "step.winds",
                 "io.writer.job", "driver.save.host_copy"):
        assert timing.PREFIX + want in names
    (spans,) = glob.glob(str(out / "al26-spans-*.json"))
    snap = json.load(open(spans))
    assert snap["spans"]["cli.main"]["calls"] == 1
    assert "driver.init" in snap["spans"]["cli.main"]["children_s"]
    assert snap["counts"]["integrator.substeps"] >= 4
    assert timing.snapshot_and_reset()["spans"] == {}
