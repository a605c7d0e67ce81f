"""The program's spans in a traced stretch (harness/program.py): the
reduction of its "al26::" ranges in a Chrome trace, the eight readers on
hand-built contexts and on a context that holds none of the program's
spans, each cell's tiny CPU stretch, and the benchmark's traced run
(main.run_cell with --trace 1) reading them."""
import json
import time

import pytest

from perfbench.harness import program, spec
from perfbench.tests import cells


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _trace(tmp_path, extra=()):
    ev = [
        _x("perfbench::window", "user_annotation", 0, 100),
        _x("al26::step.physics", "user_annotation", 5, 45),
        _x("al26::step.winds", "user_annotation", 20, 20),
        _x("al26::integrator.substep", "user_annotation", 60, 20),
        _x("al26::io.writer.job", "user_annotation", 40, 20, tid=2),
        _x("aten::mul", "cpu_op", 12, 6),
        _x("cudaLaunchKernel", "cuda_runtime", 14, 2, correlation=7),
        _x("aten::add", "cpu_op", 22, 4),
        _x("cudaLaunchKernel", "cuda_runtime", 23, 1, correlation=8),
        _x("cudaLaunchKernel", "cuda_runtime", 65, 1, correlation=9),
        _x("void k1(int)", "kernel", 20, 10, tid=7, correlation=7),
        _x("void k2(int)", "kernel", 30, 5, tid=7, correlation=8),
        _x("void k3(int)", "kernel", 70, 5, tid=7, correlation=9),
        *extra,
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_read_program_trace(tmp_path):
    r = program.read_program_trace(_trace(tmp_path))
    assert r["ranges"] == {"step.physics": 1, "step.winds": 1,
                           "integrator.substep": 1, "io.writer.job": 1}
    assert r["ops_in_span"] == {"step.physics": 2, "step.winds": 1,
                                "integrator.substep": 1}
    assert r["ops_by_span"] == {"step.physics": 1, "step.winds": 1,
                                "integrator.substep": 1}
    # idle gaps [0, 20], [35, 70], [75, 100]: the first under step.physics
    # at its middle, the other two under no span; no op open at any middle
    assert r["idle_s"] == pytest.approx(80e-6)
    assert r["idle_by_span"] == pytest.approx({"step.physics": 20e-6,
                                               "none": 60e-6})
    assert r["python_idle_by_span"] == pytest.approx(r["idle_by_span"])
    # the writer thread's job [40, 60] overlaps the gap [35, 70]
    assert r["idle_in_other"] == pytest.approx({"io.writer.job": 20e-6})


def test_read_program_trace_op_open_at_gap(tmp_path):
    """A gap whose middle lies in a host op is not a "python" gap."""
    r = program.read_program_trace(_trace(
        tmp_path, [_x("aten::sum", "cpu_op", 8, 4)]))
    assert r["idle_by_span"]["step.physics"] == pytest.approx(20e-6)
    assert "step.physics" not in r["python_idle_by_span"]


def test_read_program_trace_without_program_ranges(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _x("perfbench::window", "user_annotation", 0, 10)]}))
    r = program.read_program_trace(str(path))
    assert r["ranges"] == {} and r["ops_in_span"] == {}
    assert r["idle_by_span"] == pytest.approx({"none": 10e-6})


def _snap(spans, counts=None):
    full = {k: {"calls": c, "total_s": t, "self_s": t,
                "children_s": kids} for k, (c, t, kids) in spans.items()}
    return {"spans": full, "counts": counts or {}}


def _ctx(tmp_path):
    span = _snap({
        "integrator.substep": (40, 0.060, {"integrator.host_read": 0.004}),
        "integrator.host_read": (50, 0.020, {}),
        "driver.init": (2, 1.5, {"driver.save.host_copy": 0.01}),
        "driver.checkpoint": (204, 3.0, {"driver.save.device_wait": 1.0,
                                         "driver.save.host_copy": 0.5}),
    })
    span["counts"] = {"integrator.substeps": 40,
                      "integrator.fused_substeps": 30}
    trace = _snap({}, {"integrator.substeps": 2})
    return {"units_spanned": 2, "units_traced": 4,
            "program": {"span": span, "trace": trace},
            "program_trace": program.read_program_trace(_trace(tmp_path))}


@pytest.mark.parametrize("name,value", [
    ("substep_host_ms.n100k", 1e3 * 0.056 / 40),
    ("host_wait_ms_per_step.n100k", 1e3 * 0.020 / 2),
    ("launches_per_substep.n100k", 1 / 2),
    ("physics_launches_per_step.ensemble", 2 / 4),
    ("init_s_per_run.cli", 1.5 / 2),
    ("save_blocking_s_per_run.cli", 2.0 / 2),
    ("writer_idle_s_per_run.cli", 20e-6 / 4),
    ("fused_substep_share.n100k", 100.0 * 30 / 40),
])
def test_readers(tmp_path, name, value):
    mod = spec.load_metric(name)
    assert mod.read(_ctx(tmp_path)) == pytest.approx(value)
    # the current harness's context, or a program without the recorder
    assert mod.read({"units_spanned": 2, "units_traced": 4, "spans": {},
                     "outputs": {}, "launches": {}}) is None
    assert mod.read({"units_spanned": 2, "units_traced": 4,
                     "program": {"span": _snap({}), "trace": _snap({})},
                     "program_trace": {"ranges": {}, "ops_in_span": {},
                                       "idle_in_other": {}}}) is None


@pytest.mark.parametrize("name", program.METRICS)
def test_readers_agree_with_the_benchmark(name):
    """Each reader names a layer and an end-to-end metric its cells
    report, ready for its BENCHMARK.json entry or its parked cell's."""
    mod = spec.load_metric(name)
    e2e = {e["name"]: e for e in cells.bench()["end_to_end"]}
    assert mod.MOVES in e2e and mod.WORKLOADS
    for w in mod.WORKLOADS:
        assert w in e2e[mod.MOVES].get("workloads", [w])
        assert name.split(".")[-1] in w


SIZES = {
    "n1k-ensemble64": ({"n": 64}, {"realizations": 4, "warmup_steps": 2}),
    "n100k-block": ({"n": 256, "k_fast": 32}, {"warmup_steps": 2}),
    "n1k-cli": ({"n": 48}, {}),
}
SPAN_METRICS = {
    "n1k-ensemble64": {"physics_launches_per_step.ensemble"},
    "n100k-block": {"substep_host_ms.n100k", "host_wait_ms_per_step.n100k",
                    "launches_per_substep.n100k",
                    "fused_substep_share.n100k"},
    "n1k-cli": {"init_s_per_run.cli", "save_blocking_s_per_run.cli",
                "writer_idle_s_per_run.cli"},
}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_cell_stretch_on_cpu(name):
    """A tiny CPU stretch of each cell yields its readers' metrics; the
    device-trace ones read 0 launches here (no device ops), and the fused
    substep's share 0 (the CPU runs the torch loop)."""
    from perfbench.harness.traffic import make_cell

    ov, tov = SIZES[name]
    cs = cells.load(name)
    cs.traffic.update(tov)
    cell = make_cell(cs.config, cs.traffic, 2**31 + 99, "cpu", ov)
    try:
        cell.setup()
        ctx = program.stretch(cs, cell)
    finally:
        cell.close()
    got = program.read_metrics(ctx, name)
    assert set(got) == SPAN_METRICS[name]
    for k, v in got.items():
        assert v["value"] >= 0 and (v["value"] > 0 or "launches" in k
                                    or k == "fused_substep_share.n100k"), \
            (k, v)
    assert program.recorder().enabled() is False
    assert ctx["program_trace"]["ranges"]["step.physics"] > 0
    assert 0 <= program.idle_summary(ctx)["named_share"] <= 1


@pytest.mark.parametrize("name", sorted(SIZES))
def test_traced_run_reads_the_program(name, monkeypatch):
    """run_cell with --trace 1 on a tiny CPU cell: after the benchmark's own
    stretches, the program's span and profiled stretches run in the same
    window with its recorder on (off again after); every per-layer entry of
    the cell that reads the program reads a number; the comparison samples
    the benchmark's stretches alone, and the run is correct."""
    from perfbench.harness import check, main

    seen, compared = [], []
    real_stretch, real_compare = program.stretch, check.compare

    def stretch(*a, **k):
        seen.append(real_stretch(*a, **k))
        return seen[-1]

    def compare(cs, cell, *a, samples=None, **k):
        compared.append((cell.samples(), samples))
        return real_compare(cs, cell, *a, samples=samples, **k)

    monkeypatch.setattr(program, "stretch", stretch)
    monkeypatch.setattr(check, "compare", compare)
    ov, tov = SIZES[name]
    cs = cells.load(name)
    cs.traffic.update(tov)
    r = main.run_cell(cs, 2**31 + 5, 0.0, 1, "cpu", time.perf_counter(),
                      overrides=ov)
    (ctx,) = seen
    assert set(ctx["program"]) == {"span", "trace"}
    assert ctx["program"]["span"]["spans"] and ctx["program_trace"]["ranges"]
    assert program.recorder().enabled() is False
    n = int(cs.traffic["span_units"]) + int(cs.traffic["trace_units"])
    assert r["attempted"] == 2 * n
    [(everything, drawn)] = compared
    unit = (lambda x: int(x[1].rsplit("-", 1)[1])) if name == "n1k-cli" \
        else (lambda x: x[0])
    assert drawn and all(unit(x) <= n for x in drawn)
    assert max(map(unit, everything)) == 2 * n
    names = {m["name"] for m in cs.per_layer} & set(program.METRICS)
    assert names == SPAN_METRICS[name]
    for k in names:
        assert isinstance(r["metrics"][k]["value"], float), k
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("name", ["n100k-block", "n1k-cli"])
def test_on_cost_turns(name):
    """Windows with the program's tracing off and on, in turns, one after
    another on one set-up cell (the campaign cell's run directories
    included), then the stretch."""
    from perfbench.harness.traffic import make_cell

    ov, tov = SIZES[name]
    cs = cells.load(name)
    cs.traffic.update(tov)
    cell = make_cell(cs.config, cs.traffic, 7, "cpu", ov)
    try:
        cell.setup()
        t0 = time.perf_counter()
        cost = program.on_cost(cs, cell, 0.05, 2)
        assert program.recorder().enabled() is False
        ctx = program.stretch(cs, cell)
    finally:
        cell.close()
    assert cost["metric"] == ("run_s" if name == "n1k-cli" else "s_per_Myr")
    assert len(cost["off"]) == len(cost["on"]) == 2
    assert cost["median_ratio"] > 0 and time.perf_counter() - t0 < 300
    assert program.read_metrics(ctx, name)
