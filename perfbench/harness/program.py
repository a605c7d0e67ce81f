"""The program's own spans and counters in a traced stretch of a cell.

The program (al26_tpu_torch.utils.timing) records spans and counters at
each of its layers, and with its tracing on opens a profiler range
"al26::<span>" around each span. This module reads them:

  * `stretch(cell_spec, cell)` runs a cell's span stretch with the
    program's tracing on (no profiler; host times), then its profiled
    stretch (the profiler on every thread, the program's ranges in the
    trace), and returns the context the per-layer readers of the program's
    spans take: "program" ({"span": snapshot, "trace": snapshot} of the
    two stretches), "program_trace" (`read_program_trace`), "trace"
    (tracing.read_trace of the same file), "units_spanned" and
    "units_traced". perfbench/run.py's traced run (main.traced) runs it
    after the benchmark's own stretches;
  * `read_program_trace(path)` reduces the "al26::" ranges of a Chrome
    trace written by `profile_window`;
  * `main` (perfbench/trace_program.py) prints those readers' metrics for
    one cell, the device's idle time by program span, and the cost of the
    program's tracing on the cell's end-to-end metric.

A program without the recorder (an earlier checkout) runs the stretches
untraced, and its context holds no "program" key: the readers then read
nothing.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict

from . import spec, tracing

PREFIX = "al26::"
# the per-layer metrics read from the program's spans and counters
METRICS = ("substep_host_ms.n100k", "host_wait_ms_per_step.n100k",
           "launches_per_substep.n100k", "physics_launches_per_step.ensemble",
           "init_s_per_run.cli", "save_blocking_s_per_run.cli",
           "writer_idle_s_per_run.cli", "fused_substep_share.n100k")


def recorder():
    """The program's recorder module, or None where it has none."""
    from al26_tpu_torch.utils import timing

    return timing if hasattr(timing, "snapshot_and_reset") else None


def profile_window(work, trace_path: str) -> None:
    """tracing.profile_window with the ops and ranges of every thread (the
    checkpoint writer's too) where the installed torch records them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    timing = recorder()
    extra = timing.all_threads_config() if timing is not None else {}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, **extra) as prof:
        with record_function(tracing.WINDOW_SPAN):
            work()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged, t: float) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def _overlap(merged, gaps) -> float:
    """Length shared by two sorted lists of disjoint intervals."""
    tot, i = 0.0, 0
    for s, e in gaps:
        while i < len(merged) and merged[i][1] <= s:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < e:
            tot += min(e, merged[j][1]) - max(s, merged[j][0])
            j += 1
    return tot


def read_program_trace(path: str) -> dict:
    """Reduce the program's "al26::" ranges of a Chrome trace written by
    `profile_window` (or tracing.profile_window), inside its window:

      ranges          {span name: ranges}
      ops_in_span     {span name: device ops whose launch lies inside a
                      range of that name, at any depth, on the launching
                      thread}
      ops_by_span     {innermost span at the launch, or "none": ops}
      idle_by_span    {innermost span open on the main thread at each idle
                      gap's middle, or "none": idle seconds}
      python_idle_by_span  the same for the gaps tracing.read_trace charges
                      to "python" (no op open on the main thread)
      idle_in_other   {span name: idle seconds that overlap its ranges on
                      the other threads}
      idle_s          the device's idle seconds in the window
    Times in the trace are microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == tracing.WINDOW_SPAN]
    if not win:
        raise RuntimeError("the trace holds no perfbench::window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")
    dev = [e for e in xs if e.get("cat") in tracing.DEVICE_CATS]
    runtime = {e["args"]["correlation"]: e for e in xs
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    spans = defaultdict(list)           # tid -> [(start, end, name)]
    host = defaultdict(list)            # tid -> [(start, end, op)]
    for e in xs:
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in ("cpu_op", "cuda_runtime"):
            host[e.get("tid")].append((s, s + d, e["name"]))
        elif (e.get("cat") == "user_annotation"
              and e["name"].startswith(PREFIX) and w0 <= s <= w1):
            spans[e.get("tid")].append((s, s + d, e["name"][len(PREFIX):]))

    ranges = defaultdict(int)
    merged = {}                         # (tid, name) -> merged intervals
    for tid, ivs in spans.items():
        by_name = defaultdict(list)
        for s, e, n in ivs:
            ranges[n] += 1
            by_name[n].append((s, e))
        for n, v in by_name.items():
            merged[tid, n] = _merged(v)

    launch = defaultdict(list)          # tid -> launch times
    for e in dev:
        r = runtime.get(e.get("args", {}).get("correlation"))
        if r is not None and w0 <= float(r["ts"]) <= w1:
            launch[r.get("tid")].append(float(r["ts"]) + 1e-3)
    ops_in, ops_by = defaultdict(int), defaultdict(int)
    for tid, times in launch.items():
        for sp in tracing._innermost(spans[tid], times):
            ops_by[sp or "none"] += 1
        for (t2, n), m in merged.items():
            if t2 == tid:
                ops_in[n] += sum(_covered(m, t) for t in times)

    busy = tracing._union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in dev], w0, w1)
    gaps, edge = [], w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = e
    if w1 > edge:
        gaps.append((edge, w1))
    mids = [(s + e) / 2 for s, e in gaps]
    labels = tracing._innermost(spans[main_tid], mids)
    ops = tracing._innermost(host[main_tid], mids)
    idle_by, py_idle_by = defaultdict(float), defaultdict(float)
    for (s, e), sp, op in zip(gaps, labels, ops):
        idle_by[sp or "none"] += (e - s) * 1e-6
        if op is None:
            py_idle_by[sp or "none"] += (e - s) * 1e-6
    idle_in_other = defaultdict(float)
    for (tid, n), m in merged.items():
        if tid != main_tid:
            idle_in_other[n] += _overlap(m, gaps) * 1e-6
    return {"ranges": dict(ranges), "ops_in_span": dict(ops_in),
            "ops_by_span": dict(ops_by), "idle_by_span": dict(idle_by),
            "python_idle_by_span": dict(py_idle_by),
            "idle_in_other": dict(idle_in_other),
            "idle_s": sum(e - s for s, e in gaps) * 1e-6}


def stretch(cell_spec, cell) -> dict:
    """The span stretch and the profiled stretch of a set-up cell with the
    program's tracing on: the readers' context (module docstring). The
    caller begins the cell's window: main.traced runs these units after its
    own stretch, in the same window."""
    import torch

    timing = recorder()
    tr = cell_spec.traffic
    n_span = int(tr.get("span_units", 5))
    n_trace = int(tr.get("trace_units", 5))
    cuda = torch.cuda.is_available()
    ctx = {"units_spanned": n_span, "units_traced": n_trace}
    if timing is not None:
        timing.snapshot_and_reset()
        timing.enable()
    path = os.path.join(tempfile.gettempdir(),
                        f"perfbench-program-{cell_spec.name}.json")
    try:
        for _ in range(n_span):
            cell.unit()
        if cuda:
            torch.cuda.synchronize()
        snap_span = timing.snapshot_and_reset() if timing else None

        def work():
            for _ in range(n_trace):
                cell.unit()

        profile_window(work, path)
        snap_trace = timing.snapshot_and_reset() if timing else None
        ctx["trace"] = tracing.read_trace(path)
        if timing is not None:
            ctx["program"] = {"span": snap_span, "trace": snap_trace}
            ctx["program_trace"] = read_program_trace(path)
    finally:
        if timing is not None:
            timing.disable()
        tracing.remove_quietly(path)
    return ctx


def read_metrics(ctx: dict, cell_name: str) -> dict:
    """{name: value} of the METRICS readers that report in the cell and
    find something to read."""
    out = {}
    for name in METRICS:
        mod = spec.load_metric(name)
        if cell_name in mod.WORKLOADS:
            v = mod.read(ctx)
            if v is not None:
                out[name] = {"value": v, "unit": mod.UNIT}
    return out


def idle_summary(ctx: dict) -> dict:
    """The profiled stretch's device idle seconds: the share under a named
    program span, by span, and where tracing.read_trace's "python" gaps
    fall."""
    pt = ctx.get("program_trace")
    if not pt or pt["idle_s"] <= 0:
        return {}
    none = pt["idle_by_span"].get("none", 0.0)

    def top(d):
        return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])

    return {"idle_s": pt["idle_s"], "named_share": 1.0 - none / pt["idle_s"],
            "by_span": top(pt["idle_by_span"]),
            "python_by_span": top(pt["python_idle_by_span"]),
            "writer_overlap": top(pt["idle_in_other"])}


def on_cost(cell_spec, cell, seconds: float, turns: int) -> dict:
    """The cell's end-to-end metric (s_per_Myr, else run_s) over windows of
    `seconds` with the program's tracing off and on, in turns
    (off, on, on, off, ...)."""
    import shutil

    from .main import run_window

    timing = recorder()
    per_myr = "s_per_Myr" in {m["name"] for m in cell_spec.end_to_end}
    name = "s_per_Myr" if per_myr else "run_s"
    vals = {"off": [], "on": []}
    for k in range(turns):
        for side in (("off", "on") if k % 2 == 0 else ("on", "off")):
            if side == "on":
                timing.snapshot_and_reset()
                timing.enable()
            try:
                wall, myr, ends = run_window(cell, seconds)
            finally:
                timing.disable()
                timing.snapshot_and_reset()
            vals[side].append(wall / myr if per_myr else wall / len(ends))
            # a campaign cell's window numbers its run directories from 1
            # again: drop this window's (nothing compares them)
            for _, path in getattr(cell, "dirs", ()):
                shutil.rmtree(path, ignore_errors=True)
            if hasattr(cell, "dirs"):
                cell.dirs = []
    med = {k: statistics.median(v) for k, v in vals.items()}
    return {"metric": name, "off": vals["off"], "on": vals["on"],
            "median_ratio": med["on"] / med["off"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="a cell's stretches with the program's own tracing on")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cost-seconds", type=float, default=0.0,
                   help="also time windows of this length with the "
                        "program's tracing off and on, in turns")
    p.add_argument("--cost-turns", type=int, default=2)
    args = p.parse_args(argv)
    import torch

    from .main import card, log
    from .traffic import make_cell

    if not torch.cuda.is_available():
        log("no CUDA card: this measures the port on a card")
        return 2
    cell_spec = spec.load_cell(args.workload)
    cell = make_cell(cell_spec.config, cell_spec.traffic, args.seed, "cuda")
    t0 = time.perf_counter()
    try:
        cell.setup()
        torch.cuda.synchronize()
        log(f"set-up {time.perf_counter() - t0:.3f} s")
        cost = (on_cost(cell_spec, cell, args.cost_seconds, args.cost_turns)
                if args.cost_seconds > 0 and recorder() is not None else None)
        cell.begin_window()
        ctx = stretch(cell_spec, cell)
    finally:
        cell.close()
    tr, pt = ctx["trace"], ctx.get("program_trace") or {}
    prog = ctx.get("program") or {"span": {"spans": {}}, "trace": {}}
    out = {"workload": cell_spec.name, "seed": args.seed, "card": card(),
           "metrics": read_metrics(ctx, cell_spec.name),
           "idle": idle_summary(ctx), "on_cost": cost,
           "window_s": tr["window_s"], "busy_s": tr["busy_s"],
           "idle_gaps": tr["idle_gaps"], "ranges": pt.get("ranges"),
           "ops_by_span": pt.get("ops_by_span"),
           "counts": prog["trace"].get("counts"),
           "spans": {k: {"calls": v["calls"], "total_s": v["total_s"],
                         "self_s": v["self_s"]}
                     for k, v in prog["span"]["spans"].items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
