"""One run of one cell: set-up, the window or the traced stretch, the
comparison with the plain reference, the import guard and the result line.

The last line of standard output is one JSON object:

  correct    every compared number within its limit
  attempted  the units of work (steps, or campaign runs) the window or the
             traced stretch completed
  failed     1 when a compared number is over its limit, else 0
  metrics    {name: {"value", "unit"}}: the cell's end-to-end metrics with
             --trace 0, its per-layer metrics with --trace 1
  device     platform, kind, count, memory_peak_bytes (the peak of the
             window, read before the reference runs); with --trace 1 also
             busy_s and window_s of the profiled stretch
  breakdown  (--trace 1) the top device ops and idle gaps of that stretch
  compared   {number: {"value", "limit"}}, last in the line

The compared numbers are also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

from . import guard, spec
from ..reference import forcelaw
from .traffic import make_cell


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--steps-log", default=None,
                   help="write the window's per-unit host times and the "
                        "host's affinity, load and CPU clocks to this file")
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"# perfbench: {msg}", file=sys.stderr, flush=True)


def host_state() -> dict:
    """CPU affinity, load average and the mean CPU clock of this host."""
    out = {"affinity": sorted(os.sched_getaffinity(0))}
    try:
        with open("/proc/loadavg") as f:
            out["loadavg"] = f.read().split()[:3]
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        out["cpu_mhz_mean"] = sum(mhz) / len(mhz) if mhz else None
    except OSError:
        pass
    return out


def card() -> dict:
    """The card's name, power limit and maximum SM clock (nvidia-smi), and
    its SM count (torch)."""
    import torch

    out = {"name": torch.cuda.get_device_name(0),
           "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        lim, clk = q.stdout.strip().splitlines()[0].split(",")
        out["power_limit_w"] = float(lim)
        out["sm_clock_max_hz"] = float(clk) * 1e6
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        out["power_limit_w"] = None
        out["sm_clock_max_hz"] = None
    return out


def run_window(cell, seconds: float):
    """Units back to back until `seconds` have passed, from and to a
    synchronised device; returns (wall seconds, simulated Myr, per-unit
    host end times)."""
    import torch

    cuda = torch.cuda.is_available()
    cell.begin_window()
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ends = []
    myr = 0.0
    while True:
        myr += cell.unit()
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, myr, [e - t0 for e in ends]


def end_to_end(cell_spec, wall: float, myr: float, units: int,
               setup_s: float) -> dict:
    """The cell's end-to-end metrics from the window."""
    values = {"setup_s": setup_s,
              "s_per_Myr": wall / myr if myr > 0 else None,
              "run_s": wall / units if units else None}
    out = {}
    for m in cell_spec.end_to_end:
        v = values.get(m["name"])
        if v is None:
            raise RuntimeError(f"no value for end-to-end metric {m['name']}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def traced(cell_spec, cell) -> tuple[dict, dict, dict, int, list]:
    """The traced stretch: span units (spans closed by a synchronize),
    then profiled units with the pair counter; then, in the same window,
    the program's own span and profiled stretches (program.stretch: its
    spans and counters on, every thread profiled). The program's spans
    time what it does undisturbed by the benchmark's synchronizes, and its
    profiler ranges cost host time, so its stretches take units of their
    own after the benchmark's. Returns (per-layer metrics, device extras,
    breakdown, units, the comparison's samples: those of the benchmark's
    stretches, as drawn before the program's)."""
    import torch

    from . import program, tracing

    tr = cell_spec.traffic
    spans = tracing.Spans(keep_outputs=("driver.run",))
    cell.begin_window()

    def units(n):
        with contextlib.ExitStack() as stack:
            for target in cell.span_targets():
                stack.enter_context(spans.wrap(*target))
            for _ in range(n):
                cell.unit()

    n_span = int(tr.get("span_units", 5))
    n_trace = int(tr.get("trace_units", 5))
    spans.recording = True
    l0 = tracing.launches()
    t0 = time.perf_counter()
    units(n_span)
    span_s = time.perf_counter() - t0
    l1 = tracing.launches()
    spans.recording = False
    counter = tracing.PairCounter()
    path = os.path.join(tempfile.gettempdir(),
                        f"perfbench-trace-{cell_spec.name}.json")

    def profiled():
        with counter.installed():
            units(n_trace)

    tracing.profile_window(profiled, path)
    try:
        tr_out = tracing.read_trace(path)
    finally:
        tracing.remove_quietly(path)
    samples = cell.samples()
    prog = program.stretch(cell_spec, cell)
    info = card() if torch.cuda.is_available() else {
        "name": "cpu", "sms": 0, "power_limit_w": None,
        "sm_clock_max_hz": None}
    log(f"span stretch: {n_span} units in {span_s:.3f} s, spans "
        + ", ".join(f"{k} {sum(v):.3f} s" for k, v in spans.seconds.items()))
    ctx = {"units_spanned": n_span, "units_traced": n_trace,
           "spans": dict(spans.seconds), "outputs": dict(spans.outputs),
           "launches": {k: l1[k] - l0[k] for k in l0},
           "pair_calls": counter.calls, "trace": tr_out, "card": info,
           **{k: prog[k] for k in ("program", "program_trace") if k in prog}}
    metrics = {}
    for m in cell_spec.per_layer:
        v = spec.load_metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    log(f"card {info['name']}, power limit {info['power_limit_w']} W, "
        f"max SM clock {info['sm_clock_max_hz']} Hz, {info['sms']} SMs")
    extras = {"busy_s": tr_out["busy_s"], "window_s": tr_out["window_s"]}
    breakdown = {"device_ops": tr_out["device_ops"],
                 "idle_gaps": tr_out["idle_gaps"]}
    return metrics, extras, breakdown, 2 * (n_span + n_trace), samples


def run_cell(cell_spec, seed: int, seconds: float, trace: int, device,
             t_start: float, overrides=None, steps_log=None) -> dict:
    """Set-up, window (or traced stretch), comparison: the result dict.
    `overrides` replaces SimConfig fields (the CPU tests' small sizes)."""
    import torch

    from . import check

    cuda = torch.device(device).type == "cuda"
    # the reference's force law, in set-up: a configuration whose law has
    # no module fails here, before any window
    forcelaw.resolve(cell_spec.config["sim"])
    cell = make_cell(cell_spec.config, cell_spec.traffic, seed, device,
                     overrides)
    try:
        cell.setup()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s")
        extras, breakdown, samples = {}, None, None
        if trace:
            metrics, extras, breakdown, units, samples = traced(cell_spec,
                                                                cell)
        else:
            before = host_state() if steps_log else None
            wall, myr, ends = run_window(cell, seconds)
            units = len(ends)
            metrics = end_to_end(cell_spec, wall, myr, units, setup_s)
            log(f"window {wall:.3f} s, {units} units, {myr:.4f} Myr")
            if steps_log:
                with open(steps_log, "w") as f:
                    json.dump({"workload": cell_spec.name, "seed": seed,
                               "setup_s": setup_s, "wall_s": wall,
                               "myr": myr, "unit_ends_s": ends,
                               "host_before": before,
                               "host_after": host_state()}, f)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        compared, info, failed = check.compare(cell_spec, cell, device,
                                               samples=samples)
        for name, v in info.items():
            log(f"read, not compared: {name} {v!r}")
    finally:
        cell.close()
    correct = bool(compared) and all(c["value"] <= c["limit"]
                                     for c in compared.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), **extras}
    out = {"correct": correct, "attempted": units, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return out


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell_spec = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: this benchmark measures the port on a card")
        return 2
    if torch.cuda.device_count() < cell_spec.chips:
        log(f"{cell_spec.name} needs {cell_spec.chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    result = run_cell(cell_spec, args.seed, args.seconds, args.trace,
                      "cuda", t_start, steps_log=args.steps_log)
    bad = guard.forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
