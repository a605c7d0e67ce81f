"""Spans, counters and the device trace of a traced run (``--trace 1``).

Nothing here runs in a ``--trace 0`` window. The spans and counters wrap
calls into the program from the benchmark's side (the program's own spans
and counters are read by harness/program.py):

  * `Spans.wrap(module, attr, name)` replaces a function of the program by
    one that records its host wall time under `name` (with a
    `torch.cuda.synchronize()` before and after) while the spans are
    recording, and opens a profiler range "perfbench::<name>" so device
    ops launched inside carry the span's name;
  * `PairCounter` records every gravity kernel-wrapper call (ops.cuda_nbody,
    and the near field of ops.cuda_tree) with the pairs the roofline
    counts, its jerk and its bytes;
  * `profile_window` runs a stretch of work under torch.profiler and
    `read_trace` reduces its Chrome trace: device busy seconds in the
    window, device time by readable op name, and the idle gaps by what the
    host was doing.
"""
from __future__ import annotations

import functools
import inspect
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager

SPAN_PREFIX = "perfbench::"
WINDOW_SPAN = SPAN_PREFIX + "window"


class Spans:
    """Host wall seconds of wrapped program calls, by span name, recorded
    while `recording` (each call then synchronised at both ends); the
    profiler range opens either way."""

    def __init__(self, keep_outputs=()):
        self.seconds = defaultdict(list)
        self.outputs = defaultdict(list)
        self.keep = set(keep_outputs)
        self.recording = False

    @contextmanager
    def wrap(self, owner, attr: str, name: str):
        import torch

        fn = getattr(owner, attr)
        cuda = torch.cuda.is_available()

        @functools.wraps(fn)
        def spanned(*a, **k):
            rec = self.recording
            if rec and cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN_PREFIX + name):
                out = fn(*a, **k)
            if rec:
                if cuda:
                    torch.cuda.synchronize()
                self.seconds[name].append(time.perf_counter() - t0)
                if name in self.keep:
                    self.outputs[name].append(out)
            return out

        setattr(owner, attr, spanned)
        try:
            yield
        finally:
            setattr(owner, attr, fn)


class PairCounter:
    """Calls of the gravity kernel wrappers, each as (pairs, with_jerk,
    bytes): kernel 1 and 1b (`nbody_rows`: rows x the group size, or x N),
    kernel 2 (`nbody_predcols`, `PredcolsMma.__call__`: rows x N), and the
    tree's near field (ops.cuda_tree: the work items that `near_items`
    builds for the kernel path and the plain path alike, counted by
    roofline.near_interactions, with the jerk flag of the near-field call
    that asked for them). The near field's items are counted when `calls`
    is read, so the traced stretch holds no read-back of its own."""

    def __init__(self):
        self._calls = []        # tuples, and near-field calls to count

    @property
    def calls(self) -> list:
        self._calls = [c if isinstance(c, tuple) else c()
                       for c in self._calls]
        return self._calls

    @contextmanager
    def installed(self):
        from al26_tpu_torch.ops import cuda_nbody as cn
        from al26_tpu_torch.ops import cuda_tree as ct

        from .roofline import (near_bytes, near_interactions,
                               predcols_bytes, rows_bytes)

        rows_sig = inspect.signature(cn.nbody_rows)
        rows_fn, pred_fn = cn.nbody_rows, cn.nbody_predcols
        call_fn = cn.PredcolsMma.__call__
        items_fn = ct.near_items
        near_fns = (ct.near_field_plain, ct.near_field_launcher)
        jerk = []               # the near-field calls under way

        def rows(*a, **k):
            b = rows_sig.bind(*a, **k)
            b.apply_defaults()
            v = b.arguments
            nrow, ncol = v["pos_rows"].shape[0], v["pos"].shape[0]
            gs = max(int(v["group_size"]), 0)
            self._calls.append((nrow * (gs if gs else ncol),
                                bool(v["with_jerk"]),
                                rows_bytes(nrow, ncol, bool(v["with_jerk"]),
                                           bool(v["with_pot"]))))
            return rows_fn(*a, **k)

        def pred(pos_rows, vel_rows, row_ids, pos0, *a, **k):
            nrow, ncol = pos_rows.shape[0], pos0.shape[0]
            self._calls.append((nrow * ncol, True,
                                predcols_bytes(nrow, ncol)))
            return pred_fn(pos_rows, vel_rows, row_ids, pos0, *a, **k)

        def call(plan, pos_rows, *a, **k):
            nrow = pos_rows.shape[0]
            self._calls.append((nrow * plan.n, True,
                                predcols_bytes(nrow, plan.n)))
            return call_fn(plan, pos_rows, *a, **k)

        def items(p2p, kavg, n_true, leaf, *a, **k):
            it = items_fn(p2p, kavg, n_true, leaf, *a, **k)
            if jerk:
                n, lf, j = int(n_true), int(leaf), jerk[-1]

                def counted():
                    inter, listed = near_interactions(it.item, it.src, n, lf)
                    return inter, j, near_bytes(n, j, listed)

                self._calls.append(counted)
            return it

        def near(fn):
            @functools.wraps(fn)
            def call_near(*a, with_jerk=False, **k):
                jerk.append(bool(with_jerk))
                try:
                    return fn(*a, with_jerk=with_jerk, **k)
                finally:
                    jerk.pop()
            return call_near

        cn.nbody_rows, cn.nbody_predcols = rows, pred
        cn.PredcolsMma.__call__ = call
        ct.near_items = items
        ct.near_field_plain, ct.near_field_launcher = map(near, near_fns)
        try:
            yield self
        finally:
            cn.nbody_rows, cn.nbody_predcols = rows_fn, pred_fn
            cn.PredcolsMma.__call__ = call_fn
            ct.near_items = items_fn
            ct.near_field_plain, ct.near_field_launcher = near_fns


def profile_window(work, trace_path: str) -> None:
    """Run `work()` under torch.profiler (CPU and CUDA activity) inside a
    "perfbench::window" range, synchronise, write the Chrome trace to
    `trace_path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            work()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)


def kernel_function(name: str) -> str:
    """A device op's readable name: the kernel's function name without its
    return type, namespaces, template arguments and parameters
    ("void at::native::vectorized_elementwise_kernel<4, ...>(...)" ->
    "vectorized_elementwise_kernel"; "void (anonymous namespace)::
    pair_sweep_mma<true, 2, false>(MmaArgs)" -> "pair_sweep_mma"; a bare
    "kernel" keeps its namespace: "gemvx::kernel"). Names that are not
    C++ signatures (memcpy, memset) stay as they are."""
    s = name.replace("(anonymous namespace)::", "")
    depth, start, head = 0, 0, ""
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == " " and depth == 0:
            start = i + 1
        elif ch == "(" and depth == 0:
            head = s[start:i]
            break
    cut = head.find("<")
    parts = (head if cut < 0 else head[:cut]).split("::")
    if not parts[-1] or not parts[-1].replace("_", "a").isalnum():
        return name.strip()
    return "::".join(parts[-2:]) if parts[-1] == "kernel" else parts[-1]


def _innermost(intervals, times):
    """For each time, the label of the innermost interval that holds it
    (intervals (start, end, label), properly nested), else None."""
    ivs = sorted(intervals, key=lambda x: (x[0], -x[1]))
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [None] * len(times)
    stack, i = [], 0
    for q in order:
        t = times[q]
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] < ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def _union(intervals, lo: float, hi: float):
    """Merged busy intervals clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(path: str, top: int = 10) -> dict:
    """Reduce a Chrome trace of `profile_window`:

      window_s      the "perfbench::window" range's length
      busy_s        seconds in it with a device op running (any stream)
      kernel_s      {kernel function name: device seconds}
      device_ops    the `top` device ops by device seconds, each named
                    "<span>/<launching op>/<kernel function>" (parts that
                    do not exist left out)
      idle_gaps     the `top` host activities by idle device seconds: each
                    gap between device ops is charged to the innermost host
                    op open at its middle on the launching thread, or
                    "python" where none is
    Times in the trace are microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW_SPAN]
    if not win:
        raise RuntimeError("the trace holds no perfbench::window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    runtime = {e["args"]["correlation"]: e for e in xs
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    by_tid = defaultdict(list)
    spans_by_tid = defaultdict(list)
    for e in xs:
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in ("cpu_op", "cuda_runtime"):
            by_tid[e.get("tid")].append((s, s + d, e["name"]))
        elif (e.get("cat") == "user_annotation"
              and e["name"].startswith(SPAN_PREFIX)
              and e["name"] != WINDOW_SPAN):
            spans_by_tid[e.get("tid")].append(
                (s, s + d, e["name"][len(SPAN_PREFIX):]))

    # name each device op by its span and launching op
    launch = defaultdict(list)      # tid -> [(time, index into dev)]
    for i, e in enumerate(dev):
        r = runtime.get(e.get("args", {}).get("correlation"))
        if r is not None:
            launch[r.get("tid")].append((float(r["ts"]) + 1e-3, i))
    op_of, span_of = [None] * len(dev), [None] * len(dev)
    for tid, items in launch.items():
        times = [t for t, _ in items]
        ops = _innermost([iv for iv in by_tid[tid]
                          if not iv[2].startswith("cuda")], times)
        spans = _innermost(spans_by_tid[tid], times)
        for (_, i), op, sp in zip(items, ops, spans):
            op_of[i], span_of[i] = op, sp
    op_s = defaultdict(float)
    kernel_s = defaultdict(float)
    for i, e in enumerate(dev):
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        fn = kernel_function(e["name"])
        kernel_s[fn] += (t - s) * 1e-6
        name = "/".join(p for p in (span_of[i], op_of[i], fn) if p)
        op_s[name] += (t - s) * 1e-6

    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev], w0, w1)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, edge = [], w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = e
    if w1 > edge:
        gaps.append((edge, w1))
    mids = [(s + e) / 2 for s, e in gaps]
    hosts = _innermost(by_tid[main_tid], mids)
    gap_s = defaultdict(float)
    for (s, e), h in zip(gaps, hosts):
        gap_s[h or "python"] += (e - s) * 1e-6

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernel_s": dict(kernel_s), "device_ops": top_of(op_s),
            "idle_gaps": top_of(gap_s), "n_device_ops": len(dev)}


def remove_quietly(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def launches():
    """A copy of the program's direct-sum kernel launch counters."""
    from al26_tpu_torch.ops import cuda_nbody

    return dict(cuda_nbody.LAUNCHES)
