"""Structured run instrumentation (the port of al26_tpu/utils/timing.py).

The reference scatters manual time.time() brackets through its step and
prints them under --verbose (al26_nbody.py:764-1109). Here one recorder
serves every layer of the port:

  * `span(name)`: a context manager around one stretch of host work. With
    tracing off (the default) it is one shared no-op object returned after
    a single flag test: no clock read, no allocation, no torch call. With
    tracing on it records, per span name, the calls, the total and the
    self seconds (total less the same thread's child spans) and the
    seconds of each child span by name; while a torch profiler runs it
    also opens `torch.profiler.record_function("al26::" + name)`, so a
    profiled run shows every span in its Chrome trace on the profiler's
    clock, beside the device ops launched inside it. (A range costs
    ~10 µs of host time on an H100 machine, so it is opened only where
    a profiler records it.)
  * `count(name, n)`: a counter that is always on (host reads, substeps).
  * `enable()`, `disable()`, `snapshot_and_reset()`: tracing on and off,
    and what the recorder holds (then cleared).
  * `PhaseTimers`: the run driver's always-on per-phase totals (--verbose
    report, RunResult.phase_seconds); each phase is also the span
    "driver.<phase>".
  * `maybe_start_trace()` / `maybe_stop_trace()`: a torch.profiler trace
    of a run when AL26_TORCH_TRACE_DIR=/path is set (CPU activity of
    every thread, and CUDA activity where a card is present), with
    tracing on while it runs; at the end the trace is written as a Chrome
    trace, al26-trace-<pid>.json, and the recorder's snapshot as
    al26-spans-<pid>.json.

Spans and counters may be recorded from any thread; a span's parent is
the innermost span open on its own thread.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

PREFIX = "al26::"

_ON = False
_LOCK = threading.Lock()
_LOCAL = threading.local()
_COUNTS: Dict[str, int] = defaultdict(int)
# name -> [calls, total ns, self ns, {child name: ns}]
_SPANS: Dict[str, list] = {}
_profiler = None        # torch.autograd.profiler, bound by enable()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "parent", "child_ns", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.parent = stack[-1] if stack else None
        self.child_ns = defaultdict(int)
        stack.append(self)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        _LOCAL.stack.pop()
        if self.parent is not None:
            self.parent.child_ns[self.name] += dt
        with _LOCK:
            rec = _SPANS.get(self.name)
            if rec is None:
                rec = _SPANS[self.name] = [0, 0, 0, defaultdict(int)]
            rec[0] += 1
            rec[1] += dt
            rec[2] += dt - sum(self.child_ns.values())
            for child, ns in self.child_ns.items():
                rec[3][child] += ns
        return False


def span(name: str):
    """A context manager that records `name` while tracing is on."""
    if not _ON:
        return _NO_SPAN
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (always on)."""
    with _LOCK:
        _COUNTS[name] += n


def enabled() -> bool:
    return _ON


def enable() -> None:
    """Turn tracing on: spans record (and open profiler ranges while a
    profiler runs)."""
    global _ON, _profiler
    if _profiler is None:
        import torch.autograd.profiler

        _profiler = torch.autograd.profiler
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def snapshot_and_reset() -> dict:
    """{"spans": {name: {"calls", "total_s", "self_s", "children_s":
    {child name: s}}}, "counts": {name: n}} since the last reset; the
    recorder is then empty. Spans still open are not in it."""
    with _LOCK:
        spans = {name: {"calls": c, "total_s": tot * 1e-9,
                        "self_s": own * 1e-9,
                        "children_s": {k: v * 1e-9
                                       for k, v in kids.items()}}
                 for name, (c, tot, own, kids) in _SPANS.items()}
        counts = dict(_COUNTS)
        _SPANS.clear()
        _COUNTS.clear()
    return {"spans": spans, "counts": counts}


class PhaseTimers:
    """Wall-clock totals and counts per named phase, always on; each
    phase is also the span "driver.<name>". Phases may be timed from
    several threads (the checkpoint writer's included).

    CUDA launches are asynchronous, so a phase that only enqueues device
    work appears cheap and the wait lands in the phase that next reads a
    result back: the "checkpoint" phase absorbs the tail of the physics
    chunk before its host copy. With tracing on, that wait is the span
    "driver.save.device_wait" inside it (sim/driver.py)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span("driver." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self) -> str:
        lines = []
        with self._lock:
            items = sorted(self.totals.items(), key=lambda kv: -kv[1])
        for name, total in items:
            n = self.counts[name]
            lines.append(
                f"  {name:<18s} total {total:8.3f} s   "
                f"x{n:<6d} avg {total / n * 1e3:8.2f} ms"
            )
        return "\n".join(lines)


_PROFILER = None
_TRACE_DIR = None


def all_threads_config() -> dict:
    """torch.profiler.profile's keyword that records the ops and ranges of
    every thread (the checkpoint writer's too), where this torch has it;
    else none (only the thread that starts the profiler is recorded)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def maybe_start_trace() -> bool:
    """Start a torch.profiler trace, with tracing on, if
    AL26_TORCH_TRACE_DIR is set and none is running; True if it started
    one (the caller then stops it)."""
    global _PROFILER, _TRACE_DIR
    trace_dir = os.environ.get("AL26_TORCH_TRACE_DIR")
    if not trace_dir or _PROFILER is not None:
        return False
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _PROFILER = torch.profiler.profile(activities=acts,
                                       **all_threads_config())
    _PROFILER.start()
    _TRACE_DIR = trace_dir
    snapshot_and_reset()
    enable()
    return True


def maybe_stop_trace() -> None:
    """Stop a running trace, turn tracing off, and write the Chrome trace
    and the recorder's snapshot to the trace directory."""
    global _PROFILER
    if _PROFILER is None:
        return
    prof, _PROFILER = _PROFILER, None
    disable()
    prof.stop()
    os.makedirs(_TRACE_DIR, exist_ok=True)
    pid = os.getpid()
    prof.export_chrome_trace(
        os.path.join(_TRACE_DIR, f"al26-trace-{pid}.json"))
    with open(os.path.join(_TRACE_DIR, f"al26-spans-{pid}.json"), "w") as f:
        json.dump(snapshot_and_reset(), f, indent=1, sort_keys=True)
