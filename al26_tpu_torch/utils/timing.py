"""Structured run instrumentation (the port of al26_tpu/utils/timing.py).

The reference scatters manual time.time() brackets through its step and
prints them under --verbose (al26_nbody.py:764-1109). Here timing is a
small structured collector the driver wraps around each phase, plus an
optional torch.profiler trace of the run (AL26_TORCH_TRACE_DIR=/path
enables it: CPU activity, and CUDA activity where a card is present; the
trace is written as a Chrome trace, al26-trace-<pid>.json, when the run
ends).
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class PhaseTimers:
    """Accumulates wall-clock per named phase; cheap enough to always run.

    CAVEAT: CUDA launches are asynchronous — a phase that only ENQUEUES
    device work appears cheap, and the wait lands in whichever later phase
    first reads a result back to the host. In the driver the integrator
    loop reads back once per substep, and each save copies the state to
    the host (state.cluster_to_numpy) inside the "checkpoint" phase, so
    that phase absorbs the tail of the physics chunk before it."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"  {name:<18s} total {total:8.3f} s   "
                f"x{n:<6d} avg {total / n * 1e3:8.2f} ms"
            )
        return "\n".join(lines)


_PROFILER = None
_TRACE_DIR = None


def maybe_start_trace() -> bool:
    """Start a torch.profiler trace if AL26_TORCH_TRACE_DIR is set."""
    global _PROFILER, _TRACE_DIR
    trace_dir = os.environ.get("AL26_TORCH_TRACE_DIR")
    if not trace_dir or _PROFILER is not None:
        return False
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _PROFILER = torch.profiler.profile(activities=acts)
    _PROFILER.start()
    _TRACE_DIR = trace_dir
    return True


def maybe_stop_trace() -> None:
    """Stop a running trace and write it to the trace directory."""
    global _PROFILER
    if _PROFILER is None:
        return
    prof, _PROFILER = _PROFILER, None
    prof.stop()
    os.makedirs(_TRACE_DIR, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(_TRACE_DIR, f"al26-trace-{os.getpid()}.json"))
