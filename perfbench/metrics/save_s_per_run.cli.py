"""Seconds a campaign run spends saving: the driver's own PhaseTimers
(RunResult.phase_seconds), its "checkpoint" phase (the driver thread's
share: host copy, hand-off, final flush) plus its "writer" phase (the
writer thread's serialisation), a run. The checkpoint phase also soaks up
the device's tail before each host copy (utils/timing.py)."""
UNIT = "s"
LAYER = "driver and saves"
MOVES = "run_s"
WORKLOADS = ["n1k-cli"]


def read(ctx):
    runs = ctx["outputs"].get("driver.run") or []
    if not runs:
        return None
    total = sum(r.phase_seconds.get("checkpoint", 0.0)
                + r.phase_seconds.get("writer", 0.0) for r in runs)
    return total / len(runs)
