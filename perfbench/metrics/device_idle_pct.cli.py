"""The share of a profiled campaign run through the CLI in which no op ran
on the device (the profiler's trace, as device_idle_pct.steps)."""
UNIT = "%"
LAYER = "device"
MOVES = "run_s"
WORKLOADS = ["n1k-cli"]


def read(ctx):
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["n_device_ops"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
