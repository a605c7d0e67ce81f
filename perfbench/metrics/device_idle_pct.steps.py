"""The share of the profiled stretch of steps in which no op ran on the
device (the profiler's trace: the union of kernel, memcpy and memset
intervals against the stretch's length)."""
UNIT = "%"
LAYER = "device"
MOVES = "s_per_Myr"
WORKLOADS = ["n1k-ensemble64", "n100k-block"]


def read(ctx):
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["n_device_ops"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
