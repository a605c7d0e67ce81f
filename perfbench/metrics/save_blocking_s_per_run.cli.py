"""Seconds a campaign run's main thread is held by its saves: the
program's span "driver.checkpoint" (the host copies, the hand-off to the
writer thread and the final drain) less its "driver.save.device_wait"
children (the device's queued work, which the copy would wait for), over
the span stretch's runs, with the program's tracing on."""
UNIT = "s"
LAYER = "driver and saves"
MOVES = "run_s"
WORKLOADS = ["n1k-cli"]


def read(ctx):
    sp = (ctx.get("program") or {}).get("span", {}).get("spans", {})
    s = sp.get("driver.checkpoint")
    if not s:
        return None
    own = s["total_s"] - s["children_s"].get("driver.save.device_wait", 0.0)
    return own / ctx["units_spanned"]
