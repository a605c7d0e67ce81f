"""Seconds a campaign run spends in its start: the program's span
"driver.init" (sim/driver.py: init_cluster through save 0) over the span
stretch's runs, with the program's tracing on."""
UNIT = "s"
LAYER = "init"
MOVES = "run_s"
WORKLOADS = ["n1k-cli"]


def read(ctx):
    sp = (ctx.get("program") or {}).get("span", {}).get("spans", {})
    s = sp.get("driver.init")
    if not s:
        return None
    return s["total_s"] / ctx["units_spanned"]
