"""Host milliseconds a step blocked on the device in the integrator's
read-backs: the program's spans "integrator.host_read" (the `t < dt` reads
of ops/integrators.py) over the span stretch's steps, with the program's
tracing on."""
UNIT = "ms"
LAYER = "integrator"
MOVES = "s_per_Myr"
WORKLOADS = ["n100k-block"]


def read(ctx):
    sp = (ctx.get("program") or {}).get("span", {}).get("spans", {})
    s = sp.get("integrator.host_read")
    if not s:
        return None
    return 1e3 * s["total_s"] / ctx["units_spanned"]
