"""Host milliseconds a hermite4_block substep, the device's waits left out:
the program's span "integrator.substep" (ops/integrators.py) less its
"integrator.host_read" children, over its calls, in the span stretch with
the program's tracing on."""
UNIT = "ms"
LAYER = "integrator"
MOVES = "s_per_Myr"
WORKLOADS = ["n100k-block"]


def read(ctx):
    sp = (ctx.get("program") or {}).get("span", {}).get("spans", {})
    s = sp.get("integrator.substep")
    if not s or not s["calls"]:
        return None
    own = s["total_s"] - s["children_s"].get("integrator.host_read", 0.0)
    return 1e3 * own / s["calls"]
