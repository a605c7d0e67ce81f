"""Host milliseconds a step of parallel.ensemble.ensemble_physics_after_advance
(the per-realization physics of a flattened ensemble step), from the
benchmark's span around it, closed by a synchronize in the traced run."""
UNIT = "ms"
LAYER = "ensemble"
MOVES = "s_per_Myr"
WORKLOADS = ["n1k-ensemble64"]
SPAN = "physics.ensemble"


def read(ctx):
    s = ctx["spans"].get(SPAN)
    if not s:
        return None
    return 1e3 * sum(s) / ctx["units_spanned"]
