"""Host milliseconds a step of sim.step.physics_after_advance (the step
physics of a single run), from the benchmark's span around it, closed by a
synchronize in the traced run."""
UNIT = "ms"
LAYER = "step physics"
MOVES = "s_per_Myr"
WORKLOADS = ["n100k-block"]
SPAN = "physics.single"


def read(ctx):
    s = ctx["spans"].get(SPAN)
    if not s:
        return None
    return 1e3 * sum(s) / ctx["units_spanned"]
