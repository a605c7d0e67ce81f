"""Device ops a flattened ensemble step launches in the per-realization
physics: the ops of the profiled stretch whose launch lies inside a
program range "al26::step.physics" (sim/step.py physics_after_advance, run
once a realization), over the stretch's steps. A count."""
UNIT = "launches"
LAYER = "ensemble"
MOVES = "s_per_Myr"
WORKLOADS = ["n1k-ensemble64"]


def read(ctx):
    pt = ctx.get("program_trace")
    if not pt or "step.physics" not in pt["ranges"]:
        return None
    return pt["ops_in_span"].get("step.physics", 0) / ctx["units_traced"]
