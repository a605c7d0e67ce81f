"""Device ops a hermite4_block substep: the ops of the profiled stretch
whose launch lies inside a program range "al26::integrator.substep", over
the program's counter integrator.substeps of the same stretch. A count."""
UNIT = "launches"
LAYER = "integrator"
MOVES = "s_per_Myr"
WORKLOADS = ["n100k-block"]


def read(ctx):
    pt = ctx.get("program_trace")
    counts = (ctx.get("program") or {}).get("trace", {}).get("counts", {})
    n = counts.get("integrator.substeps", 0)
    if not pt or not n or "integrator.substep" not in pt["ranges"]:
        return None
    return pt["ops_in_span"].get("integrator.substep", 0) / n
