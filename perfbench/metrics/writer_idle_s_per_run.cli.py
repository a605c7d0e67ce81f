"""Device idle seconds a campaign run while the checkpoint writer thread
works: the idle gaps of the profiled stretch that overlap the program's
ranges "al26::io.writer.job" on the writer thread, over the stretch's
runs. Read where the profiler records every thread."""
UNIT = "s"
LAYER = "driver and saves"
MOVES = "run_s"
WORKLOADS = ["n1k-cli"]


def read(ctx):
    pt = ctx.get("program_trace")
    if not pt or "io.writer.job" not in pt["ranges"]:
        return None
    return pt["idle_in_other"].get("io.writer.job", 0.0) / ctx["units_traced"]
