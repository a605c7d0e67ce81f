"""The share of hermite4_block substeps run by the fused substep kernels
(ops/cuda_substep.py): the program's counter integrator.fused_substeps over
integrator.substeps, in the span stretch. The mechanism's engagement: 100
where every substep takes the two fused kernels around kernel 2c, 0 where
the torch loop runs them (as on the CPU)."""
UNIT = "%"
LAYER = "integrator"
MOVES = "s_per_Myr"
WORKLOADS = ["n100k-block"]


def read(ctx):
    counts = (ctx.get("program") or {}).get("span", {}).get("counts", {})
    n = counts.get("integrator.substeps", 0)
    if not n:
        return None
    return 100.0 * counts.get("integrator.fused_substeps", 0) / n
