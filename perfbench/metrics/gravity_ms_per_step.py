"""Device milliseconds a step of the direct-sum and near-field gravity
kernels, from the profiler's trace of the traced stretch. The kernels are
matched by their function names below."""
UNIT = "ms"
LAYER = "kernels"
MOVES = "s_per_Myr"
WORKLOADS = ["n1k-ensemble64", "n100k-block"]
KERNELS = ("fma_sweep", "pair_sweep_mma", "near_items", "near_reduce")


def gravity_seconds(ctx):
    return sum(v for k, v in ctx["trace"]["kernel_s"].items()
               if k in KERNELS)


def read(ctx):
    s = gravity_seconds(ctx)
    if s <= 0:
        return None
    return 1e3 * s / ctx["units_traced"]
