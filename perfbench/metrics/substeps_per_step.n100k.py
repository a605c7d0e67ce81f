"""Direct-sum sweeps a step of a single run: the program's own launch
counters (ops.cuda_nbody.LAUNCHES), kernel 2's predicted-column launches
(the fast group's substeps) plus kernel 1's (the closing sweeps), over the
span stretch's steps. A count."""
UNIT = "launches"
LAYER = "integrator"
MOVES = "s_per_Myr"
WORKLOADS = ["n100k-block"]
KEYS = ("nbody_predcols", "nbody_predcols_mma", "nbody_rows",
        "nbody_rows_mma")


def read(ctx):
    n = sum(ctx["launches"].get(k, 0) for k in KEYS)
    if n == 0:
        return None
    return n / ctx["units_spanned"]
