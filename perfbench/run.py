"""Benchmark of al26_tpu_torch, the PyTorch and CUDA package, on CUDA cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--steps-log FILE]

One run of one cell of BENCHMARK.json (at the root of the checkout): set-up
and warm-up, a window of `--seconds` seconds (``--trace 0``: the cell's
end-to-end metrics) or a traced stretch (``--trace 1``: its per-layer
metrics), then the comparison of what the window produced with the plain
reference in perfbench/reference. Progress and the compared numbers go to
standard error; the last line of standard output is one JSON object
(perfbench/harness/main.py says which keys). ``--steps-log`` writes the
host time of every unit of work in the window, the process's CPU affinity,
the load average and the CPU clocks before and after it to FILE. Build
caches stay in the checkout (.perfbench_cache/, al26_tpu_torch/_build/).
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# build caches at fixed paths inside the checkout (the program's own
# kernels build into al26_tpu_torch/_build there already)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".perfbench_cache", sub)

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
