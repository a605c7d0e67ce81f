"""A cell's stretches with the program's own spans and counters on.

    python3 perfbench/trace_program.py --workload <cell> --seed <n> \
        [--cost-seconds S --cost-turns K]

Sets the cell up as perfbench/run.py does, optionally times windows of S
seconds with the program's tracing off and on in turns (the cost of the
tracing on the cell's end-to-end metric), then runs the cell's span
stretch and profiled stretch with the program's tracing on and prints one
JSON line: the per-layer metrics read from the program's spans and
counters (perfbench/harness/program.py, METRICS), the device's idle
seconds by program span, the program's ranges in the trace and its
counters. Nothing is compared with the reference here: perfbench/run.py
is the benchmark.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".perfbench_cache", sub)

from perfbench.harness.program import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
