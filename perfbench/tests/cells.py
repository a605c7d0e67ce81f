"""The cells the CPU tests drive: BENCHMARK.json's, and the parked ones of
perfbench/parked/<cell>.json (entries that left BENCHMARK.json, kept as
they stood there, whose traffic kind, comparison and readers the harness
still holds for a later cell of the same kind)."""
import glob
import os

from perfbench.harness import spec

PARKED = sorted(glob.glob(os.path.join(spec.BENCH_DIR, "parked", "*.json")))


def bench() -> dict:
    """BENCHMARK.json with every parked cell's entries added."""
    out = spec.load_benchmark()
    for path in PARKED:
        parked = spec.read_json(path)
        for key in ("workloads", "end_to_end", "per_layer"):
            out[key] = out[key] + parked[key]
    return out


def load(name: str) -> spec.Cell:
    return spec.load_cell(name, bench())
