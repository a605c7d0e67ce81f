"""Readable device op names and the reduction of a Chrome trace."""
import json

import pytest

from perfbench.harness import tracing


@pytest.mark.parametrize("raw,name", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "AUnaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> >, std::array<char*, 2ul> >(int, ...)",
     "vectorized_elementwise_kernel"),
    ("void fma_sweep<128, 4>(FmaArgs)", "fma_sweep"),
    ("void (anonymous namespace)::pair_sweep_mma<true, 2, false>("
     "(anonymous namespace)::MmaArgs)", "pair_sweep_mma"),
    ("std::enable_if<!T7, void>::type internal::gemvx::kernel<int, int, "
     "float>(Params)", "gemvx::kernel"),
    ("pair_sweep_mma(MmaArgs)", "pair_sweep_mma"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH (Device -> Pinned)"),
])
def test_kernel_function(raw, name):
    assert tracing.kernel_function(raw) == name


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_read_trace(tmp_path):
    ev = [
        _x("perfbench::window", "user_annotation", 0, 100),
        _x("perfbench::physics.single", "user_annotation", 10, 40),
        _x("aten::mul", "cpu_op", 12, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 14, 2, correlation=7),
        _x("aten::add", "cpu_op", 60, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 62, 2, correlation=8),
        _x("void at::native::elementwise_kernel<128, 2>(int)", "kernel",
           20, 10, tid=7, correlation=7),
        _x("void at::native::elementwise_kernel<128, 4>(int)", "kernel",
           70, 20, tid=7, correlation=8),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = tracing.read_trace(str(path))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(30e-6)
    assert dict(r["device_ops"]) == pytest.approx({
        "physics.single/aten::mul/elementwise_kernel": 10e-6,
        "aten::add/elementwise_kernel": 20e-6})
    gaps = dict(r["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(70e-6)
    assert gaps == pytest.approx({"python": 70e-6})
