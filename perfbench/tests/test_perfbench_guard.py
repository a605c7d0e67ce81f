"""The import guard compares whole top-level module names."""
import pytest

from perfbench.harness import guard


@pytest.mark.parametrize("names,bad", [
    (["al26_tpu_torch", "al26_tpu_torch.sim.step", "torch"], []),
    (["al26_tpu"], ["al26_tpu"]),
    (["al26_tpu.sim", "numpy"], ["al26_tpu.sim"]),
    (["jax.numpy"], ["jax.numpy"]),
    (["jaxlib", "flax.linen"], ["flax.linen", "jaxlib"]),
    (["jaxtyping", "al26_tpu_tools"], []),
])
def test_forbidden(names, bad):
    assert guard.forbidden_modules(names) == bad
