"""On a card: the control (the reference in the program's place, in f32 with
TF32 products) fails one of a cell's limits at the cell's own size and
traffic (a 5-s window), and the program passes them all. Run with
`python -m pytest --noconftest perfbench/tests -m gpu`."""
import pytest

from perfbench import control
from perfbench.tests import cells

CELLS = ("n1k-ensemble64", "n100k-block", "n1k-cli")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cs = cells.load(name)
    r = control.readings(cs, 2**31 + 4242, 5.0, True, card)
    lim = cs.limits
    assert all(r["program"][k] <= v for k, v in lim.items()), r
    assert any(r["control"][k] > v for k, v in lim.items()), r
