"""The control, the nearest lower precision in the program's place, comes
out not correct under each cell's limits: on the CPU at a toy size, and
(``chip``) on the card at the cell's own size.

The training cells' control is the program's own int8 feature table under
its bfloat16 compute; the exact pass's is the reference with its products'
inputs rounded to TF32 (``readings.py``)."""

import pytest
import torch

from benchmark import checks, harness, readings
from benchmark.tests.toy import cells, toy_cell


def verdict(spec, seed, what, device):
    values = readings.reading(spec, seed, what, device)
    values.setdefault("nonfinite_steps", 0.0)
    return checks.judge(values, spec["limits"])


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", cells())
def test_control_fails_and_the_program_passes_at_a_toy_size(cell, seed):
    spec = toy_cell(cell)
    assert not all(c["ok"] for c in verdict(spec, seed, "control", torch.device("cpu")).values())
    assert all(c["ok"] for c in verdict(spec, seed, "program", torch.device("cpu")).values())


@pytest.mark.chip
@pytest.mark.parametrize("cell", cells())
def test_control_fails_at_the_cells_size(cell, card):
    spec = harness.load_cell(cell)
    assert not all(c["ok"] for c in verdict(spec, 2**31 + 99, "control", card).values())
