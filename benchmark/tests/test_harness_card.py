"""The control at each cell's own size, on the card: the reference with its
operands in float8 put in the program's place must come out not correct
on three seeds, where the program comes out correct. Skips without a card
(decided inside the test)."""

import pytest
import torch

import calibrate
import run
from check import verdict

CELLS = ["mvc_serve_b32", "wt_train_b8", "mvc_request_b1", "wt_serve_b32"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    spec = run.cell_spec(cell)
    limits = spec["settings"]["limits"]
    seeds = [7_000_000_001 + i for i in range(3)]
    for row in calibrate.readings(spec, torch.device("cuda", 0), seeds, len(seeds), 1.0):
        assert verdict(row, limits)[0], row
        assert not verdict({k: row[f"fp8_{k}"] for k in limits if f"fp8_{k}" in row}
                           | {k: 0 for k in limits if f"fp8_{k}" not in row}, limits)[0], row
