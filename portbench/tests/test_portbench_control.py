"""On the card: the control of each one-card cell (the plain reference in
TF32 in the program's place) comes out not correct at the cell's own size
and limits, on three seeds, while the program comes out correct."""

import pytest

from portbench import calibrate
from portbench.spec import Spec

CELLS = ["semseg-s3dis.train", "cls_msg-modelnet40.train", "semseg-s3dis.serve"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    spec = Spec()
    limits = spec.limits(cell)
    seeds = [3_900_000_001 + 7919 * i for i in range(3)]
    out = calibrate.readings(spec, cell, seeds, len(seeds), [], 0, card)
    for seed, numbers in out["program"].items():
        assert all(numbers[k] <= v for k, v in limits.items()), (seed, numbers)
    for seed, numbers in out["control"].items():
        assert any(numbers[k] > v for k, v in limits.items()), (seed, numbers)
