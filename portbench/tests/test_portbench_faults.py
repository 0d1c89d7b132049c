"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in a CPU rehearsal of the cell
(``rehearse.py``), at the cell's own limits. The same runs without a fault
come out correct."""

import pytest

from portbench.spec import Spec
from portbench.tests.rehearse import run

FAULTS = [
    ("semseg-s3dis.train", "unchanged"), ("semseg-s3dis.train", "half_batch"),
    ("cls_msg-modelnet40.train", "unchanged"), ("cls_msg-modelnet40.train", "half_batch"),
    ("semseg-s3dis.serve", "altered_answer"),
    ("semseg-s3dis.train-dp4", "unchanged"), ("semseg-s3dis.train-dp4", "half_batch"),
    ("semseg-s3dis.train-dp4", "no_exchange"),
]
SEED = 2 ** 31 + 5


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    result = run(Spec(), cell, SEED, trace=0, fault=fault)
    assert result is not None and result["correct"] is False, result


@pytest.mark.parametrize("cell", ["semseg-s3dis.train", "semseg-s3dis.serve",
                                  "semseg-s3dis.train-dp4"])
def test_sound_run_is_correct(cell):
    result = run(Spec(), cell, SEED, trace=0)
    assert result["correct"] is True, result
