"""The frozen work counters against ``chip_smoke.py``'s on one shape."""

import pytest
import torch

import chip_smoke as cs
from portbench import work
from portbench.reference.layers import fps, gather


def _levels():
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand((2, 1024, 3), generator=g)
    centers = gather(xyz, fps(xyz, 256, torch.zeros(2, dtype=torch.int32)))
    return xyz, centers


def test_peaks_are_chip_smokes():
    assert (work.HBM_BYTES_PER_S, work.FP32_OPS_PER_S) == (cs.HBM_BYTES_PER_S, cs.FP32_OPS_PER_S)
    assert (work.TF32_OPS_PER_S, work.BF16_OPS_PER_S) == (cs.TF32_OPS_PER_S, cs.BF16_OPS_PER_S)
    ms, _ = cs.bound(1e9, 1e12)
    assert work.least_seconds(1e9, 1e12) == pytest.approx(ms / 1e3)


def test_fps_and_three_nn_are_chip_smokes(monkeypatch):
    xyz, centers = _levels()
    monkeypatch.setattr(cs, "B", 2)
    monkeypatch.setattr(cs, "SA", [(256, 0.2)])
    theirs = cs.serve_work([xyz, centers])
    assert work.fps_work(2, 1024, 256) == theirs["fps"][0]
    assert work.three_nn_work(2, 1024, 256) == theirs["three_nn"][0]
    # the ball query: the same bytes; the pairs each center needs, which
    # chip_smoke rounds up to the scan's warps of 32
    nbytes, ops = work.ballquery_work(0.2, cs.K, xyz, centers)
    theirs_bytes, theirs_ops = theirs["ballquery"][0]
    assert nbytes == theirs_bytes
    assert theirs_ops - 9 * 31 * 2 * 256 <= ops <= theirs_ops


def test_segsum_is_chip_smokes():
    idx = torch.zeros((2, 3, 1024), dtype=torch.int32)
    values = torch.zeros((2, 1024, 64))
    for weights in (None, torch.zeros((2, 3, 1024))):
        assert work.segsum_work(2, 3, 1024, 64, 256, weights is not None) == cs.segsum_work(
            (idx, weights, values, 256))
