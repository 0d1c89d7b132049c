"""The readers that need more than a run's totals: the collectives' time
over the ranks, and what the serving window drives."""

import time
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.spec import Spec
from portbench.tests import small


def _ctx(ranks, reps=2):
    return SimpleNamespace(rank_device=ranks, trace=SimpleNamespace(reps=reps))


def test_collective_ms_counts_each_collectives_last_rank():
    """Each collective counts its shortest kernel over the ranks: the
    other ranks' kernels spin while they wait for the last to arrive."""
    read = Spec().reader("collective_ms.train").read
    nccl = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned long, ncclWork*)"
    rank0 = [(nccl, 900.0), ("gemm", 50.0), (nccl, 30.0)]
    rank1 = [(nccl, 100.0), ("gemm", 60.0), (nccl, 400.0)]
    assert read(_ctx([rank0, rank1])) == pytest.approx((100.0 + 30.0) * 1e-3 / 2)
    assert read(_ctx([rank0])) is None  # one process
    assert read(_ctx([rank0, rank1[:2]])) is None  # the traces do not pair up
    assert read(_ctx([[("gemm", 1.0)], [("gemm", 2.0)]])) is None


def test_the_serving_window_calls_predict_labels():
    """Every request of the window, and only those after the warm-up, is a
    call of the program's ``Predictor.predict_labels``; the check reads
    the log-probabilities of those very calls."""
    from pointnet12_tpu_torch.infer import Predictor

    calls = []

    class Counting(Predictor):
        def predict_labels(self, points):
            calls.append(len(points))
            return super().predict_labels(points)

    spec = Spec()
    name = "semseg-s3dis.serve"
    cfg, mix = small.cell(spec, name)
    args = harness.parse(["--workload", name, "--seed", str(2 ** 31 + 11), "--seconds", "0.5",
                          "--trace", "0"])
    result = harness.run_cell(spec, args, time.time(), device="cpu", config=cfg, traffic=mix,
                              program=Counting)
    assert len(calls) == mix["warmup"] + result["attempted"]
    assert set(calls) == {cfg["batch"]}
    assert result["correct"] is True, result
