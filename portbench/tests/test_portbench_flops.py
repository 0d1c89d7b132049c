"""The model-FLOP counter against the hand count from the published
widths, and the configurations' widths against the port's models."""


import pytest
import torch

from portbench import reference
from portbench.flops import cloud_flops, forward_macs
from portbench.spec import Spec
from portbench.weights import make_weights


def _cfg(name):
    return Spec().config(name)


def test_semseg_hand_count():
    rows = {"sa1": 1024 * 32, "sa2": 256 * 32, "sa3": 64 * 32, "sa4": 16 * 32}
    macs = (rows["sa1"] * (12 * 32 + 32 * 32 + 32 * 64)
            + rows["sa2"] * (67 * 64 + 64 * 64 + 64 * 128)
            + rows["sa3"] * (131 * 128 + 128 * 128 + 128 * 256)
            + rows["sa4"] * (259 * 256 + 256 * 256 + 256 * 512)
            + 64 * (768 * 256 + 256 * 256) + 256 * (384 * 256 + 256 * 256)
            + 1024 * (320 * 256 + 256 * 128) + 4096 * 3 * 128 * 128
            + 4096 * (128 * 128 + 128 * 13))
    cfg = _cfg("pointnet2_semseg-s3dis")
    assert forward_macs(cfg) == macs == 970_063_872  # ~0.970 G, the issue's count
    assert cloud_flops(cfg, train=True) == 6 * macs


def test_msg_hand_count():
    sa1 = 512 * (16 * (3 * 32 + 32 * 32 + 32 * 64) + 32 * (3 * 64 + 64 * 64 + 64 * 128)
                 + 128 * (3 * 64 + 64 * 96 + 96 * 128))
    sa2 = 128 * (32 * (323 * 64 + 64 * 64 + 64 * 128) + 64 * (323 * 128 + 128 * 128 + 128 * 256)
                 + 128 * (323 * 128 + 128 * 128 + 128 * 256))
    sa3 = 128 * (643 * 256 + 256 * 512 + 512 * 1024)
    head = 1024 * 512 + 512 * 256 + 256 * 40
    cfg = _cfg("pointnet2_cls_msg-modelnet40")
    assert forward_macs(cfg) == sa1 + sa2 + sa3 + head  # ~3.917 G, the issue's count
    assert abs(forward_macs(cfg) / 1e9 - 3.917) < 0.002


@pytest.mark.parametrize("name", ["pointnet2_semseg-s3dis", "pointnet2_cls_msg-modelnet40"])
def test_widths_are_the_ports(name):
    """Every Linear and BN the counter and the reference read has the
    shape of the port's own parameter of that name."""
    from pointnet12_tpu_torch.models import get_model

    cfg = _cfg(name)
    kw = {"in_channels": cfg["channels"]} if cfg["task"] == "seg" else {}
    port = get_model(cfg["model"], num_classes=cfg["num_classes"], **kw).state_dict()
    ours = make_weights(cfg, 1, "cpu")
    assert set(port) == set(ours)
    assert all(port[k].shape == ours[k].shape for k in port)
    model = reference.model(cfg["reference"])
    assert len(model.linear_shapes(cfg)) == sum(k.endswith(".weight") and port[k].dim() == 2
                                                 for k in port)


def test_weights_follow_the_seed():
    cfg = _cfg("pointnet2_semseg-s3dis")
    a, b, c = (make_weights(cfg, s, "cpu") for s in (5, 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sa1.mlp_convs.0.weight"], c["sa1.mlp_convs.0.weight"])
