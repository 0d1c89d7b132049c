"""Model FLOPs from a configuration's published widths, in the lineage's
formulation: every Linear (1x1 conv) of the forward at the rows it runs
on, 2 FLOPs a multiply-add, a train step three forwards. A grouped SA
layer's first Linear runs on every (center, neighbour) row of
``concat(xyz[idx] - center, feats[idx])``, as the lineage computes it (the
program lifts it out of the gather and does less). Gathers, distances,
BN, the point ops and the optimizer are not counted."""

from portbench import reference
from portbench.work import FP32_OPS_PER_S

TRAIN_FORWARDS = 3


def _rows(cfg: dict, key: str) -> int:
    """The rows a cloud runs the Linear ``key`` on."""
    head = key.split(".")[0]
    if cfg["reference"] == "pointnet2_semseg":
        if head.startswith("sa"):
            sa = cfg["sa"][int(head[2:]) - 1]
            return sa["npoint"] * sa["nsample"]
        if head.startswith("fp"):
            level = int(head[2:])  # FP<l> runs on level l-1's points
            return cfg["num_point"] if level == 1 else cfg["sa"][level - 2]["npoint"]
        return cfg["num_point"]  # the pointwise head
    if cfg["reference"] == "pointnet2_cls_msg":
        if head in ("sa1", "sa2"):
            sa = cfg["sa_msg"][int(head[2:]) - 1]
            branch = int(key.split(".")[2])
            return sa["npoint"] * sa["nsamples"][branch]
        if head == "sa3":
            return cfg["sa_msg"][-1]["npoint"]  # one group of every point
        return 1  # the head, once a cloud
    raise KeyError(f"no FLOP count for reference model {cfg['reference']!r}")


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one cloud's forward."""
    model = reference.model(cfg["reference"])
    return sum(_rows(cfg, key) * o * i for key, o, i in model.linear_shapes(cfg))


def cloud_flops(cfg: dict, train: bool) -> float:
    return 2.0 * forward_macs(cfg) * (TRAIN_FORWARDS if train else 1)


def model_flop_share(ctx, train: bool) -> float:
    """% of the cards' fp32 peak that the window's clouds' model FLOPs make."""
    flops = cloud_flops(ctx.cfg, train) * ctx.clouds
    return 100.0 * flops / ctx.window_s / (FP32_OPS_PER_S * ctx.chips)
