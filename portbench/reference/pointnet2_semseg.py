"""Plain reference of ``pointnet2_semseg`` (PointNet++ SSG segmentation):
four SA levels, four FP levels and the pointwise head, from the
configuration's widths. See ``layers.py`` for what it computes and how it
departs from the lineage."""

import torch
import torch.nn.functional as F

from portbench.reference import layers as L


def linear_shapes(cfg: dict):
    """``[(key, out, in)]`` of every Linear, under the lineage's keys."""
    out, width = [], cfg["channels"]
    widths = []
    for i, sa in enumerate(cfg["sa"], 1):
        last = width + 3
        for j, o in enumerate(sa["mlp"]):
            out.append((f"sa{i}.mlp_convs.{j}", o, last))
            last = o
        widths.append(width)
        width = last
    # FP4..FP1: the coarse level's width plus the fine level's skip (none
    # at the input level)
    coarse = width
    for level, fp in zip((4, 3, 2, 1), cfg["fp"]):
        skip = widths[level - 1] if level > 1 else 0
        last = coarse + skip
        for j, o in enumerate(fp):
            out.append((f"fp{level}.mlp_convs.{j}", o, last))
            last = o
        coarse = last
    out.append(("conv1", cfg["head"][0], coarse))
    out.append(("conv2", cfg["num_classes"], cfg["head"][0]))
    return out


def bn_keys(cfg: dict):
    """``[(key, width)]`` of every BatchNorm."""
    keys = [(k.replace("mlp_convs", "mlp_bns"), o) for k, o, _ in linear_shapes(cfg)
            if k not in ("conv1", "conv2")]
    return keys + [("bn1", cfg["head"][0])]


def forward(w: dict, points: torch.Tensor, cfg: dict, train: bool, draws=None) -> torch.Tensor:
    """points (B, N, C) -> (B, N, classes) log-probabilities."""
    xyz, feats = points[..., :3], points
    levels = [(xyz, None)]  # (xyz, features) a level; the input level has no skip
    for i, sa in enumerate(cfg["sa"], 1):
        new_xyz = L.centers(xyz, sa["npoint"], draws)
        g = L.grouped(xyz, feats, new_xyz, sa["radius"], sa["nsample"])
        convs, bns = L.layer_keys(f"sa{i}", len(sa["mlp"]))
        xyz, feats = new_xyz, L.mlp(g, w, convs, bns, train, pool_dim=2)
        levels.append((xyz, feats))
    coarse_xyz, coarse = levels[-1]
    for level, fp in zip((4, 3, 2, 1), cfg["fp"]):
        fine_xyz, skip = levels[level - 1]
        d2, idx = L.three_nn(fine_xyz, coarse_xyz)
        x = L.interpolate(coarse, idx, d2)
        if skip is not None:
            x = torch.cat([skip, x], dim=-1)
        convs, bns = L.layer_keys(f"fp{level}", len(fp))
        coarse_xyz, coarse = fine_xyz, L.mlp(x, w, convs, bns, train)
    x = torch.relu(L.batch_norm(L.linear(coarse, w, "conv1"), w, "bn1", train))
    x = L.dropout(x, cfg["dropout"], draws if train else None)
    return F.log_softmax(L.linear(x, w, "conv2"), dim=-1)
