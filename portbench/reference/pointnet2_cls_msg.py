"""Plain reference of ``pointnet2_cls_msg`` (PointNet++ MSG
classification): two multi-scale SA levels, the group-all SA and the
head, from the configuration's widths. See ``layers.py`` for what it
computes and how it departs from the lineage."""

import torch
import torch.nn.functional as F

from portbench.reference import layers as L


def linear_shapes(cfg: dict):
    """``[(key, out, in)]`` of every Linear, under the lineage's keys."""
    out, width = [], cfg["channels"] - 3
    for i, sa in enumerate(cfg["sa_msg"], 1):
        total = 0
        for b, mlp in enumerate(sa["mlps"]):
            last = width + 3
            for j, o in enumerate(mlp):
                out.append((f"sa{i}.conv_blocks.{b}.{j}", o, last))
                last = o
            total += last
        width = total
    last = width + 3
    for j, o in enumerate(cfg["sa_all"]):
        out.append((f"sa3.mlp_convs.{j}", o, last))
        last = o
    for j, o in enumerate(cfg["head"], 1):
        out.append((f"head.fc{j}", o, last))
        last = o
    out.append((f"head.fc{len(cfg['head']) + 1}", cfg["num_classes"], last))
    return out


def bn_keys(cfg: dict):
    """``[(key, width)]`` of every BatchNorm."""
    keys = []
    for k, o, _ in linear_shapes(cfg):
        if ".conv_blocks." in k:
            keys.append((k.replace("conv_blocks", "bn_blocks"), o))
        elif ".mlp_convs." in k:
            keys.append((k.replace("mlp_convs", "mlp_bns"), o))
    return keys + [(f"head.bn{j}", o) for j, o in enumerate(cfg["head"], 1)]


def forward(w: dict, points: torch.Tensor, cfg: dict, train: bool, draws=None) -> torch.Tensor:
    """points (B, N, C) -> (B, classes) log-probabilities."""
    xyz = points[..., :3]
    feats = points[..., 3:] if points.shape[-1] > 3 else None
    for i, sa in enumerate(cfg["sa_msg"], 1):
        new_xyz = L.centers(xyz, sa["npoint"], draws)
        outs = []
        for b, (radius, k, mlp) in enumerate(zip(sa["radii"], sa["nsamples"], sa["mlps"])):
            g = L.grouped(xyz, feats, new_xyz, radius, k)
            convs, bns = L.layer_keys(f"sa{i}", len(mlp), f"conv_blocks.{b}", f"bn_blocks.{b}")
            outs.append(L.mlp(g, w, convs, bns, train, pool_dim=2))
        xyz, feats = new_xyz, torch.cat(outs, dim=-1)
    g = torch.cat([xyz, feats], dim=-1)[:, None]  # one group of every point
    convs, bns = L.layer_keys("sa3", len(cfg["sa_all"]))
    x = L.mlp(g, w, convs, bns, train, pool_dim=2)[:, 0]
    for j in range(1, len(cfg["head"]) + 1):
        x = torch.relu(L.batch_norm(L.linear(x, w, f"head.fc{j}"), w, f"head.bn{j}", train))
        x = L.dropout(x, cfg["dropout"], draws if train else None)
    return F.log_softmax(L.linear(x, w, f"head.fc{len(cfg['head']) + 1}"), dim=-1)
