"""The plain reference's layers: PointNet++ in plain PyTorch, float32.

Written from the lineage's modules (a frozen reading of
``tests/torch_ref/models_torch.py`` and ``ops_torch.py`` at commit
529a356, themselves from yanx27/Pointnet_Pointnet2_pytorch), as functions
of a dict of weights under the lineage's ``state_dict`` keys. It imports
nothing of the program: no kernel, no module of ``pointnet12_tpu_torch``.

Departures from the lineage, each the published model's own semantics
computed exactly:
- Squared distances in the direct form ``(dx*dx + dy*dy) + dz*dz``, each
  product and sum its own op (so no fused multiply-add), not the expansion
  ``|a|^2 + |b|^2 - 2ab``, which misjudges radius boundaries and
  coincident points by ~1e-7 in float32. The ball query tests ``d2 <=
  float32(radius**2)`` (radius squared in double, rounded once).
- FPS starts where the caller says (the train step draws each cloud's
  start); the running minimum and the first-index argmax are the
  lineage's.
- 3-NN takes the three smallest distances, ties to the lower index.
- BatchNorm in train mode normalises by the biased batch variance (the
  lineage's ``F.batch_norm``); no running statistics are updated, since
  no compared number reads them; eval reads the running statistics.
- Dropout keeps an element where ``torch.rand(shape, generator) < 1 -
  rate`` and scales it by ``1 / (1 - rate)``.

Matmuls follow ``torch.backends.cuda.matmul.allow_tf32``: the harness
turns it off for the reference and on for its lower-precision control.
"""

from typing import Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
DIST_BLOCK = 128  # centers or queries a block of the distance tables


class Draws:
    """The train step's random draws, from a generator the harness seeds as
    it seeded the program's: each SA level's FPS starts, as
    ``randint(0, N, (B,), int32)``, and each dropout mask, as ``rand(shape)
    < keep``, in the order the forward needs them. ``None`` in place of a
    ``Draws`` starts every cloud at index 0 and draws no mask (eval)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def starts(self, n: int, rows: int, device) -> torch.Tensor:
        return torch.randint(0, n, (rows,), generator=self.generator,
                             dtype=torch.int32, device=device)

    def keep(self, shape, rate: float, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=device) < 1.0 - rate


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, S, 3), (B, N, 3) -> (B, S, N) squared distances, direct form."""
    d = a[:, :, None, :] - b[:, None, :, :]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return (x * x + y * y) + z * z


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device).view(b, *([1] * (idx.dim() - 1)))
    return points[rows, idx.long()]


def fps(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), starts (B,) -> (B, npoint) indices of farthest-point
    sampling: the running minimum of the distances to the picked set from
    1e10, the next pick the first index of its maximum."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    distance = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    farthest = start.long()
    out = torch.empty((b, npoint), dtype=torch.long, device=xyz.device)
    for i in range(npoint):
        out[:, i] = farthest
        d2 = sq_dist(xyz[rows, farthest][:, None, :], xyz)[:, 0]
        distance = torch.minimum(distance, d2)
        farthest = torch.argmax(distance, dim=-1)
    return out


def ball_query(radius: float, k: int, xyz: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The first ``k`` indices within ``radius`` of each center in ascending
    index order, the unfilled slots padded with the first: (B, S, k)."""
    n = xyz.shape[1]
    r2 = float(torch.tensor(radius * radius, dtype=torch.float64).float())
    order = torch.arange(n, device=xyz.device)
    out = []
    for c in centers.split(DIST_BLOCK, dim=1):
        score = torch.where(sq_dist(c, xyz) <= r2, order, n)
        idx = torch.topk(score, k, dim=-1, largest=False, sorted=True).values
        out.append(torch.where(idx == n, idx[..., :1], idx))
    return torch.cat(out, dim=1)


def three_nn(fine: torch.Tensor, coarse: torch.Tensor):
    """The 3 nearest coarse points of each fine one: (B, N, 3) squared
    distances and indices, ties to the lower index."""
    dists, idx = [], []
    for f in fine.split(DIST_BLOCK * 8, dim=1):
        d2, i = torch.sort(sq_dist(f, coarse), dim=-1, stable=True)
        dists.append(d2[..., :3])
        idx.append(i[..., :3])
    return torch.cat(dists, dim=1), torch.cat(idx, dim=1)


def interpolate(feats: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights ``1 / (d2 + 1e-8)``, normalised, over the 3
    neighbours' features."""
    w = 1.0 / (d2 + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    out = gather(feats, idx[..., 0]) * w[..., 0:1]
    for j in (1, 2):
        out = out + gather(feats, idx[..., j]) * w[..., j:j + 1]
    return out


def batch_norm(x: torch.Tensor, w: dict, key: str, train: bool) -> torch.Tensor:
    """BN over the last axis: batch statistics in train mode, running ones
    in eval."""
    if train:
        var, mean = torch.var_mean(x, dim=tuple(range(x.dim() - 1)), correction=0)
    else:
        mean, var = w[f"{key}.running_mean"], w[f"{key}.running_var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * w[f"{key}.weight"] + w[f"{key}.bias"]


def linear(x: torch.Tensor, w: dict, key: str) -> torch.Tensor:
    return F.linear(x, w[f"{key}.weight"], w[f"{key}.bias"])


def mlp(x: torch.Tensor, w: dict, convs: list, bns: list, train: bool,
        pool_dim: Optional[int] = None) -> torch.Tensor:
    """Linear + BN + ReLU layers over the last axis; the max over
    ``pool_dim`` at the end where given."""
    for conv, bn in zip(convs, bns):
        x = torch.relu(batch_norm(linear(x, w, conv), w, bn, train))
    return x if pool_dim is None else x.amax(dim=pool_dim)


def dropout(x: torch.Tensor, rate: float, draws: Optional[Draws]) -> torch.Tensor:
    if draws is None or rate == 0.0:
        return x
    keep = draws.keep(x.shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def centers(xyz: torch.Tensor, npoint: int, draws: Optional[Draws]):
    """FPS centers (B, npoint, 3), each cloud started where ``draws`` says
    (index 0 without draws)."""
    b, n, _ = xyz.shape
    start = (torch.zeros(b, dtype=torch.int32, device=xyz.device) if draws is None
             else draws.starts(n, b, xyz.device))
    return gather(xyz, fps(xyz, npoint, start))


def grouped(xyz, feats, new_xyz, radius, k):
    """``concat(xyz[idx] - center, feats[idx])`` of each center's ball:
    (B, S, k, 3 + D)."""
    idx = ball_query(radius, k, xyz, new_xyz)
    g = gather(xyz, idx) - new_xyz[:, :, None, :]
    return g if feats is None else torch.cat([g, gather(feats, idx)], dim=-1)


def layer_keys(prefix: str, count: int, convs="mlp_convs", bns="mlp_bns"):
    return ([f"{prefix}.{convs}.{i}" for i in range(count)],
            [f"{prefix}.{bns}.{i}" for i in range(count)])


def nll(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean negative log-likelihood over every cloud or point."""
    return -log_probs.gather(-1, labels.long()[..., None]).mean()
