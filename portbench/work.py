"""The yardstick's peaks and work counters.

Frozen from ``chip_smoke.py`` at commit 529a356 (``HBM_BYTES_PER_S``,
``FP32_OPS_PER_S``, ``TF32_OPS_PER_S``, ``BF16_OPS_PER_S``, ``bound``,
``serve_work``, ``segsum_work``), reshaped to count one call from its own
arguments. Each counter gives ``(bytes, ops)``: every input read once and
every output written once, and the operations these inputs need.

One change from ``chip_smoke.py``: the ball query's pairs are those the
first-K search in index order needs on these inputs (each center up to its
K-th hit), not rounded up to the scan's warps of 32, which is how one
kernel reads them rather than what the inputs need.
"""

import torch

# one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet; dense rates)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12


def least_seconds(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least time the card could take to move ``nbytes`` through its
    memory and do ``ops`` operations: the larger of the two times."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def fps_work(b: int, n: int, npoint: int):
    """FPS: the cloud and the starts read, the indices written; ``npoint``
    passes over every point, ~10 ops a point (3 sub, 3 mul, 2 add, the
    running min, the argmax compare)."""
    return b * n * 12 + b * 4 + b * npoint * 4, 10 * b * npoint * n


def reached_pairs(radius: float, k: int, xyz: torch.Tensor, centers: torch.Tensor) -> int:
    """Pairs a first-K ball query in index order needs on these clouds: each
    center tests points in index order up to its K-th hit (all N where it
    has fewer). Distances in the direct form against ``float32(radius**2)``,
    the kernels' test."""
    n = xyz.shape[1]
    r2 = float(torch.tensor(radius * radius, dtype=torch.float64).float())
    total = 0
    for c in centers.split(64, dim=1):  # bounded memory at any S
        d = c[:, :, None, :].float() - xyz[:, None, :, :].float()
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        found = (d2 <= r2).cumsum(-1, dtype=torch.int32)
        total += int(((found < k).sum(-1) + 1).clamp(max=n).sum())
    return total


def ballquery_work(radius: float, k: int, xyz: torch.Tensor, centers: torch.Tensor):
    """Ball query: both clouds read, the (B, S, K) indices written; 9 ops a
    reached pair (3 sub, 3 mul, 2 add, the compare)."""
    b, n = xyz.shape[:2]
    s = centers.shape[1]
    return b * (n + s) * 12 + b * s * k * 4, 9 * reached_pairs(radius, k, xyz, centers)


def three_nn_work(b: int, n: int, s: int):
    """3-NN of ``n`` query points among ``s``: both clouds read, 3 distances
    and 3 indices a query written; every pair, 9 ops for the distance and
    one compare."""
    return b * (n + s) * 12 + b * n * 3 * 8, 10 * b * n * s


def segsum_work(b: int, j: int, r: int, c: int, m: int, weighted: bool):
    """One segment sum: values, indices and weights read once, the (B, M, C)
    output written once; a multiply-add per element and contribution (an
    add when unweighted)."""
    nbytes = 4 * (b * r * c + b * j * r * (2 if weighted else 1) + b * m * c)
    return nbytes, (2 if weighted else 1) * b * j * r * c
