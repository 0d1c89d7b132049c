"""Fixed-K radius neighbourhood search ("ball query").

Counterpart of ``pointnet12_tpu/ops/ballquery.py``, with its semantics,
which are NOT "K nearest within radius": the first ``nsample`` indices in
radius (``d2 <= r^2``) in ascending INDEX order, the unfilled slots padded
with the first of them; a center with no point in radius gets ``N`` in
every slot. On the card ``impl="auto"`` routes by shape alone, as the JAX
package's ``_route`` (:64-70) does: N >= 8192 with N and S multiples of 128
to the voxel-grid kernel (``csrc/ballquery_grid.cu``), every other shape
to the index-order scan (``csrc/ballquery.cu``, which stands in for both
of JAX's other kernels). The 8192 crossover was measured on the TPU; the
card's own curve is in PERF.md, and the choice it calls for is ROADMAP
Queue 1's first item.
"""

import numpy as np
import torch

from pointnet12_tpu_torch.kernels import dispatch
from pointnet12_tpu_torch.ops.distance import square_distance

GRID_MIN_N = 8192


def _route(n: int, s: int) -> str:
    """The card's kernel for an (N, S) shape: ``"grid"`` or ``"scan"``."""
    if n >= GRID_MIN_N and n % 128 == 0 and s % 128 == 0:
        return "grid"
    return "scan"


def ballquery_torch(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Plain version, mirror of ``_ballquery_jnp``: score each point by its
    index if in radius and by ``N`` if not, and keep the ``nsample``
    smallest scores. -> (B, S, nsample) int32."""
    N = xyz.shape[1]
    if nsample > N:
        raise ValueError(f"nsample={nsample} exceeds the {N} points")
    sqrdists = square_distance(new_xyz, xyz)  # (B, S, N)
    r2 = float(np.float32(radius * radius))
    idx = torch.arange(N, dtype=torch.int32, device=xyz.device)
    score = torch.where(sqrdists <= r2, idx, torch.full_like(idx, N))
    group_idx = torch.topk(score, nsample, dim=-1, largest=False,
                           sorted=True).values  # ascending, N = padding
    first = group_idx[..., :1]
    return torch.where(group_idx == N, first, group_idx)


def query_ball_point(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Indices of up to ``nsample`` points of ``xyz (B, N, 3)`` within
    ``radius`` of each center of ``new_xyz (B, S, 3)``: (B, S, nsample)
    int32."""
    if dispatch.resolve(impl, xyz) == "cuda":
        xyz, new_xyz = xyz.float().contiguous(), new_xyz.float().contiguous()
        if _route(xyz.shape[1], new_xyz.shape[1]) == "grid":
            from pointnet12_tpu_torch.kernels.grid_cuda import ballquery_grid_cuda

            return ballquery_grid_cuda(radius, nsample, xyz, new_xyz)
        from pointnet12_tpu_torch.kernels.ballquery_cuda import ballquery_cuda

        return ballquery_cuda(radius, nsample, xyz, new_xyz)
    return ballquery_torch(radius, nsample, xyz, new_xyz)
