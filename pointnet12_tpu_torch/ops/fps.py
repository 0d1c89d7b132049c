"""Farthest-point sampling (FPS).

Counterpart of ``pointnet12_tpu/ops/fps.py``: iteratively pick ``npoint``
seeds maximising the minimum distance to the picked set. The running-min
distance starts at 1e10 and argmax ties go to the first (lowest) index.
"""

from typing import Optional

import torch

from pointnet12_tpu_torch.kernels import dispatch


def fps_torch(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """Plain version, mirror of ``_fps_jnp``: xyz (B, N, 3), start (B,) int
    -> (B, npoint) int32. The distances use the direct form
    ``(dx*dx + dy*dy) + dz*dz``, the order of the kernel and of the JAX
    twin, so all three give the same indices."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    rows = torch.arange(B, device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    farthest = start.long()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = farthest
        d = xyz - xyz[rows, farthest][:, None, :]
        d = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        distance = torch.minimum(distance, d)
        farthest = torch.argmax(distance, dim=-1)  # first index of the max
    return out


def farthest_point_sample(
    xyz: torch.Tensor,
    npoint: int,
    *,
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Sample ``npoint`` indices of ``xyz (B, N, 3)`` by FPS. With no
    ``generator`` every cloud starts at index 0 (the JAX package's
    ``key=None``); a generator on ``xyz``'s device draws each cloud's start
    uniformly from ``[0, N)`` (its ``fps_key``). Returns ``(B, npoint)``
    int32. A CUDA tensor goes to the kernel (``kernels/fps_cuda.py``) at
    every N, a CPU tensor to :func:`fps_torch`."""
    B, N, _ = xyz.shape
    if not 0 < npoint <= N:
        raise ValueError(f"npoint={npoint} must be in (0, {N}]")
    if generator is None:
        start = torch.zeros(B, dtype=torch.int32, device=xyz.device)
    else:
        start = torch.randint(
            0, N, (B,), generator=generator, dtype=torch.int32, device=xyz.device
        )
    if dispatch.resolve(impl, xyz) == "cuda":
        from pointnet12_tpu_torch.kernels.fps_cuda import fps_cuda

        return fps_cuda(xyz.float().contiguous(), npoint, start)
    return fps_torch(xyz, npoint, start)
