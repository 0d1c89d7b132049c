"""Wrapper of ``csrc/fps.cu``: farthest-point sampling on the card.

Replaces ``pointnet12_tpu/kernels/fps_pallas.py::fps_pallas``. The plain
version is ``ops/fps.py::fps_torch``. ``fps_cuda.launches`` counts the
kernel's launches.
"""

import torch

from pointnet12_tpu_torch.kernels import build

MAX_POINTS = 8192  # kMaxPerThread * kMaxThreads in csrc/fps.cu


def fps_cuda(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3) f32, start (B,) i32 -> (B, npoint) i32 on the card."""
    B, N, _ = build.check_tensor("fps", "xyz", xyz, torch.float32, (None, None, 3))
    build.check_tensor("fps", "start", start, torch.int32, (B,), xyz.device)
    if N > MAX_POINTS:
        raise ValueError(f"fps: the kernel supports N <= {MAX_POINTS}, got {N}")
    if not 0 < npoint <= N:
        raise ValueError(f"fps: npoint={npoint} must be in (0, {N}]")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    build.launch("fps", xyz.device, xyz.data_ptr(), start.data_ptr(),
                 out.data_ptr(), B, N, npoint)
    fps_cuda.launches += 1
    return out


fps_cuda.launches = 0
