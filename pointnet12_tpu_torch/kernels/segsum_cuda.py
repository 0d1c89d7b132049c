"""Wrapper of ``csrc/segsum.cu``: the weighted segment sum on the card.

Replaces ``pointnet12_tpu/kernels/segsum_pallas.py::segment_matmul_pallas``
with a scatter-add of fp32 vector atomics (the entry point zeroes the
output itself), so the sums' order, and their last bits, vary from run to
run. The plain version is ``ops/segsum.py::segment_matmul_torch``.
``segment_matmul_cuda.launches`` counts the kernel's launches.
"""

from typing import Optional

import torch

from pointnet12_tpu_torch.kernels import build

MAX_BATCH = 65535  # the kernel puts the batch on gridDim.y


def segment_matmul_cuda(
    idx: torch.Tensor,
    weights: Optional[torch.Tensor],
    values: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """idx (B, J, R) i32, weights (B, J, R) f32 or None, values (B, R, C)
    f32 -> (B, num_segments, C) f32; rows indexed outside
    ``[0, num_segments)`` add nothing."""
    B, J, R = build.check_tensor(
        "segment_matmul", "idx", idx, torch.int32, (None, None, None)
    )
    if weights is not None:
        build.check_tensor(
            "segment_matmul", "weights", weights, torch.float32, (B, J, R),
            idx.device,
        )
    _, _, C = build.check_tensor(
        "segment_matmul", "values", values, torch.float32, (B, R, None),
        idx.device,
    )
    if num_segments <= 0:
        raise ValueError(f"segment_matmul: num_segments={num_segments} must be positive")
    if B > MAX_BATCH:
        raise ValueError(f"segment_matmul: the kernel supports B <= {MAX_BATCH}")
    if B == 0 or J == 0 or R == 0 or C == 0:
        return torch.zeros((B, num_segments, C), dtype=torch.float32, device=idx.device)
    out = torch.empty((B, num_segments, C), dtype=torch.float32, device=idx.device)
    build.launch(
        "segment_matmul", idx.device, idx.data_ptr(),
        None if weights is None else weights.data_ptr(), values.data_ptr(),
        out.data_ptr(), B, J, R, num_segments, C,
    )
    segment_matmul_cuda.launches += 1
    return out


segment_matmul_cuda.launches = 0
