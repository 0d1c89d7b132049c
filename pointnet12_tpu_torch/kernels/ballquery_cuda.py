"""Wrapper of ``csrc/ballquery.cu``: ball query on the card.

Replaces both Pallas ball-query kernels of the serving path,
``pointnet12_tpu/kernels/ballquery_bitmask.py::ballquery_bitmask`` and
``pointnet12_tpu/kernels/ballquery_pallas.py::ballquery_pallas``: one
kernel serves every shape that ``ops/ballquery.py::_route`` does not send
to the grid kernel (``kernels/grid_cuda.py``). The plain version is
``ops/ballquery.py::ballquery_torch``. ``ballquery_cuda.launches`` counts
the kernel's launches.
"""

import numpy as np
import torch

from pointnet12_tpu_torch.kernels import build


def ballquery_cuda(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, S, 3) f32 -> (B, S, nsample) i32."""
    B, N, _ = build.check_tensor(
        "ballquery", "xyz", xyz, torch.float32, (None, None, 3)
    )
    _, S, _ = build.check_tensor(
        "ballquery", "new_xyz", new_xyz, torch.float32, (B, None, 3), xyz.device
    )
    if nsample <= 0:
        raise ValueError(f"ballquery: nsample={nsample} must be positive")
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    if B == 0 or S == 0:
        return out
    if N == 0:
        raise ValueError("ballquery: xyz holds no points")
    # radius * radius in double, rounded to f32 once: the value the JAX
    # package compares against
    r2 = float(np.float32(radius * radius))
    build.launch("ballquery", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
                 out.data_ptr(), B, N, S, nsample, r2)
    ballquery_cuda.launches += 1
    return out


ballquery_cuda.launches = 0
