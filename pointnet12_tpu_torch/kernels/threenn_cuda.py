"""Wrapper of ``csrc/threenn.cu``: 3-nearest-neighbour search on the card.

Replaces ``pointnet12_tpu/kernels/threenn_pallas.py::three_nn_pallas``
(its default direct form; the ``mxu`` variant is not ported). The plain
version is ``ops/interpolate.py::three_nn_torch``.
``three_nn_cuda.launches`` counts the kernel's launches.
"""

import torch

from pointnet12_tpu_torch.kernels import build

MAX_BATCH = 65535  # the kernel puts the batch on gridDim.y


def three_nn_cuda(query_xyz: torch.Tensor, ref_xyz: torch.Tensor):
    """query (B, N, 3), ref (B, M, 3) f32, M >= 3 ->
    (d2 (B, N, 3) f32 ascending, idx (B, N, 3) i32)."""
    B, N, _ = build.check_tensor(
        "three_nn", "query_xyz", query_xyz, torch.float32, (None, None, 3)
    )
    _, M, _ = build.check_tensor(
        "three_nn", "ref_xyz", ref_xyz, torch.float32, (B, None, 3),
        query_xyz.device,
    )
    if M < 3:
        raise ValueError(f"three_nn: needs M >= 3 reference points, got {M}")
    if B > MAX_BATCH:
        raise ValueError(f"three_nn: the kernel supports B <= {MAX_BATCH}")
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=query_xyz.device)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=query_xyz.device)
    if B == 0 or N == 0:
        return dist, idx
    build.launch("three_nn", query_xyz.device, query_xyz.data_ptr(),
                 ref_xyz.data_ptr(), dist.data_ptr(), idx.data_ptr(), B, N, M)
    three_nn_cuda.launches += 1
    return dist, idx


three_nn_cuda.launches = 0
