"""Wrappers of ``csrc/fused_sa.cu``: a whole eval set-abstraction layer
(ball query, gather, BN-folded MLP chain, K-max) in one kernel, on the card.

``fused_sa_eval_dense_cuda`` replaces
``pointnet12_tpu/kernels/fused_sa_eval.py::fused_sa_eval_dense`` and
``fused_sa_eval_grid_cuda`` replaces ``::fused_sa_eval_grid``; both have
the plain version ``ops/fused_sa.py::fused_sa_eval_torch``.
``<wrapper>.launches`` counts each kernel's launches.
"""

import ctypes

import numpy as np
import torch

from pointnet12_tpu_torch.kernels import build
from pointnet12_tpu_torch.kernels import grid_cuda
from pointnet12_tpu_torch.ops.grid import G

MAX_LAYERS = 8  # kMaxLayers in csrc/fused_sa.cu


def _operands(name, radius, nsample, xyz, new_xyz, w, t, layers):
    """Check the operands; returns ``(out, (B, N, S), r2, (weights, biases,
    widths))``: the output allocated, the sizes, r^2 rounded to f32, and the
    ctypes arrays of the layers' device pointers and of the widths
    ``(C1, Co_1, ..., Co_L)``, which the caller keeps until the launch."""
    B, N, _ = build.check_tensor(name, "xyz", xyz, torch.float32, (None, None, 3))
    dev = xyz.device
    _, S, _ = build.check_tensor(name, "new_xyz", new_xyz, torch.float32, (B, None, 3), dev)
    _, _, c1 = build.check_tensor(name, "w", w, torch.float32, (B, N, None), dev)
    build.check_tensor(name, "t", t, torch.float32, (B, S, c1), dev)
    if not 0 < len(layers) <= MAX_LAYERS:
        raise ValueError(f"{name}: {len(layers)} layers, the kernel takes 1 to {MAX_LAYERS}")
    widths = [c1]
    for i, (kernel, bias) in enumerate(layers):
        _, co = build.check_tensor(
            name, f"layers[{i}] kernel", kernel, torch.float32, (widths[-1], None), dev
        )
        build.check_tensor(name, f"layers[{i}] bias", bias, torch.float32, (co,), dev)
        widths.append(co)
    if nsample <= 0 or B == 0 or N == 0 or S == 0 or 0 in widths:
        raise ValueError(f"{name}: nsample={nsample}, B={B}, N={N}, S={S}, widths={widths}")
    arrays = (
        (ctypes.c_void_p * len(layers))(*(k.data_ptr() for k, _ in layers)),
        (ctypes.c_void_p * len(layers))(*(b.data_ptr() for _, b in layers)),
        (ctypes.c_int * len(widths))(*widths),
    )
    out = torch.empty((B, S, widths[-1]), dtype=torch.float32, device=dev)
    # radius * radius in double, rounded to f32 once, as ballquery_cuda
    r2 = float(np.float32(radius * radius))
    return out, (B, N, S), r2, arrays


def fused_sa_eval_dense_cuda(radius, nsample, xyz, new_xyz, w, t, layers):
    """xyz (B, N, 3), new_xyz (B, S, 3), w (B, N, C1), t (B, S, C1) and
    ``layers``, a sequence of (kernel (Ci, Co), bias (Co,)), all f32 and
    contiguous -> (B, S, C_out) f32. The neighbours come from a scan of all
    N points in index order."""
    name = "fused_sa_eval_dense"
    out, (B, N, S), r2, (weights, biases, widths) = _operands(
        name, radius, nsample, xyz, new_xyz, w, t, layers
    )
    build.launch(
        "fused_sa_dense", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(), w.data_ptr(),
        t.data_ptr(), weights, biases, widths, len(layers), out.data_ptr(),
        B, N, S, nsample, r2,
    )
    fused_sa_eval_dense_cuda.launches += 1
    return out


fused_sa_eval_dense_cuda.launches = 0


def fused_sa_eval_grid_cuda(radius, nsample, xyz, new_xyz, w, t, layers):
    """As :func:`fused_sa_eval_dense_cuda`, the neighbours from the 27
    cells around each center of ``kernels/grid_cuda.py::grid_prep_cuda``'s
    grid."""
    name = "fused_sa_eval_grid"
    out, (B, N, S), r2, (weights, biases, widths) = _operands(
        name, radius, nsample, xyz, new_xyz, w, t, layers
    )
    grid = grid_cuda.grid_prep_cuda(radius, xyz, new_xyz)
    build.launch(
        "fused_sa_grid", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(), w.data_ptr(),
        t.data_ptr(), weights, biases, widths, len(layers), grid.ptr("perm"),
        grid.ptr("offsets"), grid.ptr("qperm"), grid.ptr("sqkey"),
        out.data_ptr(), B, N, S, nsample, G, r2,
    )
    fused_sa_eval_grid_cuda.launches += 1
    return out


fused_sa_eval_grid_cuda.launches = 0
