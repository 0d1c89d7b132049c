"""Wrapper of ``csrc/bn_stats.cu``: Dense + BN statistics on the card.

Replaces ``pointnet12_tpu/kernels/bn_stats_fused.py::_pallas_fwd``. The
plain version is ``ops/bn_stats.py::dense_bn_stats_torch``; the kernel's
statistics are summed in a fixed order, so they are the same from run to
run. ``dense_bn_stats_cuda.launches`` counts the launches.
"""

import torch

from pointnet12_tpu_torch.kernels import build

MAX_COLUMN_TILES = 65535  # the kernel puts the column tiles on gridDim.y


def row_tile(co: int) -> int:
    """Rows of ``x`` per block: 64 when the block covers 64 output columns
    (``co % 64 == 0``), else 128 with 32 columns (4096 outputs a block).
    ``csrc/bn_stats.cu`` applies the same rule and refuses a workspace of
    another size."""
    return 64 if co % 64 == 0 else 128


def dense_bn_stats_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """x (..., Ci) f32 or bf16, weight (Co, Ci) in x's dtype, bias (Co,) f32
    -> ``(y (..., Co)`` in x's dtype, ``mean (Co,)``, ``var (Co,)`` f32):
    ``y = round(x @ weight.T) + round(bias)``, the biased one-pass
    statistics of the rounded ``y`` over every leading axis."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dense_bn_stats: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"dense_bn_stats: x must have rows, got shape {tuple(x.shape)}")
    shape = build.check_tensor("dense_bn_stats", "x", x, x.dtype, (None,) * x.dim())
    ci = shape[-1]
    co, _ = build.check_tensor(
        "dense_bn_stats", "weight", weight, x.dtype, (None, ci), x.device
    )
    build.check_tensor("dense_bn_stats", "bias", bias, torch.float32, (co,), x.device)
    r = x.numel() // ci if ci else 0
    if r == 0 or ci == 0 or co == 0:
        raise ValueError(f"dense_bn_stats: empty operands x {shape}, weight {(co, ci)}")
    if r >= 2**31 or -(-co // (4096 // row_tile(co))) > MAX_COLUMN_TILES:
        raise ValueError(f"dense_bn_stats: R={r}, Co={co} exceed the kernel's grid")
    tiles = -(-r // row_tile(co))
    y = torch.empty(shape[:-1] + (co,), dtype=x.dtype, device=x.device)
    partials = torch.empty((tiles, 2, co), dtype=torch.float32, device=x.device)
    mean = torch.empty((co,), dtype=torch.float32, device=x.device)
    var = torch.empty((co,), dtype=torch.float32, device=x.device)
    build.launch(
        "dense_bn_stats", x.device, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), partials.data_ptr(), mean.data_ptr(), var.data_ptr(), r, ci, co,
        tiles, int(x.dtype == torch.bfloat16),
    )
    dense_bn_stats_cuda.launches += 1
    return y, mean, var


dense_bn_stats_cuda.launches = 0
