"""Wrapper of ``csrc/bn_stats.cu``: Dense + BN statistics on the card.

Replaces ``pointnet12_tpu/kernels/bn_stats_fused.py::_pallas_fwd``. Both
dtypes run on the tensor cores (``mma.sync``): bf16 operands as bf16
products, fp32 ones as three TF32 products. The plain version is
``ops/bn_stats.py::dense_bn_stats_torch``; the kernel's statistics are
summed in a fixed order (:func:`stats_in_kernel_order`), so they are the
same bits from run to run. ``dense_bn_stats_cuda.launches`` counts the
launches.
"""

import torch

from pointnet12_tpu_torch.kernels import build

MAX_ITEMS = 2**31 - 1  # the kernel's (row tile, column tile) items, counted in an int
# rows of the kernel's row tile (kMmaRows): the workspace holds ceil(R /
# MMA_ROWS) partials, and csrc/bn_stats.cu refuses another size
MMA_ROWS = 128
WARPS_M = 4  # its warps along the rows, 32 rows each
FINAL_LANES = 128  # lanes a column of the finalize pass (kFinalLanes)


def column_tiles(co: int) -> int:
    """Column tiles of the kernel's items, in either dtype: of 32, 64 or 128
    columns, the least that covers ``co``."""
    bn = 32 if co <= 32 else 64 if co <= 64 else 128
    return -(-co // bn)


def stats_in_kernel_order(y: torch.Tensor):
    """``(mean, var)`` fp32 of ``y (..., Co)`` summed in the kernel's fixed
    order (either dtype), on ``y``'s device, in plain PyTorch fp32 ops (each rounded
    as ``__fadd_rn`` rounds):

    1. a thread sums its 4 rows of a column, rows ``32 wm + g + 8 q`` of
       the row tile (warp ``wm``, ``g = lane / 4``, q = 0..3 in order);
    2. a butterfly of shuffles (lane xor 4, 8, 16) sums the 8 values of
       ``g``: ``((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7))``;
    3. the 4 warps add in order into the row tile's partial, from 0;
    4. the finalize pass: lane ``l`` sums the partials of row tiles ``l,
       l + 128, ...`` in order, lane 0 then the 128 lane sums in order;
       ``mean = sum / R``, ``var = max(sum_sq / R - mean^2, 0)``.

    The same sums over ``y * y`` (rounded) give ``sum_sq``. Rows past ``R``
    add nothing. The kernel's statistics equal these bit for bit."""
    v = y.detach().float().reshape(-1, y.shape[-1])
    r, co = v.shape
    tiles = -(-r // MMA_ROWS)
    pad = torch.zeros((tiles * MMA_ROWS - r, co), dtype=torch.float32, device=v.device)
    out = []
    for vals in (v, v * v):
        t = torch.cat([vals, pad]).reshape(tiles, WARPS_M, 4, 8, co)  # (tile, wm, q, g, c)
        s = torch.zeros((tiles, WARPS_M, 8, co), dtype=torch.float32, device=v.device)
        for q in range(4):
            s = s + t[:, :, q]
        s = s[:, :, 0::2] + s[:, :, 1::2]  # xor 4: g with g ^ 1
        s = s[:, :, 0::2] + s[:, :, 1::2]  # xor 8: with g ^ 2
        s = s[:, :, 0] + s[:, :, 1]        # xor 16: with g ^ 4
        part = torch.zeros((tiles, co), dtype=torch.float32, device=v.device)
        for wm in range(WARPS_M):
            part = part + s[:, wm]
        rounds = -(-tiles // FINAL_LANES)
        part = torch.cat([part, torch.zeros((rounds * FINAL_LANES - tiles, co),
                                            dtype=torch.float32, device=v.device)])
        lanes = torch.zeros((FINAL_LANES, co), dtype=torch.float32, device=v.device)
        for k in range(rounds):
            lanes = lanes + part[k * FINAL_LANES:(k + 1) * FINAL_LANES]
        total = torch.zeros((co,), dtype=torch.float32, device=v.device)
        for lane in range(FINAL_LANES):
            total = total + lanes[lane]
        out.append(total)
    rows = torch.tensor(float(r), dtype=torch.float32, device=v.device)
    mean = out[0] / rows
    return mean, torch.clamp_min(out[1] / rows - mean * mean, 0.0)


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
    tiles = -(-r // MMA_ROWS)
    if r >= 2**31 or tiles * column_tiles(co) > MAX_ITEMS:
        raise ValueError(f"dense_bn_stats: R={r}, Co={co} exceed the kernel's items")
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
