"""Wrapper of ``csrc/ballquery.cu``: ball query on the card.

Replaces both Pallas ball-query kernels of the serving path,
``pointnet12_tpu/kernels/ballquery_bitmask.py::ballquery_bitmask`` and
``pointnet12_tpu/kernels/ballquery_pallas.py::ballquery_pallas``: one
kernel serves every shape that ``ops/ballquery.py::_route`` does not send
to the grid kernel (``kernels/grid_cuda.py``). The plain version is
``ops/ballquery.py::ballquery_torch``; :func:`first_k_in_plan_order` is the
kernel's own order (per-range lists, then the merge) in plain ops.
``ballquery_cuda.launches`` counts the kernel's launches.
"""

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from pointnet12_tpu_torch.kernels import build, ranges as range_layout


# the kernel's instances: centers a lane, or 0 for a warp a center (the
# ballot scan of csrc/neighbours.cuh, no staging and no merge)
PER_LANE = (0, 1, 2)
# the defaults, the fastest of chip_smoke.py's plan sweep at the slice
# shapes on the H100 (PERF.md): a warp a center up to this many points (the
# model's last two levels), two centers a lane from this many centers a launch
# (its first level), and the warps a launch aims at
WARP_FORM_MAX_N = 256
TWO_PER_LANE_FROM = 16384
WARPS = 4096
MODEL_PAIRS = 2**25  # (center, point) pairs first_k_in_plan_order takes at once


class BallQueryPlan(NamedTuple):
    """One launch of ``ballquery_kernel``: ``per_lane`` centers a lane, the
    points in ``ranges`` ranges of ``length`` (one warp a range), ``groups``
    groups of 32 lanes a block, tiles of ``chunk`` points a range,
    ``shared_bytes`` of shared memory; ``scratch`` when the per-(center,
    range) lists live in device memory. ``per_lane`` 0 is the form for tiny
    clouds, a warp a center over one range of all ``length`` points."""

    per_lane: int
    ranges: int
    groups: int
    length: int
    chunk: int
    shared_bytes: int
    scratch: bool


@functools.lru_cache(maxsize=None)  # a pure function of the shape, on every call
def ballquery_plan(b: int, n: int, s: int, k: int, per_lane: Optional[int] = None,
                   ranges: Optional[int] = None) -> BallQueryPlan:
    """The launch for B clouds of ``n`` points, ``s`` centers each and
    ``k`` slots, unless ``per_lane`` or ``ranges`` are given: a warp a
    center up to :data:`WARP_FORM_MAX_N` points; else two centers a lane
    from :data:`TWO_PER_LANE_FROM` centers, one below, and the fewest
    ranges that make :data:`WARPS` warps (:func:`ranges.default_ranges`);
    the lists in shared memory where the block still leaves room for a
    second one on its SM, else in a scratch buffer."""
    if per_lane is None:
        per_lane = (0 if n <= WARP_FORM_MAX_N and ranges is None
                    else 2 if b * s >= TWO_PER_LANE_FROM else 1)
    if per_lane not in PER_LANE:
        raise ValueError(f"ballquery: per_lane={per_lane} must be one of {PER_LANE}")
    if per_lane == 0:
        if ranges not in (None, 1):
            raise ValueError("ballquery: a warp a center scans one range")
        return BallQueryPlan(0, 1, 1, n, 32, 0, False)
    warp_groups = b * -(-s // (32 * per_lane))
    ranges = range_layout.default_ranges(n, warp_groups, WARPS) if ranges is None else ranges
    groups = range_layout.default_groups(ranges, warp_groups)
    length, chunk = range_layout.layout(n, ranges, groups)
    lanes = groups * per_lane * ranges * 32  # (center, range) pairs a block
    # the tile (then the block's rows), the counts
    shared = max(ranges * chunk * 16, groups * per_lane * 32 * (k | 1) * 4) + lanes * 4
    lists = lanes * (k | 1) * 4
    scratch = shared + lists > range_layout.TWO_BLOCKS_BYTES
    return BallQueryPlan(per_lane, ranges, groups, length, chunk,
                         shared + (0 if scratch else lists), scratch)


def first_k_in_plan_order(xyz: torch.Tensor, centers: torch.Tensor, r2: float,
                          k: int, plan: BallQueryPlan) -> torch.Tensor:
    """The kernel's order in plain ops: each range's list of its first
    ``k`` in-radius indices (``d2 <= r2``, direct-form distances rounded
    after every operation), the lists concatenated in range order, the
    first ``k`` kept and the rest padded with the first (``N`` for an
    empty center). ``r2`` is the f32 value the kernel compares with.
    -> (B, S, k) int32."""
    B, N, _ = xyz.shape
    S = centers.shape[1]
    step = max(1, MODEL_PAIRS // (B * N))  # centers at a time: (B, step, N, 3) differences
    if S > step:
        return torch.cat([first_k_in_plan_order(xyz, centers[:, i:i + step], r2, k, plan)
                          for i in range(0, S, step)], dim=1)
    d = centers[:, :, None, :] - xyz[:, None, :, :]
    hit = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2] <= r2
    merged = torch.zeros((B, S, k), dtype=torch.int64, device=xyz.device)
    filled = torch.zeros((B, S), dtype=torch.int64, device=xyz.device)
    first = torch.full((B, S), N, dtype=torch.int64, device=xyz.device)
    for lo in range(0, N, plan.length):
        h = hit[..., lo:lo + plan.length]
        rank = h.cumsum(-1) - 1  # each hit's slot in its range's list
        count = h.sum(-1).clamp(max=k)
        slot = filled[..., None] + rank
        bi, si, ji = (h & (rank < k) & (slot < k)).nonzero(as_tuple=True)
        merged[bi, si, slot[bi, si, ji]] = lo + ji
        first = torch.where((first == N) & (count > 0), lo + h.int().argmax(-1), first)
        filled += count
    slots = torch.arange(k, device=xyz.device)
    return torch.where(slots < filled[..., None], merged, first[..., None]).to(torch.int32)


def ballquery_cuda(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
    plan: Optional[BallQueryPlan] = None,
) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, S, 3) f32 -> (B, S, nsample) i32, at
    ``plan`` (by default :func:`ballquery_plan`)."""
    B, N, _ = build.check_tensor(
        "ballquery", "xyz", xyz, torch.float32, (None, None, 3)
    )
    _, S, _ = build.check_tensor(
        "ballquery", "new_xyz", new_xyz, torch.float32, (B, None, 3), xyz.device
    )
    if not 0 < nsample <= N:
        raise ValueError(f"ballquery: nsample={nsample} must be in (0, N={N}]")
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    if B == 0 or S == 0:
        return out
    plan = ballquery_plan(B, N, S, nsample) if plan is None else plan
    scratch = (torch.empty(B * -(-S // 32) * plan.ranges * 32 * (nsample | 1),
                           dtype=torch.int32, device=xyz.device)
               if plan.scratch else None)
    # radius * radius in double, rounded to f32 once: the value the JAX
    # package compares against
    r2 = float(np.float32(radius * radius))
    build.launch("ballquery", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
                 out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 B, N, S, nsample, r2, plan.per_lane, plan.ranges, plan.groups, plan.length,
                 plan.chunk.bit_length() - 1, plan.shared_bytes)
    ballquery_cuda.launches += 1
    return out


ballquery_cuda.launches = 0
