"""Wrapper of ``csrc/threenn.cu``: 3-nearest-neighbour search on the card.

Replaces ``pointnet12_tpu/kernels/threenn_pallas.py::three_nn_pallas``
(its default direct form; the ``mxu`` variant is not ported). The plain
version is ``ops/interpolate.py::three_nn_torch``;
:func:`three_nn_in_plan_order` is the kernel's own order (each range's
best three, then the merge) in plain ops. ``three_nn_cuda.launches``
counts the kernel's launches.
"""

import functools
from typing import NamedTuple, Optional

import torch

from pointnet12_tpu_torch.kernels import build, ranges as range_layout

# warps a launch aims at (16 an SM): the fastest of chip_smoke.py's plan
# sweep at the slice shapes on the H100 (PERF.md)
WARPS = 2048


class ThreeNNPlan(NamedTuple):
    """One launch of ``three_nn_kernel``: a query a lane, the references in
    ``ranges`` ranges of ``length`` (one warp a range), ``groups`` groups of
    32 lanes a block, tiles of ``chunk`` references a range,
    ``shared_bytes`` of shared memory."""

    ranges: int
    groups: int
    length: int
    chunk: int
    shared_bytes: int


@functools.lru_cache(maxsize=None)  # a pure function of the shape, on every call
def three_nn_plan(b: int, n: int, m: int, ranges: Optional[int] = None) -> ThreeNNPlan:
    """The launch for B clouds of ``n`` queries and ``m`` references: the
    fewest ranges that make :data:`WARPS` warps
    (:func:`ranges.default_ranges`), unless given."""
    warp_groups = b * -(-n // 32)
    ranges = range_layout.default_ranges(m, warp_groups, WARPS) if ranges is None else ranges
    groups = range_layout.default_groups(ranges, warp_groups)
    length, chunk = range_layout.layout(m, ranges, groups)
    # the tile; with several ranges the candidates' d2 and index planes
    cand = 2 * ranges * 3 * groups * 32 * 4 if ranges > 1 else 0
    return ThreeNNPlan(ranges, groups, length, chunk, ranges * chunk * 16 + cand)


def three_nn_in_plan_order(query_xyz: torch.Tensor, ref_xyz: torch.Tensor,
                           plan: ThreeNNPlan):
    """The kernel's order in plain ops: each range's best three in the
    sequential scan's order (the smallest direct-form distances, rounded
    after every operation, ties to the lower index; a distance that is not
    below +inf never enters, its slot holding (+inf, M)), then the ranges'
    candidates ordered by (d2, index). -> (d2 (B, N, 3), idx (B, N, 3) i32)."""
    M = ref_xyz.shape[1]
    d = query_xyz[:, :, None, :] - ref_xyz[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    inf = torch.tensor(float("inf"))
    cand_d, cand_i = [], []
    for lo in range(0, M, plan.length):
        seg = d2[..., lo:lo + plan.length]
        keyed = torch.where(seg < inf, seg, inf)
        vals, pos = torch.sort(keyed, dim=-1, stable=True)
        vals, pos = vals[..., :3], pos[..., :3] + lo
        pad = 3 - vals.shape[-1]  # a range of fewer than 3 references
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("inf"))
        pos = torch.nn.functional.pad(pos, (0, pad), value=M)
        cand_d.append(vals)
        cand_i.append(torch.where(vals < inf, pos, M))
    cd, ci = torch.cat(cand_d, -1), torch.cat(cand_i, -1)
    # by (d2, index): the index order first, then a stable sort by d2
    by_index = torch.argsort(ci, dim=-1, stable=True)
    cd, ci = cd.gather(-1, by_index), ci.gather(-1, by_index)
    by_d = torch.argsort(cd, dim=-1, stable=True)[..., :3]
    return cd.gather(-1, by_d), ci.gather(-1, by_d).to(torch.int32)


def three_nn_cuda(query_xyz: torch.Tensor, ref_xyz: torch.Tensor,
                  plan: Optional[ThreeNNPlan] = None):
    """query (B, N, 3), ref (B, M, 3) f32, M >= 3 ->
    (d2 (B, N, 3) f32 ascending, idx (B, N, 3) i32), at ``plan`` (by
    default :func:`three_nn_plan`)."""
    B, N, _ = build.check_tensor(
        "three_nn", "query_xyz", query_xyz, torch.float32, (None, None, 3)
    )
    _, M, _ = build.check_tensor(
        "three_nn", "ref_xyz", ref_xyz, torch.float32, (B, None, 3),
        query_xyz.device,
    )
    if M < 3:
        raise ValueError(f"three_nn: needs M >= 3 reference points, got {M}")
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=query_xyz.device)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=query_xyz.device)
    if B == 0 or N == 0:
        return dist, idx
    plan = three_nn_plan(B, N, M) if plan is None else plan
    build.launch("three_nn", query_xyz.device, query_xyz.data_ptr(),
                 ref_xyz.data_ptr(), dist.data_ptr(), idx.data_ptr(), B, N, M,
                 plan.ranges, plan.groups, plan.length, plan.chunk.bit_length() - 1,
                 plan.shared_bytes)
    three_nn_cuda.launches += 1
    return dist, idx


three_nn_cuda.launches = 0
