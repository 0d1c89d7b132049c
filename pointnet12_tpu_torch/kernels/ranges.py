"""The range layout of ``csrc/ranges.cuh``, shared by the plans of the ball
query (``ballquery_cuda.py``) and the 3-NN search (``threenn_cuda.py``).

A cloud of ``n`` points is split into ``ranges`` contiguous index ranges of
``length = ceil(n / ranges)`` points, one warp a range; a block holds
``groups`` groups of 32 lanes (one warp a range each) and stages every
range in tiles of ``chunk`` points (a power of two, at least 32).
"""

import math

SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SHARED_BYTES = 232448  # a block's dynamic shared memory on sm_90
# the most a block may take with two blocks an SM: the SM's 233472 bytes
# less 1024 reserved a block, halved
TWO_BLOCKS_BYTES = 233472 // 2 - 1024
MAX_WARPS = 16  # ranges * groups, csrc/ranges.cuh::kMaxRangeThreads / 32
MIN_RANGE = 32  # points a range, where the cloud holds enough
TILE_BYTES = 64 * 1024  # the staged tile of all ranges, 16 bytes a point


def pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def default_ranges(n: int, warp_groups: int, warps: int) -> int:
    """The fewest ranges (a power of two, at most 16, each of at least
    :data:`MIN_RANGE` points) that put ``warps`` warps on the card for
    ``warp_groups`` groups of 32 lanes, else the most allowed."""
    ranges = 1
    while (ranges < MAX_WARPS and n // (2 * ranges) >= MIN_RANGE
           and warp_groups * ranges < warps):
        ranges *= 2
    return ranges


def default_groups(ranges: int, warp_groups: int) -> int:
    """Groups a block: one, or more where a range alone would make blocks
    of fewer than 4 warps and the launch still holds two blocks an SM."""
    groups = 1
    while groups * ranges < 4 and warp_groups // (2 * groups) >= 2 * SMS:
        groups *= 2
    return groups


def layout(n: int, ranges: int, groups: int) -> tuple:
    """``(length, chunk)`` of ``n`` points in ``ranges`` ranges: the whole
    range in one tile where :data:`TILE_BYTES` hold it, else the largest
    power of two that fits."""
    if not (1 <= ranges and 1 <= groups and ranges * groups <= MAX_WARPS):
        raise ValueError(f"ranges={ranges} x groups={groups} must be 1..{MAX_WARPS} warps")
    length = math.ceil(n / ranges)
    fit = pow2_floor(TILE_BYTES // (16 * ranges))
    chunk = max(32, min(1 << (length - 1).bit_length(), fit))
    return length, chunk
