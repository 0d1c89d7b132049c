"""Wrapper of ``csrc/fps.cu``: farthest-point sampling on the card.

Replaces ``pointnet12_tpu/kernels/fps_pallas.py::fps_pallas``. The plain
version is ``ops/fps.py::fps_torch``. ``fps_cuda.launches`` counts the
kernel's launches: one a call, at every N.
"""

import math
from typing import NamedTuple, Optional

import torch

from pointnet12_tpu_torch.kernels import build

THREADS = (32, 64, 128, 256, 512, 1024)  # the kernel's block sizes


def register_slots(threads: int) -> tuple:
    """The register form's instances at ``threads``: points a thread, at 4
    registers a point (x, y, z, the running minimum), up to 8 at 1024
    threads (64 registers a thread), 16 at 512 and 32 below."""
    most = 8 if threads == 1024 else 16 if threads == 512 else 32
    return tuple(s for s in (1, 2, 4, 8, 16, 32) if s <= most)


# the shared form's depth of x, y, z planes a thread count (12 bytes a
# point: 18 x 1024 threads = 221184 of the block's 232448 bytes)
SHARED_SLOTS = {256: 32, 512: 32, 1024: 18}
# the default block size by the most points it takes: the fastest of the
# thread-count sweep of chip_smoke.py's FPS phase on the H100 (PERF.md);
# where two sizes came within 3% of each other, 512 up to 8192 points
DEFAULT_THREADS = ((64, 64), (256, 128), (8192, 512))


class FpsPlan(NamedTuple):
    """One instance of ``fps_kernel``: ``threads`` a cloud, ``slots`` points
    a thread in registers (register form) or the shared form's plane depth
    (``shared``); ``streamed`` slots a thread beyond those, kept in the
    scratch buffer of device memory."""

    threads: int
    slots: int
    shared: bool
    streamed: int


def default_threads(n: int) -> int:
    """The block size for ``n`` points (:data:`DEFAULT_THREADS`; past them
    1024, the shared form's deepest, which streams the fewest slots)."""
    return next((t for most, t in DEFAULT_THREADS if n <= most), 1024)


def fps_plan(n: int, threads: Optional[int] = None) -> FpsPlan:
    """The kernel instance for ``n`` points at ``threads`` a cloud (by
    default :func:`default_threads`): the register form at the fewest
    points a thread that hold ``n``, else the shared form, streaming what
    its planes do not hold."""
    threads = default_threads(n) if threads is None else threads
    if threads not in THREADS:
        raise ValueError(f"fps: threads={threads} must be one of {THREADS}")
    k = math.ceil(n / threads)
    fit = [s for s in register_slots(threads) if s >= k]
    if fit:
        return FpsPlan(threads, fit[0], False, 0)
    if threads not in SHARED_SLOTS:
        raise ValueError(f"fps: {n} points overflow the registers of {threads} threads; "
                         f"the shared form runs {tuple(SHARED_SLOTS)}")
    slots = SHARED_SLOTS[threads]
    return FpsPlan(threads, slots, True, max(0, k - slots))


def fps_cuda(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
             threads: Optional[int] = None) -> torch.Tensor:
    """xyz (B, N, 3) f32, start (B,) i32 -> (B, npoint) i32 on the card, at
    any N. ``threads`` a cloud overrides :func:`default_threads`."""
    B, N, _ = build.check_tensor("fps", "xyz", xyz, torch.float32, (None, None, 3))
    build.check_tensor("fps", "start", start, torch.int32, (B,), xyz.device)
    if not 0 < npoint <= N:
        raise ValueError(f"fps: npoint={npoint} must be in (0, {N}]")
    plan = fps_plan(N, threads)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    # the streamed slots' (x, y, z, running minimum), which the kernel fills
    scratch = (torch.empty((B, plan.streamed, plan.threads, 4), dtype=torch.float32,
                           device=xyz.device) if plan.streamed else None)
    build.launch("fps", xyz.device, xyz.data_ptr(), start.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, N, npoint,
                 plan.threads, plan.slots, int(plan.shared))
    fps_cuda.launches += 1
    return out


fps_cuda.launches = 0
