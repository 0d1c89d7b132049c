"""Wrappers of ``csrc/grid_prep.cu`` and ``csrc/ballquery_grid.cu``: the
voxel grid and the ball query through it, on the card.

``grid_prep_cuda`` replaces ``pointnet12_tpu/kernels/ballquery_grid.py::
_cell_offsets`` together with the XLA prep around it (``::grid_prep``,
:242-315), in one launch; its plain version is ``ops/grid.py::
grid_prep_torch``. ``ballquery_grid_cuda`` replaces ``::ballquery_grid``
(plain version ``ops/ballquery.py::ballquery_torch``, the same contract)
at the plan of :func:`grid_plan` (the centers a block takes, a center's
list capacity, the candidate threshold of its scan, the points staged at
once); :func:`first_k_grid_in_plan_order` renders that search in plain
ops. ``<wrapper>.launches`` counts each kernel's launches.
"""

import collections.abc
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from pointnet12_tpu_torch.kernels import build
from pointnet12_tpu_torch.ops.grid import G


class Grid(collections.abc.Mapping):
    """The grid of ``grid_prep_cuda``: ``perm``, ``skey`` (B, N),
    ``offsets`` (B, cells + 1), ``qperm``, ``sqkey`` (B, S), int32, in one
    buffer. A tensor (a view) is made only when it is asked for, since each
    costs the host microseconds; the kernels that read the grid take
    :meth:`ptr`."""

    def __init__(self, buf: torch.Tensor, shapes: dict):
        self.buf, self.shapes, self.starts = buf, shapes, {}
        start = 0
        for key, (rows, cols) in shapes.items():
            self.starts[key] = start
            start += rows * cols
        self.base = buf.data_ptr()

    def __getitem__(self, key: str) -> torch.Tensor:
        rows, cols = self.shapes[key]
        start = self.starts[key]
        return self.buf[start:start + rows * cols].view(rows, cols)

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)

    def ptr(self, key: str) -> int:
        """The device address of ``self[key]``."""
        return self.base + 4 * self.starts[key]


def grid_prep_cuda(radius: float, xyz: torch.Tensor, new_xyz: torch.Tensor,
                   g_res: int = G) -> Grid:
    """xyz (B, N, 3), new_xyz (B, S, 3) f32 -> the grid of
    ``ops/grid.py::grid_prep`` as a :class:`Grid`: ``perm``, ``skey``
    (B, N), ``offsets`` (B, g_res^3 + 1), ``qperm``, ``sqkey`` (B, S),
    int32, bit for bit the plain version's."""
    B, N, _ = build.check_tensor("grid_prep", "xyz", xyz, torch.float32, (None, None, 3))
    _, S, _ = build.check_tensor(
        "grid_prep", "new_xyz", new_xyz, torch.float32, (B, None, 3), xyz.device
    )
    if B == 0 or N == 0 or S == 0 or g_res <= 0:
        raise ValueError(f"grid_prep: B={B}, N={N}, S={S}, g_res={g_res}")
    shapes = {"perm": (B, N), "skey": (B, N), "offsets": (B, g_res**3 + 1),
              "qperm": (B, S), "sqkey": (B, S)}
    grid = Grid(torch.empty(sum(r * c for r, c in shapes.values()), dtype=torch.int32,
                            device=xyz.device), shapes)
    build.launch(
        "grid_prep", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
        *(grid.ptr(key) for key in shapes), B, N, S, g_res, radius,
    )
    grid_prep_cuda.launches += 1
    return grid


grid_prep_cuda.launches = 0


# the defaults of grid_plan, the fastest of chip_smoke.py's grid plan sweep
# on the H100 (PERF.md): consecutive sorted centers a block (halved down to a
# warp's worth while the launch would hold fewer than BLOCKS blocks), the
# points staged at once, a center's list of indices (at least twice K), and
# the threshold of the points in a center's own cell, in multiples of a
# uniform cloud's (n / G^3)
RUN = 16
BLOCKS = 264  # two a streaming multiprocessor of the H100's 132
TILE = 2048
CAPACITY = 64
THRESHOLD_UNIFORM = 8
WARPS = 8  # of a block, each with a scratch row of `capacity` (kWarps)
MAX_SHARED_BYTES = 232448  # 227 KB, sm_90's per-block limit
NO_THRESHOLD = 2**31 - 1  # no center scans the cloud
# a center's path through the kernel: its list, its list cut to its k
# smallest when its hits passed the capacity, or the scan of the cloud (its
# own cell over the threshold)
LIST, OVER_THRESHOLD, OVER_CAPACITY = 0, 1, 2


class GridPlan(NamedTuple):
    """One launch of ``ballquery_grid_kernel``: a block takes ``run``
    consecutive sorted centers; a center whose own cell holds more than
    ``threshold`` points scans the cloud in index order, every other one
    lists its hits (cut to its k smallest whenever a step's hits take the
    list past ``capacity``); the union of the block's neighbourhoods is staged
    ``tile`` points at a time; ``shared_bytes`` of shared memory."""

    run: int
    capacity: int
    threshold: int
    tile: int
    shared_bytes: int


def grid_shared_bytes(run: int, capacity: int, tile: int, g_res: int = G) -> int:
    """The kernel's shared memory: ``tile`` staged and ``run`` center
    records of 16 bytes; ``run`` lists of ``capacity + 32`` indices, their
    counts and cuts, a scratch row of ``capacity`` a warp, four ints a
    column of the grid plus one, and the ``g_res^3 + 1`` offsets
    (``csrc/ballquery_grid.cu::shared_bytes``)."""
    return 16 * (tile + run) + 4 * (run * (capacity + 34) + WARPS * capacity
                                    + 4 * g_res**2 + 1 + g_res**3 + 1)


@functools.lru_cache(maxsize=None)  # a pure function of the shape, on every call
def grid_plan(b: int, n: int, s: int, k: int, run: Optional[int] = None,
              capacity: Optional[int] = None, threshold: Optional[int] = None,
              tile: Optional[int] = None) -> GridPlan:
    """The launch for B clouds of ``n`` points, ``s`` centers each and
    ``k`` slots, from the defaults above unless given (``capacity`` at
    least ``k`` and a multiple of 4, for the 16-byte loads of the rank
    count).
    Any plan gives the contract's rows; it moves only the time."""
    if run is None:
        run = RUN
        while run > 8 and b * -(-s // run) < BLOCKS:
            run //= 2
    capacity = max(CAPACITY, -(-2 * k // 4) * 4) if capacity is None else capacity
    if threshold is None:
        threshold = THRESHOLD_UNIFORM * -(-n // G**3)
    tile = TILE if tile is None else tile
    if min(run, tile) < 1 or capacity < k or capacity % 4 or threshold < 0:
        raise ValueError(f"ballquery_grid: run={run}, capacity={capacity}, "
                         f"threshold={threshold}, tile={tile}")
    shared = grid_shared_bytes(run, capacity, tile)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"ballquery_grid: the plan needs {shared} bytes of shared memory, "
                         f"over {MAX_SHARED_BYTES}")
    return GridPlan(run, capacity, threshold, tile, shared)


def _columns(cell: int, g_res: int):
    """``[(column, z0, z1)]``: the up to 9 (x, y) columns around a cell and
    the z range of its 27 cells, in the kernel's order."""
    qx, qy, qz = cell // (g_res * g_res), cell // g_res % g_res, cell % g_res
    z0, z1 = max(qz - 1, 0), min(qz + 1, g_res - 1)
    return [(x * g_res + y, z0, z1)
            for x in range(max(qx - 1, 0), min(qx + 1, g_res - 1) + 1)
            for y in range(max(qy - 1, 0), min(qy + 1, g_res - 1) + 1)]


def first_k_grid_in_plan_order(xyz: torch.Tensor, centers: torch.Tensor, r2: float, k: int,
                               grid, plan: GridPlan, g_res: int = G):
    """``ballquery_grid_kernel``'s search at ``plan`` in plain ops, on the
    grid of ``ops/grid.py::grid_prep``: for each run of sorted centers the
    threshold on each center's own cell, the z hull of each column, the
    union staged in column order ``plan.tile`` points at a time, each
    center's walk of its 9 ranges inside each tile, 32 candidates at a
    time, into a list cut to its k smallest whenever a step's hits take it
    past ``plan.capacity``, after which only hits below the largest kept
    are taken (direct-form distances, rounded after every operation),
    then the K smallest of the list, or the index-order
    scan of the whole cloud for a center over the threshold. ``r2`` is the
    f32 value the kernel compares with. -> ``(idx (B, S, k) int32, path (B,
    S) int8)``, ``path`` one of :data:`LIST`, :data:`OVER_THRESHOLD`,
    :data:`OVER_CAPACITY` a center (original order). A loop a center: for
    small clouds."""
    B, N, _ = xyz.shape
    S = centers.shape[1]
    xyz, centers = xyz.cpu(), centers.cpu()
    perm, off, qperm, qcell = (grid[key].cpu().tolist()
                               for key in ("perm", "offsets", "qperm", "sqkey"))
    idx = torch.empty((B, S, k), dtype=torch.int32)
    path = torch.empty((B, S), dtype=torch.int8)
    for b in range(B):
        o = off[b]
        for q0 in range(0, S, plan.run):
            run = range(q0, min(q0 + plan.run, S))
            columns = {q: _columns(qcell[b][q], g_res) for q in run}
            hull, lists, cut = {}, {}, {}
            for q in run:
                cell = qcell[b][q]
                if o[cell + 1] - o[cell] > plan.threshold:
                    path[b, qperm[b][q]] = OVER_THRESHOLD
                    continue
                lists[q], cut[q] = [], N
                path[b, qperm[b][q]] = LIST
                for c, z0, z1 in columns[q]:
                    lo, hi = hull.get(c, (g_res, -1))
                    hull[c] = (min(lo, z0), max(hi, z1))
            start, base, staged = {}, {}, []
            for c in sorted(hull):
                lo, hi = hull[c]
                start[c], base[c] = o[c * g_res + lo], len(staged)
                staged += perm[b][start[c]:o[c * g_res + hi + 1]]
            staged = torch.tensor(staged, dtype=torch.int64)
            for t0 in range(0, len(staged), plan.tile):
                t1 = min(len(staged), t0 + plan.tile)
                for q, found in lists.items():
                    center = centers[b, qperm[b][q]]
                    for c, z0, z1 in columns[q]:
                        a = base[c] + o[c * g_res + z0] - start[c]
                        e = a + o[c * g_res + z1 + 1] - o[c * g_res + z0]
                        for u0 in range(max(a, t0), min(e, t1), 32):
                            walk = staged[u0:min(u0 + 32, e, t1)]
                            d = center - xyz[b, walk]
                            hit = walk[((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                                        + d[:, 2] * d[:, 2] <= r2) & (walk < cut[q])].tolist()
                            found += hit
                            if len(found) > plan.capacity:
                                found[:] = sorted(found)[:k]
                                cut[q] = found[-1]
                                path[b, qperm[b][q]] = OVER_CAPACITY
            for q in run:
                center = qperm[b][q]
                if q in lists:
                    row = sorted(lists[q])[:k]
                    idx[b, center] = torch.tensor(row + [row[0] if row else N] * (k - len(row)))
                    continue
                d = centers[b, center] - xyz[b]
                hit = torch.nonzero((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                                    + d[:, 2] * d[:, 2] <= r2)[:k, 0].tolist()
                idx[b, center] = torch.tensor(hit + [hit[0] if hit else N] * (k - len(hit)))
    return idx, path


def center_paths(grid, hits: torch.Tensor, plan: GridPlan) -> torch.Tensor:
    """Each center's path at ``plan`` (:data:`LIST`, :data:`OVER_THRESHOLD`
    or :data:`OVER_CAPACITY`, (B, S) int8 in the original center order),
    from the grid's offsets and ``hits`` (B, S), each center's number of
    points in radius (all of them lie in its 27 cells)."""
    off, cell, qperm = grid["offsets"].long(), grid["sqkey"].long(), grid["qperm"].long()
    own = off.gather(1, cell + 1) - off.gather(1, cell)
    sorted_path = torch.where(
        own > plan.threshold, OVER_THRESHOLD,
        torch.where(hits.gather(1, qperm) > plan.capacity, OVER_CAPACITY, LIST))
    return torch.empty_like(cell, dtype=torch.int8).scatter_(1, qperm, sorted_path.to(torch.int8))


def ballquery_grid_cuda(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
    plan: Optional[GridPlan] = None,
) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, S, 3) f32 -> (B, S, nsample) i32, the
    contract of ``ballquery_cuda``, at ``plan`` (by default
    :func:`grid_plan`). Bins both through :func:`grid_prep_cuda` first."""
    B, N, _ = build.check_tensor(
        "ballquery_grid", "xyz", xyz, torch.float32, (None, None, 3)
    )
    _, S, _ = build.check_tensor(
        "ballquery_grid", "new_xyz", new_xyz, torch.float32, (B, None, 3), xyz.device
    )
    if nsample <= 0 or B == 0 or N == 0 or S == 0:
        raise ValueError(f"ballquery_grid: nsample={nsample}, B={B}, N={N}, S={S}")
    plan = grid_plan(B, N, S, nsample) if plan is None else plan
    grid = grid_prep_cuda(radius, xyz, new_xyz)
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    # radius * radius in double, rounded to f32 once, as ballquery_cuda
    r2 = float(np.float32(radius * radius))
    build.launch(
        "ballquery_grid", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
        grid.ptr("perm"), grid.ptr("offsets"), grid.ptr("qperm"), grid.ptr("sqkey"),
        out.data_ptr(), B, N, S, nsample, G, r2, plan.run, plan.capacity, plan.threshold,
        plan.tile, plan.shared_bytes,
    )
    ballquery_grid_cuda.launches += 1
    return out


ballquery_grid_cuda.launches = 0
