"""Wrappers of ``csrc/grid_prep.cu`` and ``csrc/ballquery_grid.cu``: the
voxel grid and the ball query through it, on the card.

``grid_prep_cuda`` replaces ``pointnet12_tpu/kernels/ballquery_grid.py::
_cell_offsets`` together with the XLA prep around it (``::grid_prep``,
:242-315), in one launch; its plain version is ``ops/grid.py::
grid_prep_torch``. ``ballquery_grid_cuda`` replaces ``::ballquery_grid``
(plain version ``ops/ballquery.py::ballquery_torch``, the same contract).
``<wrapper>.launches`` counts each kernel's launches.
"""

import collections.abc

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


def ballquery_grid_cuda(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, S, 3) f32 -> (B, S, nsample) i32, the
    contract of ``ballquery_cuda``. Bins both through
    :func:`grid_prep_cuda` first."""
    B, N, _ = build.check_tensor(
        "ballquery_grid", "xyz", xyz, torch.float32, (None, None, 3)
    )
    _, S, _ = build.check_tensor(
        "ballquery_grid", "new_xyz", new_xyz, torch.float32, (B, None, 3), xyz.device
    )
    if nsample <= 0 or B == 0 or N == 0 or S == 0:
        raise ValueError(f"ballquery_grid: nsample={nsample}, B={B}, N={N}, S={S}")
    grid = grid_prep_cuda(radius, xyz, new_xyz)
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    # radius * radius in double, rounded to f32 once, as ballquery_cuda
    r2 = float(np.float32(radius * radius))
    build.launch(
        "ballquery_grid", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
        grid.ptr("perm"), grid.ptr("offsets"), grid.ptr("qperm"), grid.ptr("sqkey"),
        out.data_ptr(), B, N, S, nsample, G, r2,
    )
    ballquery_grid_cuda.launches += 1
    return out


ballquery_grid_cuda.launches = 0
