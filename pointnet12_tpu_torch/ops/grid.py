"""The voxel grid of the grid ball query and the fused grid SA layer.

Counterpart of ``pointnet12_tpu/kernels/ballquery_grid.py::grid_prep``
(:242-315) and ``_cell_offsets`` (:181-221). Each cloud's points are
binned into ``G^3`` cells at least ``radius`` wide, from the cloud's own
bounding box, with the linear cell id ``(cx*G + cy)*G + cz``; then the
points and the centers are sorted by cell id, stably. The cell offsets
give, for each id ``c`` in ``[0, G^3]``, ``#{i : skey[i] < c}``: the first
sorted position of cell ``c``. A kernel then reads a cell's points as one
range of sorted positions.

On the card the whole prep is one CUDA kernel (``csrc/grid_prep.cu``:
bounds, keys, a stable counting sort of the points and of the centers, the
offsets as its by-product); the plain version is PyTorch ops, as the prep
was XLA beside the Pallas kernels. The TPU's windows of 128 sorted points
and their overflow flags (``blocks``, ``ovf``) were Mosaic's way to slice
the sorted points: the CUDA kernels read the cell ranges themselves, and
the points through ``perm``, so neither windows nor a sorted copy of the
points are made.
"""

from collections.abc import Mapping

import torch

from pointnet12_tpu_torch.kernels import dispatch

G = 8  # cells per dimension (8^3 = 512), as the JAX package's G


def cell_offsets_torch(skey: torch.Tensor, cells: int) -> torch.Tensor:
    """Plain version, the compare-and-sum form of ``_cell_offsets``
    (:203-208): skey (B, N) int32 -> (B, cells + 1) int32 counts of keys
    below each id."""
    ids = torch.arange(cells + 1, dtype=skey.dtype, device=skey.device)
    return (skey[:, None, :] < ids[None, :, None]).sum(-1, dtype=torch.int32)


def _keys(p: torch.Tensor, lo: torch.Tensor, size: torch.Tensor, g_res: int) -> torch.Tensor:
    cell = torch.floor((p - lo) / size).to(torch.int32).clamp_(0, g_res - 1)
    return (cell[..., 0] * g_res + cell[..., 1]) * g_res + cell[..., 2]


def grid_prep_torch(radius: float, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    g_res: int = G) -> dict:
    """Plain version, mirror of JAX's ``grid_prep`` (its keys, stable sorts
    and ``_cell_offsets``). The radius meets the extent in fp32, as JAX's
    weak-typed ``jnp.maximum`` rounds it."""
    lo = xyz.amin(dim=1, keepdim=True)
    hi = xyz.amax(dim=1, keepdim=True)
    extent = (hi - lo).amax(dim=-1, keepdim=True)
    size = torch.clamp(extent / g_res, min=radius)  # cells at least r wide
    skey, perm = torch.sort(_keys(xyz, lo, size, g_res), dim=1, stable=True)
    sqkey, qperm = torch.sort(_keys(new_xyz, lo, size, g_res), dim=1, stable=True)
    return {
        "perm": perm.to(torch.int32), "skey": skey,
        "offsets": cell_offsets_torch(skey, g_res**3),
        "qperm": qperm.to(torch.int32), "sqkey": sqkey,
    }


def grid_prep(
    radius: float,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    *,
    g_res: int = G,
    impl: str = "auto",
) -> Mapping:
    """Bin ``xyz (B, N, 3)`` and ``new_xyz (B, S, 3)`` (f32) into the grid.

    Returns a mapping of int32 tensors (a dict; on the card
    ``kernels/grid_cuda.py::Grid``): ``perm (B, N)`` and ``qperm (B, S)``,
    the stable sorts by cell id (sorted position -> original index);
    ``skey (B, N)`` and ``sqkey (B, S)``, the sorted cell ids; ``offsets
    (B, g_res^3 + 1)``.
    """
    if dispatch.resolve(impl, xyz) == "cuda":
        from pointnet12_tpu_torch.kernels.grid_cuda import grid_prep_cuda

        return grid_prep_cuda(radius, xyz.float().contiguous(),
                              new_xyz.float().contiguous(), g_res)
    return grid_prep_torch(radius, xyz, new_xyz, g_res)
