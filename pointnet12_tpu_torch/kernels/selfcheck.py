"""Masks of the rows where a kernel and its plain version must agree.

Counterpart of ``pointnet12_tpu/kernels/selfcheck.py:133-153`` (the masks
only). The kernels compute distances in the direct form and the plain
versions in the expansion form, so a point within a rounding error of the
radius, or two references within a rounding error of each other, may be
decided either way by both. Index comparisons keep the rows these masks
mark True.
"""

import torch


def _direct_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, P, 3), (B, Q, 3) -> (B, P, Q) squared distances, direct form."""
    return ((a[:, :, None, :].float() - b[:, None, :, :].float()) ** 2).sum(-1)


def boundary_ok_mask(radius, xyz, new_xyz, tol=1e-5) -> torch.Tensor:
    """(B, S) True where NO point sits within ``tol`` of the radius
    boundary: rows where first-K-by-index selection is fp-stable."""
    d2 = _direct_d2(new_xyz, xyz)
    return ~torch.any(torch.abs(d2 - radius * radius) < tol, dim=-1)


def tie_ok_mask(query_xyz, ref_xyz, tol=1e-6) -> torch.Tensor:
    """(B, N) True where the 4 nearest references (all of them where there
    are only 3) are pairwise separated by more than ``tol``: rows where the
    3-NN slot order is fp-stable."""
    d2 = _direct_d2(query_xyz, ref_xyz)
    low4 = torch.topk(d2, min(4, d2.shape[-1]), dim=-1, largest=False, sorted=True).values
    return torch.diff(low4, dim=-1).min(dim=-1).values > tol
