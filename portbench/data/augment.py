"""Frozen copy of ``pointnet12_tpu_torch/data/augment.py`` at commit 529a356
(itself the copy of ``pointnet12_tpu/data/augment.py``): the benchmark's
own augmentations. The plain reference replays the program's ``Feeder``
with these, so the batches it trains on are worked out again, not taken
from the program.

Point-cloud augmentations (host-side numpy), the copy of
``pointnet12_tpu/data/augment.py``.

The reference's parameter set: rotation about the up axis, small-angle
perturbation, Gaussian jitter (sigma 0.01, clip 0.05), random scale
(0.8-1.25), shift (+-0.1), and random point dropout that replaces dropped
points with the first point. All touch the xyz channels only and keep the
batch's shape.

The rotations and the dropout are vectorized over the batch and consume a
``RandomState``'s stream exactly as the per-cloud loops would (outputs and
the rng state after the call are the same). Every function also takes a
``np.random.Generator`` (the Feeder's ``fast_rng``), whose gaussians come
in float32 from another stream.
"""

from typing import Optional

import numpy as np


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center to the centroid and scale into the unit sphere."""
    centroid = pc.mean(axis=0)
    pc = pc - centroid
    scale = np.max(np.sqrt(np.sum(pc**2, axis=1)))
    return pc / max(scale, 1e-12)


def _randn(rng, shape) -> np.ndarray:
    """Gaussian draws: stream-identical to legacy ``rng.randn(*shape)``
    for RandomState (randn IS standard_normal); float32 ziggurat fast
    path for Generator."""
    if isinstance(rng, np.random.Generator):
        return rng.standard_normal(shape, dtype=np.float32)
    return rng.standard_normal(size=shape)


def rotate_point_cloud(
    batch: np.ndarray, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """Random rotation about the up (y) axis. batch: (B, N, >=3)."""
    rng = rng or np.random
    out = batch.copy()
    angle = rng.uniform(size=batch.shape[0]) * 2 * np.pi
    c, s = np.cos(angle), np.sin(angle)
    z, o = np.zeros_like(c), np.ones_like(c)
    rot = np.stack(
        [np.stack([c, z, s], 1), np.stack([z, o, z], 1),
         np.stack([-s, z, c], 1)], 1
    ).astype(batch.dtype)  # (B, 3, 3)
    out[:, :, :3] = np.matmul(batch[:, :, :3], rot)
    return out


def rotate_point_cloud_z(
    batch: np.ndarray, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """Random rotation about z (up axis for scans/scenes)."""
    rng = rng or np.random
    out = batch.copy()
    angle = rng.uniform(size=batch.shape[0]) * 2 * np.pi
    c, s = np.cos(angle), np.sin(angle)
    z, o = np.zeros_like(c), np.ones_like(c)
    rot = np.stack(
        [np.stack([c, -s, z], 1), np.stack([s, c, z], 1),
         np.stack([z, z, o], 1)], 1
    ).astype(batch.dtype)
    out[:, :, :3] = np.matmul(batch[:, :, :3], rot)
    return out


def rotate_perturbation_point_cloud(
    batch: np.ndarray,
    angle_sigma: float = 0.06,
    angle_clip: float = 0.18,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Small random rotations about all three axes."""
    rng = rng or np.random
    out = batch.copy()
    B = batch.shape[0]
    a = np.clip(angle_sigma * _randn(rng, (B, 3)), -angle_clip, angle_clip)
    (cx, cy, cz), (sx, sy, sz) = np.cos(a).T, np.sin(a).T
    z, o = np.zeros_like(cx), np.ones_like(cx)
    rx = np.stack([np.stack([o, z, z], 1), np.stack([z, cx, -sx], 1),
                   np.stack([z, sx, cx], 1)], 1)
    ry = np.stack([np.stack([cy, z, sy], 1), np.stack([z, o, z], 1),
                   np.stack([-sy, z, cy], 1)], 1)
    rz = np.stack([np.stack([cz, -sz, z], 1), np.stack([sz, cz, z], 1),
                   np.stack([z, z, o], 1)], 1)
    rot = np.matmul(np.matmul(rz, ry), rx).astype(batch.dtype)
    out[:, :, :3] = np.matmul(batch[:, :, :3], rot)
    return out


def jitter_point_cloud(
    batch: np.ndarray,
    sigma: float = 0.01,
    clip: float = 0.05,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    rng = rng or np.random
    noise = np.clip(
        sigma * _randn(rng, batch[..., :3].shape), -clip, clip
    ).astype(batch.dtype)
    out = batch.copy()
    out[..., :3] += noise
    return out


def random_scale_point_cloud(
    batch: np.ndarray,
    scale_low: float = 0.8,
    scale_high: float = 1.25,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    rng = rng or np.random
    scales = rng.uniform(scale_low, scale_high, batch.shape[0])
    out = batch.copy()
    out[..., :3] *= scales[:, None, None].astype(batch.dtype)
    return out


def shift_point_cloud(
    batch: np.ndarray,
    shift_range: float = 0.1,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    rng = rng or np.random
    shifts = rng.uniform(-shift_range, shift_range, (batch.shape[0], 3))
    out = batch.copy()
    out[..., :3] += shifts[:, None, :].astype(batch.dtype)
    return out


def random_point_dropout(
    batch: np.ndarray,
    max_dropout_ratio: float = 0.875,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Replace a random fraction of points with the first point (keeps shape)."""
    rng = rng or np.random
    out = batch.copy()
    # per-cloud draws stay in the loop (ratio and mask draws interleave in
    # the rng stream); only the apply is vectorized
    mask = np.empty(batch.shape[:2], bool)
    for b in range(batch.shape[0]):
        ratio = rng.uniform() * max_dropout_ratio
        mask[b] = rng.uniform(size=batch.shape[1]) <= ratio
    return np.where(mask[..., None], out[:, :1, :], out)


def classification_augment(
    batch: np.ndarray, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """The reference train_clf.py recipe: rotate + jitter (+ dropout/scale/shift)."""
    batch = random_point_dropout(batch, rng=rng)
    batch = random_scale_point_cloud(batch, rng=rng)
    batch = shift_point_cloud(batch, rng=rng)
    batch = rotate_point_cloud(batch, rng=rng)
    batch = jitter_point_cloud(batch, rng=rng)
    return batch


def segmentation_augment(
    batch: np.ndarray, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """Scene-level recipe: z-rotation + jitter (labels untouched)."""
    batch = rotate_point_cloud_z(batch, rng=rng)
    batch = jitter_point_cloud(batch, rng=rng)
    return batch
