"""Frozen copy of ``pointnet12_tpu_torch/data/synthetic.py`` at commit
529a356 (itself the copy of ``pointnet12_tpu/data/synthetic.py``): the
benchmark's own seeded traffic generators, kept here so that a change to
the program's data package cannot change what the benchmark feeds it.
Only the import of ``pc_normalize`` differs (this package's frozen
``augment``).

Deterministic synthetic datasets, the copy of
``pointnet12_tpu/data/synthetic.py``: parametric primitives a class for
classification and planar-room scenes for segmentation, each sample a pure
function of its index, so the train and eval paths run and learn without a
real dataset on disk. The real readers (modelnet40.py, s3dis.py,
semantic_kitti.py) give the same output contracts.
"""

import numpy as np


class _SampleCache:
    """Materialize-on-first-access sample cache (mixin).

    The samples are made once, at their first access, and kept: a pure
    function of the index, so the values are those of regeneration, at the
    cost of holding the set in memory (512 scenes x 4096 x 9 float32 are
    about 75 MB).
    """

    _cache: dict

    def _cached(self, i: int, make):
        cache = getattr(self, "_cache", None)
        if cache is None:
            cache = self._cache = {}
        hit = cache.get(i)
        if hit is None:
            hit = cache[i] = make()
        return hit


def _primitive(kind: int, n: int, aspect: float, rng) -> np.ndarray:
    """Point cloud on the surface of primitive ``kind`` (unit scale)."""
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(-1, 1, n)
    if kind == 0:  # sphere
        phi = np.arccos(v)
        pts = np.stack(
            [np.sin(phi) * np.cos(u), np.sin(phi) * np.sin(u), np.cos(phi)], 1
        )
    elif kind == 1:  # cube surface
        pts = rng.uniform(-1, 1, (n, 3))
        face = rng.randint(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        pts[np.arange(n), face] = sign
    elif kind == 2:  # cylinder
        pts = np.stack([np.cos(u), np.sin(u), v], 1)
    elif kind == 3:  # cone
        r = (1 - (v + 1) / 2)
        pts = np.stack([r * np.cos(u), r * np.sin(u), v], 1)
    elif kind == 4:  # torus
        w = rng.uniform(0, 2 * np.pi, n)
        pts = np.stack(
            [
                (1 + 0.35 * np.cos(w)) * np.cos(u),
                (1 + 0.35 * np.cos(w)) * np.sin(u),
                0.35 * np.sin(w),
            ],
            1,
        )
    elif kind == 5:  # plane with ridge
        x = rng.uniform(-1, 1, n)
        y = rng.uniform(-1, 1, n)
        pts = np.stack([x, y, 0.25 * np.sin(3 * x)], 1)
    elif kind == 6:  # helix tube
        t = rng.uniform(0, 4 * np.pi, n)
        pts = np.stack(
            [np.cos(t), np.sin(t), t / (2 * np.pi) - 1], 1
        ) + 0.05 * rng.randn(n, 3)
    else:  # two-sphere dumbbell
        half = n // 2
        phi = np.arccos(rng.uniform(-1, 1, n))
        th = rng.uniform(0, 2 * np.pi, n)
        pts = 0.5 * np.stack(
            [np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th), np.cos(phi)],
            1,
        )
        pts[:half, 2] += 0.7
        pts[half:, 2] -= 0.7
    pts[:, 2] *= aspect
    return pts.astype(np.float32)


class SyntheticModelNet(_SampleCache):
    """ModelNet-like classification set: class = (primitive, aspect) family.

    Output contract matches ModelNet40H5: ``__getitem__ -> (points (N, 3)
    float32 normalized to the unit sphere, label int32)``.
    """

    def __init__(
        self,
        split: str = "train",
        num_point: int = 1024,
        num_classes: int = 40,
        size: int = 512,
        seed: int = 0,
    ):
        self.split = split
        self.num_point = num_point
        self.num_classes = num_classes
        self.size = size
        self._seed = seed + (0 if split == "train" else 10_000_019)

    def __len__(self):
        return self.size

    def __getitem__(self, i: int):
        return self._cached(i, lambda: self._make(i))

    def _make(self, i: int):
        rng = np.random.RandomState(self._seed + i)
        label = i % self.num_classes
        kind = label % 8
        aspect = 0.5 + 0.25 * (label // 8)  # distinguishes families per kind
        pts = _primitive(kind, self.num_point, aspect, rng)
        pts += 0.02 * rng.randn(*pts.shape).astype(np.float32)
        from portbench.data.augment import pc_normalize

        return pc_normalize(pts).astype(np.float32), np.int32(label)


class SyntheticScene(_SampleCache):
    """S3DIS-like segmentation scenes: floor/walls/objects with per-point labels.

    Output contract matches S3DISH5: ``(points (N, 9) float32
    [xyz, rgb, normalized-xyz], labels (N,) int32)``.
    """

    def __init__(
        self,
        split: str = "train",
        num_point: int = 4096,
        num_classes: int = 13,
        size: int = 256,
        seed: int = 0,
    ):
        self.split = split
        self.num_point = num_point
        self.num_classes = num_classes
        self.size = size
        self._seed = seed + (0 if split == "train" else 20_000_003)

    def __len__(self):
        return self.size

    def __getitem__(self, i: int):
        return self._cached(i, lambda: self._make(i))

    def _make(self, i: int):
        rng = np.random.RandomState(self._seed + i)
        n = self.num_point
        pts = np.zeros((n, 3), np.float32)
        lbl = np.zeros((n,), np.int32)
        # floor (label 0) and one wall (label 1) take ~half the points
        n_floor, n_wall = n // 3, n // 6
        pts[:n_floor] = np.stack(
            [rng.uniform(0, 1, n_floor), rng.uniform(0, 1, n_floor),
             0.01 * rng.randn(n_floor)], 1)
        lbl[:n_floor] = 0
        pts[n_floor:n_floor + n_wall] = np.stack(
            [rng.uniform(0, 1, n_wall), 0.01 * rng.randn(n_wall),
             rng.uniform(0, 1, n_wall)], 1)
        lbl[n_floor:n_floor + n_wall] = 1
        # objects: blobs of remaining classes
        cursor = n_floor + n_wall
        while cursor < n:
            cls = rng.randint(2, self.num_classes)
            cnt = min(rng.randint(64, 256), n - cursor)
            center = rng.uniform(0.15, 0.85, 3) * np.array([1, 1, 0.6])
            radius = 0.03 + 0.012 * cls  # class-dependent size cue
            blob = center + radius * rng.randn(cnt, 3)
            pts[cursor:cursor + cnt] = blob
            lbl[cursor:cursor + cnt] = cls
            cursor += cnt
        # 9-dim features: xyz, rgb (noisy class-correlated color), norm-xyz
        hue = (lbl[:, None] * np.array([[0.37, 0.71, 0.13]])) % 1.0
        rgb = np.clip(hue + 0.1 * rng.randn(n, 3), 0, 1).astype(np.float32)
        span = pts.max(0) - pts.min(0)
        norm_xyz = (pts - pts.min(0)) / np.maximum(span, 1e-6)
        feats = np.concatenate([pts, rgb, norm_xyz.astype(np.float32)], 1)
        perm = rng.permutation(n)
        return feats[perm].astype(np.float32), lbl[perm]
