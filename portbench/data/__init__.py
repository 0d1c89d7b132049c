"""The benchmark's data: frozen copies of the program's seeded generators
(``synthetic.py``) and augmentations (``augment.py``), and the pool a run
draws its clouds from."""

import numpy as np

from portbench.data import augment
from portbench.data.synthetic import SyntheticModelNet, SyntheticScene

GENERATORS = {"scene": SyntheticScene, "modelnet": SyntheticModelNet}
AUGMENTS = {"segmentation": augment.segmentation_augment,
            "classification": augment.classification_augment}


class Pool:
    """A set of clouds held as two arrays, ``points (P, N, C)`` and
    ``labels (P,)`` or ``(P, N)``; indexing gives ``(points, label)`` as the
    program's datasets do."""

    def __init__(self, points: np.ndarray, labels: np.ndarray):
        self.points, self.labels = points, labels

    def __len__(self):
        return len(self.points)

    def __getitem__(self, i: int):
        return self.points[i], self.labels[i]


def make_pool(cfg: dict, size: int, seed: int) -> Pool:
    """``size`` clouds of the configuration's generator, from ``seed``."""
    gen = GENERATORS[cfg["data"]["generator"]](
        "train", num_point=cfg["num_point"], num_classes=cfg["num_classes"], size=size,
        seed=seed)
    first = gen._make(0)
    points = np.empty((size, *first[0].shape), np.float32)
    labels = np.empty((size, *np.shape(first[1])), np.int32)
    points[0], labels[0] = first
    for i in range(1, size):
        points[i], labels[i] = gen._make(i)
    return Pool(points, labels)


def feeder_batches(pool: Pool, batch: int, seed: int, augment_name: str, count: int):
    """The first ``count`` batches a ``Feeder(pool, batch, shuffle=True,
    augment_fn=..., seed=seed)`` gives, worked out again: the epoch's
    ``RandomState(seed)`` shuffles the order, then augments each batch in
    turn. Every batch of the first epoch, so ``count`` must not pass
    ``len(pool) // batch``."""
    if count > len(pool) // batch:
        raise ValueError(f"{count} batches of {batch} pass the first epoch of {len(pool)}")
    rng = np.random.RandomState(seed)
    order = np.arange(len(pool))
    rng.shuffle(order)
    out = []
    for b in range(count):
        idx = order[b * batch:(b + 1) * batch]
        points = AUGMENTS[augment_name](pool.points[idx], rng=rng)
        out.append((points, pool.labels[idx]))
    return out
