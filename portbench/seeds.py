"""The streams a run draws from its ``--seed``: each its own 32-bit
seed, so that no two stand in for each other and any whole number, of any
size, gives a run."""

import numpy as np

NAMES = ("weights", "data", "feeder", "steps", "requests", "sample")


def streams(seed: int) -> dict:
    """``{name: seed}`` for each of ``NAMES``. The data and feeder seeds are
    kept under 2**31, as the generators add a sample's index or an epoch
    to them."""
    values = np.random.SeedSequence(abs(int(seed))).generate_state(len(NAMES))
    out = {name: int(v) for name, v in zip(NAMES, values)}
    out["data"] %= 2 ** 31
    out["feeder"] %= 2 ** 31
    return out
