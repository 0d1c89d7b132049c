"""The plain reference: each model in plain PyTorch (``<model>.py``, named
by a configuration's ``"reference"``), its layers (``layers.py``) and the
train and eval passes the harness compares the program with
(``steps.py``). Nothing here imports the program or JAX."""

import importlib


def model(name: str):
    """The reference module of model ``name``: ``linear_shapes(cfg)``,
    ``bn_keys(cfg)`` and ``forward(weights, points, cfg, train, draws)``."""
    return importlib.import_module(f"portbench.reference.{name}")
