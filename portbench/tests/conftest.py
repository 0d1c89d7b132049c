"""The benchmark's own tests: CPU rehearsals of the harness, and tests
marked ``card`` that need an NVIDIA card (they skip without one; run them
on the card with ``python3 -m pytest portbench/tests -m card``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The card's device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return "cuda:0"
