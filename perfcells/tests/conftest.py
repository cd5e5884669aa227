"""Makes ``perfcells`` importable from the repo's root and gives the tests
that need a card their fixture, which decides at run time, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def cache_in_tmp(tmp_path, monkeypatch):
    """Runs in the tests keep what set-up caches out of the checkout."""
    from perfcells import harness

    monkeypatch.setattr(harness, "CACHE_DIR", str(tmp_path / "cache"))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells' kernels run only on the card)")
    return "cuda"
