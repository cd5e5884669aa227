"""Coordinate transforms on tensors: relative offsets and normalization.

Counterpart of ``mmtraj/data/transforms.py``.  ``NormStats`` may hold numpy
arrays (as a checkpoint stores them) or tensors; the functions move them to
the data's device and dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NormStats(NamedTuple):
    """Per-axis mean/std of one-step displacements (dxy), in meters."""

    mean: np.ndarray  # (2,)
    std: np.ndarray  # (2,)


def _like(a, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def to_relative(xy: torch.Tensor) -> torch.Tensor:
    """Absolute positions (..., T, 2) -> per-step offsets with dxy[..., 0, :] = 0."""
    return torch.cat([torch.zeros_like(xy[..., :1, :]), torch.diff(xy, dim=-2)], dim=-2)


def normalize(dxy: torch.Tensor, stats: NormStats) -> torch.Tensor:
    return (dxy - _like(stats.mean, dxy)) / _like(stats.std, dxy)


def denormalize(dxy_n: torch.Tensor, stats: NormStats) -> torch.Tensor:
    return dxy_n * _like(stats.std, dxy_n) + _like(stats.mean, dxy_n)
