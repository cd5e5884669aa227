"""Coordinate transforms on tensors: relative offsets and normalization.

Counterpart of ``mmtraj/data/transforms.py``.  ``NormStats`` may hold numpy
arrays (as a checkpoint stores them) or tensors; the functions move them to
the data's device and dtype.  ``augment_windows`` is the training
augmentation: a rotation per window, and optionally a reflection.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class NormStats(NamedTuple):
    """Per-axis mean/std of one-step displacements (dxy), in meters."""

    mean: np.ndarray  # (2,)
    std: np.ndarray  # (2,)


def compute_norm_stats(windows: Sequence[np.ndarray], obs_len: int) -> NormStats:
    """Mean and std of the one-step offsets over the observed part of the
    training windows, in numpy on the host; a std under 1e-6 becomes 1."""
    deltas = [np.diff(w[:, :obs_len], axis=1).reshape(-1, 2) for w in windows if w.shape[0]]
    if not deltas:
        return NormStats(np.zeros(2, np.float32), np.ones(2, np.float32))
    d = np.concatenate(deltas, axis=0)
    std = d.std(axis=0)
    std = np.where(std < 1e-6, 1.0, std)
    return NormStats(d.mean(axis=0).astype(np.float32), std.astype(np.float32))


def _like(a, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def to_relative(xy: torch.Tensor) -> torch.Tensor:
    """Absolute positions (..., T, 2) -> per-step offsets with dxy[..., 0, :] = 0."""
    return torch.cat([torch.zeros_like(xy[..., :1, :]), torch.diff(xy, dim=-2)], dim=-2)


def normalize(dxy: torch.Tensor, stats: NormStats) -> torch.Tensor:
    return (dxy - _like(stats.mean, dxy)) / _like(stats.std, dxy)


def denormalize(dxy_n: torch.Tensor, stats: NormStats) -> torch.Tensor:
    return dxy_n * _like(stats.std, dxy_n) + _like(stats.mean, dxy_n)


def augment_windows(xy: torch.Tensor, mask: torch.Tensor, theta: torch.Tensor,
                    det: torch.Tensor) -> torch.Tensor:
    """Rotate window b of xy (B, N, T, 2) absolute meters by theta[b], then
    reflect its y axis where det[b] = -1 (the JAX package's
    ``augment_windows``, with its random angles and flips drawn by the
    caller).  Pairwise distances, and so the social graph, are unchanged;
    offsets rotate with the window; padded rows stay zero; the mask is not
    touched."""
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s], dim=-1), torch.stack([det * s, det * c], dim=-1)],
                      dim=-2)  # (B, 2, 2)
    del mask  # padded rows are zeros; the orthogonal map keeps them zero
    return torch.einsum("bij,bntj->bnti", rot, xy)
