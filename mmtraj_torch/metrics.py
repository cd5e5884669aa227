"""Masked ADE/FDE and best-of-K on tensors (counterpart of
``mmtraj/metrics.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def displacement_errors(pred: torch.Tensor, gt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pred/gt (..., Tp, 2) -> per-trajectory (ade (...), fde (...))."""
    dist = torch.linalg.vector_norm(pred - gt, dim=-1)  # (..., Tp)
    return dist.mean(-1), dist[..., -1]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = mask.sum().clamp_min(1)
    return torch.where(mask, x, 0.0).sum() / denom


def ade_fde(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-mean ADE/FDE.  pred/gt (..., N, Tp, 2), mask (..., N) -> scalars."""
    ade, fde = displacement_errors(pred, gt)
    return _masked_mean(ade, mask), _masked_mean(fde, mask)


def best_of_k(preds: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-of-K ADE/FDE.  preds (K, ..., N, Tp, 2), gt (..., N, Tp, 2),
    mask (..., N) -> scalar (min-ADE, min-FDE), meters."""
    ade_k, fde_k = displacement_errors(preds, gt[None])
    return _masked_mean(ade_k.amin(0), mask), _masked_mean(fde_k.amin(0), mask)
