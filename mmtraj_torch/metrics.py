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


def miss_rate(preds: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
              threshold: float = 2.0) -> torch.Tensor:
    """Best-of-K miss rate: the share of valid agents whose best final-step
    displacement exceeds ``threshold`` meters.  preds (K, ..., N, Tp, 2),
    gt (..., N, Tp, 2), mask (..., N) -> scalar."""
    _, fde_k = displacement_errors(preds, gt[None])
    return _masked_mean((fde_k.amin(0) > threshold).float(), mask)


def collisions(preds: torch.Tensor, mask: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """Per-(sample, window, agent) collision indicator: True where the agent
    comes within ``threshold`` meters of another valid agent of the same
    joint sample at any predicted step.  preds (K, B, N, Tp, 2), mask (B, N)
    -> bool (K, B, N).  Builds the (K, B, Tp, N, N) squared distances: about
    98 MB at (20, 25, 12, 64, 64)."""
    xt = preds[..., 0].transpose(2, 3)  # (K, B, Tp, N)
    yt = preds[..., 1].transpose(2, 3)
    d2 = (xt[..., :, None] - xt[..., None, :]) ** 2 + (yt[..., :, None] - yt[..., None, :]) ** 2
    pair = (mask[:, :, None] & mask[:, None, :])[None, :, None]  # (1, B, 1, N, N)
    n = mask.shape[-1]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=mask.device)
    hit = (d2 < threshold * threshold) & pair & off_diag
    return hit.any(dim=4).any(dim=2)


def collision_rate(preds: torch.Tensor, mask: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """Share of the valid agents' sampled trajectories that collide with
    another agent's of the same sample.  preds (K, B, N, Tp, 2), mask (B, N)
    -> scalar in [0, 1]."""
    collided = collisions(preds, mask, threshold)
    denom = (mask.sum() * preds.shape[0]).clamp_min(1)
    return torch.where(mask[None], collided, False).sum() / denom
