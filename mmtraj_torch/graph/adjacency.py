"""Per-frame proximity graph on tensors (counterpart of
``mmtraj/graph/adjacency.py``)."""

from __future__ import annotations

import torch


def pairwise_sq_dists(xy: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) positions -> (..., N, N) squared euclidean distances."""
    diff = xy[..., :, None, :] - xy[..., None, :, :]
    return (diff * diff).sum(-1)


def proximity_adjacency(xy: torch.Tensor, mask: torch.Tensor, radius: float) -> torch.Tensor:
    """Bool (..., N, N): i <-> j iff both are valid, i != j and
    ||xy_i - xy_j||^2 <= radius^2 (inclusive); radius <= 0 connects every pair
    of valid agents.  Self-loops are added by the GAT layer."""
    valid = mask[..., :, None] & mask[..., None, :]
    n = xy.shape[-2]
    not_self = ~torch.eye(n, dtype=torch.bool, device=xy.device)
    if radius <= 0:
        return valid & not_self
    # A Python float compares in the tensor's float32, as the JAX package's
    # weakly typed constant does, and costs no host-to-device copy.
    return valid & not_self & (pairwise_sq_dists(xy) <= radius * radius)
