"""Leaf math on tensors (counterpart of ``mmtraj/models/layers.py``).

Parameters are plain dicts of tensors in the JAX ``(in, out)`` orientation:
``dense`` computes ``x @ w + b``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Params = Dict[str, object]

NEG_INF = -1e9


def glorot(generator: torch.Generator, shape) -> torch.Tensor:
    """Glorot-normal draw, std sqrt(2 / (fan_in + fan_out)), on the
    generator's device."""
    fan_in, fan_out = shape[-2], shape[-1]
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(shape, generator=generator, device=generator.device) * scale


def dense_init(generator: torch.Generator, din: int, dout: int) -> Params:
    return {"w": glorot(generator, (din, dout)),
            "b": torch.zeros(dout, device=generator.device)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with mask==False entries absent; a row with no
    valid entry gives zeros (exp(0) * 0 over a 1e-20 floor), never NaN."""
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=dim, keepdim=True)
    e = torch.exp(logits - m) * mask
    return e / e.sum(dim=dim, keepdim=True).clamp_min(1e-20)
