"""Fused-gate GRU cell on tensors (counterpart of ``mmtraj/models/cells.py``).

Gate order (z, r, n) in one ``(din, 3H)`` input matrix and one ``(H, 3H)``
recurrent matrix; n = tanh(x Wxn + b_n + r * (h Whn)), h' = (1 - z) n + z h.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mmtraj_torch.models.layers import Params, glorot


class Carry(NamedTuple):
    """Recurrent state; c is all zeros and unused for the GRU."""

    h: torch.Tensor
    c: torch.Tensor


def check_cell(kind: str, p: Params = None) -> None:
    if kind != "gru":
        raise NotImplementedError(
            f"cell={kind!r}: the port has only the GRU so far; the LSTM comes "
            "with the rest of ROADMAP.md queue 1 item 2")
    if p is not None and ("bh" in p or "wh_n" in p):
        raise NotImplementedError(
            "the import-only cell params 'bh'/'wh_n' are not ported yet "
            "(ROADMAP.md queue 1 item 2)")


def cell_init(generator: torch.Generator, kind: str, din: int, hidden: int) -> Params:
    check_cell(kind)
    return {
        "wx": glorot(generator, (din, 3 * hidden)),
        "wh": glorot(generator, (hidden, 3 * hidden)),
        "b": torch.zeros(3 * hidden, device=generator.device),
    }


def init_carry(batch_shape: Tuple[int, ...], hidden: int, device=None) -> Carry:
    z = torch.zeros(tuple(batch_shape) + (hidden,), device=device)
    return Carry(h=z, c=z)


def cell_apply(p: Params, kind: str, x: torch.Tensor, carry: Carry) -> Carry:
    check_cell(kind, p)
    h = carry.h
    xg = x @ p["wx"] + p["b"]
    hg = h @ p["wh"]
    hid = h.shape[-1]
    z = torch.sigmoid(xg[..., :hid] + hg[..., :hid])
    r = torch.sigmoid(xg[..., hid:2 * hid] + hg[..., hid:2 * hid])
    n = torch.tanh(xg[..., 2 * hid:] + r * hg[..., 2 * hid:])
    return Carry(h=(1.0 - z) * n + z * h, c=carry.c)
