"""Fused-gate GRU and LSTM cells on tensors (counterpart of
``mmtraj/models/cells.py``).

All gates come from one ``(din, gH)`` input matrix and one ``(H, gH)``
recurrent matrix.  GRU: gate order (z, r, n), n = tanh(x Wxn + b_n +
r * (h Whn)), h' = (1 - z) n + z h.  LSTM: gate order (i, f, g, o) with
+1.0 on the forget gate inside its sigmoid, carry (c, h).

Two optional parameters come only from imported checkpoints, as in the JAX
package: ``bh``, a recurrent bias added to h Wh (torch's and Keras's
reset-after GRU put the n-gate's recurrent bias inside the reset product),
and ``wh_n``, Keras's reset-before GRU, where ``wh`` covers z and r only and
n = tanh(x Wxn + b_n + (r * h) Whn).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mmtraj_torch.models.layers import Params, glorot

GATES = {"gru": 3, "lstm": 4}


class Carry(NamedTuple):
    """Recurrent state; c is all zeros and unused for the GRU."""

    h: torch.Tensor
    c: torch.Tensor


def _gates(kind: str) -> int:
    if kind not in GATES:
        raise ValueError(f"unknown cell kind {kind!r}")
    return GATES[kind]


def cell_init(generator: torch.Generator, kind: str, din: int, hidden: int) -> Params:
    g = _gates(kind)
    return {
        "wx": glorot(generator, (din, g * hidden)),
        "wh": glorot(generator, (hidden, g * hidden)),
        "b": torch.zeros(g * hidden, device=generator.device),
    }


def init_carry(batch_shape: Tuple[int, ...], hidden: int, device=None) -> Carry:
    z = torch.zeros(tuple(batch_shape) + (hidden,), device=device)
    return Carry(h=z, c=z)


def cell_apply(p: Params, kind: str, x: torch.Tensor, carry: Carry) -> Carry:
    _gates(kind)
    h, c = carry.h, carry.c
    xg = x @ p["wx"] + p["b"]
    hg = h @ p["wh"]
    if "bh" in p:
        hg = hg + p["bh"]
    hid = h.shape[-1]
    if kind == "lstm":
        i, f, g, o = torch.split(xg + hg, hid, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        return Carry(h=o * torch.tanh(c_new), c=c_new)
    z = torch.sigmoid(xg[..., :hid] + hg[..., :hid])
    r = torch.sigmoid(xg[..., hid:2 * hid] + hg[..., hid:2 * hid])
    if "wh_n" in p:
        n = torch.tanh(xg[..., 2 * hid:] + (r * h) @ p["wh_n"])
    else:
        n = torch.tanh(xg[..., 2 * hid:] + r * hg[..., 2 * hid:])
    return Carry(h=(1.0 - z) * n + z * h, c=c)
