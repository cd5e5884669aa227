"""Masked multi-head graph attention over padded social graphs (counterpart
of ``mmtraj/models/gat.py``).

Self-loops are added for valid agents, so an isolated pedestrian attends to
itself; padded rows of the output are zero.  Under ``dtype=torch.bfloat16``
only the input h is rounded to bf16; the weights, the attend chain and every
kernel stay float32, as in the JAX package.
"""

from __future__ import annotations

import torch

from mmtraj_torch.models.layers import Params, glorot
from mmtraj_torch.ops import fused_attend, fused_gat


def gat_init(generator: torch.Generator, din: int, dout: int, num_heads: int) -> Params:
    assert dout % num_heads == 0, "num_heads must divide dout"
    dh = dout // num_heads
    return {
        "wv": glorot(generator, (din, num_heads * dh)),
        "a_src": glorot(generator, (num_heads, dh)),
        "a_dst": glorot(generator, (num_heads, dh)),
        "wo": glorot(generator, (num_heads * dh, dout)),
        "bo": torch.zeros(dout, device=generator.device),
    }


def _attend_group(n: int, num_heads: int, hd: int) -> int:
    """The JAX package's graphs per Pallas attend program (sized for the
    TPU's VMEM).  Passed on to ``attend`` for the same call; the Hopper
    kernels do not block by it."""
    per_g = n * num_heads * n * 4 + n * n * 4 + num_heads * n * hd * 4
    g = max(1, (8 * 2**20) // per_g)
    return min(8, 1 << (g.bit_length() - 1))


def use_attend_kernel(attend_kernel: str, use_pallas: bool, n: int, train: bool,
                      on_cuda: bool) -> bool:
    """The attend dispatch rule of the JAX package, with "on a TPU" read as
    "the tensor is on CUDA": "auto" takes the kernel at N >= 128 on paths that
    are not differentiated; "pallas" always takes it, "xla" never; the
    whole-layer kernel (``use_pallas``) takes precedence."""
    if attend_kernel not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown attend_kernel {attend_kernel!r}")
    return not use_pallas and (
        attend_kernel == "pallas"
        or (attend_kernel == "auto" and n >= 128 and not train and on_cuda)
    )


def gat_apply(p: Params, h: torch.Tensor, adj: torch.Tensor, mask: torch.Tensor,
              num_heads: int, dtype=None, use_pallas: bool = False, attend_kernel: str = "auto",
              train: bool = False) -> torch.Tensor:
    """h (B, N, D), adj (B, N, N) bool, mask (B, N) bool -> (B, N, dout).

    ``use_pallas`` runs the whole layer through ``fused_gat``; otherwise the
    projections are plain products and the attend chain goes through the
    ``fused_attend.attend`` kernel where ``use_attend_kernel`` says so.
    ``dtype``: h rounded to it (and held as float32) for every route."""
    N = h.shape[-2]
    eye = torch.eye(N, dtype=torch.bool, device=h.device)
    attend = (adj | (eye & mask[:, None, :] & mask[:, :, None])).to(torch.float32)
    hin = h if dtype is None else h.to(dtype).float()
    if use_attend_kernel(attend_kernel, use_pallas, N, train, h.is_cuda):
        v = hin @ p["wv"]
        s_src = v @ fused_gat._block_diag(p["a_src"])
        s_dst = v @ fused_gat._block_diag(p["a_dst"])
        dh = p["wv"].shape[1] // num_heads
        agg = fused_attend.attend(v, s_src, s_dst, attend, num_heads,
                                  _attend_group(N, num_heads, dh))
        out = agg @ p["wo"] + p["bo"]
    else:
        fn = fused_gat.fused_gat if use_pallas else fused_gat.gat_math
        out = fn(hin, attend, p["wv"], p["a_src"], p["a_dst"], p["wo"], p["bo"], num_heads)
    return torch.where(mask[..., None], out, 0.0)
