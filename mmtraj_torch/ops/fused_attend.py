"""The GAT attend chain: per-head masked LeakyReLU softmax and aggregate.

Counterpart of ``mmtraj/ops/fused_attend.py``.  ``attend_math`` is the plain
PyTorch version; ``attend`` is the wrapper of the Hopper kernel in
``csrc/attend.cu``.

Kernel note.  Replaces ``mmtraj/ops/fused_attend.py:_attend_pallas_fwd``
(kernel ``_attend_kernel``).  On the H100 it is bound by bytes: at the main
path's (B*K, N) = (500, 64) with 4 heads of 16 it reads v, the two score
vectors and the 0/1 attend tile and writes the output, about 26 MB against
about 0.3 GFLOP of f32 work.  The design therefore reads every input once:
one block per graph stages v and the scores in shared memory, one warp per
row keeps that row of the attend tile in registers for all heads, and the
per-head weights never leave shared memory.  The TPU blocking (group of
graphs, two graphs a lane tile, head-block-diagonal v) is not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from mmtraj_torch.models.layers import NEG_INF
from mmtraj_torch.ops import _build

MAX_N = 256  # the widest graph the kernel takes (its per-lane row registers)


def attend_math(v: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                attend: torch.Tensor, num_heads: int) -> torch.Tensor:
    """v (B, N, H*dh); s_src/s_dst (B, N, H); attend (B, N, N) 0/1 float
    -> (B, N, H*dh): concat over heads of alpha^h @ v^h."""
    dh = v.shape[-1] // num_heads
    cols = []
    for hh in range(num_heads):
        logits = s_src[:, :, hh, None] + s_dst[:, None, :, hh]
        logits = torch.where(logits > 0, logits, 0.2 * logits)
        logits = torch.where(attend > 0, logits, NEG_INF)
        m = logits.amax(dim=2, keepdim=True)
        e = torch.exp(logits - m) * attend
        alpha = e / e.sum(dim=2, keepdim=True).clamp_min(1e-20)
        cols.append(alpha @ v[:, :, hh * dh:(hh + 1) * dh])
    return torch.cat(cols, dim=-1)


def attend(v: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
           att: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``attend_math`` through the Hopper kernel for CUDA tensors; a CPU
    tensor takes ``attend_math`` itself.  ``att`` is the 0/1 attend tile."""
    if not v.is_cuda:
        return attend_math(v, s_src, s_dst, att, num_heads)
    B, N, HD = v.shape
    H = num_heads
    if N > MAX_N:
        raise ValueError(f"attend kernel takes N <= {MAX_N}, got N={N}")
    if HD % H:
        raise ValueError(f"num_heads={H} must divide the value width {HD}")
    _build.check_cuda(v, "v", (B, N, HD))
    _build.check_cuda(s_src, "s_src", (B, N, H))
    _build.check_cuda(s_dst, "s_dst", (B, N, H))
    _build.check_cuda(att, "attend", (B, N, N))
    out = torch.empty_like(v)
    lib = _build.load("attend")
    fn = lib.mmtraj_attend
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(v.device):
        code = fn(v.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(), att.data_ptr(),
                  out.data_ptr(), B, N, H, HD, _build.stream_of(v))
    _build.raise_on_error(lib, code, "attend")
    attend.launches += 1
    return out


attend.launches = 0
