"""The whole multi-head GAT layer on raw matrices.

Counterpart of ``mmtraj/ops/fused_gat.py``.  ``gat_math`` is the plain
PyTorch version; ``fused_gat`` is the wrapper of the Hopper kernel in
``csrc/gat.cu``.

Kernel note.  Replaces ``mmtraj/ops/fused_gat.py:_fused_gat_fwd_impl``
(kernel ``_gat_kernel``).  On the H100 it is bound by operations: at the main
path's (B, N, D) = (25, 64, 64) it moves about 1.3 MB but does about 44 MFLOP
of f32 work (the value and output products and the attend chain), and the
grid is small.  The design keeps every intermediate on chip: one block per
graph holds h, v, the scores and the aggregate in shared memory, reads the
weights through the cache, and runs the attend chain of ``csrc/attend.cu``
from the same device routine.  The JAX package's super-graph packing (128/N
graphs folded into one for the TPU's lanes) is exact and is not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from mmtraj_torch.ops import _build
from mmtraj_torch.ops.fused_attend import MAX_N, attend_math


def _block_diag(a: torch.Tensor) -> torch.Tensor:
    """(H, dh) per-head vectors -> (H*dh, H) block-diagonal matrix."""
    H = a.shape[0]
    eye = torch.eye(H, dtype=a.dtype, device=a.device)
    return (a[:, :, None] * eye[:, None, :]).reshape(-1, H)


def gat_math(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """h (B, N, D); attend (B, N, N) 0/1 float; wv (D, H*dh); a_src/a_dst
    (H, dh); wo (H*dh, Dout); bo (Dout,) -> (B, N, Dout) float32."""
    v = h @ wv
    s_src = v @ _block_diag(a_src)
    s_dst = v @ _block_diag(a_dst)
    return attend_math(v, s_src, s_dst, attend, num_heads) @ wo + bo


def fused_gat(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """``gat_math`` through the Hopper kernel for CUDA tensors; a CPU tensor
    takes ``gat_math`` itself."""
    if not h.is_cuda:
        return gat_math(h, attend, wv, a_src, a_dst, wo, bo, num_heads)
    B, N, D = h.shape
    H = num_heads
    HD = wv.shape[1]
    Dout = wo.shape[1]
    if N > MAX_N:
        raise ValueError(f"GAT kernel takes N <= {MAX_N}, got N={N}")
    if HD % H:
        raise ValueError(f"num_heads={H} must divide the value width {HD}")
    _build.check_cuda(h, "h", (B, N, D))
    _build.check_cuda(attend, "attend", (B, N, N))
    _build.check_cuda(wv, "wv", (D, HD))
    _build.check_cuda(a_src, "a_src", (H, HD // H))
    _build.check_cuda(a_dst, "a_dst", (H, HD // H))
    _build.check_cuda(wo, "wo", (HD, Dout))
    _build.check_cuda(bo, "bo", (Dout,))
    out = torch.empty((B, N, Dout), dtype=torch.float32, device=h.device)
    lib = _build.load("gat")
    fn = lib.mmtraj_gat
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        code = fn(h.data_ptr(), attend.data_ptr(), wv.data_ptr(), a_src.data_ptr(),
                  a_dst.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr(),
                  B, N, D, H, HD, Dout, _build.stream_of(h))
    _build.raise_on_error(lib, code, "fused_gat")
    fused_gat.launches += 1
    return out


fused_gat.launches = 0
