"""The whole multi-head GAT layer on raw matrices.

Counterpart of ``mmtraj/ops/fused_gat.py``.  ``gat_math`` is the plain
PyTorch version; ``fused_gat`` is the wrapper of the Hopper kernel in
``csrc/gat.cu``, a ``torch.autograd.Function`` whose backward is autograd of
``gat_math``, as the JAX package's ``custom_vjp`` differentiates it.

Kernel note.  Replaces ``mmtraj/ops/fused_gat.py:_fused_gat_fwd_impl``
(kernel ``_gat_kernel``).  On the H100 it is bound by operations: at the main
path's (B, N, D) = (25, 64, 64) it moves about 1.3 MB but does about 44 MFLOP
of f32 work (the value and output products and the attend chain).  The
design keeps every intermediate on chip and spreads each graph over a thread
block cluster: a block takes a 16-row slab of one graph (two slabs where
N > 128), so a graph is at most 8 blocks and (25, 64, 64) is 100 blocks.  A
block computes its rows of v = h wv on the tensor cores (``mma.sync`` in
3xTF32, float32-level), and their head scores, then copies the rest of the
graph's v and scores from its peers' shared memory after a cluster barrier,
runs the attend chain of ``csrc/attend.cu`` (``attend_slab``) for each head
of its slab, and computes out = agg wo + bo on the tensor cores; wv and wo
arrive in shared memory by ``cp.async``.  The JAX package's super-graph
packing (128/N graphs folded into one for the TPU's lanes) is exact and is
not carried over.

The kernel is the ``torch.library`` custom op ``mmtraj::fused_gat``,
registered when this module is imported: ``gat_math`` on the CPU, the
kernel on CUDA, and a fake implementation for ``torch.export``.
"""

from __future__ import annotations

import ctypes

import torch

from mmtraj_torch.ops import _build
from mmtraj_torch.ops.fused_attend import MAX_N, _wants_grad, attend_math


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


@torch.library.custom_op("mmtraj::fused_gat", mutates_args=(), device_types="cpu")
def _fused_gat_op(h: torch.Tensor, attend: torch.Tensor, wv: torch.Tensor, a_src: torch.Tensor,
                  a_dst: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """``mmtraj::fused_gat`` on the CPU: the plain version."""
    return gat_math(h, attend, wv, a_src, a_dst, wo, bo, num_heads)


@_fused_gat_op.register_kernel("cuda")
def _fused_gat_cuda(h, attend, wv, a_src, a_dst, wo, bo, num_heads):
    return _launch(h, attend, wv, a_src, a_dst, wo, bo, num_heads)


@_fused_gat_op.register_fake
def _fused_gat_fake(h, attend, wv, a_src, a_dst, wo, bo, num_heads):
    return h.new_empty((h.shape[0], h.shape[1], wo.shape[1]))


class _FusedGat(torch.autograd.Function):
    """``mmtraj::fused_gat`` forward with the JAX package's backward:
    autograd of ``gat_math`` on the saved inputs
    (``mmtraj/ops/fused_gat.py:_bwd``, the VJP of ``gat_math``).  ``attend``
    gets the gradient of ``gat_math`` too, as JAX's VJP returns one, but only
    when the caller's ``attend`` requires it (the model's 0/1 tile, made from
    a bool adjacency, never does); ``num_heads`` gets none.  There is no
    backward kernel, as in JAX.  On CPU tensors the op's forward is
    ``gat_math`` itself (the CPU tests drive the Function that way)."""

    @staticmethod
    def forward(ctx, h, attend, wv, a_src, a_dst, wo, bo, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(h, attend, wv, a_src, a_dst, wo, bo)
        return torch.ops.mmtraj.fused_gat(h, attend, wv, a_src, a_dst, wo, bo, num_heads)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = gat_math(*inputs, ctx.num_heads)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,)


def fused_gat(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """``mmtraj::fused_gat``: the Hopper kernel for CUDA tensors, ``gat_math``
    for CPU tensors; differentiable (``_FusedGat``, taken where a gradient
    is recorded)."""
    args = (h, attend, wv, a_src, a_dst, wo, bo)
    if _wants_grad(*args):
        return _FusedGat.apply(*args, num_heads)
    return torch.ops.mmtraj.fused_gat(*args, num_heads)


def _launch(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """One launch of ``mmtraj_gat`` on checked CUDA inputs; counted in
    ``fused_gat.launches``."""
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
