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
kernel on CUDA, and a fake implementation for ``torch.export``.  Under
``torch.func.vmap`` over S lanes with their own weights (a population of
seeds) its vmap rule calls ``mmtraj::fused_gat_lanes``: the same kernel in
one launch for all S * B graphs, graph b reading the weights of lane b / B,
as JAX's batching rule makes a grid axis of the vmapped ``pallas_call``.
"""

from __future__ import annotations

import ctypes

import torch

from mmtraj_torch.ops import _build
from mmtraj_torch.ops.fused_attend import MAX_N, _math_vjp, _wants_grad, attend_math


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
def _fused_gat_cuda(  # lint: ok: torch.library calls it
        h, attend, wv, a_src, a_dst, wo, bo, num_heads):
    return _launch(h, attend, wv, a_src, a_dst, wo, bo, num_heads)


@_fused_gat_op.register_fake
def _fused_gat_fake(  # lint: ok: torch.library calls it
        h, attend, wv, a_src, a_dst, wo, bo, num_heads):
    return h.new_empty((h.shape[0], h.shape[1], wo.shape[1]))


@torch.library.custom_op("mmtraj::fused_gat_lanes", mutates_args=(), device_types="cpu")
def _fused_gat_lanes_op(h: torch.Tensor, attend: torch.Tensor, wv: torch.Tensor,
                        a_src: torch.Tensor, a_dst: torch.Tensor, wo: torch.Tensor,
                        bo: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``mmtraj::fused_gat_lanes`` on the CPU: ``gat_math`` lane by lane."""
    return torch.stack([gat_math(*(t[s] for t in (h, attend, wv, a_src, a_dst, wo, bo)),
                                 num_heads) for s in range(h.shape[0])])


@_fused_gat_lanes_op.register_kernel("cuda")
def _fused_gat_lanes_cuda(  # lint: ok: torch.library calls it
        h, attend, wv, a_src, a_dst, wo, bo, num_heads):
    return _launch_lanes(h, attend, wv, a_src, a_dst, wo, bo, num_heads)


@_fused_gat_lanes_op.register_fake
def _fused_gat_lanes_fake(  # lint: ok: torch.library calls it
        h, attend, wv, a_src, a_dst, wo, bo, num_heads):
    return h.new_empty((h.shape[0], h.shape[1], h.shape[2], wo.shape[2]))


def _lanes(t: torch.Tensor, dim, S: int) -> torch.Tensor:
    """A vmapped argument with its lane axis first, contiguous; an unbatched
    one expanded to S lanes."""
    return (t.movedim(dim, 0) if dim is not None else t.expand((S,) + t.shape)).contiguous()


@torch.library.register_vmap("mmtraj::fused_gat")
def _fused_gat_vmap(  # lint: ok: torch.library calls it
        info, in_dims, h, attend, wv, a_src, a_dst, wo, bo, num_heads):
    """``mmtraj::fused_gat`` under ``torch.func.vmap`` of S lanes, in one
    launch, as JAX's batching rule makes a grid axis of the vmapped axis:
    lanes that share the weights fold into the graphs of one
    ``mmtraj::fused_gat``; lanes with their own weights (a population of
    seeds) go to ``mmtraj::fused_gat_lanes``."""
    S = info.batch_size
    hs, att = _lanes(h, in_dims[0], S), _lanes(attend, in_dims[1], S)
    weights, w_dims = (wv, a_src, a_dst, wo, bo), in_dims[2:7]
    if all(d is None for d in w_dims):
        B, N = hs.shape[1], hs.shape[2]
        out = torch.ops.mmtraj.fused_gat(hs.reshape((S * B,) + hs.shape[2:]),
                                         att.reshape(S * B, N, N), *weights, num_heads)
        return out.reshape((S, B) + out.shape[1:]), 0
    out = torch.ops.mmtraj.fused_gat_lanes(
        hs, att, *(_lanes(w, d, S) for w, d in zip(weights, w_dims)), num_heads)
    return out, 0


class _FusedGat(torch.autograd.Function):
    """``mmtraj::fused_gat`` forward with the JAX package's backward: the VJP
    of ``gat_math`` on the saved inputs (``mmtraj/ops/fused_gat.py:_bwd``),
    taken by ``torch.func.vjp``.  ``attend`` gets the gradient of
    ``gat_math`` too, as JAX's VJP returns one, but only when the caller's
    ``attend`` requires it (the model's 0/1 tile, made from a bool
    adjacency, never does); ``num_heads`` gets none.  There is no backward
    kernel, as in JAX.  On CPU tensors the op's forward is ``gat_math``
    itself (the CPU tests drive the Function that way).

    Written with a separate ``setup_context``, ``generate_vmap_rule`` and a
    functional backward, so that it runs under ``torch.func.vmap`` (a
    population of seeds, ``mmtraj_torch/population.py``): the forward's op
    then takes its vmap rule, one lane-batched launch."""

    generate_vmap_rule = True

    @staticmethod
    def forward(h, attend, wv, a_src, a_dst, wo, bo, num_heads):
        return torch.ops.mmtraj.fused_gat(h, attend, wv, a_src, a_dst, wo, bo, num_heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.num_heads = inputs[-1]
        ctx.save_for_backward(*inputs[:-1])

    @staticmethod
    def backward(ctx, g):
        return _math_vjp(gat_math, ctx.saved_tensors, ctx.needs_input_grad, ctx.num_heads, g)


def fused_gat(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """``mmtraj::fused_gat``: the Hopper kernel for CUDA tensors, ``gat_math``
    for CPU tensors; differentiable (``_FusedGat``, taken where a gradient
    is recorded) and vmappable (one launch for every lane)."""
    args = (h, attend, wv, a_src, a_dst, wo, bo)
    if _wants_grad(*args):
        return _FusedGat.apply(*args, num_heads)
    return torch.ops.mmtraj.fused_gat(*args, num_heads)


def fused_gat_lanes(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """``mmtraj::fused_gat_lanes``: S lanes, each ``fused_gat`` of its own B
    graphs with its own weights, in one launch of ``csrc/gat.cu``'s kernel
    for CUDA tensors; ``gat_math`` lane by lane for CPU tensors.  h (S, B,
    N, D), attend (S, B, N, N), wv (S, D, H*dh), a_src/a_dst (S, H, dh), wo
    (S, H*dh, Dout), bo (S, Dout) -> (S, B, N, Dout).  No gradient: a
    population reaches it through ``fused_gat``'s vmap rule."""
    return torch.ops.mmtraj.fused_gat_lanes(h, attend, wv, a_src, a_dst, wo, bo, num_heads)


def _check_gat(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int, lead=()) -> None:
    """Raise unless the inputs are contiguous float32 CUDA tensors of one
    GAT call, with the leading axes ``lead`` on every one (the lanes)."""
    N, D = h.shape[-2:]
    H, HD, Dout = num_heads, wv.shape[-1], wo.shape[-1]
    B = h.shape[len(lead)]
    if N > MAX_N:
        raise ValueError(f"GAT kernel takes N <= {MAX_N}, got N={N}")
    if HD % H:
        raise ValueError(f"num_heads={H} must divide the value width {HD}")
    _build.check_cuda(h, "h", lead + (B, N, D))
    _build.check_cuda(attend, "attend", lead + (B, N, N))
    _build.check_cuda(wv, "wv", lead + (D, HD))
    _build.check_cuda(a_src, "a_src", lead + (H, HD // H))
    _build.check_cuda(a_dst, "a_dst", lead + (H, HD // H))
    _build.check_cuda(wo, "wo", lead + (HD, Dout))
    _build.check_cuda(bo, "bo", lead + (Dout,))


def _call(entry: str, args, sizes, out_shape) -> torch.Tensor:
    """``entry`` of ``csrc/gat.cu`` on checked CUDA inputs -> its output."""
    h = args[0]
    out = torch.empty(out_shape, dtype=torch.float32, device=h.device)
    lib = _build.load("gat")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * len(sizes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        code = fn(*(t.data_ptr() for t in args), out.data_ptr(), *sizes, _build.stream_of(h))
    _build.raise_on_error(lib, code, entry)
    return out


def _launch(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """One launch of ``mmtraj_gat`` on checked CUDA inputs; counted in
    ``fused_gat.launches``."""
    args = (h, attend, wv, a_src, a_dst, wo, bo)
    _check_gat(*args, num_heads)
    B, N, D = h.shape
    sizes = (B, N, D, num_heads, wv.shape[1], wo.shape[1])
    out = _call("mmtraj_gat", args, sizes, (B, N, wo.shape[1]))
    fused_gat.launches += 1
    return out


def _launch_lanes(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """One launch of ``mmtraj_gat_lanes`` (``gat_kernel`` over S lanes of
    weights) on checked CUDA inputs; counted in ``fused_gat_lanes.launches``
    and, as a launch of the same kernel, in ``fused_gat.launches``."""
    args = (h, attend, wv, a_src, a_dst, wo, bo)
    S = h.shape[0]
    _check_gat(*args, num_heads, lead=(S,))
    _, B, N, D = h.shape
    sizes = (S, B, N, D, num_heads, wv.shape[2], wo.shape[2])
    out = _call("mmtraj_gat_lanes", args, sizes, (S, B, N, wo.shape[2]))
    fused_gat_lanes.launches += 1
    fused_gat.launches += 1
    return out


fused_gat.launches = 0
fused_gat_lanes.launches = 0
