"""The whole multi-head GAT layer on raw matrices.

Counterpart of ``mmtraj/ops/fused_gat.py``.  ``gat_math`` is the plain
PyTorch version; ``fused_gat`` is the wrapper of the Hopper kernel in
``csrc/gat.cu``, a ``torch.autograd.Function`` whose backward gives
``gat_math``'s gradients, as the JAX package's ``custom_vjp`` differentiates
it: the attend chain's part by the kernels of ``csrc/gat_grad.cu``
(``fused_gat_grad``), the products around it plainly.

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

The backward's op ``mmtraj::gat_attend_grad`` (``fused_gat_grad``) has no
TPU counterpart: JAX differentiates the plain math, about 200 ops a call at
4 heads, each over a (B, N, N) tensor.  It is for speed only: on the CPU it
is ``torch.func.vjp`` of ``attend_math`` (the decomposition the CPU tests
drive), on CUDA three launches that keep every N x N value on chip, and under
``torch.func.vmap`` the lanes fold into the graphs of one call (the op takes
no weights).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mmtraj_torch.ops import _build
from mmtraj_torch.ops.dense_grad import dense_product, dense_weight_grad
from mmtraj_torch.ops.fused_attend import (MAX_N, _check, _fold_lanes, _math_vjp, _wants_grad,
                                           attend_math)


def _block_diag(a: torch.Tensor) -> torch.Tensor:
    """(H, dh) per-head vectors -> (H*dh, H) block-diagonal matrix."""
    H = a.shape[0]
    eye = torch.eye(H, dtype=a.dtype, device=a.device)
    return (a[:, :, None] * eye[:, None, :]).reshape(-1, H)


def gat_math(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """h (B, N, D); attend (B, N, N) 0/1 float; wv (D, H*dh); a_src/a_dst
    (H, dh); wo (H*dh, Dout); bo (Dout,) -> (B, N, Dout) float32.  For a
    population's lanes the two weight products take their weights' gradient
    from the weight-gradient kernel (``dense_product``; in ``_FusedGat``'s
    backward ``dense_weight_grad``)."""
    v = dense_product(h, wv)
    s_src = v @ _block_diag(a_src)
    s_dst = v @ _block_diag(a_dst)
    return dense_product(attend_math(v, s_src, s_dst, attend, num_heads), wo) + bo


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


def attend_grad_math(v, s_src, s_dst, attend, d_agg, num_heads: int):
    """``attend_math(v, s_src, s_dst, attend, num_heads)`` and its VJP at
    ``d_agg`` for v, s_src and s_dst, by ``torch.func.vjp`` -> (agg, dv,
    ds_src, ds_dst)."""
    agg, vjp = torch.func.vjp(lambda *x: attend_math(*x, attend, num_heads), v, s_src, s_dst)
    return (agg, *vjp(d_agg))


@torch.library.custom_op("mmtraj::gat_attend_grad", mutates_args=(), device_types="cpu")
def _gat_attend_grad_op(v: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                        attend: torch.Tensor, d_agg: torch.Tensor, num_heads: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mmtraj::gat_attend_grad`` on the CPU: the plain version."""
    return attend_grad_math(v, s_src, s_dst, attend, d_agg, num_heads)


@_gat_attend_grad_op.register_kernel("cuda")
def _gat_attend_grad_cuda(  # lint: ok: torch.library calls it
        v, s_src, s_dst, attend, d_agg, num_heads):
    """One call of ``mmtraj_gat_grad`` (``csrc/gat_grad.cu``, three launches)
    on checked CUDA inputs, counted in ``fused_gat_grad.launches``; its
    scratch (the rows' statistics, the edge bits) allocated here."""
    _check(v, s_src, s_dst, attend, num_heads)
    B, N, HD = v.shape
    _build.check_cuda(d_agg, "d_agg", (B, N, HD))
    agg, dv = torch.empty_like(v), torch.empty_like(v)
    ds_src, ds_dst = torch.empty_like(s_src), torch.empty_like(s_dst)
    stats = torch.empty((B, num_heads, 3, N), dtype=torch.float64, device=v.device)
    bits = torch.empty((2, B, N, (N + 31) // 32), dtype=torch.int32, device=v.device)
    _build.launch("gat_grad", "mmtraj_gat_grad", v.device, v, s_src, s_dst, attend, d_agg, agg,
                  dv, ds_src, ds_dst, stats, bits, B, N, num_heads, HD)
    fused_gat_grad.launches += 1
    return agg, dv, ds_src, ds_dst


@_gat_attend_grad_op.register_fake
def _gat_attend_grad_fake(  # lint: ok: torch.library calls it
        v, s_src, s_dst, attend, d_agg, num_heads):
    return (v.new_empty(v.shape), v.new_empty(v.shape), s_src.new_empty(s_src.shape),
            s_dst.new_empty(s_dst.shape))


torch.library.register_vmap("mmtraj::gat_attend_grad",
                            _fold_lanes(torch.ops.mmtraj.gat_attend_grad))


def _gat_grads(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int, g, needs):
    """``gat_math``'s gradients at the output gradient g for the inputs that
    ``needs`` marks (None for the rest, ``attend`` and ``num_heads``): v and
    its scores recomputed, the attend chain's VJP and its output from
    ``mmtraj::gat_attend_grad``, the products around it plainly, in the
    order autograd of ``gat_math`` takes them (on the CPU the gradients are
    its own to the bit).  A weight that is a population's lane takes its
    gradient from the weight-gradient kernel (``dense_weight_grad``), as
    ``dense_product``'s backward gives it."""
    bd_src, bd_dst = _block_diag(a_src), _block_diag(a_dst)
    v = h @ wv
    agg, dv, ds_src, ds_dst = fused_gat_grad(v, v @ bd_src, v @ bd_dst, attend, g @ wo.mT,
                                             num_heads)
    dv = dv + ds_dst @ bd_dst.mT + ds_src @ bd_src.mT
    H, HD = num_heads, v.shape[-1]

    def score_grad(ds):  # (H, dh): the diagonal blocks of v^T ds, _block_diag's gradient
        full = (v.reshape(-1, HD).mT @ ds.reshape(-1, H)).reshape(H, HD // H, H)
        return torch.diagonal(full, dim1=0, dim2=2).mT

    return (dv @ wv.mT if needs[0] else None, None,
            dense_weight_grad(h, dv, wv) if needs[2] else None,
            score_grad(ds_src) if needs[3] else None,
            score_grad(ds_dst) if needs[4] else None,
            dense_weight_grad(agg, g, wo) if needs[5] else None,
            g.sum(tuple(range(g.dim() - 1))) if needs[6] else None, None)


class _FusedGat(torch.autograd.Function):
    """``mmtraj::fused_gat`` forward with the JAX package's backward, the VJP
    of ``gat_math`` on the saved inputs (``mmtraj/ops/fused_gat.py:_bwd``):
    the attend chain's part from ``mmtraj::gat_attend_grad`` (the kernels of
    ``csrc/gat_grad.cu`` on the card), the products around it plainly
    (``_gat_grads``).  ``attend`` gets the gradient of ``gat_math`` too, as
    JAX's VJP returns one, but only when the caller's ``attend`` requires it
    (the model's 0/1 tile, made from a bool adjacency, never does): that
    backward is ``torch.func.vjp`` of ``gat_math``, which has the tile's
    gradient.  ``num_heads`` gets none.  On CPU tensors both ops are their
    plain versions (the CPU tests drive the Function that way).

    Written with a separate ``setup_context``, ``generate_vmap_rule`` and a
    functional backward, so that it runs under ``torch.func.vmap`` (a
    population of seeds, ``mmtraj_torch/population.py``): the forward's op
    then takes its vmap rule, one lane-batched launch, and so does the
    backward's."""

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
        if ctx.needs_input_grad[1]:  # the tile's gradient: the plain VJP has it
            return _math_vjp(gat_math, ctx.saved_tensors, ctx.needs_input_grad, ctx.num_heads, g)
        return _gat_grads(*ctx.saved_tensors, ctx.num_heads, g, ctx.needs_input_grad)


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


def _launch(h, attend, wv, a_src, a_dst, wo, bo, num_heads: int) -> torch.Tensor:
    """One launch of ``mmtraj_gat`` on checked CUDA inputs; counted in
    ``fused_gat.launches``."""
    args = (h, attend, wv, a_src, a_dst, wo, bo)
    _check_gat(*args, num_heads)
    B, N, D = h.shape
    out = torch.empty((B, N, wo.shape[1]), dtype=torch.float32, device=h.device)
    _build.launch("gat", "mmtraj_gat", h.device, *args, out, B, N, D, num_heads, wv.shape[1],
                  wo.shape[1])
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
    out = torch.empty((S, B, N, wo.shape[2]), dtype=torch.float32, device=h.device)
    _build.launch("gat", "mmtraj_gat_lanes", h.device, *args, out, S, B, N, D, num_heads,
                  wv.shape[2], wo.shape[2])
    fused_gat_lanes.launches += 1
    fused_gat.launches += 1
    return out


def fused_gat_grad(v, s_src, s_dst, attend, d_agg, num_heads: int):
    """``mmtraj::gat_attend_grad``: the attend chain ``attend_math(v, s_src,
    s_dst, attend, num_heads)`` and its VJP at ``d_agg`` -> (agg, dv, ds_src,
    ds_dst), the gradients of v, s_src and s_dst (the 0/1 tile gets none).
    On CUDA tensors the kernels of ``csrc/gat_grad.cu``, counted in
    ``fused_gat_grad.launches`` (one a call); on CPU tensors
    ``attend_grad_math``.  Vmappable: one call for every lane."""
    return torch.ops.mmtraj.gat_attend_grad(v, s_src, s_dst, attend, d_agg, num_heads)


fused_gat.launches = 0
fused_gat_lanes.launches = 0
fused_gat_grad.launches = 0
