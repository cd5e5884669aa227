"""The GAT attend chain: per-head masked LeakyReLU softmax and aggregate.

Counterpart of ``mmtraj/ops/fused_attend.py``.  ``attend_math`` is the plain
PyTorch version; ``attend`` is the wrapper of the Hopper kernels in
``csrc/attend.cu`` and, with ``packed=True``, ``csrc/attend_packed.cu``.

Kernel note.  ``csrc/attend.cu`` replaces
``mmtraj/ops/fused_attend.py:_attend_pallas_fwd`` (kernel ``_attend_kernel``).
On the H100 it is bound by bytes: at the main path's (B*K, N) = (500, 64)
with 4 heads of 16 it reads v, the two score vectors and the 0/1 attend tile
and writes the output, about 26 MB against about 0.3 GFLOP of f32 work.  A
block takes one graph's block of 16 rows (so B = 12 graphs of 128 agents are
96 blocks), reads its attend rows once, as float4, into a bit mask, and each
warp builds one head's softmax weights straight into tensor-core fragments
and multiplies them with that head's columns of v on ``mma.sync`` in 3xTF32
(float32-level products; the row max comes from the largest s_dst over the
row's edges, so no pass over the logits).  v is read once per row block,
from L2 after the first; the scores are staged by ``cp.async``.  The TPU
blocking (group of graphs, head-block-diagonal v) is not carried over.

``csrc/attend_packed.cu`` replaces the same launch with ``packed=True``
(kernel ``_attend_kernel_packed``), which packs two graphs into the TPU's
128 lanes.  Its Hopper form computes the same function with the same bound
from the same kernel body (``csrc/attend_block.cuh``): a block takes a pair
of graphs' 16-row slabs, four warps a graph, each graph with its own edge
bit masks and tensor-core chains; in the last block of an odd B the second
graph loads and stores nothing.

Both kernels are ``torch.library`` custom ops, ``mmtraj::attend`` and
``mmtraj::attend_packed``, registered when this module is imported (nothing
is built or loaded then): the CPU implementation is ``attend_math``, the
CUDA one launches the kernel, and the fake one gives the output's shape, so
``torch.export`` keeps each call as one node of its graph.  The wrappers
call the ops on every device.  ``mmtraj::attend`` also has a vmap rule
(the lanes folded into its graphs, one launch); ``attend_packed``, which
has no backward and no training path, has none, and vmapping it raises
torch's own error.
"""

from __future__ import annotations

import ctypes

import torch

from mmtraj_torch.ops import _build

MAX_N = 256  # the widest graph the kernels take (four edge-mask words a lane)
NEG_INF = -1e9  # the masked logit, as ``models.layers.NEG_INF``


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
        m = logits.amax(dim=2, keepdim=True).detach()  # JAX's stop_gradient
        e = torch.exp(logits - m) * attend
        alpha = e / e.sum(dim=2, keepdim=True).clamp_min(1e-20)
        cols.append(alpha @ v[:, :, hh * dh:(hh + 1) * dh])
    return torch.cat(cols, dim=-1)


def _check(v, s_src, s_dst, att, num_heads: int) -> None:
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


def _launch(name: str, v, s_src, s_dst, att, num_heads: int) -> torch.Tensor:
    """Run ``mmtraj_<name>`` of ``csrc/<name>.cu`` on checked CUDA inputs."""
    B, N, HD = v.shape
    out = torch.empty_like(v)
    lib = _build.load(name)
    fn = getattr(lib, f"mmtraj_{name}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(v.device):
        code = fn(v.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(), att.data_ptr(),
                  out.data_ptr(), B, N, num_heads, HD, _build.stream_of(v))
    _build.raise_on_error(lib, code, name)
    return out


def _requires_grad(t: torch.Tensor) -> bool:
    """``t.requires_grad``, read through ``torch.func.vmap``'s wrappers: a
    vmapped tensor reports False whatever the tensor it wraps records."""
    while torch._C._functorch.is_batchedtensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t.requires_grad


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(_requires_grad(t) for t in ts)


@torch.library.custom_op("mmtraj::attend", mutates_args=(), device_types="cpu")
def _attend_op(v: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor, att: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    """``mmtraj::attend`` on the CPU: the plain version."""
    return attend_math(v, s_src, s_dst, att, num_heads)


@_attend_op.register_kernel("cuda")
def _attend_cuda(v, s_src, s_dst, att, num_heads):  # lint: ok: torch.library calls it
    _check(v, s_src, s_dst, att, num_heads)
    out = _launch("attend", v, s_src, s_dst, att, num_heads)
    attend.launches += 1
    return out


@torch.library.custom_op("mmtraj::attend_packed", mutates_args=(), device_types="cpu")
def _attend_packed_op(v: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                      att: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``mmtraj::attend_packed`` on the CPU: the plain version."""
    return attend_math(v, s_src, s_dst, att, num_heads)


@_attend_packed_op.register_kernel("cuda")
def _attend_packed_cuda(v, s_src, s_dst, att, num_heads):  # lint: ok: torch.library calls it
    _check(v, s_src, s_dst, att, num_heads)
    out = _launch("attend_packed", v, s_src, s_dst, att, num_heads)
    attend_packed.launches += 1
    return out


@_attend_op.register_fake
def _attend_fake(v, s_src, s_dst, att, num_heads):
    return torch.empty_like(v)


_attend_packed_op.register_fake(_attend_fake)


@torch.library.register_vmap("mmtraj::attend")
def _attend_vmap(  # lint: ok: torch.library calls it
        info, in_dims, v, s_src, s_dst, att, num_heads):
    """``mmtraj::attend`` under ``torch.func.vmap`` of S lanes: every input
    with its lane axis first (an unbatched one expanded), the lanes folded
    into the graphs of one launch, as JAX's batching rule folds them into
    its grid."""
    S = info.batch_size

    def fold(t, dim):
        t = t.movedim(dim, 0) if dim is not None else t.expand((S,) + t.shape)
        return t.reshape((-1,) + t.shape[2:]).contiguous()

    out = torch.ops.mmtraj.attend(*(fold(t, d) for t, d in zip((v, s_src, s_dst, att), in_dims)),
                                  num_heads)
    return out.reshape((S, -1) + out.shape[1:]), 0


class _Attend(torch.autograd.Function):
    """``mmtraj::attend`` forward with the JAX package's backward: the VJP
    of ``attend_math`` for v, s_src and s_dst on the saved inputs
    (``mmtraj/ops/fused_attend.py:_bwd``), taken by ``torch.func.vjp``; the
    0/1 tile and ``num_heads`` get none, as in JAX.  There is no backward
    kernel.  On CPU tensors the op's forward is ``attend_math`` itself (the
    CPU tests drive the Function that way).  Written with a separate
    ``setup_context`` and ``generate_vmap_rule``, so that it runs under
    ``torch.func.vmap``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(v, s_src, s_dst, att, num_heads):
        return torch.ops.mmtraj.attend(v, s_src, s_dst, att, num_heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.num_heads = inputs[-1]
        ctx.save_for_backward(*inputs[:-1])

    @staticmethod
    def backward(ctx, g):
        needs = tuple(ctx.needs_input_grad[:3]) + (False,)  # the tile gets none
        return _math_vjp(attend_math, ctx.saved_tensors, needs, ctx.num_heads, g)


def _math_vjp(math_fn, saved, needs, num_heads: int, g):
    """The gradients of ``math_fn(*saved, num_heads)`` for the saved inputs
    that ``needs`` marks (None for the rest and for ``num_heads``), by
    ``torch.func.vjp`` of the plain math: a backward that runs under
    ``torch.func.vmap`` as well as on an ordinary autograd path."""
    which = [i for i in range(len(saved)) if needs[i]]
    if not which:
        return (None,) * (len(saved) + 1)

    def fn(*wanted):
        args = list(saved)
        for i, t in zip(which, wanted):
            args[i] = t
        return math_fn(*args, num_heads)

    _, vjp = torch.func.vjp(fn, *(saved[i] for i in which))
    grads = dict(zip(which, vjp(g)))
    return tuple(grads.get(i) for i in range(len(saved))) + (None,)


def attend(v: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
           att: torch.Tensor, num_heads: int, group: int = 8,
           packed: bool = False) -> torch.Tensor:
    """``mmtraj::attend``: the Hopper kernel for CUDA tensors, ``attend_math``
    for CPU tensors.  ``att`` is the 0/1 attend tile.  The unpacked kernel
    is differentiable (``_Attend``, taken where a gradient is recorded).

    The signature and defaults are those of the JAX package's
    ``attend_pallas``.  ``packed=True`` launches the lane-packed kernel
    (``attend_packed``), never the unpacked one, and needs an even ``group``
    on every device, as in JAX.  ``group`` (graphs per TPU program) is no
    blocking knob on Hopper, where a block takes one graph or one pair: it is
    accepted for the JAX signature only and changes no result."""
    if packed and group % 2:
        raise ValueError("packed attend kernel needs an even group size")
    if packed:
        return attend_packed(v, s_src, s_dst, att, num_heads)
    if _wants_grad(v, s_src, s_dst):
        return _Attend.apply(v, s_src, s_dst, att, num_heads)
    return torch.ops.mmtraj.attend(v, s_src, s_dst, att, num_heads)


def attend_packed(v: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                  att: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``mmtraj::attend_packed``: the lane-packed Hopper kernel (a pair of
    graphs a block; an odd B leaves the last block's second graph idle) for
    CUDA tensors, ``attend_math`` for CPU tensors.  It has no backward (only
    the op sweep calls it) and raises on every device when asked for a
    gradient."""
    if _wants_grad(v, s_src, s_dst):
        raise ValueError("attend(packed=True) has no backward; call it under torch.no_grad() "
                         "or use the unpacked kernel")
    return torch.ops.mmtraj.attend_packed(v, s_src, s_dst, att, num_heads)


attend.launches = 0
attend_packed.launches = 0
