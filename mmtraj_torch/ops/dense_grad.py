"""The weight gradient of the float32 dense products, x^T g.

``dense_product(x, w)`` is ``x @ w``; for the lanes of a population
(under ``torch.func.vmap``, a weight a lane) where a gradient is recorded
it goes through ``_DenseProduct``, whose backward gives x the usual
``g @ w^T`` and w ``mmtraj::weight_grad(x, g)``, which the op's vmap rule
makes one launch for all lanes of the Hopper kernel of ``csrc/wgrad.cu`` on
CUDA.  The forward stays a plain ``torch.matmul``: a large product with
many rows, as the JAX package leaves it to XLA.  A single product (a
sequential step) stays plain, and so does ``mmtraj::weight_grad`` outside
vmap, on every device: there cuBLAS's unbatched ``mm`` is as fast as the
kernel at one lane on the H100, at less host cost a call (PERF.md
section 6).

Kernel note.  ``csrc/wgrad.cu`` replaces no TPU kernel: XLA computes this
product in the JAX package.  It was added for the lanes of a population
(``mmtraj_torch/population.py``): under ``torch.func.vmap`` over lanes with
their own weights autograd gives w's gradient to cuBLAS's batched SGEMM,
which does not split the row axis, and at config 3's shapes (din x dout of
64 x 192 at most, R = 8,192 rows a lane) that one product kind took 18.65 ms
of a 41-43 ms step on the H100 (PERF.md section 5).  Bound on the H100:
bytes and operations alike, about 0.55 ms a config-3 step each (1.8 GB of x
and g read once; 37 GFLOP in float32 FFMA).  The kernel splits the rows over
blocks (``plan``: enough splits for about two blocks on every SM) and all
lanes go in one launch; a second launch sums the splits in a fixed order,
so the result repeats to the bit and a CUDA graph captures it.

``mmtraj::weight_grad`` has a vmap rule: the lanes go to
``mmtraj::weight_grad_lanes``, one launch for all of them, an operand
shared by every lane (the zero initial state of a recurrence) expanded to
the lanes.  A weight that the lanes share keeps the plain product.  A fake
implementation of each op serves ``torch.export`` and ``FlopCounterMode``
counts their FLOPs as it counted the products they replace.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from mmtraj_torch.ops import _build
from mmtraj_torch.ops.fused_attend import _wants_grad

STAGE_ROWS = 32  # rows a block stages at a time (csrc/wgrad.cu: kRows)
MIN_SPLIT_ROWS = 64  # shorter splits would spend more on their partial tiles than on rows
BLOCKS_PER_SM = 2


def weight_grad_math(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x (..., din), g (..., dout) -> x^T g (din, dout), summed over every
    leading axis."""
    return x.flatten(0, -2).T @ g.flatten(0, -2)


def plan(S: int, R: int, din: int, dout: int, sms: int):
    """The launch of ``csrc/wgrad.cu`` for S lanes of R rows on a card of
    ``sms`` SMs -> (tm, tn, splits, rows): the output tile (16 or 64 rows of
    din, 32 or 64 columns of dout) and ``splits`` splits of ``rows`` rows
    each (a multiple of STAGE_ROWS, the last split shorter): as many as
    keep the blocks within BLOCKS_PER_SM on every SM (more would leave a
    third block on some SMs to finish alone), none shorter than
    MIN_SPLIT_ROWS."""
    tm = 16 if din <= 16 else 64
    tn = 32 if dout <= 32 else 64
    tiles = math.ceil(din / tm) * math.ceil(dout / tn) * max(S, 1)
    splits = max(1, min(BLOCKS_PER_SM * sms // tiles, R // MIN_SPLIT_ROWS))
    rows = math.ceil(math.ceil(max(R, 1) / splits) / STAGE_ROWS) * STAGE_ROWS
    return tm, tn, math.ceil(max(R, 1) / rows), rows


@torch.library.custom_op("mmtraj::weight_grad", mutates_args=())
def _weight_grad_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``mmtraj::weight_grad`` on every device: the plain version (its vmap
    rule takes the lanes to the kernel)."""
    return weight_grad_math(x, g)


@_weight_grad_op.register_fake
def _weight_grad_fake(x, g):  # lint: ok: torch.library calls it
    return x.new_empty((x.shape[-1], g.shape[-1]))


@torch.library.custom_op("mmtraj::weight_grad_lanes", mutates_args=(), device_types="cpu")
def _weight_grad_lanes_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``mmtraj::weight_grad_lanes`` on the CPU: ``weight_grad_math`` lane by
    lane, as one batched product."""
    return x.transpose(1, 2) @ g


@_weight_grad_lanes_op.register_kernel("cuda")
def _weight_grad_lanes_cuda(x, g):  # lint: ok: torch.library calls it
    """``mmtraj_wgrad`` on x (S, R, din), g (S, R, dout) CUDA float32 tensors
    (made contiguous) -> (S, din, dout); the split's scratch allocated
    here."""
    x, g = x.contiguous(), g.contiguous()
    S, R, din = x.shape
    dout = g.shape[2]
    _build.check_cuda(x, "x", (S, R, din))
    _build.check_cuda(g, "g", (S, R, dout))
    tm, tn, splits, rows = plan(S, R, din, dout, _sms(x.device))
    out = torch.empty((S, din, dout), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, S, din, dout), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    _build.launch("wgrad", "mmtraj_wgrad", x.device, x, g, out, partial, S, R, din, dout, tm, tn,
                  splits, rows)
    weight_grad_lanes.launches += 1
    return out


@_weight_grad_lanes_op.register_fake
def _weight_grad_lanes_fake(x, g):  # lint: ok: torch.library calls it
    return x.new_empty((x.shape[0], x.shape[2], g.shape[2]))


@register_flop_formula([torch.ops.mmtraj.weight_grad, torch.ops.mmtraj.weight_grad_lanes])
def _weight_grad_flops(x_shape, g_shape, *args, **kwargs) -> int:  # lint: ok: FlopCounterMode
    return 2 * math.prod(x_shape) * g_shape[-1]


@torch.library.register_vmap("mmtraj::weight_grad")
def _weight_grad_vmap(info, in_dims, x, g):  # lint: ok: torch.library calls it
    """``mmtraj::weight_grad`` under ``torch.func.vmap`` of S lanes: one
    ``mmtraj::weight_grad_lanes`` launch for all of them.  An operand that
    every lane shares (the zero initial state of a recurrence) is expanded
    to the lanes first."""
    S = info.batch_size
    xs, gs = (t.expand((S,) + t.shape) if d is None else t.movedim(d, 0)
              for t, d in zip((x, g), in_dims))
    out = torch.ops.mmtraj.weight_grad_lanes(xs.reshape(S, -1, x.shape[-1]),
                                             gs.reshape(S, -1, g.shape[-1]))
    return out, 0


class _DenseProduct(torch.autograd.Function):
    """``x @ w`` with w's gradient from ``mmtraj::weight_grad``; x's is
    autograd's ``g @ w^T``.  Written with a separate ``setup_context`` and
    ``generate_vmap_rule``, so that it runs under ``torch.func.vmap`` (a
    population's lanes: the op's vmap rule makes w's gradient one
    lane-batched launch) and under ``torch.func.vjp`` (``_FusedGat``'s
    backward differentiates ``gat_math``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w):
        return x @ w

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = torch.ops.mmtraj.weight_grad(x, g) if ctx.needs_input_grad[1] else None
        return gx, gw


def dense_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., din) and w (din, dout) in float32; where w is a
    lane of ``torch.func.vmap`` and a gradient is recorded through
    ``_DenseProduct`` (w's gradient on the kernel for CUDA tensors),
    elsewhere the plain product."""
    if _wants_grad(x, w) and _is_lane(w):
        return _DenseProduct.apply(x, w)
    return x @ w


def dense_weight_grad(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w's gradient of ``dense_product(x, w)`` at the output gradient g, for a
    backward written by hand: ``mmtraj::weight_grad`` where w is a lane of
    ``torch.func.vmap`` (as ``_DenseProduct``'s backward gives it),
    ``weight_grad_math`` elsewhere (the plain product's)."""
    return torch.ops.mmtraj.weight_grad(x, g) if _is_lane(w) else weight_grad_math(x, g)


def _is_lane(t: torch.Tensor) -> bool:
    """Whether ``t`` is batched by ``torch.func.vmap``, read through the
    wrappers of transforms inside it (``_FusedGat``'s ``torch.func.vjp``)."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        if torch._C._functorch.is_batchedtensor(t):
            return True
        t = torch._C._functorch.get_unwrapped(t)
    return False


def weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``mmtraj::weight_grad``: x (..., din), g (..., dout) -> x^T g (din,
    dout) over every row, ``weight_grad_math`` on every device; under
    ``torch.func.vmap`` one ``weight_grad_lanes`` call for all lanes."""
    return torch.ops.mmtraj.weight_grad(x, g)


def weight_grad_lanes(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``mmtraj::weight_grad_lanes``: S lanes, x (S, R, din), g (S, R, dout)
    -> (S, din, dout), lane s ``x[s]^T g[s]``, in one launch of the kernel
    for CUDA tensors.  A population reaches it through ``weight_grad``'s
    vmap rule."""
    return torch.ops.mmtraj.weight_grad_lanes(x, g)


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


weight_grad_lanes.launches = 0
