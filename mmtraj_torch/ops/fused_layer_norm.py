"""Layer norm over the last axis as a forward and a backward kernel.

No counterpart in the JAX package, whose ``layer_norm``
(``mmtraj/models/layers.py``) is plain jnp that XLA fuses.  In PyTorch the
plain chain (``models.layers.layer_norm``) dispatches 10 kernels forward and
autograd 29 more backward; the attention encoder runs ten layer norms over
up to 65,536 tokens a training step, forward, again in remat's
recomputation, and backward.  ``layer_norm_math`` is the plain chain (which
``models.layers.layer_norm`` runs in float32), with the rows' mean and
reciprocal standard deviation; ``fused_layer_norm`` the wrapper of the
kernels in ``csrc/layer_norm.cu``.

Kernel note.  Bound by bytes: at (P, H) = (65,536, 64) the forward reads x
and writes y (33.6 MB), the backward reads x and dy and writes dx (50.3 MB);
the plain chain moves about 72 such (P, H) tensors a layer norm in a
remat-"full" step.  A warp takes a row, H / 32 values a lane in registers,
in float32 as the plain chain; x and dy are read through a row stride, so
the readout's ``x[:, :, -1]`` is not copied.  The backward recomputes xhat
from x and the forward's mu and rstd, gives dx row by row, and sums dscale
and dbias over the rows in float64: each block's partial sums to a scratch,
then a second small launch adds the blocks in a fixed order, so the result
repeats to the bit (no atomics).  Widths 64 and 128 (the repo's hidden
sizes) take the kernels; on the card any other width, or a tensor that is
not float32, raises.

The kernels are the ``torch.library`` custom ops ``mmtraj::layer_norm`` ->
(y, mu, rstd) and ``mmtraj::layer_norm_grad`` -> (dx, dscale, dbias),
registered when this module is imported: the plain versions on the CPU
(``layer_norm_math``, ``layer_norm_grad_math``), one ``_build.launch`` on
CUDA, a fake for tracing.  ``fused_layer_norm`` goes through
``_FusedLayerNorm`` where a gradient is recorded.  Under
``torch.func.vmap`` (an attention-encoder population) the forward's lanes
fold into the rows of one call where they share scale and bias, and take a
call a lane where each has its own; the backward takes a call a lane, since
each lane sums its own dscale and dbias.  Counters:
``fused_layer_norm.launches`` (forward calls) and
``fused_layer_norm_grad.launches`` (backward calls), in
``ops.launch_counters()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmtraj_torch.ops import _build
from mmtraj_torch.ops.fused_attend import _wants_grad

EPS = 1e-6  # ``models.layers.layer_norm``'s
WIDTHS = (64, 128)  # the widths the kernels take
BWD_WARPS = 16  # warps a backward block (csrc/layer_norm.cu: kBwdWarps)
MAX_BLOCKS = 256  # the most backward blocks, and so rows of the float64 scratch


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, as the plain chain computes; float64 kept (the CPU tests)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def layer_norm_math(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = EPS, dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain layer norm over the last axis of x (..., H), in ``dtype``
    (None: float32, float64 for a float64 x) -> (y, mu, rstd): y like x, each
    row's mean and 1 / sqrt(biased variance + eps) of shape x.shape[:-1].
    ``models.layers.layer_norm`` is this chain in float32."""
    xf = x.to(dtype or _compute_dtype(x))
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * rstd
    return (y * scale + bias).to(x.dtype), mu.squeeze(-1), rstd.squeeze(-1)


def layer_norm_grad_math(x: torch.Tensor, scale: torch.Tensor, mu: torch.Tensor,
                         rstd: torch.Tensor, dy: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of ``layer_norm_math`` at dy for x, scale and bias, from
    its mu and rstd, as the kernel computes them: xhat = (x - mu) rstd, g =
    dy scale, dx = rstd (g - mean(g) - xhat mean(g xhat)) in x's compute
    dtype; dscale = sum(dy xhat), dbias = sum(dy) over the rows in float64,
    rounded once."""
    dt = _compute_dtype(x)
    xf, dyf = x.to(dt), dy.to(dt)
    xhat = (xf - mu[..., None]) * rstd[..., None]
    g = dyf * scale
    dx = rstd[..., None] * (g - g.mean(-1, keepdim=True)
                            - xhat * (g * xhat).mean(-1, keepdim=True))
    rows = tuple(range(x.dim() - 1))
    dscale = (dyf.double() * xhat.double()).sum(rows).to(scale.dtype)
    dbias = dyf.double().sum(rows).to(scale.dtype)
    return dx.to(x.dtype), dscale, dbias


def plan(P: int) -> Tuple[int, int]:
    """(blocks, rows a warp) of the backward at P rows: the fewest rows a
    warp that keep the blocks at ``MAX_BLOCKS`` or under, and no block
    without a row.  From P alone, so the sums' order, and their bits, are
    the same on every card."""
    rows_a_warp = max(1, -(-P // (BWD_WARPS * MAX_BLOCKS)))
    return max(1, -(-P // (BWD_WARPS * rows_a_warp))), rows_a_warp


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t (..., H) as (P, H) rows of unit column stride: a view where the
    leading axes fold into one row stride (``x[:, :, -1]`` does), else a
    copy."""
    rows = t.reshape(-1, t.shape[-1])
    return rows if rows.stride(-1) == 1 else rows.contiguous()


def _check(x: torch.Tensor, scale: torch.Tensor, *vectors: Tuple[str, torch.Tensor]) -> None:
    H = x.shape[-1]
    if H not in WIDTHS:
        raise ValueError(f"layer-norm kernel takes H in {WIDTHS}, got H={H}")
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"x: expected a float32 CUDA tensor, got {x.dtype} on {x.device}")
    _build.check_cuda(scale, "scale", (H,))
    for name, t in vectors:
        _build.check_cuda(t, name, (H,))


@torch.library.custom_op("mmtraj::layer_norm", mutates_args=(), device_types="cpu")
def _layer_norm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mmtraj::layer_norm`` on the CPU: the plain version."""
    return layer_norm_math(x, scale, bias, eps)


@_layer_norm_op.register_kernel("cuda")
def _layer_norm_cuda(x, scale, bias, eps):  # lint: ok: torch.library calls it
    """One launch of ``mmtraj_layer_norm`` on checked inputs, counted in
    ``fused_layer_norm.launches``."""
    _check(x, scale, ("bias", bias))
    rows = _rows(x)
    P, H = rows.shape
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    _build.launch("layer_norm", "mmtraj_layer_norm", x.device, rows, scale, bias, y, mu, rstd,
                  P, H, rows.stride(0), float(eps))
    fused_layer_norm.launches += 1
    return y, mu, rstd


@_layer_norm_op.register_fake
def _layer_norm_fake(x, scale, bias, eps):  # lint: ok: torch.library calls it
    stats = x.new_empty(x.shape[:-1], dtype=_compute_dtype(x))
    return x.new_empty(x.shape), stats, stats.new_empty(stats.shape)


@torch.library.custom_op("mmtraj::layer_norm_grad", mutates_args=(), device_types="cpu")
def _layer_norm_grad_op(x: torch.Tensor, scale: torch.Tensor, mu: torch.Tensor,
                        rstd: torch.Tensor, dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mmtraj::layer_norm_grad`` on the CPU: the plain version."""
    return layer_norm_grad_math(x, scale, mu, rstd, dy)


@_layer_norm_grad_op.register_kernel("cuda")
def _layer_norm_grad_cuda(x, scale, mu, rstd, dy):  # lint: ok: torch.library calls it
    """One call of ``mmtraj_layer_norm_grad`` (two launches) on checked
    inputs, counted in ``fused_layer_norm_grad.launches``; its float64
    scratch allocated here."""
    _check(x, scale)
    rows, drows = _rows(x), _rows(dy)
    P, H = rows.shape
    mu, rstd = mu.reshape(-1), rstd.reshape(-1)  # a copy where a lane's slice is strided
    _build.check_cuda(mu, "mu", (P,))
    _build.check_cuda(rstd, "rstd", (P,))
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != torch.float32:
        raise ValueError(f"dy: expected float32 {tuple(x.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    blocks, rows_a_warp = plan(P)
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    partial = torch.empty((blocks, 2 * H), dtype=torch.float64, device=x.device)
    _build.launch("layer_norm", "mmtraj_layer_norm_grad", x.device, rows, drows, scale, mu, rstd,
                  dx, dscale, dbias, partial, P, H, rows.stride(0), drows.stride(0), blocks,
                  rows_a_warp)
    fused_layer_norm_grad.launches += 1
    return dx, dscale, dbias


@_layer_norm_grad_op.register_fake
def _layer_norm_grad_fake(x, scale, mu, rstd, dy):  # lint: ok: torch.library calls it
    return x.new_empty(x.shape), scale.new_empty(scale.shape), scale.new_empty(scale.shape)


def _lane_first(t: torch.Tensor, dim, S: int) -> torch.Tensor:
    """A vmapped argument with its lane axis first; an unbatched one expanded
    to S lanes."""
    return t.movedim(dim, 0) if dim is not None else t.expand((S,) + t.shape)


@torch.library.register_vmap("mmtraj::layer_norm")
def _layer_norm_vmap(info, in_dims, x, scale, bias, eps):  # lint: ok: torch.library calls it
    """``mmtraj::layer_norm`` over S lanes: lanes that share scale and bias
    fold into the rows of one call (each row is normalised alone, so the
    result is that of S calls); lanes with their own (a population of
    seeds) take a call each."""
    S = info.batch_size
    xs = _lane_first(x, in_dims[0], S)
    if in_dims[1] is None and in_dims[2] is None:
        return torch.ops.mmtraj.layer_norm(xs, scale, bias, eps), (0, 0, 0)
    scales, biases = (_lane_first(t, d, S).contiguous() for t, d in ((scale, in_dims[1]),
                                                                     (bias, in_dims[2])))
    outs = [torch.ops.mmtraj.layer_norm(xs[s], scales[s], biases[s], eps) for s in range(S)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


@torch.library.register_vmap("mmtraj::layer_norm_grad")
def _layer_norm_grad_vmap(  # lint: ok: torch.library calls it
        info, in_dims, x, scale, mu, rstd, dy):
    """``mmtraj::layer_norm_grad`` over S lanes, a call a lane: each lane's
    dscale and dbias sum over its own rows."""
    S = info.batch_size
    x, scale, mu, rstd, dy = (_lane_first(t, d, S)
                              for t, d in zip((x, scale, mu, rstd, dy), in_dims))
    outs = [torch.ops.mmtraj.layer_norm_grad(x[s], scale[s].contiguous(), mu[s], rstd[s], dy[s])
            for s in range(S)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


class _FusedLayerNorm(torch.autograd.Function):
    """``mmtraj::layer_norm`` forward, ``mmtraj::layer_norm_grad`` backward
    from the saved x, scale and the rows' mu and rstd.  On CPU tensors both
    ops are their plain versions (the CPU tests drive the Function that
    way).  Written with a separate ``setup_context`` and
    ``generate_vmap_rule``, so that it runs under ``torch.func.vmap``: both
    ops then take their vmap rules."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale, bias, eps):
        return torch.ops.mmtraj.layer_norm(x, scale, bias, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale = inputs[:2]
        _, mu, rstd = output
        ctx.mark_non_differentiable(mu, rstd)
        ctx.set_materialize_grads(False)  # no zero-filled dmu and drstd: two kernels a backward
        ctx.save_for_backward(x, scale, mu, rstd)

    @staticmethod
    def backward(ctx, dy, _dmu, _drstd):
        dx, dscale, dbias = fused_layer_norm_grad(*ctx.saved_tensors, dy)
        needs = ctx.needs_input_grad
        return (dx if needs[0] else None, dscale if needs[1] else None,
                dbias if needs[2] else None, None)


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = EPS) -> torch.Tensor:
    """``models.layers.layer_norm`` of x (..., H) with ``scale`` and ``bias``
    (H,): ``mmtraj::layer_norm`` (the kernel for CUDA tensors, which raises
    for a width outside ``WIDTHS`` or a dtype other than float32; the plain
    version for CPU ones), differentiable through ``_FusedLayerNorm`` where
    a gradient is recorded, and vmappable."""
    if _wants_grad(x, scale, bias):
        return _FusedLayerNorm.apply(x, scale, bias, eps)[0]
    return torch.ops.mmtraj.layer_norm(x, scale, bias, eps)[0]


def fused_layer_norm_grad(x, scale, mu, rstd, dy):
    """``mmtraj::layer_norm_grad``: the gradients (dx, dscale, dbias) of the
    layer norm of x at dy from the forward's mu and rstd.  On CUDA tensors
    the kernels of ``csrc/layer_norm.cu``, counted in
    ``fused_layer_norm_grad.launches`` (one a call); on CPU tensors
    ``layer_norm_grad_math``."""
    return torch.ops.mmtraj.layer_norm_grad(x, scale, mu, rstd, dy)


fused_layer_norm.launches = 0
fused_layer_norm_grad.launches = 0
