"""Leaf math on tensors (counterpart of ``mmtraj/models/layers.py``).

Parameters are plain dicts of tensors in the JAX ``(in, out)`` orientation:
``dense`` computes ``x @ w + b``.  ``maybe_remat`` checkpoints a time step's
body (or an attention layer) for the backward pass under the JAX package's
three remat policies, as its ``jax.checkpoint`` does.

``dtype=torch.bfloat16`` (``ModelConfig.dtype="bfloat16"``) is the JAX
package's ``jnp.dot(x.astype(bf16), w.astype(bf16),
preferred_element_type=jnp.float32)``: both operands rounded to bf16, the
product accumulated and returned in float32 (``matmul``).  The product of two
bf16 values is exact in float32, so the operands are rounded and held as
float32 and the product runs as a float32 ``mm``; autocast, or a product of
bf16 tensors, would round the output to bf16 too.  The backward is JAX's
transpose: each operand's gradient is computed in float32 and rounded to
bf16 at every product.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

Params = Dict[str, object]

NEG_INF = -1e9


def _saved_products(policy: str):
    """The matrix products whose outputs a remat policy keeps: "dots" every
    one (``jax.checkpoint_policies.dots_saveable``), "dots_no_batch" those
    with no batch dimension, the weight-stationary ``mm``/``addmm``
    (``dots_with_no_batch_dims_saveable``)."""
    aten = torch.ops.aten
    no_batch = [aten.mm.default, aten.addmm.default]
    if policy == "dots_no_batch":
        return no_batch
    if policy == "dots":
        return no_batch + [aten.bmm.default, aten.baddbmm.default]
    raise ValueError(f"unknown remat_policy {policy!r}")


def maybe_remat(cfg, body: Callable) -> Callable:
    """``body`` recomputed in the backward pass instead of keeping its
    intermediates, per ``cfg.remat``/``cfg.remat_policy`` (the JAX package's
    ``maybe_remat``, ``mmtraj/models/layers.py:19``), by
    ``torch.utils.checkpoint`` (non-reentrant):

    * "full" keeps only the body's inputs and recomputes the rest;
    * "dots" and "dots_no_batch" keep the outputs of the matrix products of
      ``_saved_products`` and recompute everything else
      (``create_selective_checkpoint_contexts``).  The kernels'
      ``autograd.Function``s are no aten op, so every policy recomputes
      them, as JAX's policies recompute a ``custom_vjp`` call.

    Policies change what backward recomputes, never the math.  The body
    draws no random numbers, so no generator state is kept for the
    recomputation.  Where nothing records a graph (inference) the body runs
    as it is."""
    if not cfg.remat or not torch.is_grad_enabled():
        return body
    kw = {}
    if cfg.remat_policy != "full":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _saved_products(cfg.remat_policy))

    def remat_body(*args):
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return remat_body


def glorot(generator: torch.Generator, shape) -> torch.Tensor:
    """Glorot-normal draw, std sqrt(2 / (fan_in + fan_out)), on the
    generator's device."""
    fan_in, fan_out = shape[-2], shape[-1]
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(shape, generator=generator, device=generator.device) * scale


def dense_init(generator: torch.Generator, din: int, dout: int) -> Params:
    return {"w": glorot(generator, (din, dout)),
            "b": torch.zeros(dout, device=generator.device)}


class _RoundOnce(torch.autograd.Function):
    """``w`` rounded to bf16 and held as float32; the gradient passes through."""

    @staticmethod
    def forward(ctx, w):
        return w.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradient(torch.autograd.Function):
    """The identity, with its gradient rounded to bf16: the transpose of the
    JAX package's ``w.astype(bf16)`` at one use of ``w``."""

    @staticmethod
    def forward(ctx, w):
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


class Bf16Weight(NamedTuple):
    """A weight rounded to bf16 once for a forward call (``bf16_weight``),
    held as float32, for the products of every time step.  Each product
    rounds its own gradient, as the JAX package's cast inside the step
    does, and the steps' gradients add up in float32; rounding once and
    differentiating the plain cast would round their sum instead."""

    value: torch.Tensor


def bf16_weight(w: torch.Tensor) -> Bf16Weight:
    return Bf16Weight(_RoundOnce.apply(w))


def matmul(x: torch.Tensor, w, dtype=None) -> torch.Tensor:
    """``x @ w`` in float32; under ``dtype=torch.bfloat16`` with both operands
    rounded to bf16 first (see the module docstring).  ``x`` may come in as a
    bf16 tensor already, where one rounded activation feeds several products
    (the JAX package's single ``x.astype(bf16)``); ``w`` may be a
    ``Bf16Weight``."""
    if dtype is None:
        return x @ w
    if dtype != torch.bfloat16:
        raise ValueError(f"compute dtype {dtype} is not bfloat16 or None (float32)")
    xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    if isinstance(w, Bf16Weight):
        w = _RoundGradient.apply(w.value) if w.value.requires_grad else w.value
    else:
        w = w.to(torch.bfloat16).float()
    return xb.float() @ w


def dense(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x @ w + b``; ``dtype`` rounds the product's operands (``matmul``),
    the bias is added in float32."""
    return matmul(x, p["w"], dtype) + p["b"]


def mlp_init(generator: torch.Generator, dims) -> Params:
    return {f"l{i}": dense_init(generator, dims[i], dims[i + 1]) for i in range(len(dims) - 1)}


def mlp(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Dense layers ``l0, l1, ...`` with a ReLU between them, none after the last."""
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x, dtype)
        if i < n - 1:
            x = torch.relu(x)
    return x


def layer_norm_init(dim: int, device=None) -> Params:
    return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis: float32 statistics, biased variance."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with mask==False entries absent; a row with no
    valid entry gives zeros (exp(0) * 0 over a 1e-20 floor), never NaN."""
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=dim, keepdim=True).detach()  # JAX's stop_gradient
    e = torch.exp(logits - m) * mask
    return e / e.sum(dim=dim, keepdim=True).clamp_min(1e-20)
