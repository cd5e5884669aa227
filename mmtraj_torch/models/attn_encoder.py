"""Spatio-temporal attention encoder, the second encoder family (counterpart
of ``mmtraj/models/attn_encoder.py``; ``ModelConfig.encoder="attn"``).

Per layer (pre-LN block, L = ``cfg.attn_layers``): causal multi-head
self-attention over each agent's observed steps; when ``cfg.social``, the
masked multi-head GAT of ``models/gat.py`` over every frame at once, with
time folded into the batch as (B·T, N, H) graphs; then a position-wise MLP
(H -> 4H -> H).  Positions are the parameter-free sinusoidal encoding, and
the readout is the layer-normed last observed step, zero on padded agents.

The temporal attention, the MLP and the residuals are plain ``torch``, as
the JAX package leaves them to XLA; the per-frame GAT reaches the attend
kernel through ``gat_apply`` where its dispatch rule says so ("auto": N >= 128
on CUDA), or the whole-layer kernel under ``cfg.use_pallas``.  Under
``cfg.use_pallas`` the layer norms of a CUDA tensor take the kernel pair of
``ops/fused_layer_norm.py`` (``_layer_norm``): a forward and a backward
kernel each, in place of the plain chain's 10 and 29; otherwise
``layers.layer_norm``.
Under ``compute_dtype=torch.bfloat16`` the products' operands are rounded to
bf16 (``layers.matmul``): the embedding, the projection, q, k, v, the
attention output before ``wo``, the MLP and the GAT's input; scores, the
softmax, the layer norms and the residual stream stay float32.

Tracing (``utils/profiling``): spans ``attn.encode``, ``attn.layer`` and,
over the backward, ``attn.encode_grad``; ``attn_layer.launches`` counts the
blocks applied.
"""

from __future__ import annotations

import math

import torch

from mmtraj_torch.graph.adjacency import proximity_adjacency
from mmtraj_torch.models.gat import gat_apply, gat_init
from mmtraj_torch.models.layers import (
    NEG_INF,
    Params,
    dense,
    dense_init,
    glorot,
    layer_norm,
    layer_norm_init,
    matmul,
    maybe_remat,
    mlp,
    mlp_init,
)
from mmtraj_torch.ops.fused_layer_norm import fused_layer_norm
from mmtraj_torch.utils.profiling import BackwardSpan, annotate, spans_on


def attn_encoder_init(generator: torch.Generator, cfg) -> Params:
    """Parameters with the JAX keys and shapes: embed (2->E), proj (E->H),
    layers.l{i}.{ln1, attn.{wq,wk,wv,wo,bo}, [ln2, gat], ln3, mlp.{l0,l1}},
    ln_out.  Drawn from ``generator`` on its device; the draws differ from
    JAX's."""
    E, H, L = cfg.embed_dim, cfg.hidden_dim, cfg.attn_layers
    assert H % cfg.num_heads == 0, "num_heads must divide hidden_dim"
    g, dev = generator, generator.device
    params: Params = {
        "embed": dense_init(g, 2, E),
        "proj": dense_init(g, E, H),
        "ln_out": layer_norm_init(H, dev),
        "layers": {},
    }
    for i in range(L):
        layer: Params = {
            "ln1": layer_norm_init(H, dev),
            "attn": {
                "wq": glorot(g, (H, H)),
                "wk": glorot(g, (H, H)),
                "wv": glorot(g, (H, H)),
                "wo": glorot(g, (H, H)),
                "bo": torch.zeros(H, device=dev),
            },
            "ln3": layer_norm_init(H, dev),
            "mlp": mlp_init(g, (H, 4 * H, H)),
        }
        if cfg.social:
            layer["ln2"] = layer_norm_init(H, dev)
            layer["gat"] = gat_init(g, H, H, cfg.num_heads)
        params["layers"][f"l{i}"] = layer
    return params


def sinusoidal_positions(T: int, H: int, device=None) -> torch.Tensor:
    """(T, H) parameter-free sinusoidal positional encoding (float32); an odd
    H pads the last lane with zero."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(H // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * dim / H)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    if pe.shape[-1] < H:
        pe = torch.nn.functional.pad(pe, (0, H - pe.shape[-1]))
    return pe


def _layer_norm(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """``layers.layer_norm(p, x)``; on the card under ``cfg.use_pallas`` (the
    flag that sends the GAT to ``fused_gat``) ``fused_layer_norm``: one
    forward and one backward kernel, which raise for what they do not take."""
    if cfg.use_pallas and x.is_cuda:
        return fused_layer_norm(x, p["scale"], p["bias"])
    return layer_norm(p, x)


def _temporal_mhsa(p: Params, x: torch.Tensor, num_heads: int, dtype=None) -> torch.Tensor:
    """Causal multi-head self-attention over the time axis, per agent:
    x (B, N, T, H) -> (B, N, T, H).  Scores are scaled by 1/sqrt(dh) and the
    future is masked with -1e9; every row keeps at least itself.  ``dtype``
    rounds the operands of the four products; scores and softmax are
    float32."""
    B, N, T, H = x.shape
    dh = H // num_heads
    xin = x if dtype is None else x.to(dtype)

    def split(a):
        return a.reshape(B, N, T, num_heads, dh)

    q, k, v = (split(matmul(xin, p[w], dtype)) for w in ("wq", "wk", "wv"))
    scores = torch.einsum("bnthd,bnshd->bnhts", q, k) / math.sqrt(dh)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = torch.where(causal, scores, NEG_INF)
    alpha = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnhts,bnshd->bnthd", alpha, v).reshape(B, N, T, H)
    return matmul(out, p["wo"], dtype) + p["bo"]


def attn_layer(lp: Params, x: torch.Tensor, cfg, adj_flat, mask_flat, drop, train: bool,
               dt, layer: int) -> torch.Tensor:
    """One pre-LN block (layer ``layer``) on x (B, N, T, H): x += causal
    MHSA(LN1 x); x += GAT(LN2 x) over the (B·T, N, H) frame graphs
    ``adj_flat``/``mask_flat`` where ``cfg.social``; x += MLP(LN3 x).  Each
    application, a checkpoint's recomputation included, counts in
    ``attn_layer.launches`` (no kernel launch: ``ops.launch_counters()``
    leaves it out) and is an ``attn.layer`` span (``layer``)."""
    attn_layer.launches += 1
    with annotate("attn.layer", layer=layer):
        B, N, T, _ = x.shape
        x = x + _temporal_mhsa(lp["attn"], _layer_norm(lp["ln1"], x, cfg), cfg.num_heads, dt)
        if cfg.social:
            y_flat = _layer_norm(lp["ln2"], x, cfg).transpose(1, 2).reshape(B * T, N, -1)
            g = gat_apply(lp["gat"], y_flat, adj_flat, mask_flat, cfg.num_heads, dt,
                          use_pallas=cfg.use_pallas, attend_kernel=cfg.attend_kernel,
                          train=train)
            g = g.reshape(B, T, N, -1).transpose(1, 2)  # (B, N, T, H)
            if drop is not None:
                g = g * drop["gat"][:, :, None, :]
            x = x + g
        return x + mlp(lp["mlp"], _layer_norm(lp["ln3"], x, cfg), dt)


attn_layer.launches = 0


def attn_encode(params: Params, cfg, xy_obs: torch.Tensor, dxy_n: torch.Tensor,
                mask: torch.Tensor, drop=None, train: bool = False,
                compute_dtype=None) -> torch.Tensor:
    """Encode an observation window -> (B, N, H) last-step features.

    xy_obs (B, N, To, 2) absolute meters (the per-frame proximity graphs),
    dxy_n (B, N, To, 2) normalized offsets (the content stream), mask (B, N).
    ``drop``: the encoder's variational dropout masks {"emb": (B, N, E),
    "gat": (B, N, H)}, broadcast over time: "emb" scales the embedding,
    "gat" the GAT residual.  ``train`` marks a differentiated path, on which
    "auto" keeps the plain attend chain.  Each layer is checkpointed per
    ``cfg.remat`` where a graph is recorded.  ``compute_dtype``: the
    products' operand dtype (None: float32); the result is float32.

    Spans: ``attn.encode`` around the call, an ``attn.layer`` a block
    (``attn_layer``) and, where a gradient is recorded, ``attn.encode_grad``
    over the encoder's backward, from the readout's gradient to the
    embedding's (``profiling.BackwardSpan``; blocks a checkpoint recomputes
    run inside it)."""
    with annotate("attn.encode"):
        dt = compute_dtype
        B, N, T, _ = xy_obs.shape
        grad_span = None
        embed = params["embed"]
        if spans_on() and torch.is_grad_enabled():
            grad_span = BackwardSpan("attn.encode_grad")
            w, b = grad_span.closes(embed["w"], embed["b"])
            embed = {"w": w, "b": b}
        x = torch.relu(dense(embed, dxy_n, dt))  # (B, N, T, E)
        if drop is not None:
            x = x * drop["emb"][:, :, None, :]
        x = dense(params["proj"], x, dt)  # (B, N, T, H)
        x = x + sinusoidal_positions(T, x.shape[-1], x.device)

        adj_flat = mask_flat = None
        if cfg.social:
            # One adjacency per frame, all frames at once: fold T into the batch.
            xy_flat = xy_obs.transpose(1, 2).reshape(B * T, N, 2)
            mask_flat = mask[:, None, :].expand(B, T, N).reshape(B * T, N)
            adj_flat = proximity_adjacency(xy_flat, mask_flat, cfg.adjacency_radius)

        layer_apply = maybe_remat(cfg, attn_layer)
        for i in range(cfg.attn_layers):
            x = layer_apply(params["layers"][f"l{i}"], x, cfg, adj_flat, mask_flat, drop, train,
                            dt, i)
        feat = _layer_norm(params["ln_out"], x[:, :, -1], cfg)
        feat = torch.where(mask[..., None], feat, 0.0)
        if grad_span is not None:
            (feat,) = grad_span.opens(feat)
        return feat
