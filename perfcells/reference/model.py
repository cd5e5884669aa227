"""The forecaster in plain PyTorch, float32: the reference the benchmark
holds the program to.

Written from the model's equations, independent of the program's code: an
encoder over the observed frames (embed the normalised offset, a fused-gate
GRU, then a GAT residual over the proximity graph of that frame's
positions), a tanh bridge, and a decoder that at each predicted step reads
a bivariate-Gaussian-mixture head from its state, samples an offset
(Gumbel-max component pick, correlated normal draw), integrates it, and
advances on it as the encoder does.  Parameters are a flat dict of
``"enc.cell.wx"``-style keys in ``(in, out)`` orientation, the layout the
program's state dict uses, so one set of weights made by the harness feeds
both.  Nothing here imports the program.

``tf32=True`` makes every matrix product take TF32 operands (10-bit
mantissas): on a card by TF32 itself, elsewhere by rounding the operands.
That is the control: the reference one precision below the float32 the
configuration states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]
NEG_INF = -1e9


# -- parameters -----------------------------------------------------------------

def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Name -> shape for the GRU + social GAT + GMM forecaster of ``cfg``
    (the ``model`` part of a configuration file)."""
    E, H, M = cfg["embed_dim"], cfg["hidden_dim"], cfg["num_mixtures"]
    shapes = {}
    for coder in ("enc", "dec"):
        shapes.update({f"{coder}.embed.w": (2, E), f"{coder}.embed.b": (E,),
                       f"{coder}.cell.wx": (E, 3 * H), f"{coder}.cell.wh": (H, 3 * H),
                       f"{coder}.cell.b": (3 * H,),
                       f"{coder}.gat.wv": (H, H), f"{coder}.gat.a_src": (cfg["num_heads"],
                                                                         H // cfg["num_heads"]),
                       f"{coder}.gat.a_dst": (cfg["num_heads"], H // cfg["num_heads"]),
                       f"{coder}.gat.wo": (H, H), f"{coder}.gat.bo": (H,)})
    shapes.update({"bridge_h.w": (H, H), "bridge_h.b": (H,), "head.w": (H, 6 * M),
                   "head.b": (6 * M,)})
    return shapes


def init_params(cfg: dict, lanes: int, generator: torch.Generator) -> Params:
    """Glorot-normal weights (std sqrt(2 / (fan_in + fan_out))) and zero
    biases for ``lanes`` models, each leaf (lanes, ...), from one draw on
    the generator's device."""
    shapes = param_shapes(cfg)
    weights = {k: s for k, s in shapes.items() if len(s) == 2}
    sizes = [math.prod(s) for s in weights.values()]
    flat = torch.randn((lanes, sum(sizes)), generator=generator, device=generator.device)
    out, at = {}, 0
    for (k, s), size in zip(weights.items(), sizes):
        out[k] = flat[:, at:at + size].reshape((lanes,) + s) * math.sqrt(2.0 / (s[0] + s[1]))
        at += size
    for k, s in shapes.items():
        if k not in out:
            out[k] = torch.zeros((lanes,) + s, device=generator.device)
    return {k: out[k].contiguous() for k in shapes}


def sub(p: Params, prefix: str) -> Params:
    return {k[len(prefix) + 1:]: v for k, v in p.items() if k.startswith(prefix + ".")}


# -- precision ------------------------------------------------------------------

_TF32 = [False]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (nearest, ties away), held as float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and the backward's products
    likewise, as TF32 runs them; b is (k, n) or batched like a."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = _round_tf32(a), _round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = _round_tf32(g)
        ga = rg @ rb.transpose(-1, -2)
        if rb.dim() == 2:
            gb = ra.reshape(-1, ra.shape[-1]).T @ rg.reshape(-1, rg.shape[-1])
        else:
            gb = ra.transpose(-1, -2) @ rg
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, in float32, or with TF32 operands under ``precision(tf32=True)``
    on a device without TF32 of its own."""
    if _TF32[0] and not a.is_cuda:
        return _Tf32Matmul.apply(a, b)
    return a @ b


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in float32 (TF32 off), or in TF32 (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, _TF32[0])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _TF32[0] = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         _TF32[0]) = old


# -- layers ---------------------------------------------------------------------

def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return mm(x, p["w"]) + p["b"]


def gru(p: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Gate order (z, r, n); n = tanh(x Wxn + b_n + r * (h Whn))."""
    H = h.shape[-1]
    xg = mm(x, p["wx"]) + p["b"]
    hg = mm(h, p["wh"])
    z = torch.sigmoid(xg[..., :H] + hg[..., :H])
    r = torch.sigmoid(xg[..., H:2 * H] + hg[..., H:2 * H])
    n = torch.tanh(xg[..., 2 * H:] + r * hg[..., 2 * H:])
    return (1.0 - z) * n + z * h


def adjacency(xy: torch.Tensor, mask: torch.Tensor, radius: float) -> torch.Tensor:
    """(G, N, 2), (G, N) -> bool (G, N, N): both valid, not the same agent,
    squared distance at most radius^2."""
    dx = xy[..., :, None, 0] - xy[..., None, :, 0]
    dy = xy[..., :, None, 1] - xy[..., None, :, 1]
    d2 = dx * dx + dy * dy
    n = xy.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=xy.device)
    return mask[..., :, None] & mask[..., None, :] & ~eye & (d2 <= radius * radius)


def gat(p: Params, h: torch.Tensor, adj: torch.Tensor, mask: torch.Tensor,
        heads: int) -> torch.Tensor:
    """Masked multi-head graph attention with self-loops for valid agents:
    per head, LeakyReLU(0.2) of s_src[i] + s_dst[j] over i's neighbours,
    softmax, aggregate of v; concatenated heads through wo + bo; padded
    rows 0."""
    G, N, _ = h.shape
    v = mm(h, p["wv"])
    dh = v.shape[-1] // heads
    vh = v.reshape(G, N, heads, dh)
    s_src = (vh * p["a_src"]).sum(-1)  # (G, N, heads)
    s_dst = (vh * p["a_dst"]).sum(-1)
    eye = torch.eye(N, dtype=torch.bool, device=h.device)
    att = adj | (eye & mask[:, :, None] & mask[:, None, :])
    cols = []
    for k in range(heads):
        logit = s_src[:, :, k, None] + s_dst[:, None, :, k]
        logit = torch.where(logit > 0, logit, 0.2 * logit)
        logit = torch.where(att, logit, NEG_INF)
        e = torch.exp(logit - logit.amax(-1, keepdim=True).detach()) * att
        alpha = e / e.sum(-1, keepdim=True).clamp_min(1e-20)
        cols.append(mm(alpha, vh[:, :, k]))
    out = mm(torch.cat(cols, -1), p["wo"]) + p["bo"]
    return torch.where(mask[..., None], out, 0.0)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


def head(p: Params, h: torch.Tensor, cfg: dict):
    """-> (logits (..., M), mu (..., M, 2), sigma (..., M, 2), rho (..., M));
    the raw columns are [logits, (mu_x, mu_y) per component, (sigma_x,
    sigma_y) per component, rho]."""
    M = cfg["num_mixtures"]
    raw = dense(p, h)
    lead = raw.shape[:-1]
    mu = raw[..., M:3 * M].reshape(lead + (M, 2))
    sigma = (softplus(raw[..., 3 * M:5 * M]) + cfg["sigma_min"]).reshape(lead + (M, 2))
    rho = cfg["rho_max"] * torch.tanh(raw[..., 5 * M:])
    return raw[..., :M], mu, sigma, rho


def component_offsets(mu, sigma, rho, z):
    """The normalised offset each component would give for the normal draw
    z (..., 2) -> (..., M, 2)."""
    z0, z1 = z[..., None, 0], z[..., None, 1]
    dx = mu[..., 0] + sigma[..., 0] * z0
    dy = mu[..., 1] + sigma[..., 1] * (rho * z0 + torch.sqrt(torch.clamp_min(1.0 - rho * rho,
                                                                           1e-6)) * z1)
    return torch.stack([dx, dy], -1)


def sample(mu, sigma, rho, logits, gumbel, z):
    """One offset (..., 2): the component that maximises logits + gumbel
    (the first of equal ones), drawn with the normal z."""
    k = torch.argmax(logits + gumbel, -1, keepdim=True)
    offs = component_offsets(mu, sigma, rho, z)
    return torch.gather(offs, -2, k[..., None].expand(k.shape + (2,)))[..., 0, :]


# -- the model ------------------------------------------------------------------

def _advance(p: Params, cfg: dict, h, dxy_n, xy, mask, drop=None):
    """One frame of a coder: embed -> GRU -> GAT residual on the graph of ``xy``."""
    x = torch.relu(dense(sub(p, "embed"), dxy_n))
    if drop is not None:
        x = x * drop["emb"]
    h = gru(sub(p, "cell"), x, h)
    g = gat(sub(p, "gat"), h, adjacency(xy, mask, cfg["adjacency_radius"]), mask,
            cfg["num_heads"])
    if drop is not None:
        g = g * drop["gat"]
    return h + g


def offsets(xy: torch.Tensor) -> torch.Tensor:
    """(..., T, 2) positions -> one-step offsets, the first 0."""
    return torch.cat([torch.zeros_like(xy[..., :1, :]), xy[..., 1:, :] - xy[..., :-1, :]], -2)


def encode(p: Params, cfg: dict, xy_obs, mask, mean, std, drop=None) -> torch.Tensor:
    """xy_obs (G, N, To, 2) meters, mask (G, N) -> the decoder's initial
    state (G, N, H): the encoder's last state through the tanh bridge."""
    G, N = mask.shape
    d = (offsets(xy_obs) - mean) / std
    h = torch.zeros((G, N, cfg["hidden_dim"]), dtype=xy_obs.dtype, device=xy_obs.device)
    pe = sub(p, "enc")
    for t in range(xy_obs.shape[2]):
        h = _advance(pe, cfg, h, d[:, :, t], xy_obs[:, :, t], mask, drop)
    return torch.tanh(dense(sub(p, "bridge_h"), h))


def rollout(p: Params, cfg: dict, h, xy_last, mask, mean, std, gumbel, normal,
            frozen: bool = False) -> torch.Tensor:
    """Sampled decode: h (G, N, H), xy_last (G, N, 2), gumbel (G, T, N, M),
    normal (G, T, N, 2) -> positions (G, N, T, 2).  ``frozen`` is a fault:
    the state is never advanced."""
    pd = sub(p, "dec")
    xy, outs = xy_last, []
    for t in range(gumbel.shape[1]):
        logits, mu, sigma, rho = head(sub(p, "head"), h, cfg)
        dxy_n = sample(mu, sigma, rho, logits, gumbel[:, t], normal[:, t])
        xy = xy + dxy_n * std + mean
        h_new = _advance(pd, cfg, h, dxy_n, xy, mask)
        h = h if frozen else h_new
        outs.append(xy)
    return torch.stack(outs, 2)


def augment(xy: torch.Tensor, theta: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """Rotate window b by theta[b], then reflect its y axis where det[b] = -1."""
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    dt = det[:, None, None]
    x, y = xy[..., 0], xy[..., 1]
    return torch.stack([c * x - s * y, dt * (s * x + c * y)], -1)


def variety_loss(p: Params, cfg: dict, xy, mask, mean, std, drop_enc, gumbel, normal,
                 n_samples: int, obs_len: int) -> torch.Tensor:
    """Winner-takes-all loss over ``n_samples`` rollouts: each valid agent's
    smallest mean squared position error, averaged over valid agents.
    gumbel/normal: (n_samples * B, T, N, .), row kk * B + b."""
    xy_obs, gt = xy[:, :, :obs_len], xy[:, :, obs_len:]
    B, N = mask.shape
    h = encode(p, cfg, xy_obs, mask, mean, std, drop_enc)
    k = n_samples
    preds = rollout(p, cfg, h.repeat(k, 1, 1), xy_obs[:, :, -1].repeat(k, 1, 1), mask.repeat(k, 1),
                    mean, std, gumbel, normal).reshape(k, B, N, -1, 2)
    err = ((preds - gt[None]) ** 2).sum(-1).mean(-1)
    w = mask.to(torch.float32)
    return (err.amin(0) * w).sum() / torch.clamp_min(w.sum(), 1.0)


def draw_gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def stream(rows: int, steps: int, n: int, mixtures: int, generator: torch.Generator,
           device) -> tuple:
    """(gumbel (rows, T, N, M), normal (rows, T, N, 2)): uniforms then
    normals from ``generator``, the order the program draws them in."""
    u = torch.rand((rows, steps, n, mixtures), generator=generator, device=device)
    z = torch.randn((rows, steps, n, 2), generator=generator, device=device)
    return draw_gumbel(u), z


def lane_params(p: Params, s: int, requires_grad: bool = False) -> Params:
    return {k: v[s].detach().clone().requires_grad_(requires_grad) for k, v in p.items()}
