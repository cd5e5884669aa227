"""The attention-encoder forecaster in plain PyTorch, float32, with its
teacher-forced NLL and a sequential training step: the reference that the
``config4-attn3`` cells hold the program to.

Written from the model's equations (the spatio-temporal transformer of
STAR, https://arxiv.org/abs/2005.08514, as the repository states it),
independent of the program's code:

- input: ``x = proj(relu(embed(dxy_n))) + sinusoid(T)``, the sinusoid
  ``[sin(t / 10000^(2i/H)), cos(...)]`` over i < H/2, halves side by side;
- L pre-LN blocks, each ``x += MHSA(LN1 x)`` (per agent over its T steps,
  ``heads`` heads of H/heads, scores over sqrt(H/heads), the future masked),
  ``x += GAT(LN2 x)`` (every frame's agents one graph: proximity adjacency
  of that frame's positions, self-loops for valid agents) and
  ``x += MLP(LN3 x)`` (H -> 4H -> H, ReLU between);
- readout ``LN_out(x[:, :, -1])``, zero on padded agents, then the tanh
  bridge, the GRU decoder advanced on the ground truth, and the GMM head
  of ``reference/model.py``; the loss is the mixture's negative
  log-likelihood of each normalised target offset, averaged over valid
  agent-steps.

Layer norms take float32 statistics with the biased variance and eps 1e-6.
A step (``train_step``) differentiates the loss by autograd, clips by the
global norm and takes AdamW (``reference/train.py``'s ``LaneOptimizer``) at
the configuration's learning rate, from any state: the cell's check
compares each of the program's steps with the reference's step from the
program's own state before it.  Departures from the program, none of which
changes the mathematics: no kernel (the GAT is ``model.gat``'s plain heads),
no checkpointing (every activation is kept), no vmap and no CUDA graph; the
GAT's per-node scores are sums of products rather than a product with a
block-diagonal matrix; the clip's global norm is summed in float64.
``causal=False`` drops the temporal mask: a reference that sees the future,
which the tests show the comparison refuses.  Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from perfcells.reference import model as ref
from perfcells.reference import train as reftrain

Params = Dict[str, torch.Tensor]


# -- parameters -----------------------------------------------------------------

def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Name -> shape for the attention encoder (``cfg["attn_layers"]``
    blocks), the GRU + GAT decoder, the bridge and the GMM head, in the
    program's ``(in, out)`` orientation and state-dict names."""
    E, H, M, heads = cfg["embed_dim"], cfg["hidden_dim"], cfg["num_mixtures"], cfg["num_heads"]
    gat = {"wv": (H, H), "a_src": (heads, H // heads), "a_dst": (heads, H // heads),
           "wo": (H, H), "bo": (H,)}
    shapes = {"enc.embed.w": (2, E), "enc.embed.b": (E,), "enc.proj.w": (E, H),
              "enc.proj.b": (H,)}
    for i in range(cfg["attn_layers"]):
        p = f"enc.layers.l{i}."
        for ln in ("ln1", "ln2", "ln3"):
            shapes.update({p + ln + ".scale": (H,), p + ln + ".bias": (H,)})
        shapes.update({p + "attn." + w: (H, H) for w in ("wq", "wk", "wv", "wo")})
        shapes[p + "attn.bo"] = (H,)
        shapes.update({p + "gat." + k: s for k, s in gat.items()})
        shapes.update({p + "mlp.l0.w": (H, 4 * H), p + "mlp.l0.b": (4 * H,),
                       p + "mlp.l1.w": (4 * H, H), p + "mlp.l1.b": (H,)})
    shapes.update({"enc.ln_out.scale": (H,), "enc.ln_out.bias": (H,),
                   "dec.embed.w": (2, E), "dec.embed.b": (E,), "dec.cell.wx": (E, 3 * H),
                   "dec.cell.wh": (H, 3 * H), "dec.cell.b": (3 * H,)})
    shapes.update({"dec.gat." + k: s for k, s in gat.items()})
    shapes.update({"bridge_h.w": (H, H), "bridge_h.b": (H,), "head.w": (H, 6 * M),
                   "head.b": (6 * M,)})
    return shapes


def draw_order(cfg: dict) -> list:
    """The weight matrices in the order ``cli train`` draws them: the
    encoder's embedding and projection, each block's attention (q, k, v,
    o), MLP and GAT (v, a_src, a_dst, o), then the decoder's embedding, GRU
    (x, h) and GAT, the bridge and the head."""
    names = ["enc.embed.w", "enc.proj.w"]
    for i in range(cfg["attn_layers"]):
        p = f"enc.layers.l{i}."
        names += [p + "attn." + w for w in ("wq", "wk", "wv", "wo")]
        names += [p + "mlp.l0.w", p + "mlp.l1.w"]
        names += [p + "gat." + w for w in ("wv", "a_src", "a_dst", "wo")]
    names += ["dec.embed.w", "dec.cell.wx", "dec.cell.wh"]
    names += ["dec.gat." + w for w in ("wv", "a_src", "a_dst", "wo")]
    return names + ["bridge_h.w", "head.w"]


def init_params(cfg: dict, generator: torch.Generator) -> Params:
    """The weights a training run seeded with ``generator``'s seed starts
    from: each matrix Glorot-normal (a normal draw of its shape times
    sqrt(2 / (fan_in + fan_out))), one draw after another on the generator
    (a CPU one for ``cli train``'s) in ``draw_order``; layer-norm scales 1,
    every other vector 0.  On the generator's device."""
    shapes = param_shapes(cfg)
    order = draw_order(cfg)
    assert sorted(order) == sorted(k for k, s in shapes.items() if len(s) == 2)
    out = {}
    for k in order:
        s = shapes[k]
        out[k] = torch.randn(s, generator=generator, device=generator.device) * \
            math.sqrt(2.0 / (s[0] + s[1]))
    for k, s in shapes.items():
        if k not in out:
            fill = 1.0 if k.endswith(".scale") else 0.0
            out[k] = torch.full(s, fill, device=generator.device)
    return {k: out[k] for k in shapes}


# -- the encoder ----------------------------------------------------------------

def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def positions(T: int, H: int, device) -> torch.Tensor:
    """(T, H) sinusoids: sin in the first H/2 lanes, cos in the next."""
    t = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(H // 2, dtype=torch.float32, device=device)[None, :]
    angle = t / torch.pow(10000.0, 2.0 * i / H)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], -1)
    return torch.nn.functional.pad(pe, (0, H - pe.shape[-1]))


def mhsa(p: Params, x: torch.Tensor, heads: int, causal: bool = True) -> torch.Tensor:
    """Self-attention over the time axis of x (B, N, T, H), per agent."""
    B, N, T, H = x.shape
    dh = H // heads

    def split(w):  # (B, N, heads, T, dh)
        return ref.mm(x, p[w]).reshape(B, N, T, heads, dh).transpose(2, 3)

    q, k, v = split("wq"), split("wk"), split("wv")
    scores = ref.mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    if causal:
        future = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(future, ref.NEG_INF)
    out = ref.mm(torch.softmax(scores, -1), v).transpose(2, 3).reshape(B, N, T, H)
    return ref.mm(out, p["wo"]) + p["bo"]


def block(p: Params, cfg: dict, x, adj, mask_flat, causal: bool = True) -> torch.Tensor:
    """One pre-LN block on x (B, N, T, H); adj (B·T, N, N) and mask_flat
    (B·T, N) are the frames' graphs, frame-major within a window."""
    B, N, T, H = x.shape
    x = x + mhsa(ref.sub(p, "attn"), layer_norm(ref.sub(p, "ln1"), x), cfg["num_heads"], causal)
    y = layer_norm(ref.sub(p, "ln2"), x).transpose(1, 2).reshape(B * T, N, H)
    g = ref.gat(ref.sub(p, "gat"), y, adj, mask_flat, cfg["num_heads"])
    x = x + g.reshape(B, T, N, H).transpose(1, 2)
    y = torch.relu(ref.dense(ref.sub(p, "mlp.l0"), layer_norm(ref.sub(p, "ln3"), x)))
    return x + ref.dense(ref.sub(p, "mlp.l1"), y)


def encode_features(p: Params, cfg: dict, xy_obs, d_obs, mask, causal: bool = True):
    """xy_obs (B, N, T, 2) meters, d_obs its normalised offsets, mask (B, N)
    -> the readout (B, N, H), zero on padded agents."""
    B, N, T, _ = xy_obs.shape
    pe = ref.sub(p, "enc")
    x = torch.relu(ref.dense(ref.sub(pe, "embed"), d_obs))
    x = ref.dense(ref.sub(pe, "proj"), x)
    x = x + positions(T, x.shape[-1], x.device)
    xy_flat = xy_obs.transpose(1, 2).reshape(B * T, N, 2)
    mask_flat = mask[:, None, :].expand(B, T, N).reshape(B * T, N)
    adj = ref.adjacency(xy_flat, mask_flat, cfg["adjacency_radius"])
    for i in range(cfg["attn_layers"]):
        x = block(ref.sub(pe, f"layers.l{i}"), cfg, x, adj, mask_flat, causal)
    feat = layer_norm(ref.sub(pe, "ln_out"), x[:, :, -1])
    return torch.where(mask[..., None], feat, 0.0)


# -- the loss -------------------------------------------------------------------

def gmm_nll(logits, mu, sigma, rho, target) -> torch.Tensor:
    """-log of the mixture's density of target (..., 2), each component a
    bivariate normal with correlation rho (1 - rho^2 floored at 1e-6)."""
    d = (target[..., None, :] - mu) / sigma
    dx, dy = d[..., 0], d[..., 1]
    one_m = torch.clamp_min(1.0 - rho * rho, 1e-6)
    log_comp = (-torch.log(2 * math.pi * sigma[..., 0] * sigma[..., 1]) - 0.5 * torch.log(one_m)
                - (dx * dx + dy * dy - 2 * rho * dx * dy) / (2 * one_m))
    return -torch.logsumexp(torch.log_softmax(logits, -1) + log_comp, -1)


def nll_loss(p: Params, cfg: dict, xy, mask, mean, std, obs_len: int,
             causal: bool = True) -> torch.Tensor:
    """Teacher-forced NLL of full windows xy (B, N, T, 2): each predicted
    step's head reads the state before it, which then advances on the true
    offset and positions; masked mean over valid agent-steps."""
    d = (ref.offsets(xy) - mean) / std
    xy_obs, d_obs, xy_fut, d_fut = xy[:, :, :obs_len], d[:, :, :obs_len], xy[:, :, obs_len:], \
        d[:, :, obs_len:]
    feat = encode_features(p, cfg, xy_obs, d_obs, mask, causal)
    h = torch.tanh(ref.dense(ref.sub(p, "bridge_h"), feat))
    pd = ref.sub(p, "dec")
    per_step = []
    for t in range(d_fut.shape[2]):
        logits, mu, sigma, rho = ref.head(ref.sub(p, "head"), h, cfg)
        per_step.append(gmm_nll(logits, mu, sigma, rho, d_fut[:, :, t]))
        h = ref._advance(pd, cfg, h, d_fut[:, :, t], xy_fut[:, :, t], mask)
    nll = torch.stack(per_step, -1)  # (B, N, Tp)
    w = mask[..., None].to(nll.dtype)
    return (nll * w).sum() / torch.clamp_min(w.sum() * nll.shape[-1], 1.0)


# -- training -------------------------------------------------------------------

def start_state(init: Params) -> dict:
    """A run's state before its first step: the parameters, Adam's zero
    moments and a count of 0."""
    return {"params": {k: v.detach().clone() for k, v in init.items()},
            "mu": {k: torch.zeros_like(v) for k, v in init.items()},
            "nu": {k: torch.zeros_like(v) for k, v in init.items()}, "count": 0}


def train_step(state: dict, mcfg: dict, train: dict, obs_len: int, mean, std, xy, mask,
               tf32: bool = False, causal: bool = True) -> tuple:
    """One sequential step from ``state`` (``start_state``'s keys) on the
    batch (xy, mask) -> (loss, {leaf: gradient}, the state after it): the
    loss's gradient by autograd, then the clip by the global norm and AdamW
    (``reference/train.py``'s ``LaneOptimizer``) from the state's moments and
    count.  ``tf32``: every product one precision down (the control)."""
    names = list(state["params"])
    dev = xy.device
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    std = torch.as_tensor(std, dtype=torch.float32, device=dev)
    p = {k: v.detach().clone().requires_grad_() for k, v in state["params"].items()}
    opt = reftrain.LaneOptimizer([p[k] for k in names], train)
    opt.mu = [state["mu"][k].clone() for k in names]
    opt.nu = [state["nu"][k].clone() for k in names]
    opt.count = state["count"]
    with ref.precision(tf32):
        loss = nll_loss(p, mcfg, xy, mask, mean, std, obs_len, causal)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        opt.step(grads)
    after = {"params": {k: v.detach() for k, v in p.items()},
             "mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu)), "count": opt.count}
    return float(loss.detach()), dict(zip(names, grads)), after


def follow(init: Params, mcfg: dict, train: dict, data: dict, mean, std, xy_all, mask_all,
           batches: Sequence[np.ndarray], steps: int = 3, tf32: bool = False,
           causal: bool = True) -> dict:
    """Train ``init`` for ``steps`` sequential steps on ``batches[t]`` (window
    indices) -> {"loss": [steps], "grad": [{leaf: gradient}], "state":
    [the state before each step, and after the last]}."""
    state = start_state(init)
    out = {"loss": [], "grad": [], "state": [state]}
    for t in range(steps):
        idx = torch.as_tensor(np.asarray(batches[t]), device=xy_all.device)
        loss, grads, state = train_step(state, mcfg, train, data["obs_len"], mean, std,
                                        xy_all[idx], mask_all[idx], tf32, causal)
        out["loss"].append(loss)
        out["grad"].append(grads)
        out["state"].append(state)
    return out
