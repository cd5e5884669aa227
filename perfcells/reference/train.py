"""The population's first training steps, lane by lane, in plain PyTorch.

Each lane is one run of the recipe: its draws worked out again from its seed
(the augment angles and flips, the encoder's dropout masks and the variety
rollouts' stream, from three generators on the device seeded by
``numpy.random.SeedSequence((seed ^ 0x5EED, step))``, drawn in the order the
program draws them), the variety loss on its batch (``model.variety_loss``),
its gradients by autograd, then clipping by the lane's global norm, AdamW
with the cosine schedule's warm-up, and the EMA, each written out from its
definition.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfcells.reference import model as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


def draws(seed: int, step: int, B: int, N: int, mcfg: dict, train: dict, T: int, device):
    """One lane's draws for ``step`` -> (theta, det, encoder dropout masks or
    None, gumbel, normal)."""
    words = np.random.SeedSequence(((int(seed) ^ 0x5EED) % 2**64, int(step))).generate_state(
        3, np.uint64)

    def gen(i):
        return torch.Generator(device=device).manual_seed(int(words[i]))

    g = gen(0)
    theta = (torch.rand(B, generator=g, device=device) * (2 * math.pi)
             if train["augment_rotate"] else torch.zeros(B, device=device))
    det = (torch.where(torch.rand(B, generator=g, device=device) < 0.5, -1.0, 1.0)
           if train["augment_flip"] else torch.ones(B, device=device))
    drop = None
    if mcfg["dropout"] > 0:
        g, keep = gen(1), 1.0 - mcfg["dropout"]
        drop = {k: (torch.rand((B, N, mcfg[d]), generator=g, device=device) < keep).float() / keep
                for k, d in (("emb", "embed_dim"), ("gat", "hidden_dim"))}
    gumbel, normal = ref.stream(train["variety_n"] * B, T, N, mcfg["num_mixtures"], gen(2), device)
    return theta, det, drop, gumbel, normal


def lr_at(count: int, train: dict) -> float:
    """The learning rate of update ``count`` (0 first): linear warm-up from
    0, then cosine decay to a hundredth, or constant."""
    lr = train["lr"]
    if train["lr_schedule"] == "constant":
        return lr
    warmup = min(train["warmup_steps"], train["steps"])
    decay = train["steps"] - warmup
    if count < warmup:
        return lr * count / warmup
    c = min(count - warmup, decay)
    return lr * (0.99 * 0.5 * (1 + math.cos(math.pi * c / decay)) + 0.01)


class LaneOptimizer:
    """Clip by the global norm, then AdamW, on one lane's parameters."""

    def __init__(self, params: List[torch.Tensor], train: dict):
        self.params, self.train = params, train
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        clip = self.train["grad_clip"]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).to(grads[0].dtype)
        if clip > 0 and norm >= clip:
            grads = [g * (clip / norm) for g in grads]
        lr = lr_at(self.count, self.train)
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        wd = self.train["weight_decay"]
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(B1).add_((1 - B1) * g)
            v.mul_(B2).add_((1 - B2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS) + wd * p
            p.sub_(lr * u)


def follow(init: Dict[str, torch.Tensor], mcfg: dict, train: dict, data: dict,
           mean, std, xy_all, mask_all, batches: Sequence[np.ndarray], seeds: Sequence[int],
           steps: int = 3, tf32: bool = False, dtype=torch.float32) -> dict:
    """Train every lane of ``init`` (leaves (S, ...)) for ``steps`` steps on
    ``batches[t][s]`` -> {"loss": (steps, S), "mu1": {leaf: (S, ...)} Adam's
    first moment after one step, "change": {leaf: (S, ...)} parameters
    minus their start after ``steps``, "ema_change": the same of the EMA}.
    ``dtype=torch.float64`` is a second witness: the same steps, every
    value but the draws in double precision."""
    init = {k: v.to(dtype) for k, v in init.items()}
    xy_all = xy_all.to(dtype)
    names = list(init)
    S = len(seeds)
    T, obs = data["pred_len"], data["obs_len"]
    dev = xy_all.device
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev).to(dtype)
    std = torch.as_tensor(std, dtype=torch.float32, device=dev).to(dtype)
    losses = np.zeros((steps, S))
    mu1 = {k: torch.empty_like(init[k]) for k in names}
    change = {k: torch.empty_like(init[k]) for k in names}
    ema_change = {k: torch.empty_like(init[k]) for k in names}
    d = train["ema_decay"]
    with ref.precision(tf32):
        for s in range(S):
            p = ref.lane_params(init, s, requires_grad=True)
            ema = {k: v.detach().clone() for k, v in p.items()}
            opt = LaneOptimizer([p[k] for k in names], train)
            for t in range(steps):
                idx = torch.as_tensor(np.asarray(batches[t][s]), device=dev)
                xy, mask = xy_all[idx], mask_all[idx]
                theta, det, drop, gumbel, normal = draws(seeds[s], t, len(idx), mask.shape[1],
                                                         mcfg, train, T, dev)
                xy = ref.augment(xy, theta, det)
                loss = ref.variety_loss(p, mcfg, xy, mask, mean, std, drop, gumbel, normal,
                                        train["variety_n"], obs)
                grads = torch.autograd.grad(loss, [p[k] for k in names])
                opt.step(grads)
                with torch.no_grad():
                    for k in names:
                        ema[k].mul_(d).add_((1 - d) * p[k])
                losses[t, s] = float(loss.detach())
                if t == 0:
                    for k, m in zip(names, opt.mu):
                        mu1[k][s] = m
            for k in names:
                change[k][s] = p[k].detach() - init[k][s]
                ema_change[k][s] = ema[k] - init[k][s]
    return {"loss": losses, "mu1": mu1, "change": change, "ema_change": ema_change}


def leaf_gaps(prog: Dict[str, torch.Tensor], refd: Dict[str, torch.Tensor],
              keep=None) -> list:
    """Each leaf's gap of norms: |‖prog‖ - ‖ref‖| over the larger of that
    leaf's ‖ref‖ and the median leaf's -> [(worst gap, its leaf, median
    gap)] a lane."""
    names = [k for k in refd if keep is None or k in keep]
    S = next(iter(refd.values())).shape[0]
    out = []
    for s in range(S):
        rn = {k: float(refd[k][s].double().norm()) for k in names}
        pn = {k: float(prog[k][s].double().norm()) for k in names}
        med = float(np.median(list(rn.values())))
        gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}
        worst = max(gaps, key=gaps.get)
        out.append((gaps[worst], worst, float(np.median(list(gaps.values())))))
    return out


def moved_leaves(mu1: Dict[str, torch.Tensor], frac: float = 1e-3) -> set:
    """Leaves whose first gradient (Adam's first moment after one step) is
    at least ``frac`` of the median leaf's in every lane: the rest move
    under Adam by round-off alone."""
    S = next(iter(mu1.values())).shape[0]
    keep = set(mu1)
    for s in range(S):
        n = {k: float(v[s].double().norm()) for k, v in mu1.items()}
        med = float(np.median(list(n.values())))
        keep &= {k for k, x in n.items() if x >= frac * med}
    return keep
