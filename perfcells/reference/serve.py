"""Judging served rollouts against the reference, one step at a time.

A served answer is K sampled trajectories a window.  Each step of one is a
draw: the component that maximises the head's logits plus that step's
Gumbel noise, moved by that component's correlated normal draw.  The
reference reads the served trajectory back as its input, as a served model's
tokens are read back: at every step it computes the head from its own state
(encoded from the window, advanced on the served positions), finds the
component whose draw lies closest to the served offset, and measures

- ``logit_gap``: how far that component's logit plus noise lies below the
  reference's best (0 where the program picked as the reference does, a
  rounding's worth at a near tie), and
- ``pos_gap_m``: how far the served offset lies from that component's draw,
  in meters.

Reading the answer back keeps one step's rounding from compounding into a
different trajectory.  One thing can still fork a step honestly: a pair of
agents whose squared distance lies within ``adj_eps`` of the radius squared
may be neighbours on one side and not on the other.  A sample graph is left
out from the step after such a pair appears (a window from the start where
one appears among its observed frames); how many were left out is reported.
"""

from __future__ import annotations

import torch

from perfcells.reference import model as ref


def ambiguous(xy: torch.Tensor, mask: torch.Tensor, radius: float, eps: float) -> torch.Tensor:
    """(G, N, 2), (G, N) -> (G,) bool: some valid pair's squared distance
    is within ``eps`` of radius^2."""
    dx = xy[..., :, None, 0] - xy[..., None, :, 0]
    dy = xy[..., :, None, 1] - xy[..., None, :, 1]
    near = ((dx * dx + dy * dy) - radius * radius).abs() < eps
    n = xy.shape[-2]
    pair = mask[:, :, None] & mask[:, None, :] & ~torch.eye(n, dtype=torch.bool,
                                                            device=xy.device)
    return (near & pair).flatten(1).any(1)


@torch.no_grad()
def read_back(p, cfg: dict, xy_obs, mask, mean, std, served, gumbel, normal,
              adj_eps: float) -> dict:
    """xy_obs (R, N, To, 2), mask (R, N), served (R, K, N, T, 2) meters,
    gumbel (R, K, T, N, M), normal (R, K, T, N, 2) -> {"logit_gap",
    "pos_gap_m", "graphs", "left_out"}: the widest gaps over every valid
    agent's every step of every sample graph not left out."""
    R, K, N, T, _ = served.shape
    radius = cfg["adjacency_radius"]
    h = ref.encode(p, cfg, xy_obs, mask, mean, std)
    bad_window = torch.zeros(R, dtype=torch.bool, device=mask.device)
    for t in range(xy_obs.shape[2]):
        bad_window |= ambiguous(xy_obs[:, :, t], mask, radius, adj_eps)
    G = R * K
    h = h.repeat_interleave(K, 0)
    m = mask.repeat_interleave(K, 0)
    prev = xy_obs[:, :, -1].repeat_interleave(K, 0)
    gum = gumbel.reshape(G, T, N, -1)
    nrm = normal.reshape(G, T, N, 2)
    out = served.reshape(G, N, T, 2)
    live = ~bad_window.repeat_interleave(K, 0)
    logit_gap = torch.zeros((), device=mask.device)
    pos_gap = torch.zeros((), device=mask.device)
    pd, ph = ref.sub(p, "dec"), ref.sub(p, "head")
    for t in range(T):
        logits, mu, sigma, rho = ref.head(ph, h, cfg)
        xy_t = out[:, :, t]
        d = xy_t - prev
        offs = ref.component_offsets(mu, sigma, rho, nrm[:, t]) * std + mean  # (G, N, M, 2)
        err = (offs - d[:, :, None]).abs().amax(-1)  # (G, N, M)
        pick = err.argmin(-1, keepdim=True)
        score = logits + gum[:, t]
        gap = score.amax(-1) - torch.gather(score, -1, pick)[..., 0]
        counted = m & live[:, None]
        logit_gap = torch.maximum(logit_gap, torch.where(counted, gap, 0.0).max())
        pos_gap = torch.maximum(pos_gap,
                                torch.where(counted, torch.gather(err, -1, pick)[..., 0], 0.0).max())
        live &= ~ambiguous(xy_t, m, radius, adj_eps)
        h = ref._advance(pd, cfg, h, (d - mean) / std, xy_t, m)
        prev = xy_t
    return {"logit_gap": float(logit_gap), "pos_gap_m": float(pos_gap), "graphs": G,
            "left_out": int(G - live.sum())}


@torch.no_grad()
def free_rollout(p, cfg: dict, xy_obs, mask, mean, std, gumbel, normal,
                 frozen: bool = False) -> torch.Tensor:
    """The reference in the program's place: K sampled rollouts of each
    window -> (R, K, N, T, 2) meters.  gumbel/normal as ``read_back``'s."""
    R, K, T, N, M = gumbel.shape
    h = ref.encode(p, cfg, xy_obs, mask, mean, std).repeat_interleave(K, 0)
    traj = ref.rollout(p, cfg, h, xy_obs[:, :, -1].repeat_interleave(K, 0),
                       mask.repeat_interleave(K, 0), mean, std, gumbel.reshape(R * K, T, N, M),
                       normal.reshape(R * K, T, N, 2), frozen=frozen)
    return traj.reshape(R, K, N, T, 2)
