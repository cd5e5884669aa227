"""Bivariate-Gaussian-mixture head, NLL and sampling on tensors (counterpart
of ``mmtraj/models/gmm.py``).  All head math runs in float32, and the
mixture reduction of the NLL is a log-sum-exp."""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from mmtraj_torch.models.layers import Params, dense, dense_init


class GMMParams(NamedTuple):
    """Mixture of M bivariate Gaussians over a 2D offset; leading dims free."""

    logits: torch.Tensor  # (..., M)
    mu: torch.Tensor  # (..., M, 2)
    sigma: torch.Tensor  # (..., M, 2) positive
    rho: torch.Tensor  # (..., M) in (-rho_max, rho_max)


def head_init(generator, hidden: int, num_mixtures: int) -> Params:
    return dense_init(generator, hidden, 6 * num_mixtures)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as JAX computes it, with no switch to the identity at
    large x (``torch.nn.functional.softplus`` switches above 20)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


def head_apply(p: Params, h: torch.Tensor, num_mixtures: int, sigma_min: float,
               rho_max: float) -> GMMParams:
    """Hidden state (..., H) -> constrained GMMParams."""
    raw = dense(p, h).float()
    M = num_mixtures
    lead = raw.shape[:-1]
    logits = raw[..., :M]
    mu = raw[..., M:3 * M].reshape(lead + (M, 2))
    sigma = (softplus(raw[..., 3 * M:5 * M]) + sigma_min).reshape(lead + (M, 2))
    rho = rho_max * torch.tanh(raw[..., 5 * M:])
    return GMMParams(logits, mu, sigma, rho)


def nll(params: GMMParams, target: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood of target (..., 2) under the mixture -> (...).

    log N(x; mu, Sigma) of a bivariate Gaussian with correlation rho is
    -log(2 pi sx sy sqrt(1 - rho^2)) - z / (2 (1 - rho^2)),
    z = dx^2/sx^2 + dy^2/sy^2 - 2 rho dx dy / (sx sy)."""
    x = target[..., None, :].float()  # (..., 1, 2)
    d = (x - params.mu) / params.sigma  # (..., M, 2)
    dx, dy = d[..., 0], d[..., 1]
    one_m_rho2 = torch.clamp_min(1.0 - params.rho ** 2, 1e-6)
    z = dx * dx + dy * dy - 2.0 * params.rho * dx * dy
    log_norm = (-torch.log(2 * math.pi * params.sigma[..., 0] * params.sigma[..., 1])
                - 0.5 * torch.log(one_m_rho2))
    comp_logp = log_norm - z / (2.0 * one_m_rho2)  # (..., M)
    log_pi = torch.log_softmax(params.logits, dim=-1)
    return -torch.logsumexp(log_pi + comp_logp, dim=-1)


def mixture_mean(params: GMMParams) -> torch.Tensor:
    """Probability-weighted mean offset (..., 2)."""
    pi = torch.softmax(params.logits, dim=-1)
    return (pi[..., None] * params.mu).sum(dim=-2)


def sample_from(params: GMMParams, gumbel: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """One offset (..., 2) from pre-drawn randoms: gumbel (..., M) picks the
    component (the first maximum wins, as ``argmax`` does), z (..., 2) ~ N(0, 1)
    gives the correlated normal draw."""
    k = torch.argmax(params.logits + gumbel, dim=-1, keepdim=True)  # (..., 1)
    mu = torch.gather(params.mu, -2, k[..., None].expand(k.shape + (2,)))[..., 0, :]
    sigma = torch.gather(params.sigma, -2, k[..., None].expand(k.shape + (2,)))[..., 0, :]
    rho = torch.gather(params.rho, -1, k)[..., 0]
    dx = mu[..., 0] + sigma[..., 0] * z[..., 0]
    dy = mu[..., 1] + sigma[..., 1] * (
        rho * z[..., 0] + torch.sqrt(torch.clamp_min(1.0 - rho * rho, 1e-6)) * z[..., 1]
    )
    return torch.stack([dx, dy], dim=-1)
