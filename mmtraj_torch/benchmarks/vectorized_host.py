"""Vectorized-NumPy host forecaster: the port's second denominator (a copy
of ``mmtraj/benchmarks/vectorized_host.py``).

The best-case host bracket: the same architecture and math fully vectorized
in NumPy over batch x agents x samples, with Python loops only over the 8+12
time steps (inherent to the recurrence).  Any real host implementation of
this model lands between it and ``reference_loop.py``, so the bench reports
both ratios (``vs_baseline`` = the loop, ``vs_vectorized_host`` = this).  A
throughput denominator, not a numerics-parity path: it mirrors the model's
ops and shapes without pinning bit equality.
"""

from __future__ import annotations

import numpy as np

from mmtraj_torch.benchmarks.reference_loop import numpy_tree


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax_masked(logits, attend):
    """logits (..., N_j, H) masked over N_j by attend (..., N_j, 1)."""
    neg = -1e9
    logits = np.where(attend, logits, neg)
    m = logits.max(axis=-2, keepdims=True)
    e = np.exp(logits - m) * attend
    return e / np.maximum(e.sum(axis=-2, keepdims=True), 1e-20)


class VectorizedHostForecaster:
    """Same GAT+GRU+GMM math, batched NumPy execution (no agent loops)."""

    def __init__(self, params, num_heads: int, num_mixtures: int, radius: float,
                 sigma_min: float, rho_max: float, stats_mean, stats_std):
        self.p = numpy_tree(params)
        self.H = num_heads
        self.M = num_mixtures
        self.radius = radius
        self.sigma_min = sigma_min
        self.rho_max = rho_max
        self.mean = np.asarray(stats_mean, dtype=np.float32)
        self.std = np.asarray(stats_std, dtype=np.float32)

    def _gru(self, cell, x, h):
        """x (B, N, E), h (B, N, Hd) -> new h; one batched matmul per side."""
        xg = x @ cell["wx"] + cell["b"]
        hg = h @ cell["wh"]
        hid = h.shape[-1]
        z = _sigmoid(xg[..., :hid] + hg[..., :hid])
        r = _sigmoid(xg[..., hid : 2 * hid] + hg[..., hid : 2 * hid])
        n = np.tanh(xg[..., 2 * hid :] + r * hg[..., 2 * hid :])
        return (1.0 - z) * n + z * h

    def _attend(self, xy, mask):
        """(B, N, 2), (B, N) -> bool attend (B, N, N) incl. self-loops."""
        d = xy[:, :, None] - xy[:, None, :]
        dist2 = (d**2).sum(-1)
        pair = mask[:, :, None] & mask[:, None, :]
        # radius <= 0 means fully connected over valid agents, as
        # graph/adjacency.py.
        adj = pair if self.radius <= 0 else (dist2 <= self.radius**2) & pair
        N = xy.shape[1]
        eye = np.eye(N, dtype=bool)[None]
        return adj | (eye & pair)

    def _gat(self, gp, h, attend):
        B, N, D = h.shape
        v = (h @ gp["wv"]).reshape(B, N, self.H, -1)
        s_src = np.einsum("bnhd,hd->bnh", v, gp["a_src"])
        s_dst = np.einsum("bnhd,hd->bnh", v, gp["a_dst"])
        logits = s_src[:, :, None, :] + s_dst[:, None, :, :]  # (B, Ni, Nj, H)
        logits = np.where(logits > 0, logits, 0.2 * logits)
        alpha = _softmax_masked(logits, attend[..., None])
        out = np.einsum("bijh,bjhd->bihd", alpha, v).reshape(B, N, D)
        return out @ gp["wo"] + gp["bo"]

    def _step(self, pp, h, dxy_n, xy, mask):
        x = np.maximum(dxy_n @ pp["embed"]["w"] + pp["embed"]["b"], 0.0)
        h = self._gru(pp["cell"], x, h)
        g = self._gat(pp["gat"], h, self._attend(xy, mask))
        return h + np.where(mask[..., None], g, 0.0)

    def _head(self, h):
        raw = h @ self.p["head"]["w"] + self.p["head"]["b"]
        M = self.M
        logits = raw[..., :M]
        mu = raw[..., M : 3 * M].reshape(raw.shape[:-1] + (M, 2))
        sigma = np.log1p(np.exp(raw[..., 3 * M : 5 * M])).reshape(mu.shape) + self.sigma_min
        rho = self.rho_max * np.tanh(raw[..., 5 * M :])
        return logits, mu, sigma, rho

    def rollout_batch(self, xy_obs: np.ndarray, mask: np.ndarray, k: int,
                      pred_len: int, rng) -> np.ndarray:
        """xy_obs (B, N, To, 2), mask (B, N) -> (B*k, N, pred_len, 2).

        K is folded into the batch exactly like ``rollout_k``, so the host
        pays one batched product per op over (B*K, N, .), its best shape."""
        B, N, To, _ = xy_obs.shape
        hid = self.p["enc"]["cell"]["wh"].shape[0]
        dxy = np.diff(xy_obs, axis=2, prepend=xy_obs[:, :, :1])
        dxy_n = (dxy - self.mean) / self.std

        h = np.zeros((B, N, hid), dtype=np.float32)
        for t in range(To):
            h = self._step(self.p["enc"], h, dxy_n[:, :, t], xy_obs[:, :, t], mask)
        h = np.tanh(h @ self.p["bridge_h"]["w"] + self.p["bridge_h"]["b"])

        rep = lambda a: np.tile(a, (k,) + (1,) * (a.ndim - 1))  # noqa: E731
        h = rep(h)
        xy = rep(xy_obs[:, :, -1]).copy()
        mk = rep(mask)
        BK = B * k
        out = np.zeros((BK, N, pred_len, 2), dtype=np.float32)
        for t in range(pred_len):
            logits, mu, sigma, rho = self._head(h)
            g = rng.gumbel(size=(BK, N, self.M)).astype(np.float32)
            comp = np.argmax(logits + g, axis=-1)  # (BK, N)
            bi, ni = np.ogrid[:BK, :N]
            mu_s, sg_s, rh_s = mu[bi, ni, comp], sigma[bi, ni, comp], rho[bi, ni, comp]
            z = rng.standard_normal((BK, N, 2)).astype(np.float32)
            dn = np.empty((BK, N, 2), dtype=np.float32)
            dn[..., 0] = mu_s[..., 0] + sg_s[..., 0] * z[..., 0]
            dn[..., 1] = mu_s[..., 1] + sg_s[..., 1] * (
                rh_s * z[..., 0] + np.sqrt(np.maximum(1 - rh_s**2, 1e-6)) * z[..., 1]
            )
            xy = xy + dn * self.std + self.mean
            h = self._step(self.p["dec"], h, dn, xy, mk)
            out[:, :, t] = xy
        return out
