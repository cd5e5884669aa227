"""Reference-style NumPy loop: the port's throughput-baseline denominator
(a copy of ``mmtraj/benchmarks/reference_loop.py``).

The stand-in for the reference's execution style: Python loops over frames,
a per-frame adjacency built in Python loops over the agents, per-agent numpy
products, and Python loops over the K samples and the 12 rollout steps, with
the same model architecture and sizes as the path being benchmarked, so the
ratio isolates the execution model, not the math.  It is intentionally not
vectorized beyond single-product numpy calls: that is the point being
measured.  It takes the parameters as the JAX package's nested dict, which
``Forecaster.params()`` gives (tensors or numpy leaves).
"""

from __future__ import annotations

import numpy as np


def numpy_tree(tree):
    """A nested dict of tensors or arrays -> the same dict of float32 numpy."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu().numpy()
    return np.asarray(tree, dtype=np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class ReferenceStyleForecaster:
    """Same GAT+GRU+GMM math as the forecaster, reference-style execution."""

    def __init__(self, params, num_heads: int, num_mixtures: int, radius: float,
                 sigma_min: float, rho_max: float, stats_mean, stats_std):
        # Parameters to host numpy once; only the loop's time is measured.
        self.p = numpy_tree(params)
        self.H = num_heads
        self.M = num_mixtures
        self.radius = radius
        self.sigma_min = sigma_min
        self.rho_max = rho_max
        self.mean = np.asarray(stats_mean)
        self.std = np.asarray(stats_std)

    # -- per-agent pieces, Python-looped like the reference ------------------
    def _gru_step(self, cell, x_i, h_i):
        xg = x_i @ cell["wx"] + cell["b"]
        hg = h_i @ cell["wh"]
        hid = h_i.shape[-1]
        z = _sigmoid(xg[:hid] + hg[:hid])
        r = _sigmoid(xg[hid : 2 * hid] + hg[hid : 2 * hid])
        n = np.tanh(xg[2 * hid :] + r * hg[2 * hid :])
        return (1.0 - z) * n + z * h_i

    def _adjacency(self, xy):
        """Python double loop over agents, as the reference builds its graph."""
        n = len(xy)
        adj = np.zeros((n, n), dtype=bool)
        for i in range(n):
            for j in range(n):
                # radius <= 0 = fully connected, as graph/adjacency.py.
                if i != j and (self.radius <= 0
                               or np.linalg.norm(xy[i] - xy[j]) <= self.radius):
                    adj[i, j] = True
        return adj

    def _gat(self, gp, h, adj):
        n, d = h.shape
        v = (h @ gp["wv"]).reshape(n, self.H, -1)
        s_src = np.einsum("nhd,hd->nh", v, gp["a_src"])
        s_dst = np.einsum("nhd,hd->nh", v, gp["a_dst"])
        out = np.zeros_like(v)
        for i in range(n):  # per-receiver Python loop
            nbrs = list(np.nonzero(adj[i])[0]) + [i]
            logits = s_src[i][None, :] + s_dst[nbrs]  # (nbr, H)
            logits = np.where(logits > 0, logits, 0.2 * logits)  # leaky relu
            e = np.exp(logits - logits.max(axis=0, keepdims=True))
            alpha = e / e.sum(axis=0, keepdims=True)
            out[i] = np.einsum("kh,khd->hd", alpha, v[nbrs])
        return out.reshape(n, -1) @ gp["wo"] + gp["bo"]

    def _step(self, pp, h, dxy_n, xy):
        n = len(xy)
        x = np.maximum(dxy_n @ pp["embed"]["w"] + pp["embed"]["b"], 0.0)
        for i in range(n):  # per-agent RNN loop
            h[i] = self._gru_step(pp["cell"], x[i], h[i])
        adj = self._adjacency(xy)
        h += self._gat(pp["gat"], h, adj)
        return h

    def _head(self, h_i):
        raw = h_i @ self.p["head"]["w"] + self.p["head"]["b"]
        M = self.M
        logits = raw[:M]
        mu = raw[M : 3 * M].reshape(M, 2)
        sigma = np.log1p(np.exp(raw[3 * M : 5 * M])).reshape(M, 2) + self.sigma_min
        rho = self.rho_max * np.tanh(raw[5 * M :])
        return logits, mu, sigma, rho

    # -- public: one window, K sampled rollouts ------------------------------
    def rollout(self, xy_obs: np.ndarray, k: int, pred_len: int, rng) -> np.ndarray:
        """xy_obs (N, To, 2) -> (K, N, pred_len, 2); Python K/step loops like
        the reference eval stack."""
        n = xy_obs.shape[0]
        hid = self.p["enc"]["cell"]["wh"].shape[0]
        dxy = np.diff(xy_obs, axis=1, prepend=xy_obs[:, :1])
        dxy_n = (dxy - self.mean) / self.std

        h = np.zeros((n, hid), dtype=np.float32)
        for t in range(xy_obs.shape[1]):  # frame loop
            h = self._step(self.p["enc"], h, dxy_n[:, t], xy_obs[:, t])
        h_enc = np.tanh(h @ self.p["bridge_h"]["w"] + self.p["bridge_h"]["b"])

        out = np.zeros((k, n, pred_len, 2), dtype=np.float32)
        for s in range(k):  # K-sample Python loop
            h = h_enc.copy()
            xy = xy_obs[:, -1].copy()
            for t in range(pred_len):  # rollout step loop
                dn = np.zeros((n, 2), dtype=np.float32)
                for i in range(n):  # per-agent sampling loop
                    logits, mu, sigma, rho = self._head(h[i])
                    pi = np.exp(logits - logits.max())
                    pi /= pi.sum()
                    m = rng.choice(self.M, p=pi)
                    z = rng.standard_normal(2)
                    dn[i, 0] = mu[m, 0] + sigma[m, 0] * z[0]
                    dn[i, 1] = mu[m, 1] + sigma[m, 1] * (
                        rho[m] * z[0] + np.sqrt(max(1 - rho[m] ** 2, 1e-6)) * z[1]
                    )
                xy = xy + dn * self.std + self.mean
                h = self._step(self.p["dec"], h, dn, xy)
                out[s, :, t] = xy
        return out
