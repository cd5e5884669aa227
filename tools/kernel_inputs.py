"""Random inputs for the port's CUDA kernels, made with numpy from a seed.

``tests/test_torch_gpu.py`` checks the kernels on these inputs and
``tools/kernel_times.py`` times them on the same ones, so the two are built in
one place.  Imports only numpy and torch: ``kernel_times.py --root`` imports
the ``mmtraj_torch`` of another checkout, and the caller passes in what it
needs of it.
"""

from __future__ import annotations

import numpy as np
import torch

# fused_decode beyond the model's own widths, (N, hidden, embed, HD, M, heads):
# config 4 (hidden = embed = HD = 64, 4 heads of 16) at N = 64 and 128, widths
# off the 8-column tiles (4 heads, dh = 12; 6M = 30 and 18 head columns),
# config 3 (one head of 64) at its N_max = 32, and the experiments' config-4
# variants at N = 64: dense-sweep cell A's hidden 128 (4 heads of 32) and the
# social ablation's one head of 64.
DECODER_CASES = [(64, 64, 64, 64, 5, 4), (128, 64, 64, 64, 5, 4), (64, 32, 32, 48, 5, 4),
                 (16, 20, 12, 48, 3, 4), (32, 64, 64, 64, 5, 1), (64, 128, 64, 128, 5, 4),
                 (64, 64, 64, 64, 5, 1)]


def tensor(rng, *shape, scale=1.0, device="cuda") -> torch.Tensor:
    """Normal draws times ``scale``, float32, on ``device``."""
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)


def attend_tile(rng, b, n, device="cuda", density=0.3) -> torch.Tensor:
    """0/1 attend tiles (b, n, n), each edge set with probability ``density``;
    the last row of every graph is a padded agent's, without edges, whose
    output must come out zero."""
    att = (rng.random((b, n, n)) < density).astype(np.float32)
    att[:, -1] = 0.0
    return torch.from_numpy(att).to(device)


def decoder_params(rng, hidden, embed, hd, heads, m, device="cuda"):
    """The decoder's weights at any widths -> (params of ``dec``, head w
    (hidden, 6 M), head b (6 M)), the head in the model's column order (the
    caller permutes it with ``fused_decoder.permute_head``).  Weights are
    glorot-normal, std sqrt(2 / (fan_in + fan_out)), as the model's
    ``init_params`` draws them; biases, which the model starts at zero, are
    normal with std 0.1, so that each enters the check."""
    def glorot(fan_in, fan_out):
        return tensor(rng, fan_in, fan_out, scale=(2.0 / (fan_in + fan_out)) ** 0.5, device=device)

    def bias(n):
        return tensor(rng, n, scale=0.1, device=device)

    dh = hd // heads
    p = {"embed": {"w": glorot(2, embed), "b": bias(embed)},
         "cell": {"wx": glorot(embed, 3 * hidden), "wh": glorot(hidden, 3 * hidden),
                  "b": bias(3 * hidden)},
         "gat": {"wv": glorot(hidden, hd), "a_src": glorot(heads, dh), "a_dst": glorot(heads, dh),
                 "wo": glorot(hd, hidden), "bo": bias(hidden)}}
    return p, glorot(hidden, 6 * m), bias(6 * m)


def decoder_stream(rng, bk, steps, n, m, device="cuda"):
    """A rollout's random stream: (gumbel (bk, steps, n, m), normal (bk, steps, n, 2))."""
    gumbel = torch.from_numpy(rng.gumbel(size=(bk, steps, n, m)).astype(np.float32)).to(device)
    return gumbel, tensor(rng, bk, steps, n, 2, device=device)


def decoder_case(fused_decoder, n, hidden, embed, hd, m, heads, bk=100, steps=12,
                 device="cuda"):
    """One case of ``DECODER_CASES`` -> (args, kwargs) of ``fused_decode`` and
    ``reference_decode``, from the seed n + hidden + hd: bk rollout graphs of
    n agents, 75% of them valid, positions spread over about 3 m around the
    origin with a 2 m radius."""
    rng = np.random.default_rng(n + hidden + hd)
    p, hw, hb = decoder_params(rng, hidden, embed, hd, heads, m, device)
    hw, hb = fused_decoder.permute_head(hw, hb, m)
    h0, xy0 = tensor(rng, bk, n, hidden, device=device), tensor(rng, bk, n, 2, scale=3, device=device)
    mask = torch.from_numpy(rng.random((bk, n)) < 0.75).to(device)
    gumbel, normal = decoder_stream(rng, bk, steps, n, m, device)
    kw = dict(num_heads=heads, num_mixtures=m, radius=2.0, sigma_min=1e-3, rho_max=0.99,
              stats_mean=np.array([0.01, -0.02], np.float32),
              stats_std=np.array([0.4, 0.5], np.float32))
    return (h0, xy0, mask, gumbel, normal, p, hw, hb), kw


def rollout_errors(got, want, mask, tol=1e-3):
    """Per rollout graph, the largest error over valid agents and steps ->
    (the largest of all, how many graphs are past ``tol``)."""
    err = torch.where(mask[:, None, :, None], (got - want).abs(), 0.0).flatten(1).amax(1)
    return float(err.max()), int((err > tol).sum())


# The GAT backward's attend chain (fused_gat.fused_gat_grad) on the training
# paths, (graphs, N, HD, heads): config4-attn3's B·T = 1,024 frame graphs and
# its decoder's 128, config 3's population rollout (5 lanes x 256 graphs,
# folded as the vmap rule folds them), N = 256, and one head of 128.
GRAD_CASES = [(1024, 64, 64, 4), (128, 64, 64, 4), (1280, 32, 64, 1), (16, 256, 64, 4),
              (16, 256, 128, 1)]


def gat_grad_case(rng, b, n, hd, heads, device="cuda"):
    """Inputs of ``fused_gat_grad`` -> (v, s_src, s_dst, attend, d_agg,
    heads): ``attend_tile``'s edges with self edges, the last agent padded
    (no edge in or out), and head 0's s_dst = -s_src, so that every self
    edge's logit of that head is exactly 0 (LeakyReLU's kink)."""
    v, d_agg = tensor(rng, b, n, hd, device=device), tensor(rng, b, n, hd, device=device)
    s_src = tensor(rng, b, n, heads, scale=2, device=device)
    s_dst = tensor(rng, b, n, heads, scale=2, device=device)
    s_dst[..., 0] = -s_src[..., 0]
    att = torch.maximum(attend_tile(rng, b, n, device), torch.eye(n, device=device))
    att[:, -1] = 0.0
    att[:, :, -1] = 0.0
    return v, s_src, s_dst, att.contiguous(), d_agg, heads


# The layer norm's kernels (csrc/layer_norm.cu), (label, leading shape, H): a
# config4-attn3 block's tokens (B = 128 windows of 64 agents over 8 steps),
# its readout's strided last step (x[:, :, -1] of those tokens), the hidden
# 128 width, and a row count that fills no block of either kernel.
LN_CASES = [("tokens", (65536,), 64), ("readout", (128, 64), 64), ("wide", (8192,), 128),
            ("ragged", (1001,), 64)]


def layer_norm_case(rng, lead, h, device="cuda", spread=(0.5, 2.0), offset=None):
    """Inputs of ``fused_layer_norm`` -> (x, scale, bias, dy): rows of their
    own offset (normal; ``offset`` for every row where given) and spread
    (uniform in ``spread``), row 0 constant (zero variance); for "readout"'s
    two leading axes x is the strided last step of (..., 8, h) tokens.  (A
    row whose spread is far under its offset loses digits in x - mu in any
    float32 implementation.)"""
    full = lead + (8, h) if len(lead) == 2 else lead + (h,)
    spread = torch.from_numpy(rng.uniform(*spread, full[:-1] + (1,)).astype(np.float32))
    x = tensor(rng, *full, device=device) * spread.to(device)
    x = x + (tensor(rng, *full[:-1], 1, device=device) if offset is None else offset)
    if len(lead) == 2:
        x = x[:, :, -1]
    x[(0,) * len(lead)] = 1.7
    scale = 1.0 + tensor(rng, h, scale=0.3, device=device)
    return x, scale, tensor(rng, h, scale=0.2, device=device), tensor(rng, *x.shape, device=device)
