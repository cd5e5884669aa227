"""The whole autoregressive rollout of the decoder in one kernel launch.

Counterpart of ``mmtraj/ops/fused_decoder.py``.  ``reference_decode`` is the
plain PyTorch version (the port of ``_step_math`` looped over T);
``fused_decode`` is the wrapper of the Hopper kernel in ``csrc/decoder.cu``.
Each step: GMM head (columns in ``permute_head`` order), softplus + sigma_min
and rho_max * tanh, first-max Gumbel pick, correlated normal draw,
denormalize and integrate, proximity adjacency with self-loops for valid
agents, ReLU embed, GRU, 4-head GAT residual with padded rows zeroed.  The
random streams come in pre-drawn, so the kernel and the plain version sample
the same trajectories.

Kernel note.  Replaces ``mmtraj/ops/fused_decoder.py:fused_decode`` (kernel
``_decoder_kernel``).  On the H100 it is bound by operations: at the main
path's B*K = 500 rollout graphs of N = 64 agents it does about 31 GFLOP over
12 steps, nearly all of it in matrix products (the GRU's two are most of it),
and moves only about 22 MB (h0, the random streams, the trajectory).  The
design keeps the recurrent state on chip for all 12 steps: one block per
rollout graph holds h, xy and every per-step intermediate in shared memory
and prefetches the next step's random rows with ``cp.async``.  Every
product (head, fused GRU, value, the per-head attend aggregate, output) runs
on the tensor cores as ``mma.sync`` m16n8k8 tiles in 3xTF32 (float32-level
products); a warp owns an 8-column output tile for up to four 16-row slabs,
so each weight fragment it loads feeds every slab.  The adjacency of each
slab is a bit mask built from the positions in registers (no N x N tile).
The kernel takes N a multiple of 8 up to 128, and any widths: K and columns
are padded with zeros in the fragments.

The kernel is the ``torch.library`` custom op ``mmtraj::fused_decode``,
registered when this module is imported: ``reference_decode`` on the CPU,
the kernel on CUDA, and a fake implementation for ``torch.export``.  An op's
schema takes no dict, so the decoder's weights and the head go in as the
fixed list ``WEIGHTS`` and the norm stats as one tensor of four.  The plain
version writes the GRU and the softplus out, as the JAX package's
``_step_math`` does, so that this module needs nothing of ``models``.
"""

from __future__ import annotations

import torch

from mmtraj_torch.ops import _build
from mmtraj_torch.ops.fused_gat import gat_math

# The op's weight list: the decoder step's parameters, then the permuted head.
WEIGHTS = ("embed/w", "embed/b", "cell/wx", "cell/wh", "cell/b", "gat/wv", "gat/a_src",
           "gat/a_dst", "gat/wo", "gat/bo", "head/w", "head/b")


def permute_head(w: torch.Tensor, b: torch.Tensor, m: int):
    """(H, 6M), (6M,) canonical head -> the same parameters with columns
    grouped as [logits(M), mu_x(M), mu_y(M), sigma_x(M), sigma_y(M), rho(M)]."""
    ar = torch.arange(m, device=w.device)
    idx = torch.cat([ar, m + 2 * ar, m + 2 * ar + 1, 3 * m + 2 * ar, 3 * m + 2 * ar + 1,
                     5 * m + ar])
    return w[:, idx].contiguous(), b[idx].contiguous()


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) -> standard Gumbel noise, u clamped away from 0."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def random_stream(rows: int, steps: int, n: int, num_mixtures: int,
                  generator: torch.Generator, device):
    """The pre-drawn random stream of ``rows`` rollout graphs from
    ``generator`` (the device's default generator when None): (gumbel
    (rows, T, N, M), normal (rows, T, N, 2)), the uniforms drawn first."""
    u = torch.rand((rows, steps, n, num_mixtures), generator=generator, device=device)
    normal = torch.randn((rows, steps, n, 2), generator=generator, device=device)
    return gumbel(u), normal


def _stats4(stats_mean, stats_std, device) -> torch.Tensor:
    """[mean_x, mean_y, std_x, std_y] as a float32 tensor on ``device``."""
    return torch.cat([torch.as_tensor(stats_mean, dtype=torch.float32).reshape(2),
                      torch.as_tensor(stats_std, dtype=torch.float32).reshape(2)]).to(device)


def _step_math(h, xy, maskf, gum_t, nrm_t, p, head_w, head_b, stats4, num_heads: int,
               m: int, radius: float, sigma_min: float, rho_max: float):
    """One decode step.  h (B, N, H); xy (B, N, 2); maskf (B, N) 0/1;
    gum_t (B, N, M); nrm_t (B, N, 2) -> (h', xy')."""
    raw = h @ head_w + head_b  # (B, N, 6M)
    k = torch.argmax(raw[..., :m] + gum_t, dim=-1, keepdim=True)  # the first maximum

    def pick(c):
        return torch.gather(raw[..., c * m:(c + 1) * m], -1, k)  # (B, N, 1)

    def softplus(x):  # JAX's, with no switch to the identity at large x
        return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)

    mu_x, mu_y = pick(1), pick(2)
    s_x = softplus(pick(3)) + sigma_min
    s_y = softplus(pick(4)) + sigma_min
    rho = rho_max * torch.tanh(pick(5))
    z0, z1 = nrm_t[..., 0:1], nrm_t[..., 1:2]
    dx = mu_x + s_x * z0
    dy = mu_y + s_y * (rho * z0 + torch.sqrt(torch.clamp_min(1.0 - rho * rho, 1e-6)) * z1)
    dxy_n = torch.cat([dx, dy], dim=-1)
    xy = xy + torch.cat([dx * stats4[2] + stats4[0], dy * stats4[3] + stats4[1]], dim=-1)

    px, py = xy[..., 0], xy[..., 1]
    d2 = (px[:, :, None] - px[:, None, :]) ** 2 + (py[:, :, None] - py[:, None, :]) ** 2
    pairm = maskf[:, :, None] * maskf[:, None, :]
    eye = torch.eye(xy.shape[1], dtype=xy.dtype, device=xy.device)
    attend = pairm * (1.0 - eye) * (d2 <= radius * radius).to(xy.dtype) + eye * pairm

    x_in = torch.relu(dxy_n @ p["embed"]["w"] + p["embed"]["b"])
    c = p["cell"]  # the fused-gate GRU, gate order (z, r, n)
    xg = x_in @ c["wx"] + c["b"]
    hg = h @ c["wh"]
    hid = h.shape[-1]
    z = torch.sigmoid(xg[..., :hid] + hg[..., :hid])
    r = torch.sigmoid(xg[..., hid:2 * hid] + hg[..., hid:2 * hid])
    n = torch.tanh(xg[..., 2 * hid:] + r * hg[..., 2 * hid:])
    h = (1.0 - z) * n + z * h
    g = p["gat"]
    gat = gat_math(h, attend, g["wv"], g["a_src"], g["a_dst"], g["wo"], g["bo"], num_heads)
    return h + gat * maskf[..., None], xy


def reference_decode(h0, xy0, mask, gumbel, normal, params_dec, head_w, head_b, *,
                     num_heads: int, num_mixtures: int, radius: float, sigma_min: float,
                     rho_max: float, stats_mean, stats_std) -> torch.Tensor:
    """Plain rollout.  h0 (B, N, H); xy0 (B, N, 2); mask (B, N) bool;
    gumbel (B, T, N, M); normal (B, T, N, 2); head_w/head_b permuted
    (``permute_head``) -> trajectory (B, T, N, 2) float32."""
    stats4 = _stats4(stats_mean, stats_std, h0.device)
    h, xy, maskf = h0.float(), xy0.float(), mask.float()
    outs = []
    for t in range(gumbel.shape[1]):
        h, xy = _step_math(h, xy, maskf, gumbel[:, t], normal[:, t], params_dec, head_w,
                           head_b, stats4, num_heads, num_mixtures, radius, sigma_min,
                           rho_max)
        outs.append(xy)
    return torch.stack(outs, dim=1)


def _unflatten(weights):
    """The op's weight list -> (params_dec, head_w, head_b)."""
    w = dict(zip(WEIGHTS, weights))
    dec = {}
    for key in WEIGHTS[:-2]:
        mod, leaf = key.split("/")
        dec.setdefault(mod, {})[leaf] = w[key]
    return dec, w["head/w"], w["head/b"]


@torch.library.custom_op("mmtraj::fused_decode", mutates_args=(), device_types="cpu")
def _fused_decode_op(h0: torch.Tensor, xy0: torch.Tensor, mask: torch.Tensor,
                     gumbel: torch.Tensor, normal: torch.Tensor, weights: list[torch.Tensor],
                     stats: torch.Tensor, num_heads: int, num_mixtures: int, radius: float,
                     sigma_min: float, rho_max: float) -> torch.Tensor:
    """``mmtraj::fused_decode`` on the CPU: the plain version."""
    dec, head_w, head_b = _unflatten(weights)
    return reference_decode(h0, xy0, mask, gumbel, normal, dec, head_w, head_b,
                            num_heads=num_heads, num_mixtures=num_mixtures, radius=radius,
                            sigma_min=sigma_min, rho_max=rho_max, stats_mean=stats[:2],
                            stats_std=stats[2:])


@_fused_decode_op.register_fake
def _fused_decode_fake(  # lint: ok: torch.library calls it
        h0, xy0, mask, gumbel, normal, weights, stats, num_heads, num_mixtures,
        radius, sigma_min, rho_max):
    B, T, N, _ = normal.shape
    return h0.new_empty((B, T, N, 2))


@_fused_decode_op.register_kernel("cuda")
def _fused_decode_cuda(  # lint: ok: torch.library calls it
        h0, xy0, mask, gumbel, normal, weights, stats, num_heads, num_mixtures,
        radius, sigma_min, rho_max):
    B, N, Hd = h0.shape
    T = gumbel.shape[1]
    M = num_mixtures
    dec, head_w, head_b = _unflatten(weights)
    de, dc, dg = dec["embed"], dec["cell"], dec["gat"]
    E = de["w"].shape[1]
    HD = dg["wv"].shape[1]
    if HD % num_heads:
        raise ValueError(f"num_heads={num_heads} must divide the value width {HD}")
    maskf = mask.to(torch.float32).contiguous()
    args = [
        (h0, "h0", (B, N, Hd)), (xy0, "xy0", (B, N, 2)), (maskf, "mask", (B, N)),
        (gumbel, "gumbel", (B, T, N, M)), (normal, "normal", (B, T, N, 2)),
        (stats, "stats", (4,)),
        (de["w"], "embed/w", (2, E)), (de["b"], "embed/b", (E,)),
        (dc["wx"], "cell/wx", (E, 3 * Hd)), (dc["wh"], "cell/wh", (Hd, 3 * Hd)),
        (dc["b"], "cell/b", (3 * Hd,)),
        (dg["wv"], "gat/wv", (Hd, HD)), (dg["a_src"], "gat/a_src", (num_heads, HD // num_heads)),
        (dg["a_dst"], "gat/a_dst", (num_heads, HD // num_heads)),
        (dg["wo"], "gat/wo", (HD, Hd)), (dg["bo"], "gat/bo", (Hd,)),
        (head_w, "head/w", (Hd, 6 * M)), (head_b, "head/b", (6 * M,)),
    ]
    for t, name, shape in args:
        _build.check_cuda(t, name, shape)
    out = torch.empty((B, T, N, 2), dtype=torch.float32, device=h0.device)
    _build.launch("decoder", "mmtraj_decode", h0.device, *[t for t, _, _ in args], out,
                  B, T, N, Hd, E, num_heads, HD, M, float(radius) * float(radius),
                  float(sigma_min), float(rho_max))
    fused_decode.launches += 1
    return out


def fused_decode(h0, xy0, mask, gumbel, normal, params_dec, head_w, head_b, *,
                 num_heads: int, num_mixtures: int, radius: float, sigma_min: float,
                 rho_max: float, stats_mean, stats_std) -> torch.Tensor:
    """``mmtraj::fused_decode``: the Hopper kernel for CUDA tensors,
    ``reference_decode`` for CPU tensors.  No backward."""
    N = h0.shape[1]
    assert radius > 0, "fused decoder requires a finite adjacency radius"
    assert N in (8, 16, 32, 64, 128), (
        f"fused decoder requires a lane-tileable agent count, got N={N}; "
        "use the plain path (use_fused_decoder=False) for other shapes"
    )
    weights = [params_dec[mod][leaf] for mod, leaf in (k.split("/") for k in WEIGHTS[:-2])]
    weights += [head_w, head_b]
    return torch.ops.mmtraj.fused_decode(
        h0, xy0, mask, gumbel, normal, weights, _stats4(stats_mean, stats_std, h0.device),
        num_heads, num_mixtures, float(radius), float(sigma_min), float(rho_max))


fused_decode.launches = 0
