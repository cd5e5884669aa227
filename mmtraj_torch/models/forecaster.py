"""The trajectory forecaster, RNN family, inference path (counterpart of
``mmtraj/models/forecaster.py``).

``Forecaster`` is an ``nn.Module`` whose parameters keep the JAX keys and the
JAX ``(in, out)`` orientation: ``state_dict()`` keys are the JAX tree's keys
joined with ``.``.  The math is the JAX package's, step for step:

* ``encode``: over the observed frames, embed the normalized offset, run the
  GRU, rebuild the proximity adjacency from that frame's absolute positions
  and add the GAT residual; then bridge the hidden state with tanh.
* ``rollout_k``: tile the K samples into the batch (flat row ``kk*B + b``)
  and decode 12 sampled steps, either step by step (``decode_rollout``) or in
  one kernel launch (``use_fused_decoder``).

It runs on the card unless the caller asks for the CPU.  Training
(``train=True``, ``remat=True``, dropout masks) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data.transforms import NormStats, denormalize, normalize, to_relative
from mmtraj_torch.graph.adjacency import proximity_adjacency
from mmtraj_torch.models import gmm
from mmtraj_torch.models.cells import Carry, cell_apply, init_carry
from mmtraj_torch.models.gat import gat_apply
from mmtraj_torch.models.layers import Params, dense
from mmtraj_torch.ops import fused_decoder
from mmtraj_torch.params import State, check_supported, init_params, not_ported, unflatten


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device needs a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mmtraj_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch math on the CPU")
    return device


def _no_training(train: bool = False, remat: bool = False, drop=None) -> None:
    if train or remat or drop is not None:
        raise not_ported("training (train=True, remat=True, dropout)",
                         "train.py with autograd.Function wrappers")


def _step(pp: Params, cfg: ModelConfig, carry: Carry, dxy_n, xy_abs, mask) -> Carry:
    """Advance one frame: embed offset -> GRU -> social GAT residual."""
    x = torch.relu(dense(pp["embed"], dxy_n))
    carry = cell_apply(pp["cell"], cfg.cell, x, carry)
    if cfg.social:
        adj = proximity_adjacency(xy_abs, mask, cfg.adjacency_radius)
        for li in range(cfg.gat_layers):
            g = gat_apply(pp["gat" if li == 0 else f"gat_{li}"], carry.h, adj, mask,
                          cfg.num_heads, use_pallas=cfg.use_pallas,
                          attend_kernel=cfg.attend_kernel)
            carry = Carry(h=carry.h + g, c=carry.c)
    return carry


class _Params(nn.Module):
    """One node of the JAX parameter tree: tensors become parameters, dicts
    child modules, under the same names."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Params(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class Forecaster(nn.Module):
    """Config-bound forecaster.  ``state``: parameters as ``from_jax`` /
    ``load_npz`` / ``init_params`` give them; without one, ``init_params``
    draws them from ``generator``."""

    def __init__(self, cfg: ModelConfig, obs_len: int, pred_len: int, device="cuda",
                 state: State = None, generator: torch.Generator = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.obs_len = obs_len
        self.pred_len = pred_len
        self.device = resolve_device(device)
        if state is None:
            if generator is None:
                raise TypeError("Forecaster needs state= or a generator= to draw it from")
            state = init_params(cfg, generator)
        if any(k.endswith((".bh", ".wh_n")) for k in state):
            raise not_ported("the import-only cell params 'bh'/'wh_n'",
                             "LSTM, imported GRU biases and bf16")
        tree = unflatten({k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                          for k, v in state.items()})
        for k, v in tree.items():
            self.add_module(k, _Params(v))

    def params(self) -> dict:
        """The parameters as the JAX package's nested dict, on the device."""
        return {k: m.tree() for k, m in self._modules.items()}

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- encoder ------------------------------------------------------------
    @torch.no_grad()
    def encode(self, xy_obs, mask, stats: NormStats, drop=None, train: bool = False) -> Carry:
        """xy_obs (B, N, To, 2) absolute meters, mask (B, N) -> bridged carry."""
        _no_training(train, drop=drop)
        cfg, p = self.cfg, self.params()
        xy_obs, mask = self._tensor(xy_obs), self._tensor(mask, torch.bool)
        B, N = mask.shape
        dxy_n = normalize(to_relative(xy_obs), stats)
        carry = init_carry((B, N), cfg.hidden_dim, self.device)
        for t in range(xy_obs.shape[2]):
            carry = _step(p["enc"], cfg, carry, dxy_n[:, :, t], xy_obs[:, :, t], mask)
        h = torch.tanh(dense(p["bridge_h"], carry.h))
        return Carry(h=h, c=torch.zeros_like(carry.c))

    # -- heads --------------------------------------------------------------
    def _head(self, p: Params, h):
        cfg = self.cfg
        if cfg.head == "gmm":
            return gmm.head_apply(p["head"], h, cfg.num_mixtures, cfg.sigma_min, cfg.rho_max)
        return dense(p["head"], h)

    # -- rollout random streams -----------------------------------------------
    def _rollout_stream(self, Bk: int, N: int, generator: torch.Generator = None):
        """Pre-drawn rollout randomness on the device: (gumbel (Bk, T, N, M),
        normal (Bk, T, N, 2)), drawn from ``generator`` (the device's default
        generator when None).  Same distributions as the JAX package's
        stream, not the same numbers."""
        T, M = self.pred_len, self.cfg.num_mixtures
        u = torch.rand((Bk, T, N, M), generator=generator, device=self.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        normal = torch.randn((Bk, T, N, 2), generator=generator, device=self.device)
        return gumbel, normal

    # -- sampling decode (autoregressive rollout) ----------------------------
    @torch.no_grad()
    def decode_rollout(self, carry: Carry, xy_last, mask, stats: NormStats,
                       generator: torch.Generator = None, stream=None,
                       train: bool = False, remat: bool = False):
        """One sampled rollout -> absolute positions (B, N, Tp, 2), meters.
        ``stream``: pre-drawn (gumbel, normal); drawn from ``generator`` when
        None."""
        _no_training(train, remat)
        cfg, p = self.cfg, self.params()
        B, N = mask.shape
        if cfg.head == "gmm" and stream is None:
            stream = self._rollout_stream(B, N, generator)
        xy, outs = xy_last, []
        for t in range(self.pred_len):
            out = self._head(p, carry.h)
            if cfg.head == "gmm":
                dxy_n = gmm.sample_from(out, stream[0][:, t], stream[1][:, t])
            else:
                dxy_n = out
            xy = xy + denormalize(dxy_n, stats)
            carry = _step(p["dec"], cfg, carry, dxy_n, xy, mask)
            outs.append(xy)
        return torch.stack(outs, dim=2)

    # -- public API ----------------------------------------------------------
    @torch.no_grad()
    def rollout_k(self, xy_obs, mask, stats: NormStats, k: int,
                  generator: torch.Generator = None, carry: Carry = None,
                  stream=None, train: bool = False, remat: bool = False):
        """K sampled rollouts, encode once -> (K, B, N, Tp, 2) absolute meters.

        ``generator`` draws the random stream on the device; ``stream``
        passes a pre-drawn (gumbel (K*B, T, N, M), normal (K*B, T, N, 2))
        instead, laid out as flat row ``kk*B + b`` (the JAX package's
        ``_rollout_stream(key, K*B, N)`` draws it so).  ``carry``: a
        precomputed encoder carry."""
        _no_training(train, remat)
        xy_obs, mask = self._tensor(xy_obs), self._tensor(mask, torch.bool)
        B, N = mask.shape
        if carry is None:
            carry = self.encode(xy_obs, mask, stats)

        def tile(a):
            return a.repeat((k,) + (1,) * (a.ndim - 1))

        carry_k = Carry(h=tile(carry.h), c=tile(carry.c))
        xy_last = tile(xy_obs[:, :, -1])
        mask_k = tile(mask)
        if self.cfg.head == "gmm":
            if stream is None:
                stream = self._rollout_stream(k * B, N, generator)
            stream = tuple(self._tensor(s).contiguous() for s in stream)
        if self.cfg.use_fused_decoder:
            traj = self._decode_fused(carry_k, xy_last, mask_k, stats, stream)
        else:
            traj = self.decode_rollout(carry_k, xy_last, mask_k, stats, stream=stream)
        return traj.reshape((k, B) + traj.shape[1:])

    def _decode_fused(self, carry: Carry, xy_last, mask, stats: NormStats, stream):
        """The whole rollout in one ``fused_decode`` launch -> (Bk, N, T, 2)."""
        cfg, p = self.cfg, self.params()
        assert cfg.cell == "gru" and cfg.social and cfg.head == "gmm", (
            "fused decoder covers the flagship GRU+social+GMM configuration"
        )
        assert cfg.gat_layers == 1, (
            "fused decoder implements the single-round GAT step; use the "
            "plain path for gat_layers > 1"
        )
        assert "bh" not in p["dec"]["cell"] and "wh_n" not in p["dec"]["cell"], (
            "fused decoder does not consume the import-only cell params 'bh'/'wh_n'"
        )
        M = cfg.num_mixtures
        gumbel, normal = stream
        hw, hb = fused_decoder.permute_head(p["head"]["w"], p["head"]["b"], M)
        traj = fused_decoder.fused_decode(
            carry.h.contiguous(), xy_last.contiguous(), mask, gumbel, normal, p["dec"], hw, hb,
            num_heads=cfg.num_heads, num_mixtures=M, radius=cfg.adjacency_radius,
            sigma_min=cfg.sigma_min, rho_max=cfg.rho_max,
            stats_mean=stats.mean, stats_std=stats.std,
        )
        return traj.permute(0, 2, 1, 3)  # (Bk, N, T, 2)
