"""The trajectory forecaster, inference path, both encoder families
(counterpart of ``mmtraj/models/forecaster.py``).

``Forecaster`` is an ``nn.Module`` whose parameters keep the JAX keys and the
JAX ``(in, out)`` orientation: ``state_dict()`` keys are the JAX tree's keys
joined with ``.``.  The math is the JAX package's, step for step:

* ``encode``, ``encoder="rnn"``: over the observed frames, embed the
  normalized offset, run the cell (GRU or LSTM), rebuild the proximity adjacency from that
  frame's absolute positions and add the GAT residual; then bridge the
  hidden state (and the LSTM's cell state) with tanh.
* ``encode``, ``encoder="attn"``: the spatio-temporal attention encoder of
  ``models/attn_encoder.py``; its last-step features are bridged with tanh.
* ``rollout_k``: tile the K samples into the batch (flat row ``kk*B + b``)
  and decode 12 sampled steps, either step by step (``decode_rollout``) or in
  one kernel launch (``use_fused_decoder``); the random stream is drawn for
  the whole call, or for each window from its own seed
  (``_per_window_stream``), which the evaluator uses.
* ``rollout_modes``: one trajectory per mixture component, following the
  component's mean at every step.
* ``decode_teacher``: the teacher-forced decode whose head outputs give the
  evaluator's NLL and the training loss.
* ``loss`` (teacher-forced GMM NLL, MSE for the deterministic head) and
  ``loss_variety`` (min over sampled rollouts): the training objectives.

The parameters require gradients.  ``encode``, ``decode_teacher`` and the
losses record an autograd graph wherever grad mode is on; ``rollout_k``,
``decode_rollout`` and ``rollout_modes`` run under ``torch.no_grad()``
unless ``train=True``, so inference records none.  Random draws of training
(dropout masks, the variety loss's stream) come in pre-drawn, as the
rollout's stream does.  It runs on the card unless the caller asks for the
CPU.

``cfg.dtype="bfloat16"`` rounds the operands of the encoder's and the
decoder step's products to bf16 and keeps every product's result, the
parameters, the carries, the bridges, the GMM head and the losses float32
(``_compute_dtype``, ``layers.matmul``).  The embedding and cell weights are
rounded once a forward call (``_round_coder``).  The fused decoder takes no
dtype: under bf16 route A runs a bf16 encoder and the float32 rollout
kernel, as the JAX package does.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data.transforms import NormStats, denormalize, normalize, to_relative
from mmtraj_torch.graph.adjacency import proximity_adjacency
from mmtraj_torch.models import gmm
from mmtraj_torch.models.attn_encoder import attn_encode
from mmtraj_torch.models.cells import Carry, cell_apply, init_carry
from mmtraj_torch.models.gat import gat_apply
from mmtraj_torch.models.layers import Params, bf16_weight, dense, maybe_remat
from mmtraj_torch.ops import fused_decoder
from mmtraj_torch.params import State, check_supported, init_params, unflatten


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device needs a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mmtraj_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch math on the CPU")
    return device


def _compute_dtype(cfg: ModelConfig):
    """The products' operand dtype: bf16 for ``dtype="bfloat16"``, else None
    (float32)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


def _round_coder(pp: Params, dt) -> Params:
    """A coder's parameters for one forward call: under bf16 its embedding and
    cell weights rounded once (``layers.bf16_weight``) for every step's
    products; the GAT's stay float32.  Unchanged for float32."""
    if dt is None:
        return pp
    cell = {k: bf16_weight(v) if k in ("wx", "wh", "wh_n") else v for k, v in pp["cell"].items()}
    return {**pp, "embed": {**pp["embed"], "w": bf16_weight(pp["embed"]["w"])}, "cell": cell}


def _step(pp: Params, cfg: ModelConfig, carry: Carry, dxy_n, xy_abs, mask, drop=None,
          train: bool = False) -> Carry:
    """Advance one frame: embed offset -> GRU -> social GAT residual.

    ``drop``: variational dropout masks {"emb": (B, N, E), "gat": (B, N, H)},
    scaled by 1/keep, one draw a forward pass reused at every step.
    ``train`` marks a differentiated path, on which "auto" keeps the plain
    attend chain as the JAX package does."""
    dt = _compute_dtype(cfg)
    x = torch.relu(dense(pp["embed"], dxy_n, dt))
    if drop is not None:
        x = x * drop["emb"]
    carry = cell_apply(pp["cell"], cfg.cell, x, carry, dt)
    if cfg.social:
        adj = proximity_adjacency(xy_abs, mask, cfg.adjacency_radius)
        for li in range(cfg.gat_layers):
            g = gat_apply(pp["gat" if li == 0 else f"gat_{li}"], carry.h, adj, mask,
                          cfg.num_heads, dt, use_pallas=cfg.use_pallas,
                          attend_kernel=cfg.attend_kernel, train=train)
            if drop is not None:
                g = g * drop["gat"]
            carry = Carry(h=carry.h + g, c=carry.c)
    return carry


def dropout_masks(cfg: ModelConfig, B: int, N: int, generator: torch.Generator,
                  device=None):
    """Two variational masks a coder -> (encoder masks, decoder masks), each
    {"emb": (B, N, E), "gat": (B, N, H)}: Bernoulli(keep) scaled by 1/keep
    (the JAX package's ``_dropout_masks``, drawn from ``generator``)."""
    keep = 1.0 - cfg.dropout

    def bern(d):
        u = torch.rand((B, N, d), generator=generator, device=device)
        return (u < keep).to(torch.float32) / keep

    enc = {"emb": bern(cfg.embed_dim), "gat": bern(cfg.hidden_dim)}
    return enc, {"emb": bern(cfg.embed_dim), "gat": bern(cfg.hidden_dim)}


def _grad_mode(train: bool):
    """Recording as the caller has it for a differentiated path, else none
    (no context where none is recorded already, so that a traced program
    holds no grad-mode switches)."""
    return contextlib.nullcontext() if train or not torch.is_grad_enabled() else torch.no_grad()


class _Params(nn.Module):
    """One node of the JAX parameter tree: tensors become parameters, dicts
    child modules, under the same names."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Params(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

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
        # Copied, so that models built from one state never share storage:
        # training updates the parameters in place.
        tree = unflatten({k: torch.as_tensor(v, dtype=torch.float32).to(self.device, copy=True)
                          for k, v in state.items()})
        for k, v in tree.items():
            self.add_module(k, _Params(v))

    def params(self) -> dict:
        """The parameters as the JAX package's nested dict, on the device."""
        return {k: m.tree() for k, m in self._modules.items()}

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- encoder ------------------------------------------------------------
    def encode(self, xy_obs, mask, stats: NormStats, drop=None, train: bool = False) -> Carry:
        """xy_obs (B, N, To, 2) absolute meters, mask (B, N) -> bridged carry.
        ``drop``: the encoder's dropout masks; ``train`` marks a
        differentiated path.  The step body is checkpointed per
        ``cfg.remat`` where a graph is recorded."""
        cfg, p = self.cfg, self.params()
        xy_obs, mask = self._tensor(xy_obs), self._tensor(mask, torch.bool)
        B, N = mask.shape
        dxy_n = normalize(to_relative(xy_obs), stats)
        dt = _compute_dtype(cfg)
        if cfg.encoder == "attn":
            return self._bridge(p, attn_encode(p["enc"], cfg, xy_obs, dxy_n, mask, drop, train,
                                               compute_dtype=dt))
        pe = _round_coder(p["enc"], dt)

        def body(carry, dxy_t, xy_t):
            return _step(pe, cfg, carry, dxy_t, xy_t, mask, drop, train=train)

        body = maybe_remat(cfg, body)
        carry = init_carry((B, N), cfg.hidden_dim, self.device)
        for t in range(xy_obs.shape[2]):
            carry = body(carry, dxy_n[:, :, t], xy_obs[:, :, t])
        return self._bridge(p, carry.h, carry.c)

    def _bridge(self, p: Params, h, c=None) -> Carry:
        """The decoder's carry from the encoder's features: tanh of
        ``bridge_h`` for h; for the LSTM tanh of ``bridge_c`` of the
        encoder's cell state (the attention encoder bridges its features
        for both), else zeros."""
        if self.cfg.cell == "lstm":
            c = torch.tanh(dense(p["bridge_c"], h if c is None else c))
        else:
            c = torch.zeros_like(h)
        return Carry(h=torch.tanh(dense(p["bridge_h"], h)), c=c)

    # -- heads --------------------------------------------------------------
    def _head(self, p: Params, h):
        cfg = self.cfg
        if cfg.head == "gmm":
            return gmm.head_apply(p["head"], h, cfg.num_mixtures, cfg.sigma_min, cfg.rho_max)
        return dense(p["head"], h)

    # -- teacher-forced decode ------------------------------------------------
    def decode_teacher(self, carry: Carry, xy_fut, dxy_fut_n, mask, drop=None):
        """At step t emit the head output that predicts offset t from the
        state before the step, then advance on the ground truth.  xy_fut
        (B, N, Tp, 2) absolute, dxy_fut_n (B, N, Tp, 2) normalized offsets ->
        GMMParams with leaves (B, N, Tp, ...), or (B, N, Tp, 2) for the
        deterministic head.  ``drop``: the decoder's dropout masks."""
        cfg, p = self.cfg, self.params()
        xy_fut, dxy_fut_n = self._tensor(xy_fut), self._tensor(dxy_fut_n)
        mask = self._tensor(mask, torch.bool)
        pd = _round_coder(p["dec"], _compute_dtype(cfg))

        def body(carry, dxy_t, xy_t):
            out = self._head(p, carry.h)
            return _step(pd, cfg, carry, dxy_t, xy_t, mask, drop, train=True), out

        body = maybe_remat(cfg, body)
        outs = []
        for t in range(xy_fut.shape[2]):
            carry, out = body(carry, dxy_fut_n[:, :, t], xy_fut[:, :, t])
            outs.append(out)
        if cfg.head == "gmm":
            return gmm.GMMParams(*(torch.stack(leaf, dim=2) for leaf in zip(*outs)))
        return torch.stack(outs, dim=2)

    # -- rollout random streams -----------------------------------------------
    def _rollout_stream(self, Bk: int, N: int, generator: torch.Generator = None,
                        sigma_scale: float = 1.0):
        """Pre-drawn rollout randomness on the device: (gumbel (Bk, T, N, M),
        normal (Bk, T, N, 2)), drawn from ``generator`` (the device's default
        generator when None) by ``fused_decoder.random_stream``, the normals
        scaled by ``sigma_scale``.  Same distributions as the JAX package's
        stream, not the same numbers."""
        gumbel, normal = fused_decoder.random_stream(Bk, self.pred_len, N, self.cfg.num_mixtures,
                                                     generator, self.device)
        if sigma_scale != 1.0:
            normal = normal * sigma_scale
        return gumbel, normal

    def _per_window_stream(self, keys, k: int, N: int, sigma_scale: float = 1.0,
                           draw_n: int = None):
        """Per-window randomness: window b's k sample streams come from a
        generator on the device seeded with ``keys[b]`` alone, so sampled
        metrics do not depend on batch size, batch position or padding.
        keys (B,) integer seeds -> (gumbel (k*B, T, N, M), normal
        (k*B, T, N, 2)), flat row ``kk*B + b`` as ``rollout_k`` tiles.

        ``draw_n``: draw each window's stream at this canonical agent
        capacity (>= N) and keep the first N slots.  Valid agents fill a
        prefix of the slots, so a window evaluated in a narrower shape
        bucket gets the values it would get in the full padded batch."""
        T, M = self.pred_len, self.cfg.num_mixtures
        n_draw = N if draw_n is None else int(draw_n)
        if n_draw < N:
            raise ValueError(f"draw_n={n_draw} must be >= N={N}")
        B = len(keys)
        u = torch.empty((B, k, T, n_draw, M), device=self.device)
        normal = torch.empty((B, k, T, n_draw, 2), device=self.device)
        g = torch.Generator(device=self.device)
        for b, seed in enumerate(keys):
            g.manual_seed(int(seed))
            u[b].uniform_(generator=g)
            normal[b].normal_(generator=g)
        gumbel = fused_decoder.gumbel(u[..., :N, :]).transpose(0, 1).reshape(k * B, T, N, M)
        normal = normal[..., :N, :].transpose(0, 1).reshape(k * B, T, N, 2)
        if sigma_scale != 1.0:
            normal = normal * sigma_scale
        return gumbel, normal

    # -- sampling decode (autoregressive rollout) ----------------------------
    def decode_rollout(self, carry: Carry, xy_last, mask, stats: NormStats,
                       generator: torch.Generator = None, stream=None,
                       train: bool = False, remat: bool = False):
        """One sampled rollout -> absolute positions (B, N, Tp, 2), meters.
        ``stream``: pre-drawn (gumbel, normal); drawn from ``generator`` when
        None.  Runs under ``torch.no_grad()`` unless ``train``; ``remat``
        checkpoints the step body per ``cfg.remat`` (the variety loss)."""
        cfg, p = self.cfg, self.params()
        with _grad_mode(train):
            B, N = mask.shape
            if cfg.head == "gmm" and stream is None:
                stream = self._rollout_stream(B, N, generator)
            pd = _round_coder(p["dec"], _compute_dtype(cfg))

            def body(carry, xy, gum_t, nrm_t):
                out = self._head(p, carry.h)
                dxy_n = gmm.sample_from(out, gum_t, nrm_t) if cfg.head == "gmm" else out
                xy = xy + denormalize(dxy_n, stats)
                return _step(pd, cfg, carry, dxy_n, xy, mask, train=train), xy

            if remat:
                body = maybe_remat(cfg, body)
            xy, outs = xy_last, []
            for t in range(self.pred_len):
                draws = (stream[0][:, t], stream[1][:, t]) if cfg.head == "gmm" else (None, None)
                carry, xy = body(carry, xy, *draws)
                outs.append(xy)
            return torch.stack(outs, dim=2)

    # -- public API ----------------------------------------------------------
    def rollout_k(self, xy_obs, mask, stats: NormStats, k: int,
                  generator: torch.Generator = None, carry: Carry = None,
                  stream=None, train: bool = False, remat: bool = False,
                  sigma_scale: float = 1.0, keys=None, draw_n: int = None):
        """K sampled rollouts, encode once -> (K, B, N, Tp, 2) absolute meters.

        ``generator`` draws the random stream on the device; ``keys`` (B,)
        per-window integer seeds draw each window's own stream instead
        (``_per_window_stream``, at the canonical capacity ``draw_n``);
        ``stream`` passes a pre-drawn (gumbel (K*B, T, N, M), normal
        (K*B, T, N, 2)), laid out as flat row ``kk*B + b`` (the JAX package's
        ``_rollout_stream(key, K*B, N)`` draws it so), with ``sigma_scale``
        already applied.  ``sigma_scale`` scales the drawn normals (the
        within-component spread).  ``carry``: a precomputed encoder carry.
        ``train``: a differentiated rollout (the variety loss), recorded for
        autograd; otherwise the call runs under ``torch.no_grad()``.
        ``remat``: checkpoint the decode step per ``cfg.remat``."""
        if self.cfg.use_fused_decoder and (train or remat):
            raise ValueError(
                "use_fused_decoder=True cannot serve a differentiated rollout "
                "(loss=variety/hybrid): the fused decoder kernel has no backward and "
                "the train/remat flags do not apply to it; train with the plain "
                "decode path (use_fused_decoder=False)")
        with _grad_mode(train):
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
                if stream is None and keys is not None:
                    stream = self._per_window_stream(keys, k, N, sigma_scale, draw_n)
                elif stream is None:
                    stream = self._rollout_stream(k * B, N, generator, sigma_scale)
                stream = tuple(self._tensor(s).contiguous() for s in stream)
            if self.cfg.use_fused_decoder:
                traj = self._decode_fused(carry_k, xy_last, mask_k, stats, stream)
            else:
                traj = self.decode_rollout(carry_k, xy_last, mask_k, stats, stream=stream,
                                           train=train, remat=remat)
            return traj.reshape((k, B) + traj.shape[1:])

    @torch.no_grad()
    def rollout_modes(self, xy_obs, mask, stats: NormStats, carry: Carry = None):
        """One trajectory per mixture component -> (M, B, N, Tp, 2) absolute
        meters: trajectory m follows component m's mean offset at every
        step.  No randomness.  The M copies are tiled into the batch as in
        ``rollout_k`` (flat row ``m*B + b`` follows component m); the steps
        go through ``_step``, so ``use_pallas`` runs ``fused_gat``."""
        cfg, p = self.cfg, self.params()
        if cfg.head != "gmm":
            raise ValueError("rollout_modes requires the GMM head")
        M = cfg.num_mixtures
        xy_obs, mask = self._tensor(xy_obs), self._tensor(mask, torch.bool)
        B, N = mask.shape
        if carry is None:
            carry = self.encode(xy_obs, mask, stats)

        def tile(a):
            return a.repeat((M,) + (1,) * (a.ndim - 1))

        carry = Carry(h=tile(carry.h), c=tile(carry.c))
        xy, mask_m = tile(xy_obs[:, :, -1]), tile(mask)
        comp = torch.arange(M, device=self.device).repeat_interleave(B)
        pick = comp[:, None, None, None].expand(M * B, N, 1, 2)
        pd = _round_coder(p["dec"], _compute_dtype(cfg))
        outs = []
        for _ in range(self.pred_len):
            dxy_n = torch.gather(self._head(p, carry.h).mu, 2, pick)[:, :, 0]
            xy = xy + denormalize(dxy_n, stats)
            carry = _step(pd, cfg, carry, dxy_n, xy, mask_m)
            outs.append(xy)
        traj = torch.stack(outs, dim=2)
        return traj.reshape((M, B) + traj.shape[1:])

    # -- training objectives -------------------------------------------------
    def _split(self, xy, name: str):
        To = self.obs_len
        if xy.shape[2] != To + self.pred_len:
            raise ValueError(f"{name} expects full windows of {To}+{self.pred_len} frames, "
                             f"got T={xy.shape[2]}")
        return xy[:, :, :To], xy[:, :, To:]

    def loss(self, xy, mask, stats: NormStats, drop=None, agents=None) -> torch.Tensor:
        """Training objective on full windows xy (B, N, To+Tp, 2) -> scalar.
        GMM head: mixture NLL of the normalized target offsets; deterministic
        head: squared error on them.  Masked mean over valid agent-steps, the
        denominator at least 1.  ``drop``: (encoder, decoder) dropout masks
        (``dropout_masks``), or None for no dropout.  ``agents``: the valid
        agents the mean divides by (a 0-d float32 tensor), where the batch is
        one rank's rows of a larger one (data parallelism: each rank's
        numerator over the whole batch's denominator, summed across ranks);
        by default this batch's."""
        xy, mask = self._tensor(xy), self._tensor(mask, torch.bool)
        xy_obs, xy_fut = self._split(xy, "loss")
        dxy_fut_n = normalize(to_relative(xy), stats)[:, :, self.obs_len:]
        drop_enc, drop_dec = drop if drop is not None else (None, None)
        carry = self.encode(xy_obs, mask, stats, drop_enc, train=True)
        outs = self.decode_teacher(carry, xy_fut, dxy_fut_n, mask, drop_dec)
        if self.cfg.head == "gmm":
            per_step = gmm.nll(outs, dxy_fut_n)  # (B, N, Tp)
        else:
            per_step = ((outs - dxy_fut_n) ** 2).sum(-1)
        w = mask[..., None].to(torch.float32)
        n = w.sum() if agents is None else agents
        denom = torch.clamp_min(n * per_step.shape[-1], 1.0)
        return (per_step * w).sum() / denom

    def loss_variety(self, xy, mask, stats: NormStats, stream, n_samples: int, drop=None,
                     fde_weight: float = 0.0, agents=None) -> torch.Tensor:
        """Winner-takes-all objective -> scalar: each agent's smallest mean
        squared position error over ``n_samples`` sampled rollouts (plus
        ``fde_weight`` times its final-step squared error), masked mean over
        agents.  ``stream``: the rollouts' pre-drawn (gumbel, normal) for
        n_samples*B graphs; ``drop``: the encoder's dropout masks only (the
        rollout runs without dropout, as inference does).  Gradients flow
        through the chosen components' means and spreads and the whole
        recurrence; the component choice gets none.  ``agents`` as for
        ``loss``."""
        xy, mask = self._tensor(xy), self._tensor(mask, torch.bool)
        xy_obs, gt = self._split(xy, "loss_variety")
        carry = self.encode(xy_obs, mask, stats, drop, train=True)
        preds = self.rollout_k(xy_obs, mask, stats, n_samples, carry=carry, stream=stream,
                               train=True, remat=True)  # (n, B, N, Tp, 2)
        sq = ((preds - gt[None]) ** 2).sum(-1)  # (n, B, N, Tp)
        err = sq.mean(-1)
        if fde_weight > 0.0:
            err = err + fde_weight * sq[..., -1]
        best = err.amin(0)  # ties share the gradient, as JAX's min does
        w = mask.to(torch.float32)
        return (best * w).sum() / torch.clamp_min(w.sum() if agents is None else agents, 1.0)

    def _decode_fused(self, carry: Carry, xy_last, mask, stats: NormStats, stream):
        """The whole rollout in one ``fused_decode`` launch -> (Bk, N, T, 2),
        in float32 whatever ``cfg.dtype`` (the JAX package passes its fused
        decoder no dtype)."""
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
