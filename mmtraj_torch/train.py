"""Single-device training (counterpart of ``mmtraj/train.py``).

A step is the JAX package's: the step's random draws (augment angles and
flips, dropout masks, the variety loss's rollout stream), the objective
("nll", "variety" or "hybrid"), its gradients by autograd, then gradient
clipping by the global norm and AdamW with the learning-rate schedule,
written out here to optax's arithmetic, and an optional EMA of the
parameters.  PyTorch runs it eagerly: the forward and backward go through
the model's ops and, under ``use_pallas``/``attend_kernel="pallas"``, the
Hopper kernels, whose backward is autograd of their plain math.

``fit`` trains from a data directory with the window set resident on the
device, logs JSONL, checkpoints with the optimizer state (npz, the JAX
package's layout) and evaluates through the port's ``evaluate``.  A resumed
run replays the uninterrupted run's data order and draws, so it reaches the
same parameters.  Not ported: ``steps_per_dispatch > 1`` (ROADMAP.md queue 1
item 2), streaming ingest and data parallelism (item 6).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from mmtraj_torch.config import Config
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.pipeline import DeviceDataset
from mmtraj_torch.data.registry import load_split
from mmtraj_torch.data.transforms import NormStats, augment_windows, compute_norm_stats
from mmtraj_torch.evaluate import _device_stats, evaluate
from mmtraj_torch.models.forecaster import Forecaster, dropout_masks
from mmtraj_torch.params import State, load_npz, not_ported, save_npz
from mmtraj_torch.utils.logging import MetricsLogger

ITEM2 = "item 2, single-device training"
ITEM6 = "item 6, scale-out"


@dataclasses.dataclass
class TrainResult:
    state: State  # the EMA parameters when EMA is on, as the JAX package returns them
    stats: NormStats
    config: Config
    history: list
    eval_metrics: Dict[str, float]


# -- the optimizer ------------------------------------------------------------

def jax_order(names) -> List[str]:
    """Parameter names in the order ``jax.tree.leaves`` visits the JAX tree:
    dict keys sorted at every level."""
    return sorted(names, key=lambda k: k.split("."))


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """The learning rate at optax's update count (0 for the first update):
    constant, or ``warmup_cosine_decay_schedule`` as ``mmtraj/train.py:43``
    builds it (linear from 0 over the warm-up, then cosine to lr/100)."""
    t = cfg.train
    if t.lr_schedule == "constant":
        return lambda count: t.lr
    if t.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")
    warmup = min(t.warmup_steps, max(t.steps, 1))
    decay = max(t.steps, 1) - warmup
    if decay <= 0:
        raise ValueError(f"the cosine schedule needs steps > warmup_steps, got "
                         f"steps={t.steps}, warmup_steps={t.warmup_steps}")
    alpha = (t.lr / 100.0) / t.lr if t.lr else 0.0

    def schedule(count: int) -> float:
        if count < warmup:
            return t.lr * (count / warmup)
        c = min(count - warmup, decay)
        return t.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)

    return schedule


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay))``
    of ``mmtraj/train.py:make_optimizer``, by hand, in float32 on the
    parameters' device, updating them in place:

    * the clip scales every gradient by max_norm / global norm, computed as
      (g / norm) * max_norm with no epsilon, only where the norm is not below
      max_norm (torch's ``clip_grad_norm_`` adds 1e-6 to the norm);
    * Adam with b1 0.9, b2 0.999, eps 1e-8, eps_root 0 and bias correction;
      decoupled weight decay ``cfg.train.weight_decay`` (torch's AdamW
      defaults to 1e-2);
    * the step is -lr(count) times that, at optax's count, 0 first.

    ``state_leaves`` lays the state out as ``jax.tree.leaves`` of optax's
    state: the Adam count, every first moment, every second moment (both in
    ``jax_order``), and the schedule's count under "cosine"."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Config):
        self.names = jax_order(params)
        self.params = [params[k] for k in self.names]
        self.schedule = lr_schedule(cfg)
        self.cosine = cfg.train.lr_schedule == "cosine"
        self.clip = float(cfg.train.grad_clip)
        self.weight_decay = float(cfg.train.weight_decay)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # Adam's count (int32 in optax)
        self.schedule_count = 0

    @torch.no_grad()
    def step(self, grads=None) -> None:
        """One update from ``grads`` (in ``names`` order), or from each
        parameter's ``.grad``."""
        if grads is None:
            grads = [p.grad for p in self.params]
        if self.clip > 0:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.clip
            grads = [torch.where(keep, g, (g / g_norm) * self.clip) for g in grads]
        self.count = min(self.count + 1, 2**31 - 1)
        bc1 = float(1 - np.float32(self.B1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(self.B2) ** np.float32(self.count))
        step_size = -float(np.float32(self.schedule(self.schedule_count)))
        if self.cosine:
            self.schedule_count = min(self.schedule_count + 1, 2**31 - 1)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.mu[i] = (1 - self.B1) * g + self.B1 * self.mu[i]
            self.nu[i] = (1 - self.B2) * (g * g) + self.B2 * self.nu[i]
            u = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + self.EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(step_size * u)

    def state_leaves(self) -> List[np.ndarray]:
        leaves = [np.asarray(self.count, np.int32)]
        leaves += [m.detach().cpu().numpy() for m in self.mu]
        leaves += [v.detach().cpu().numpy() for v in self.nu]
        if self.cosine:
            leaves.append(np.asarray(self.schedule_count, np.int32))
        return leaves

    def load_state_leaves(self, leaves) -> None:
        n = len(self.params)
        want = 1 + 2 * n + int(self.cosine)
        if len(leaves) != want:
            schedule = "cosine" if self.cosine else "constant"
            raise ValueError(f"optimizer state has {len(leaves)} leaves, expected {want} "
                             f"({n} parameters, schedule {schedule})")
        for p, a in zip(self.params * 2, leaves[1:1 + 2 * n]):
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"optimizer leaf of shape {a.shape} for a parameter of "
                                 f"shape {tuple(p.shape)}")
        dev = self.params[0].device
        self.count = int(leaves[0])
        self.mu = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
                   for a in leaves[1:1 + n]]
        self.nu = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
                   for a in leaves[1 + n:1 + 2 * n]]
        self.schedule_count = int(leaves[-1]) if self.cosine else 0


def make_optimizer(cfg: Config, model: Forecaster) -> Optimizer:
    return Optimizer(dict(model.named_parameters()), cfg)


# -- the step -----------------------------------------------------------------

class StepDraws(NamedTuple):
    """One step's random numbers; None where the step needs none."""

    theta: Optional[torch.Tensor] = None  # (B,) rotation angles
    det: Optional[torch.Tensor] = None  # (B,) +1, or -1 for a reflection
    drop: Optional[tuple] = None  # (encoder masks, decoder masks), dropout_masks
    stream: Optional[tuple] = None  # (gumbel, normal) for variety_n * B rollouts


def step_draws(model: Forecaster, seed: int, step: int, B: int, N: int, rotate: bool,
               flip: bool, variety_n: int) -> StepDraws:
    """Every random number of training step ``step``, from three generators
    on the model's device seeded by ``numpy.random.SeedSequence((seed ^
    0x5EED, step))``: the augment angles (uniform in [0, 2 pi)) and flips
    (-1 with probability 1/2), the dropout masks where ``cfg.dropout > 0``,
    and the variety rollouts' stream where ``variety_n > 0``.  It parallels
    the JAX package's ``fold_in(PRNGKey(seed ^ 0x5EED), step)`` split into
    (augment, dropout, variety) keys; the numbers differ.  The step draws
    through this function alone, which the tests replace with JAX's draws."""
    dev = model.device
    words = np.random.SeedSequence(((seed ^ 0x5EED) % 2**64, int(step))).generate_state(
        3, np.uint64)

    def gen(i):
        return torch.Generator(device=dev).manual_seed(int(words[i]))

    theta = det = drop = stream = None
    if rotate or flip:
        g = gen(0)
        theta = (torch.rand(B, generator=g, device=dev) * (2 * math.pi) if rotate
                 else torch.zeros(B, device=dev))
        det = (torch.where(torch.rand(B, generator=g, device=dev) < 0.5, -1.0, 1.0) if flip
               else torch.ones(B, device=dev))
    if model.cfg.dropout > 0.0:
        drop = dropout_masks(model.cfg, B, N, gen(1), dev)
    if variety_n:
        stream = model._rollout_stream(variety_n * B, N, gen(2))
    return StepDraws(theta, det, drop, stream)


def objective(model: Forecaster, xy, mask, stats: NormStats, draws: StepDraws,
              loss_mode: str, variety_n: int, variety_weight: float = 1.0,
              variety_fde_weight: float = 0.0) -> torch.Tensor:
    """The training loss of ``loss_mode`` on a batch (already augmented):
    "nll" (teacher-forced), "variety" (winner-takes-all over ``variety_n``
    rollouts, encoder dropout only) or "hybrid" (nll + ``variety_weight`` x
    variety), as ``mmtraj/train.py:106-116``."""
    if loss_mode == "nll":
        return model.loss(xy, mask, stats, draws.drop)
    drop_enc = draws.drop[0] if draws.drop is not None else None
    lv = model.loss_variety(xy, mask, stats, draws.stream, variety_n, drop_enc,
                            variety_fde_weight)
    if loss_mode == "hybrid":
        return model.loss(xy, mask, stats, draws.drop) + variety_weight * lv
    return lv


def make_train_step(model: Forecaster, optimizer: Optimizer, stats: NormStats,
                    ema: Forecaster = None, ema_decay: float = 0.0,
                    augment_rotate: bool = False, augment_flip: bool = False, seed: int = 0,
                    loss_mode: str = "nll", variety_n: int = 8, variety_weight: float = 1.0,
                    variety_fde_weight: float = 0.0):
    """-> ``step(xy, mask, step_idx)``, which trains ``model`` in place on one
    batch and returns the loss (a detached 0-d tensor on the device: reading
    it waits for the device).  The step's draws come from ``step_draws(...,
    step_idx, ...)``.  With ``ema`` (a Forecaster of the same configuration)
    and ``ema_decay > 0`` it also moves ``ema``'s parameters to d * ema +
    (1 - d) * params after the update.  Each parameter's ``.grad`` holds the
    step's gradient afterwards."""
    if loss_mode not in ("nll", "variety", "hybrid"):
        raise ValueError(f"unknown loss mode {loss_mode!r}")
    if model.cfg.encoder == "attn":
        raise not_ported("encoder='attn' training", ITEM2)
    if loss_mode != "nll" and model.cfg.use_fused_decoder:
        raise ValueError("loss=variety/hybrid differentiates the rollout, which "
                         "use_fused_decoder=True cannot serve; train with the plain decoder")
    stats = _device_stats(stats, model.device)
    n_var = variety_n if loss_mode != "nll" else 0
    params = list(model.parameters())
    pairs = list(zip(ema.parameters(), params)) if ema is not None and ema_decay > 0 else []
    d = float(ema_decay)

    def step(xy, mask, step_idx: int = 0) -> torch.Tensor:
        B, N = mask.shape
        draws = step_draws(model, seed, step_idx, B, N, augment_rotate, augment_flip, n_var)
        if draws.theta is not None:
            xy = augment_windows(xy, mask, draws.theta, draws.det)
        for p in params:
            p.grad = None
        loss = objective(model, xy, mask, stats, draws, loss_mode, variety_n, variety_weight,
                         variety_fde_weight)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            for e, p in pairs:
                e.copy_(d * e + (1.0 - d) * p)
        return loss.detach()

    return step


# -- the loop -------------------------------------------------------------------

def _check_supported(cfg: Config) -> None:
    if cfg.train.steps_per_dispatch > 1:
        raise not_ported("train steps_per_dispatch > 1 (a CUDA graph of a chunk of steps)", ITEM2)
    if cfg.train.stream:
        raise not_ported("train --stream (a pinned, double-buffered prefetch)", ITEM6)
    if cfg.train.data_parallel:
        raise not_ported("train --data-parallel", ITEM6)
    if cfg.model.encoder == "attn":
        raise not_ported("encoder='attn' training", ITEM2)


def fit(cfg: Config, data_dir: Optional[str] = None, logger: Optional[MetricsLogger] = None,
        resume: bool = False, device="cuda") -> TrainResult:
    """Train per the config (the entry point behind ``cli train``), the JAX
    package's ``fit`` in resident mode.

    With ``resume=True`` and an existing ``{out_dir}/checkpoint.npz`` it
    restores the parameters, the optimizer state, the stats and the step
    (and the EMA from ``checkpoint_ema.npz``) and goes on: the data order is
    a function of (seed, epoch) and the draws of (seed, step), and the
    batches the interrupted run consumed are skipped, so the resumed run
    reaches the uninterrupted run's parameters."""
    _check_supported(cfg)
    data_dir = data_dir or cfg.data.data_dir
    t_setup = time.time()
    train_w, test_w = load_split(data_dir, cfg.data.scene, cfg.data.obs_len, cfg.data.pred_len,
                                 cfg.data.stride, cfg.data.min_agents)
    if not train_w:
        raise RuntimeError(f"no training windows found under {data_dir!r}")
    stats = compute_norm_stats(train_w, cfg.data.obs_len)
    train_ds = WindowDataset(train_w, cfg.data.n_max)
    test_ds = WindowDataset(test_w, cfg.data.n_max) if test_w else None

    obs_len, pred_len = cfg.data.obs_len, cfg.data.pred_len
    ckpt_path = os.path.join(cfg.train.out_dir, "checkpoint.npz") if cfg.train.out_dir else None
    ema_path = os.path.join(cfg.train.out_dir, "checkpoint_ema.npz") if cfg.train.out_dir else None
    start_step, opt_leaves, ema_state = 0, None, None
    if resume and ckpt_path and os.path.exists(ckpt_path):
        ck = load_npz(ckpt_path)
        model = Forecaster(cfg.model, obs_len, pred_len, device=device, state=ck.state)
        stats, start_step, opt_leaves = ck.stats, ck.step, ck.opt_leaves
        if cfg.train.ema_decay > 0 and start_step > 0 and os.path.exists(ema_path):
            ema_state = load_npz(ema_path).state
    else:
        model = Forecaster(cfg.model, obs_len, pred_len, device=device,
                           generator=torch.Generator().manual_seed(cfg.train.seed))
    device_ds = DeviceDataset(train_ds, model.device)
    optimizer = make_optimizer(cfg, model)
    if opt_leaves is not None:
        optimizer.load_state_leaves(opt_leaves)
    ema_decay = cfg.train.ema_decay
    ema = None
    if ema_decay > 0:
        ema = Forecaster(cfg.model, obs_len, pred_len, device=model.device,
                         state=ema_state if ema_state is not None else model.state_dict())
    step_fn = make_train_step(
        model, optimizer, stats, ema, ema_decay,
        augment_rotate=cfg.train.augment_rotate, augment_flip=cfg.train.augment_flip,
        seed=cfg.train.seed, loss_mode=cfg.train.loss, variety_n=cfg.train.variety_n,
        variety_weight=cfg.train.variety_weight,
        variety_fde_weight=cfg.train.variety_fde_weight)

    logger = logger or MetricsLogger(cfg.train.out_dir)
    logger.log(
        start_step,
        event="setup" if start_step == 0 else "resume",
        train_windows=len(train_ds),
        test_windows=len(test_ds) if test_ds else 0,
        dropped_agents=train_ds.n_dropped,
        params=sum(p.numel() for p in model.parameters()),
        devices=1,
        device=str(model.device),
        setup_s=round(time.time() - t_setup, 2),
    )

    batches_per_epoch = max(1, math.ceil(train_ds.n_windows / cfg.train.batch_size))

    def epoch_batches(epoch: int, skip: int = 0):
        rng = np.random.default_rng([cfg.train.seed, epoch])
        idxs = device_ds.epoch_indices(cfg.train.batch_size, rng)
        return (device_ds.batch(idx) for idx in itertools.islice(idxs, skip, None))

    history = []
    eval_metrics: Dict[str, float] = {}
    last_eval_step = -1
    step = start_step
    epoch, skip = divmod(start_step, batches_per_epoch)
    t_train = time.time()

    def _log(s: int, lv: float):
        history.append((s, lv))
        sps = (s - start_step) / max(time.time() - t_train, 1e-9)
        logger.log(s, loss=lv, steps_per_sec=round(sps, 2))

    def _save(s: int):
        save_npz(ckpt_path, model.state_dict(), stats, cfg, s, optimizer.state_leaves())
        logger.log(s, event="checkpoint", path=ckpt_path)
        if ema is not None:
            save_npz(ema_path, ema.state_dict(), stats, cfg, s)
            logger.log(s, event="checkpoint", path=ema_path)

    def _eval(s: int):
        nonlocal eval_metrics, last_eval_step
        last_eval_step = s
        eval_metrics = evaluate(ema if ema is not None else model, stats, test_ds,
                                cfg.train.k_samples, batch_size=min(cfg.train.batch_size, 64),
                                seed=cfg.train.seed)
        logger.log(s, **{f"eval_{k}": v for k, v in eval_metrics.items()})

    while step < cfg.train.steps:
        for xy, mask in epoch_batches(epoch, skip):
            loss = step_fn(xy, mask, step)
            step += 1
            if step % cfg.train.log_every == 0 or step == start_step + 1:
                _log(step, float(loss))
            if ckpt_path and cfg.train.ckpt_every > 0 and step % cfg.train.ckpt_every == 0:
                _save(step)
            if (test_ds is not None and cfg.train.eval_every > 0
                    and step % cfg.train.eval_every == 0):
                _eval(step)
            if step >= cfg.train.steps:
                break
        epoch += 1
        skip = 0

    # The final eval is at the last step's parameters, not a periodic one.
    if test_ds is not None and last_eval_step != step:
        _eval(step)
    if ckpt_path:
        _save(step)
    final = ema if ema is not None else model
    return TrainResult({k: v.detach().clone() for k, v in final.state_dict().items()}, stats,
                       cfg, history, eval_metrics)
