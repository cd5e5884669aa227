"""Single-device training (counterpart of ``mmtraj/train.py``).

A step is the JAX package's: the step's random draws (augment angles and
flips, dropout masks, the variety loss's rollout stream), the objective
("nll", "variety" or "hybrid"), its gradients by autograd, then gradient
clipping by the global norm and AdamW with the learning-rate schedule,
written out here to optax's arithmetic, and an optional EMA of the
parameters.  PyTorch runs it eagerly: the forward and backward go through
the model's ops and, under ``use_pallas``/``attend_kernel="pallas"``, the
Hopper kernels, whose backward is autograd of their plain math.  The
optimizer's counts, bias corrections and learning rate live on the device,
so a step never waits for it.

``make_multi_train_step`` runs a chunk of M steps (``steps_per_dispatch``,
the JAX package's scan of steps in one program): on CUDA a CUDA graph of one
step, replayed M times, so the host pays its per-op dispatch once at
capture; on the CPU the same steps eagerly.

``fit`` trains from a data directory with the window set resident on the
device (or streamed from the host through a pinned prefetch), in chunks
where ``steps_per_dispatch > 1``, logs JSONL, checkpoints with the optimizer
state (npz, the JAX package's layout) and evaluates through the port's
``evaluate``.  A resumed run replays the uninterrupted run's data order,
draws and chunks, so it reaches the same parameters.  With a data-parallel
mesh (``mmtraj_torch/parallel``) each rank trains on its rows of every
batch and the gradients are summed across ranks.  A population of seeds
trained as one vmapped step is ``mmtraj_torch/population.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import os
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mmtraj_torch import checkpoint
from mmtraj_torch.config import Config
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.pipeline import DeviceDataset, prefetch_to_device
from mmtraj_torch.data.registry import load_split
from mmtraj_torch.data.transforms import NormStats, augment_windows, compute_norm_stats
from mmtraj_torch.evaluate import _device_stats, evaluate
from mmtraj_torch.models.forecaster import Forecaster, dropout_masks
from mmtraj_torch.ops import _build, launch_counters
from mmtraj_torch.parallel.mesh import all_reduce_sum, is_writer, make_mesh, shard_batch
from mmtraj_torch.params import State, save_npz
from mmtraj_torch.utils.logging import MetricsLogger
from mmtraj_torch.utils.profiling import annotate, nan_debugging

CAPTURE_WARMUP = 2  # eager steps on a side stream before a step's capture


@dataclasses.dataclass
class TrainResult:
    state: State  # the EMA parameters when EMA is on, as the JAX package returns them
    stats: NormStats
    config: Config
    history: list
    eval_metrics: Dict[str, float]


# -- the optimizer ------------------------------------------------------------

INT32_MAX = 2**31 - 1


def jax_order(names) -> List[str]:
    """Parameter names in the order ``jax.tree.leaves`` visits the JAX tree:
    dict keys sorted at every level."""
    return sorted(names, key=lambda k: k.split("."))


def lr_schedule(cfg: Config) -> Callable[[torch.Tensor], torch.Tensor]:
    """The learning rate at optax's update count (0 for the first update), a
    float32 0-d tensor on the count's device (an int counts on the CPU):
    constant, or ``warmup_cosine_decay_schedule`` as ``mmtraj/train.py:43``
    builds it, in optax's float32 arithmetic: ``join_schedules`` of a linear
    schedule from 0 to lr over the warm-up and a cosine decay to lr/100."""
    t = cfg.train
    if t.lr_schedule == "constant":
        return lambda count: torch.full((), t.lr, device=torch.as_tensor(count).device)
    if t.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")
    warmup = min(t.warmup_steps, max(t.steps, 1))
    decay = max(t.steps, 1) - warmup
    if decay <= 0:
        raise ValueError(f"the cosine schedule needs steps > warmup_steps, got "
                         f"steps={t.steps}, warmup_steps={t.warmup_steps}")
    alpha = (t.lr / 100.0) / t.lr if t.lr else 0.0

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.int32)
        if warmup > 0:  # optax's linear schedule; one of 0 steps is constant 0
            frac = 1 - count.clamp(0, warmup) / warmup
            warm = (0.0 - t.lr) * frac + t.lr
        else:
            warm = torch.zeros((), device=count.device)
        c = (count - warmup).to(torch.float32).clamp_max(float(decay))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay))
        return torch.where(count < warmup, warm, t.lr * ((1 - alpha) * cosine + alpha))

    return schedule


def _increment(count: torch.Tensor) -> None:
    """optax's ``safe_increment`` of an int32 count, in place: saturates."""
    count.copy_(torch.where(count < INT32_MAX, count + 1, count))


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay))``
    of ``mmtraj/train.py:make_optimizer``, by hand, in float32 on the
    parameters' device, updating them and its state in place (a captured
    step reads and writes the same tensors at every replay):

    * the clip scales every gradient by max_norm / global norm, computed as
      (g / norm) * max_norm with no epsilon, only where the norm is not below
      max_norm (torch's ``clip_grad_norm_`` adds 1e-6 to the norm);
    * Adam with b1 0.9, b2 0.999, eps 1e-8, eps_root 0 and bias correction at
      the int32 count (saturating); decoupled weight decay
      ``cfg.train.weight_decay`` (torch's AdamW defaults to 1e-2);
    * the step is -lr(count) times that, the schedule read at its count
      before the update, 0 first.

    The counts are int32 tensors and the bias corrections and the learning
    rate are computed on the device, so a step reads nothing back from it.
    ``state_leaves`` lays the state out as ``jax.tree.leaves`` of optax's
    state: the Adam count, every first moment, every second moment (both in
    ``jax_order``), and the schedule's count under "cosine".

    ``lanes=True`` (a population of seeds, ``mmtraj_torch/population.py``):
    every parameter, gradient and moment carries a leading lane axis, and
    each lane is its own run.  The clip's global norm is taken per lane,
    over that lane's slices only (one norm over all lanes would couple the
    seeds); Adam, the weight decay, the schedule and the counts are
    elementwise or shared, as in the JAX package's vmapped optimizer.
    ``state_leaves(lane)`` gives one lane's state in the layout above."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Config, lanes: bool = False):
        self.names = jax_order(params)
        self.params = [params[k] for k in self.names]
        self.lanes = lanes
        self.schedule = lr_schedule(cfg)
        self.cosine = cfg.train.lr_schedule == "cosine"
        self.clip = float(cfg.train.grad_clip)
        self.weight_decay = float(cfg.train.weight_decay)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)  # Adam's
        self.schedule_count = torch.zeros((), dtype=torch.int32, device=dev)

    def state(self) -> List[torch.Tensor]:
        """Every tensor the update writes besides the parameters."""
        return [self.count, self.schedule_count, *self.mu, *self.nu]

    @torch.no_grad()
    def step(self, grads=None) -> None:
        """One update from ``grads`` (in ``names`` order), or from each
        parameter's ``.grad``."""
        if grads is None:
            grads = [p.grad for p in self.params]
        if self.clip > 0 and self.lanes:  # a norm a lane, over the lane's slices
            sq = torch._foreach_mul(grads, grads)
            g_norm = torch.sqrt(sum(t.flatten(1).sum(1) for t in sq))
            norms = [g_norm.view((-1,) + (1,) * (g.ndim - 1)) for g in grads]
            scaled = torch._foreach_div(grads, norms)
            torch._foreach_mul_(scaled, self.clip)
            grads = [torch.where(n < self.clip, g, s) for g, s, n in zip(grads, scaled, norms)]
        elif self.clip > 0:
            g_norm = torch.sqrt(sum(torch.sum(gg) for gg in torch._foreach_mul(grads, grads)))
            keep = g_norm < self.clip
            scaled = torch._foreach_div(grads, g_norm)
            torch._foreach_mul_(scaled, self.clip)
            grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
        step_size = -self.schedule(self.schedule_count)
        _increment(self.count)
        if self.cosine:
            _increment(self.schedule_count)
        n = self.count.to(torch.float32)
        bc1, bc2 = 1 - torch.pow(self.B1, n), 1 - torch.pow(self.B2, n)
        # mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu, as optax rounds them.
        torch._foreach_mul_(self.mu, self.B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - self.B2)
        torch._foreach_mul_(self.nu, self.B2)
        torch._foreach_add_(self.nu, sq)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        u = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(u, step_size)
        torch._foreach_add_(self.params, u)

    def state_leaves(self, lane: Optional[int] = None) -> List[np.ndarray]:
        """The state as optax's leaves, copies on the host; with lanes, lane
        ``lane``'s."""
        pick = (lambda t: t) if lane is None else (lambda t: t[lane])
        leaves = [np.array(self.count.cpu())]
        leaves += [np.array(pick(m).detach().cpu()) for m in self.mu]
        leaves += [np.array(pick(v).detach().cpu()) for v in self.nu]
        if self.cosine:
            leaves.append(np.array(self.schedule_count.cpu()))
        return leaves

    @torch.no_grad()
    def load_state_leaves(self, leaves) -> None:
        """Copy a checkpoint's leaves into the state, in place."""
        if self.lanes:
            raise ValueError("a population's optimizer state loads lane by lane; it resumes "
                             "no checkpoint")
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
        self.count.fill_(int(leaves[0]))
        for t, a in zip(self.mu + self.nu, leaves[1:1 + 2 * n]):
            t.copy_(torch.as_tensor(np.asarray(a, np.float32)))
        self.schedule_count.fill_(int(leaves[-1]) if self.cosine else 0)


def make_optimizer(cfg: Config, model: Forecaster) -> Optimizer:
    return Optimizer(dict(model.named_parameters()), cfg)


# -- the step -----------------------------------------------------------------

class StepDraws(NamedTuple):
    """One step's random numbers; None where the step needs none."""

    theta: Optional[torch.Tensor] = None  # (B,) rotation angles
    det: Optional[torch.Tensor] = None  # (B,) +1, or -1 for a reflection
    drop: Optional[tuple] = None  # (encoder masks, decoder masks), dropout_masks
    stream: Optional[tuple] = None  # (gumbel, normal) for variety_n * B rollouts

    def tensors(self) -> List[torch.Tensor]:
        masks = [m[k] for m in (self.drop or ()) for k in ("emb", "gat")]
        return [t for t in (self.theta, self.det, *masks, *(self.stream or ())) if t is not None]

    def with_tensors(self, ts) -> "StepDraws":
        """These draws with ``ts`` (in ``tensors()``'s order) in place of
        their tensors."""
        it = iter(ts)
        return self.map(lambda _: next(it), lambda _: next(it))

    def map(self, rows: Callable, stream: Callable) -> "StepDraws":
        """``rows`` applied to every per-window tensor, ``stream`` to each of
        the stream's two (laid out ``(variety_n * B, ...)``, row ``kk*B + b``),
        in ``tensors()``'s order."""
        theta, det = (None if t is None else rows(t) for t in (self.theta, self.det))
        drop = None if self.drop is None else tuple({k: rows(m[k]) for k in ("emb", "gat")}
                                                    for m in self.drop)
        return StepDraws(theta, det, drop,
                         None if self.stream is None else tuple(map(stream, self.stream)))


def shard_draws(draws: StepDraws, mesh, variety_n: int) -> StepDraws:
    """This rank's rows of a whole batch's draws: the per-window ones by
    ``shard_batch``; the stream's ``(variety_n * B)`` rows, sample-major, as
    ``(variety_n, B)`` with the rank's B rows of every sample."""
    def stream(t):
        lanes = shard_batch(t.reshape((variety_n, -1) + t.shape[1:]).transpose(0, 1), mesh)
        return lanes.transpose(0, 1).reshape((-1,) + t.shape[1:])

    return draws.map(lambda t: shard_batch(t, mesh), stream)


def step_draws(model: Forecaster, seed: int, step: int, B: int, N: int, rotate: bool,
               flip: bool, variety_n: int) -> StepDraws:
    """Every random number of training step ``step``, from three generators
    on the model's device seeded by ``numpy.random.SeedSequence((seed ^
    0x5EED, step))``: the augment angles (uniform in [0, 2 pi)) and flips
    (-1 with probability 1/2), the dropout masks where ``cfg.dropout > 0``,
    and the variety rollouts' stream where ``variety_n > 0``.  It parallels
    the JAX package's ``fold_in(PRNGKey(seed ^ 0x5EED), step)`` split into
    (augment, dropout, variety) keys; the numbers differ.  The step draws
    through this function alone, which the tests replace with JAX's draws;
    a chunk of steps calls it before each step's replay."""
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
              variety_fde_weight: float = 0.0, agents=None) -> torch.Tensor:
    """The training loss of ``loss_mode`` on a batch (already augmented):
    "nll" (teacher-forced), "variety" (winner-takes-all over ``variety_n``
    rollouts, encoder dropout only) or "hybrid" (nll + ``variety_weight`` x
    variety), as ``mmtraj/train.py:106-116``.  ``agents``: the whole
    batch's valid agents where ``xy`` is one rank's rows (``Forecaster.loss``)."""
    if loss_mode == "nll":
        return model.loss(xy, mask, stats, draws.drop, agents)
    drop_enc = draws.drop[0] if draws.drop is not None else None
    lv = model.loss_variety(xy, mask, stats, draws.stream, variety_n, drop_enc,
                            variety_fde_weight, agents)
    if loss_mode == "hybrid":
        return model.loss(xy, mask, stats, draws.drop, agents) + variety_weight * lv
    return lv


def _build_core(model: Forecaster, optimizer: Optimizer, stats: NormStats,
                ema: Optional[Forecaster], ema_decay: float, augment_rotate: bool,
                augment_flip: bool, seed: int, loss_mode: str, variety_n: int,
                variety_weight: float, variety_fde_weight: float, mesh=None):
    """The one-step core that ``make_train_step`` and ``make_multi_train_step``
    share -> (core, draw, state): ``core(xy, mask, draws, agents=None)``
    trains ``model`` in place on one batch and returns the detached loss;
    ``draw(step, B, N)`` is the step's ``step_draws``; ``state`` every tensor
    a step updates (parameters, optimizer state, EMA).

    With a ``mesh`` (data parallelism) the draws are the whole batch's and
    the core takes this rank's rows of them; ``xy``/``mask`` are the whole
    batch, of which it takes its rows too, or, where ``agents`` (the whole
    batch's valid agents) is given, already this rank's rows.  The rank's
    loss is its numerator over the whole batch's denominator, and the
    gradients and the loss are summed across the mesh (one ``all_reduce``),
    so every rank clips and updates with the whole batch's gradient: the
    JAX package's step on the whole batch."""
    if loss_mode not in ("nll", "variety", "hybrid"):
        raise ValueError(f"unknown loss mode {loss_mode!r}")
    if loss_mode != "nll" and model.cfg.use_fused_decoder:
        raise ValueError("loss=variety/hybrid differentiates the rollout, which "
                         "use_fused_decoder=True cannot serve; train with the plain decoder")
    stats = _device_stats(stats, model.device)
    n_var = variety_n if loss_mode != "nll" else 0
    params = list(model.parameters())
    ema_params = list(ema.parameters()) if ema is not None and ema_decay > 0 else []
    d = float(ema_decay)

    def draw(step_idx: int, B: int, N: int) -> StepDraws:
        return step_draws(model, seed, step_idx, B, N, augment_rotate, augment_flip, n_var)

    def core(xy, mask, draws: StepDraws, agents=None) -> torch.Tensor:
        if mesh is not None:
            if agents is None:
                agents = mask.sum().to(torch.float32)
                xy, mask = shard_batch((xy, mask), mesh)
            draws = shard_draws(draws, mesh, n_var)
        if draws.theta is not None:
            xy = augment_windows(xy, mask, draws.theta, draws.det)
        for p in params:
            p.grad = None
        loss = objective(model, xy, mask, stats, draws, loss_mode, variety_n, variety_weight,
                         variety_fde_weight, agents)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            loss = loss.reshape(1).clone()
            all_reduce_sum([p.grad for p in params] + [loss], mesh)
            loss = loss[0]
        optimizer.step()
        if ema_params:  # d * ema + (1 - d) * params, as the JAX package rounds it
            with torch.no_grad():
                torch._foreach_mul_(ema_params, d)
                torch._foreach_add_(ema_params, torch._foreach_mul(params, 1.0 - d))
        return loss

    return core, draw, params + optimizer.state() + ema_params


def _global_rows(mask, agents, mesh) -> int:
    """The whole batch's rows: ``mask``'s, or all ranks' where ``mask`` is
    one rank's (``agents`` given)."""
    return mask.shape[0] * (mesh.size() if mesh is not None and agents is not None else 1)


def make_train_step(model: Forecaster, optimizer: Optimizer, stats: NormStats,
                    ema: Forecaster = None, ema_decay: float = 0.0,
                    augment_rotate: bool = False, augment_flip: bool = False, seed: int = 0,
                    loss_mode: str = "nll", variety_n: int = 8, variety_weight: float = 1.0,
                    variety_fde_weight: float = 0.0, mesh=None):
    """-> ``step(xy, mask, step_idx, agents=None)``, which trains ``model``
    in place on one batch and returns the loss (a detached 0-d tensor on the
    device: reading it waits for the device).  The step's draws come from
    ``step_draws(..., step_idx, ...)``.  With ``ema`` (a Forecaster of the
    same configuration) and ``ema_decay > 0`` it also moves ``ema``'s
    parameters to d * ema + (1 - d) * params after the update.  Each
    parameter's ``.grad`` holds the step's gradient afterwards.

    With a ``mesh`` (``parallel.make_mesh``) the step is data-parallel:
    ``xy``/``mask`` are the whole batch (every rank passes the same), or
    this rank's rows with ``agents`` the whole batch's valid agents; every
    rank draws the whole batch's draws and takes its rows, and the
    gradients are summed across the mesh (``_build_core``)."""
    core, draw, _ = _build_core(model, optimizer, stats, ema, ema_decay, augment_rotate,
                                augment_flip, seed, loss_mode, variety_n, variety_weight,
                                variety_fde_weight, mesh)

    def step(xy, mask, step_idx: int = 0, agents=None) -> torch.Tensor:
        draws = draw(step_idx, _global_rows(mask, agents, mesh), mask.shape[1])
        return core(xy, mask, draws, agents)

    return step


class _GraphedStep:
    """One training step captured as a CUDA graph over static slots: the
    batch's window indices (of shape ``idx_shape``), the step's draws, and
    the loss it writes.  The parameters, the optimizer state, the EMA and
    the gradients are the graph's own tensors, updated in place at every
    replay.  ``core(xy, mask, draws)`` gets the rows of the indices, shaped
    ``idx_shape + xy_all.shape[1:]``."""

    def __init__(self, core, draws: StepDraws, state, params, xy_all, mask_all, idx_shape):
        dev = xy_all.device
        idx_shape = tuple(idx_shape)
        self.key = self.key_of(xy_all, mask_all, idx_shape)
        self.idx = torch.zeros(idx_shape, dtype=torch.int64, device=dev)
        self.draws = draws  # fresh tensors: the slots

        def run():
            flat = self.idx.reshape(-1)
            xy = xy_all.index_select(0, flat).reshape(idx_shape + xy_all.shape[1:])
            mask = mask_all.index_select(0, flat).reshape(idx_shape + mask_all.shape[1:])
            return core(xy, mask, self.draws)

        _build.build()  # every kernel built (and loaded) before capture
        counters = launch_counters()
        with torch.no_grad():
            snapshot = [t.detach().clone() for t in state]
        # Warm-up on a side stream, as capture requires; it trains, so the
        # state is restored after capture (which itself runs nothing).  A
        # data-parallel step's first all_reduce also sets up its NCCL
        # communicator here, outside the capture.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                run()
        torch.cuda.current_stream(dev).wait_stream(side)
        for p in params:
            p.grad = None
        before = {k: c.launches for k, c in counters.items()}
        self.graph = torch.cuda.CUDAGraph()
        # An unreachable graph that the collector destroys during the capture
        # ends it (cudaGraphExecDestroy is not allowed then): collect first,
        # and not again until the capture is over.
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.loss = run()
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: c.launches - before[k] for k, c in counters.items()}
        with torch.no_grad():
            for t, s in zip(state, snapshot):
                t.copy_(s)
        self.params = params
        self.grads = [p.grad for p in params]

    @staticmethod
    def key_of(xy_all, mask_all, idx_shape) -> tuple:
        """What a capture depends on: the window set's tensors and the
        indices' shape."""
        return xy_all.data_ptr(), mask_all.data_ptr(), tuple(xy_all.shape), tuple(idx_shape)

    def replay(self, idx: torch.Tensor, draws: StepDraws) -> torch.Tensor:
        self.idx.copy_(idx)
        for slot, t in zip(self.draws.tensors(), draws.tensors()):
            slot.copy_(t)
        self.graph.replay()
        return self.loss


def run_chunk(graphed: list, make, model, params, xy_all, mask_all, idx_chunk: np.ndarray,
              step_ids, draw_step) -> torch.Tensor:
    """Replay a chunk of steps from the one captured step in ``graphed``
    (captured anew by ``make()`` when the window set or the index shape
    changed): step k's indices ``idx_chunk[k]`` and draws ``draw_step(s)``
    go into the slots before its replay.  -> the losses, stacked (a device
    tensor); the parameters' ``.grad`` then hold the last step's gradient.

    Spans (``profiling.annotate``): ``train.chunk`` around it all,
    ``train.capture`` around a capture, ``train.upload`` (the index chunk
    pinned and copied), and a step's ``train.step`` (``step``) with its
    ``train.draw`` and ``train.replay`` (the slot copies and the replay)."""
    with annotate("train.chunk"):
        if not graphed or graphed[0].key != _GraphedStep.key_of(xy_all, mask_all,
                                                                idx_chunk.shape[1:]):
            with annotate("train.capture"):
                graphed[:] = [make()]
        g = graphed[0]
        with annotate("train.upload"):
            idx_dev = torch.from_numpy(idx_chunk).pin_memory().to(model.device,
                                                                  non_blocking=True)
        losses = torch.empty((len(step_ids),) + g.loss.shape, device=model.device)
        for k, s in enumerate(step_ids):
            with annotate("train.step", step=s):
                with annotate("train.draw"):
                    draws = draw_step(s)
                with annotate("train.replay"):
                    losses[k].copy_(g.replay(idx_dev[k], draws))
        for p, grad in zip(params, g.grads):
            p.grad = grad
        return losses


def replays_graph(device: torch.device, said: list) -> bool:
    """Whether a chunk of steps replays a CUDA graph: on the card, unless
    ``enable_nan_debugging``'s per-op check is on, which a graph cannot
    hold; the chunk's steps then run eagerly on the card, and the first such
    chunk says so on stderr (``said`` remembers it)."""
    if device.type != "cuda":
        return False
    if not nan_debugging():
        return True
    if not said:
        said.append(True)
        print("debug-nans: each step of a chunk runs eagerly (a CUDA graph cannot hold the "
              "per-op NaN check)", file=sys.stderr, flush=True)
    return False


def make_multi_train_step(model: Forecaster, optimizer: Optimizer, stats: NormStats,
                          ema: Forecaster = None, ema_decay: float = 0.0,
                          augment_rotate: bool = False, augment_flip: bool = False,
                          seed: int = 0, loss_mode: str = "nll", variety_n: int = 8,
                          variety_weight: float = 1.0, variety_fde_weight: float = 0.0,
                          mesh=None):
    """M training steps per host dispatch (``TrainConfig.steps_per_dispatch``;
    ``mmtraj/train.py:155-231``) -> ``multi(xy_all, mask_all, idx_chunk,
    step_ids)``: the window set on the device (``DeviceDataset.xy``/``.mask``),
    an index chunk (M, B) and the M step ids, -> the (M,) losses, a device
    tensor (reading it waits for the device).

    Step k gathers rows ``idx_chunk[k]`` of the window set and runs the same
    one-step core as ``make_train_step`` with ``step_draws`` of
    ``step_ids[k]``: the same batches, draws, optimizer and EMA math as M
    single steps.  On the CPU, and under ``enable_nan_debugging``, the steps
    run eagerly.  Otherwise, on CUDA, the first call
    captures one step as a CUDA graph (after ``CAPTURE_WARMUP`` steps on a
    side stream; the state they trained is restored, so the chunk follows the
    per-step run from its first step), and every step is a replay: the index
    chunk goes to the device once per chunk from pinned memory; before each
    replay, step k's indices and its draws (made by ``step_draws`` on the
    device) are copied into the graph's slots.  Nothing in a chunk waits for
    the device.  A capture that fails raises; nothing falls back to eager.
    With a ``mesh`` the indices are the whole batch's, every rank passes
    the same, and the graph holds the gradients' ``all_reduce`` (NCCL
    supports capture; gloo, on the CPU, runs the chunk eagerly).

    The gradients come from the graph's memory pool; after a chunk each
    parameter's ``.grad`` holds its last step's gradient.

    Launch counts: the kernel wrappers count Python calls, so the warm-up
    steps and the capture count once each and replays count nothing; every
    replay launches what ``multi.capture_launches`` holds (the counts of the
    capture; empty before the first capture)."""
    core, draw, state = _build_core(model, optimizer, stats, ema, ema_decay, augment_rotate,
                                    augment_flip, seed, loss_mode, variety_n, variety_weight,
                                    variety_fde_weight, mesh)
    params = list(model.parameters())
    graphed: List[_GraphedStep] = []
    capture_launches: Dict[str, int] = {}
    said: list = []

    def multi(xy_all, mask_all, idx_chunk, step_ids: Sequence[int]) -> torch.Tensor:
        idx_chunk = np.asarray(idx_chunk, np.int64)
        step_ids = [int(s) for s in step_ids]
        M, B = idx_chunk.shape
        if len(step_ids) != M:
            raise ValueError(f"{len(step_ids)} step ids for an index chunk of {M} steps")
        N = mask_all.shape[1]
        if not replays_graph(model.device, said):
            losses = []
            for idx, s in zip(torch.from_numpy(idx_chunk), step_ids):
                idx = idx.to(model.device)
                losses.append(core(xy_all[idx], mask_all[idx], draw(s, B, N)))
            return torch.stack(losses)

        def make():
            g = _GraphedStep(core, draw(step_ids[0], B, N), state, params, xy_all, mask_all,
                             (B,))
            capture_launches.clear()
            capture_launches.update(g.launches)
            return g

        return run_chunk(graphed, make, model, params, xy_all, mask_all, idx_chunk, step_ids,
                         lambda s: draw(s, B, N))

    multi.capture_launches = capture_launches
    return multi


# -- the loop -------------------------------------------------------------------

def _check_supported(cfg: Config) -> None:
    if cfg.train.stream and cfg.train.steps_per_dispatch > 1:
        raise ValueError("steps_per_dispatch > 1 requires resident ingest (stream=False): a "
                         "chunk gathers its batches on the device from the resident window set")


def data_mesh(cfg: Config, mesh, device):
    """The data-parallel mesh of a run: ``mesh``, else a new one where
    ``cfg.train.data_parallel``, else None; the batch must split over it."""
    if mesh is None and cfg.train.data_parallel:
        mesh = make_mesh(device=device)
    if mesh is not None and cfg.train.batch_size % mesh.size():
        raise ValueError(f"data_parallel needs a batch size that divides over the mesh "
                         f"({cfg.train.batch_size} % {mesh.size()} != 0)")
    return mesh


def index_stream(device_ds: DeviceDataset, batch_size: int, seed: int, start_epoch: int = 0,
                 skip: int = 0):
    """The batches' window indices of a run, endlessly: epoch e's
    ``(seed, e)`` permutation (``DeviceDataset.epoch_indices``), from epoch
    ``start_epoch`` with its first ``skip`` batches skipped."""
    e, sk = start_epoch, skip
    while True:
        rng = np.random.default_rng([seed, e])
        yield from itertools.islice(device_ds.epoch_indices(batch_size, rng), sk, None)
        e, sk = e + 1, 0


def batch_source(cfg: Config, train_ds: WindowDataset, device_ds: Optional[DeviceDataset],
                 idx_iter, start_epoch: int, skip: int, device, mesh=None):
    """The batches of ``fit``'s per-step path, as (xy, mask, agents) on the
    device: resident, the rows of the next index of ``idx_iter`` gathered on
    the device (the whole batch; ``agents`` None); streamed
    (``cfg.train.stream``), the host's ``WindowDataset.epoch_batches`` of the
    same ``(seed, epoch)`` permutation from epoch ``start_epoch``, its first
    ``skip`` batches skipped, through ``prefetch_to_device``.  With a mesh a
    streamed batch is this rank's rows, and ``agents`` the whole batch's
    valid agents, counted on the host."""
    if not cfg.train.stream:
        return ((*device_ds.batch(idx), None) for idx in idx_iter)

    def host():
        e, sk = start_epoch, skip
        while True:
            rng = np.random.default_rng([cfg.train.seed, e])
            for xy, mask in itertools.islice(
                    train_ds.epoch_batches(cfg.train.batch_size, rng), sk, None):
                yield (xy, mask, np.float32(mask.sum())) if mesh is not None else (xy, mask)
            e, sk = e + 1, 0

    batches = prefetch_to_device(host(), size=2, device=device, mesh=mesh)
    if mesh is not None:
        return batches
    return ((xy, mask, None) for xy, mask in batches)


def fit(cfg: Config, data_dir: Optional[str] = None, logger: Optional[MetricsLogger] = None,
        resume: bool = False, device="cuda", mesh=None) -> TrainResult:
    """Train per the config (the entry point behind ``cli train``), the JAX
    package's ``fit``.

    With ``steps_per_dispatch`` M > 1, full chunks of M steps run through
    ``make_multi_train_step`` (a CUDA graph on the card) and a ragged tail
    up to the next checkpoint, eval or last step runs step by step, as the
    JAX package's ``fit`` does; a logged chunk fetches its loss vector once.
    With ``resume=True`` and an existing ``{out_dir}/checkpoint.npz`` it
    restores the parameters, the optimizer state, the stats and the step
    (and the EMA from ``checkpoint_ema.npz``) and goes on: the data order is
    a function of (seed, epoch) and the draws of (seed, step), and the
    batches the interrupted run consumed are skipped, so the resumed run
    reaches the uninterrupted run's parameters.

    Ingest: resident (the window set on the device, a gather a batch), or
    with ``cfg.train.stream`` streamed: the host's batches of the same
    permutation, pinned and copied ahead on a side stream
    (``data.pipeline.prefetch_to_device``), so the losses are the resident
    run's.  ``stream`` needs ``steps_per_dispatch`` 1.

    Data parallelism (``cfg.train.data_parallel``, or a ``mesh`` from
    ``parallel.make_mesh``): every rank of the mesh runs this with the same
    configuration; each step trains on the rank's rows of the whole batch
    and sums the gradients across the mesh, so the parameters follow the
    single-process run (``make_train_step``).  Resident, every rank holds
    the window set and gathers the whole batch; streamed, each rank
    prefetches its own rows.  Rank 0 writes the checkpoints and the metrics
    log; every rank returns the same result."""
    _check_supported(cfg)
    mesh = data_mesh(cfg, mesh, device)
    writer = is_writer(mesh)
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
        ck = checkpoint.load(ckpt_path)
        model = Forecaster(cfg.model, obs_len, pred_len, device=device, state=ck.state)
        stats, start_step, opt_leaves = ck.stats, ck.step, ck.opt_leaves
        if cfg.train.ema_decay > 0 and start_step > 0 and os.path.exists(ema_path):
            ema_state = checkpoint.load(ema_path).state
    else:
        model = Forecaster(cfg.model, obs_len, pred_len, device=device,
                           generator=torch.Generator().manual_seed(cfg.train.seed))
    device_ds = None if cfg.train.stream else DeviceDataset(train_ds, model.device)
    optimizer = make_optimizer(cfg, model)
    if opt_leaves is not None:
        optimizer.load_state_leaves(opt_leaves)
    ema_decay = cfg.train.ema_decay
    ema = None
    if ema_decay > 0:
        ema = Forecaster(cfg.model, obs_len, pred_len, device=model.device,
                         state=ema_state if ema_state is not None else model.state_dict())
    step_kw = dict(augment_rotate=cfg.train.augment_rotate, augment_flip=cfg.train.augment_flip,
                   seed=cfg.train.seed, loss_mode=cfg.train.loss, variety_n=cfg.train.variety_n,
                   variety_weight=cfg.train.variety_weight,
                   variety_fde_weight=cfg.train.variety_fde_weight, mesh=mesh)
    step_fn = make_train_step(model, optimizer, stats, ema, ema_decay, **step_kw)
    multi_fn = (make_multi_train_step(model, optimizer, stats, ema, ema_decay, **step_kw)
                if cfg.train.steps_per_dispatch > 1 else None)

    logger = logger or MetricsLogger(cfg.train.out_dir if writer else None, quiet=not writer)
    logger.log(
        start_step,
        event="setup" if start_step == 0 else "resume",
        train_windows=len(train_ds),
        test_windows=len(test_ds) if test_ds else 0,
        dropped_agents=train_ds.n_dropped,
        params=sum(p.numel() for p in model.parameters()),
        devices=mesh.size() if mesh is not None else 1,
        device=str(model.device),
        setup_s=round(time.time() - t_setup, 2),
    )

    history = []
    eval_metrics: Dict[str, float] = {}
    last_eval_step = -1
    step = start_step
    t_train = time.time()

    def _log(s: int, lv: float):
        history.append((s, lv))
        sps = (s - start_step) / max(time.time() - t_train, 1e-9)
        logger.log(s, loss=lv, steps_per_sec=round(sps, 2))

    def _save(s: int):
        if not writer:
            return
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
                                seed=cfg.train.seed, mesh=mesh)
        logger.log(s, **{f"eval_{k}": v for k, v in eval_metrics.items()})

    def _maybe_ckpt_and_eval(s: int):
        if ckpt_path and cfg.train.ckpt_every > 0 and s % cfg.train.ckpt_every == 0:
            _save(s)
        if test_ds is not None and cfg.train.eval_every > 0 and s % cfg.train.eval_every == 0:
            _eval(s)

    # The data order is a function of (seed, epoch): a resumed run rebuilds
    # its epoch's permutation and skips the batches already consumed.
    batches_per_epoch = max(1, math.ceil(train_ds.n_windows / cfg.train.batch_size))
    start_epoch, skip = divmod(start_step, batches_per_epoch)

    def next_boundary(s: int) -> int:
        """The next step that checkpoints, evaluates or ends the run."""
        b = cfg.train.steps
        if ckpt_path and cfg.train.ckpt_every > 0:
            b = min(b, (s // cfg.train.ckpt_every + 1) * cfg.train.ckpt_every)
        if test_ds is not None and cfg.train.eval_every > 0:
            b = min(b, (s // cfg.train.eval_every + 1) * cfg.train.eval_every)
        return b

    # Full chunks of steps_per_dispatch steps run through multi_fn; a ragged
    # tail up to the next boundary runs step by step, as in the JAX package.
    spd = cfg.train.steps_per_dispatch
    idx_iter = None if cfg.train.stream else index_stream(device_ds, cfg.train.batch_size,
                                                          cfg.train.seed, start_epoch, skip)
    batches = batch_source(cfg, train_ds, device_ds, idx_iter, start_epoch, skip, model.device,
                           mesh)
    try:
        while step < cfg.train.steps:
            m = min(spd, next_boundary(step) - step)
            if m == spd > 1:
                idx_chunk = np.stack([next(idx_iter) for _ in range(m)])
                losses = multi_fn(device_ds.xy, device_ds.mask, idx_chunk,
                                  range(step, step + m))
                to_log = [t for t in range(step + 1, step + m + 1)
                          if t % cfg.train.log_every == 0 or t == start_step + 1]
                if to_log:  # one fetch from the device a logged chunk
                    lv = losses.cpu().numpy()
                    for t in to_log:
                        _log(t, float(lv[t - step - 1]))
                step += m
            else:
                for _ in range(m):
                    xy, mask, agents = next(batches)
                    loss = step_fn(xy, mask, step, agents)
                    step += 1
                    if step % cfg.train.log_every == 0 or step == start_step + 1:
                        _log(step, float(loss))
            _maybe_ckpt_and_eval(step)
    finally:
        if hasattr(batches, "close"):
            batches.close()  # a streamed run stops its producer thread

    # The final eval is at the last step's parameters, not a periodic one.
    if test_ds is not None and last_eval_step != step:
        _eval(step)
    if ckpt_path:
        _save(step)
    final = ema if ema is not None else model
    return TrainResult({k: v.detach().clone() for k, v in final.state_dict().items()}, stats,
                       cfg, history, eval_metrics)
