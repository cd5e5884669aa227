"""Population training: one step for a whole seed sweep (counterpart of
``mmtraj/population.py``).

The quality protocol is multi-seed (mean and spread over 5 seeds), so the
unit of training work is a sweep, not a run.  On the H100 a graphed training
step at B = 16 is bound by its node count, not its arithmetic (thousands of
kernels of about 2 us each, PERF.md section 5), so S sequential runs pay that
S times.  ``fit_population(cfg, seeds)`` trains the S runs as one program:
the parameters, the optimizer state and the EMA carry a leading lane axis,
and ``torch.func.vmap`` maps the per-lane objective over it, so every kernel
of a step runs once for all S lanes (``fused_gat`` through its vmap rule: one
lane-batched launch of ``csrc/gat.cu``).  Each lane is its sequential run:

- lane s starts from the parameters ``fit`` draws for ``seed_s``;
- it takes that run's draws, ``train.step_draws(model, seed_s, step, ...)``;
- it gathers that run's batches from the shared resident window set, the
  ``(seed_s, epoch)`` permutation streams zipped into (M, S, B) chunks;
- the optimizer is the sequential one with the clip's norm taken per lane
  (``train.Optimizer(lanes=True)``); the schedule, Adam and the EMA are
  elementwise.

A step is the vmapped objective through ``torch.func.functional_call`` on
the stacked parameters, then one ordinary ``.backward()`` of the summed lane
losses (the lanes share nothing, so each gets its own gradient), then the
lane optimizer and the EMA.  ``steps_per_dispatch`` M > 1 replays one
captured population step M times on the card, as ``make_multi_train_step``.

Remat: the lanes run without ``torch.utils.checkpoint``, which cannot run
inside ``vmap`` (under ``torch.func.grad`` it "does not yet support saved
tensor hooks", and a vmapped forward followed by ``.backward()`` lets a
tensor escape the transform).  The population builds its model with
``remat=False``: recomputation changes memory, not values, so each lane
still follows its remat run within rounding; the checkpoints record the
configuration as given.

Scope, as in the JAX package: resident ingest only (``stream`` raises);
``data_parallel`` composes (each rank takes its rows of every lane's batch
and the lane gradients are summed across the mesh); periodic eval is
skipped and a final per-seed ``evaluate`` runs; periodic checkpoints go to
``{out_dir}/s{seed}/checkpoint.npz`` (and ``checkpoint_ema.npz``) with each
lane's optimizer state, the layout of sequential ``train --seeds`` runs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmtraj_torch.config import Config
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.pipeline import DeviceDataset
from mmtraj_torch.data.registry import load_split
from mmtraj_torch.data.transforms import NormStats, augment_windows, compute_norm_stats
from mmtraj_torch.evaluate import _device_stats, evaluate
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.parallel.mesh import all_reduce_sum, is_writer, shard_batch
from mmtraj_torch.params import save_npz
from mmtraj_torch.train import (Optimizer, StepDraws, TrainResult, _GraphedStep, data_mesh,
                                index_stream, objective, replays_graph, run_chunk, shard_draws,
                                step_draws)
from mmtraj_torch.utils.logging import MetricsLogger


class _LaneObjective(nn.Module):
    """The training objective of ``model`` as a module's forward, so that
    ``torch.func.functional_call`` runs it on one lane's parameters."""

    def __init__(self, model: Forecaster, stats: NormStats, loss_mode: str, variety_n: int,
                 variety_weight: float, variety_fde_weight: float):
        super().__init__()
        self.model = model
        self.stats = stats
        self.kw = dict(loss_mode=loss_mode, variety_n=variety_n, variety_weight=variety_weight,
                       variety_fde_weight=variety_fde_weight)

    def forward(self, xy, mask, draws: StepDraws, agents=None):
        if draws.theta is not None:
            xy = augment_windows(xy, mask, draws.theta, draws.det)
        return objective(self.model, xy, mask, self.stats, draws, agents=agents, **self.kw)


def lane_model(cfg: Config, device="cuda") -> Forecaster:
    """The population's template model: ``cfg.model`` without remat (see the
    module's docstring), its own parameters never trained."""
    return Forecaster(dataclasses.replace(cfg.model, remat=False), cfg.data.obs_len,
                      cfg.data.pred_len, device=device,
                      generator=torch.Generator().manual_seed(0))


def stack_lanes(states: Sequence[Dict[str, torch.Tensor]], device) -> Dict[str, torch.Tensor]:
    """Per-lane states -> {name: (S, ...) leaf tensor that requires grad}."""
    return {k: torch.stack([torch.as_tensor(s[k], dtype=torch.float32) for s in states])
            .to(device).requires_grad_() for k in states[0]}


def _stack_draws(draws: List[StepDraws]) -> StepDraws:
    first = draws[0]
    return StepDraws(
        *(None if t is None else torch.stack([getattr(d, f) for d in draws])
          for f, t in (("theta", first.theta), ("det", first.det))),
        None if first.drop is None else tuple(
            {k: torch.stack([d.drop[i][k] for d in draws]) for k in first.drop[i]}
            for i in range(2)),
        None if first.stream is None else tuple(
            torch.stack([d.stream[i] for d in draws]) for i in range(2)))


def _lane_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of every lane's batch: (S, B, ...) -> (S, B / W, ...)."""
    return shard_batch(t.transpose(0, 1), mesh).transpose(0, 1)


def make_population_step(model: Forecaster, params: Dict[str, torch.Tensor],
                         optimizer: Optimizer, stats: NormStats, seeds: Sequence[int],
                         ema: Optional[Dict[str, torch.Tensor]] = None, ema_decay: float = 0.0,
                         augment_rotate: bool = False, augment_flip: bool = False,
                         loss_mode: str = "nll", variety_n: int = 8, variety_weight: float = 1.0,
                         variety_fde_weight: float = 0.0, mesh=None):
    """The population step (``mmtraj/population.py:85``) -> ``pop(xy_all,
    mask_all, idx_chunk, step_ids)``: the resident window set, an (M, S, B)
    chunk of per-lane batch indices and the M step ids -> the (M, S) lane
    losses (a device tensor).

    ``model`` is the template (``lane_model``); ``params`` the stacked lane
    parameters (``stack_lanes``), which it trains in place with
    ``optimizer`` (``Optimizer(params, cfg, lanes=True)``) and moves ``ema``
    (stacked like ``params``) after each update.  Lane s draws
    ``step_draws`` of ``seeds[s]``.  On the CPU, and under
    ``enable_nan_debugging``, the steps run eagerly; otherwise on CUDA a chunk of M > 1 steps replays one captured step M times
    (``pop.capture_launches`` holds the capture's kernel launches).

    With a ``mesh`` every rank passes the same indices and takes its rows of
    every lane's batch; lane s's loss is its rows' numerator over its whole
    batch's valid agents, and the lane gradients and losses are summed
    across the mesh."""
    if loss_mode not in ("nll", "variety", "hybrid"):
        raise ValueError(f"unknown loss mode {loss_mode!r}")
    if model.cfg.remat:
        raise ValueError("a population runs without remat (torch.utils.checkpoint cannot run "
                         "inside torch.func.vmap); build its model with lane_model")
    seeds = [int(s) for s in seeds]
    n_var = variety_n if loss_mode != "nll" else 0
    names = list(params)
    stacked = [params[k] for k in names]
    ema_list = [ema[k] for k in names] if ema is not None and ema_decay > 0 else []
    d = float(ema_decay)
    lane_obj = _LaneObjective(model, _device_stats(stats, model.device), loss_mode, variety_n,
                              variety_weight, variety_fde_weight)

    def lane_loss(p, xy, mask, draws, agents):
        return torch.func.functional_call(lane_obj, {f"model.{k}": v for k, v in p.items()},
                                          (xy, mask, draws, agents))

    def draw(step_idx: int, B: int, N: int) -> StepDraws:
        """Every lane's draws for its whole batch of B, stacked; with a mesh
        this rank's rows of each."""
        per = [step_draws(model, s, step_idx, B, N, augment_rotate, augment_flip, n_var)
               for s in seeds]
        if mesh is not None:
            per = [shard_draws(x, mesh, n_var) for x in per]
        return _stack_draws(per)

    def core(xy, mask, draws: StepDraws) -> torch.Tensor:
        agents = None
        if mesh is not None:
            agents = mask.flatten(1).sum(1).to(torch.float32)
            xy, mask = _lane_rows(xy, mesh), _lane_rows(mask, mesh)
        for p in stacked:
            p.grad = None
        p = dict(zip(names, stacked))

        def one_lane(p_, x, m, ts, n):  # vmap takes tensors, not the draws' Nones
            return lane_loss(p_, x, m, draws.with_tensors(ts), n)

        losses = torch.func.vmap(one_lane, in_dims=(0, 0, 0, 0, None if agents is None else 0))(
            p, xy, mask, draws.tensors(), agents)
        losses.sum().backward()
        losses = losses.detach()
        if mesh is not None:
            losses = losses.clone()
            all_reduce_sum([t.grad for t in stacked] + [losses], mesh)
        optimizer.step()
        if ema_list:
            with torch.no_grad():
                torch._foreach_mul_(ema_list, d)
                torch._foreach_add_(ema_list, torch._foreach_mul(stacked, 1.0 - d))
        return losses

    state = stacked + optimizer.state() + ema_list
    graphed: List[_GraphedStep] = []
    capture_launches: Dict[str, int] = {}
    said: list = []

    def pop(xy_all, mask_all, idx_chunk, step_ids: Sequence[int]) -> torch.Tensor:
        idx_chunk = np.asarray(idx_chunk, np.int64)
        step_ids = [int(s) for s in step_ids]
        M, S, B = idx_chunk.shape
        if S != len(seeds):
            raise ValueError(f"an index chunk of {S} lanes for {len(seeds)} seeds")
        if len(step_ids) != M:
            raise ValueError(f"{len(step_ids)} step ids for an index chunk of {M} steps")
        N = mask_all.shape[1]
        if M == 1 or not replays_graph(model.device, said):
            losses = []
            for idx, s in zip(torch.from_numpy(idx_chunk), step_ids):
                idx = idx.to(model.device)
                losses.append(core(xy_all[idx], mask_all[idx], draw(s, B, N)))
            return torch.stack(losses)

        def make():
            g = _GraphedStep(core, draw(step_ids[0], B, N), state, stacked, xy_all, mask_all,
                             (S, B))
            capture_launches.clear()
            capture_launches.update(g.launches)
            return g

        return run_chunk(graphed, make, model, stacked, xy_all, mask_all, idx_chunk, step_ids,
                         lambda s: draw(s, B, N))

    pop.capture_launches = capture_launches
    return pop


def fit_population(cfg: Config, seeds: Sequence[int], data_dir: Optional[str] = None,
                   out_dirs: Optional[Sequence[str]] = None,
                   logger: Optional[MetricsLogger] = None, device="cuda",
                   mesh=None) -> List[TrainResult]:
    """Train ``len(seeds)`` runs of ``cfg`` that differ only in their seed
    as one population (``mmtraj/population.py:166``) -> a ``TrainResult``
    a seed, in order.  ``out_dirs`` overrides the per-seed checkpoint
    directories (default ``{cfg.train.out_dir}/s{seed}``, the sequential
    ``train --seeds`` layout); each seed's checkpoint records a config whose
    ``train.seed``/``train.out_dir`` are that seed's."""
    seeds = [int(s) for s in seeds]
    if len(seeds) != len(set(seeds)):
        raise ValueError(f"duplicate seeds in population: {seeds}")
    if cfg.train.stream:
        raise ValueError("population training requires resident ingest (stream=False): each "
                         "lane gathers its batches on the device from the resident window set")
    mesh = data_mesh(cfg, mesh, device)
    writer = is_writer(mesh)
    if out_dirs is None:
        base = cfg.train.out_dir
        out_dirs = [os.path.join(base, f"s{s}") if base else None for s in seeds]
    if len(out_dirs) != len(seeds):
        raise ValueError("out_dirs must align with seeds")

    data_dir = data_dir or cfg.data.data_dir
    t_setup = time.time()
    train_w, test_w = load_split(data_dir, cfg.data.scene, cfg.data.obs_len, cfg.data.pred_len,
                                 cfg.data.stride, cfg.data.min_agents)
    if not train_w:
        raise RuntimeError(f"no training windows found under {data_dir!r}")
    stats = compute_norm_stats(train_w, cfg.data.obs_len)
    train_ds = WindowDataset(train_w, cfg.data.n_max)
    test_ds = WindowDataset(test_w, cfg.data.n_max) if test_w else None

    model = lane_model(cfg, device)
    device_ds = DeviceDataset(train_ds, model.device)
    S = len(seeds)
    # Lane s starts where the sequential fit of seeds[s] starts.
    inits = [Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device="cpu",
                        generator=torch.Generator().manual_seed(s)).state_dict() for s in seeds]
    params = stack_lanes(inits, model.device)
    optimizer = Optimizer(params, cfg, lanes=True)
    ema_decay = cfg.train.ema_decay
    ema = ({k: v.detach().clone() for k, v in params.items()} if ema_decay > 0 else None)
    pop = make_population_step(
        model, params, optimizer, stats, seeds, ema, ema_decay,
        augment_rotate=cfg.train.augment_rotate, augment_flip=cfg.train.augment_flip,
        loss_mode=cfg.train.loss, variety_n=cfg.train.variety_n,
        variety_weight=cfg.train.variety_weight,
        variety_fde_weight=cfg.train.variety_fde_weight, mesh=mesh)

    logger = logger or MetricsLogger(cfg.train.out_dir if writer else None, quiet=not writer)
    logger.log(0, event="setup", population=S, seeds=seeds, train_windows=len(train_ds),
               test_windows=len(test_ds) if test_ds else 0, dropped_agents=train_ds.n_dropped,
               params=sum(p.numel() for p in params.values()),
               devices=mesh.size() if mesh is not None else 1, device=str(model.device),
               setup_s=round(time.time() - t_setup, 2))

    # Each lane's index stream is the sequential run's (seed, epoch)
    # permutation stream; they advance in lockstep.
    streams = [index_stream(device_ds, cfg.train.batch_size, s) for s in seeds]
    spd = max(1, cfg.train.steps_per_dispatch)
    ckpt_every = cfg.train.ckpt_every
    history: list = [[] for _ in seeds]
    step = 0
    t_train = time.time()

    def lane_cfg(seed: int, out: Optional[str]) -> Config:
        return cfg.replace(train=dataclasses.replace(cfg.train, seed=seed,
                                                     out_dir=out or cfg.train.out_dir))

    def save_all(at_step: int, final: bool = False) -> None:
        if not writer:
            return
        for i, (seed, out) in enumerate(zip(seeds, out_dirs)):
            if not out:
                continue
            cfg_s = lane_cfg(seed, out)
            save_npz(os.path.join(out, "checkpoint.npz"), _lane(params, i), stats, cfg_s,
                     at_step, optimizer.state_leaves(i))
            if ema is not None:
                save_npz(os.path.join(out, "checkpoint_ema.npz"), _lane(ema, i), stats, cfg_s,
                         at_step)
        logger.log(at_step, event="checkpoint", population=S, **({"final": True} if final else {}))

    def next_boundary(s: int) -> int:
        b = cfg.train.steps
        if ckpt_every > 0:
            b = min(b, (s // ckpt_every + 1) * ckpt_every)
        return b

    while step < cfg.train.steps:
        m = min(spd, next_boundary(step) - step)
        idx_chunk = np.stack([np.stack([next(st) for st in streams]) for _ in range(m)])
        losses = pop(device_ds.xy, device_ds.mask, idx_chunk, range(step, step + m))
        to_log = [t for t in range(step + 1, step + m + 1)
                  if t % cfg.train.log_every == 0 or t == 1]
        if to_log:
            lv = losses.cpu().numpy()  # (m, S)
            for t in to_log:
                row = lv[t - step - 1]
                for i in range(S):
                    history[i].append((t, float(row[i])))
                sps = t / max(time.time() - t_train, 1e-9)
                logger.log(t, loss=float(row.mean()),
                           loss_per_seed=[round(float(x), 4) for x in row],
                           steps_per_sec=round(sps, 2))
        step += m
        if ckpt_every > 0 and step % ckpt_every == 0 and step < cfg.train.steps:
            save_all(step)

    save_all(step, final=True)

    results = []
    for i, (seed, out) in enumerate(zip(seeds, out_dirs)):
        state = _lane(ema if ema is not None else params, i)
        eval_metrics: Dict[str, float] = {}
        if test_ds is not None:
            member = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len,
                                device=model.device, state=state)
            eval_metrics = evaluate(member, stats, test_ds, cfg.train.k_samples,
                                    batch_size=min(cfg.train.batch_size, 64), seed=seed,
                                    mesh=mesh)
            logger.log(step, seed=seed, **{f"eval_{k}": v for k, v in eval_metrics.items()})
        results.append(TrainResult(state, stats, lane_cfg(seed, out), history[i], eval_metrics))
    return results


def _lane(stacked: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Lane ``i``'s parameters, detached copies."""
    return {k: v[i].detach().clone() for k, v in stacked.items()}

