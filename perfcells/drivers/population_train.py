"""A population of seeds trained as one vmapped step: the chunked step that
``mmtraj_torch.population.fit_population`` runs between its boundaries.

Set-up builds the step once (``make_population_step`` over the harness's
window set, weights and statistics), drives it through its first three steps
with the window's own call (step 0 alone, steps 1-2 as a chunk, which
captures the CUDA graph the window replays) and keeps what the check reads:
Adam's first moment after step 0, the parameters and the EMA after step 2.
The window then calls the same step on chunks of ``steps_per_dispatch``
steps until ``--seconds`` have passed, each chunk ending in a read of its
losses; ``train_windows_per_s`` is lanes x batch x steps over the time from
the window's start to the end of its last chunk.  With ``--trace 1`` one
chunk (the second) runs under the profiler.

The check: the reference follows every lane's first three steps from the
same weights, batches and seeds; each lane's loss gaps and its leaves' gaps
of the first gradient and of the parameters' and the EMA's change.  Each
quantity gives two numbers: the median over the lanes of a lane's worst
step or leaf, and the worst lane's median step or leaf.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np

from perfcells import data, traffic
from perfcells import trace as tracing
from perfcells.harness import Checks
from perfcells.reference import model as ref
from perfcells.reference import train as reftrain

TRACED_CHUNK = 1


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    import torch

    from mmtraj_torch import population as popmod
    from mmtraj_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.train import Optimizer

    cfgj, mix, hooks = spec["config"], spec["traffic"], spec["hooks"]
    mcfg, dcfg, tcfg = cfgj["model"], cfgj["data"], cfgj["train"]
    S, B, M = cfgj["population"], tcfg["batch_size"], tcfg["steps_per_dispatch"]
    obs, pred, n_max = dcfg["obs_len"], dcfg["pred_len"], dcfg["n_max"]
    dev = torch.device(device)

    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    train_w, _ = traffic.train_windows(mix, obs, pred)
    if hooks.get("max_windows"):
        train_w = train_w[:hooks["max_windows"]]
    xy_np, mask_np = data.pad(train_w, n_max)
    mean, std = data.norm_stats(train_w, obs)
    xy_all = torch.as_tensor(xy_np, device=dev)
    mask_all = torch.as_tensor(mask_np, device=dev)
    init = ref.init_params(mcfg, S, torch.Generator(device=dev).manual_seed(seed % 2**63))
    seeds = [seed * 8 + i for i in range(S)]
    phases["data_and_weights"] = time.perf_counter() - t

    cfg = Config(model=ModelConfig(**mcfg), data=DataConfig(**dcfg), train=TrainConfig(**tcfg))
    model = popmod.lane_model(cfg, dev)
    params = {k: v.clone().requires_grad_() for k, v in init.items()}
    optimizer = Optimizer(params, cfg, lanes=True)
    ema = {k: v.detach().clone() for k, v in params.items()}
    if hooks.get("fault") == "frozen":  # a step that leaves its state unchanged
        optimizer.step = lambda *a, **k: None
        ema = None
    elif hooks.get("fault") == "frozen_lane":  # the same in the last lane alone
        real_step = optimizer.step

        def step_but_last(*a, **k):
            keep = [p.detach()[-1].clone() for p in optimizer.params]
            real_step(*a, **k)
            with torch.no_grad():
                for p, v in zip(optimizer.params, keep):
                    p[-1].copy_(v)

        optimizer.step = step_but_last
    objective = popmod.objective
    if hooks.get("fault") == "half_batch":  # the mean over half of each batch
        def half(model_, xy, mask, *a, **k):
            keep = torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2
            return objective(model_, xy, mask & keep[:, None], *a, **k)

        popmod.objective = half
    try:
        pop = popmod.make_population_step(
            model, params, optimizer, NormStats(mean, std), seeds, ema, tcfg["ema_decay"],
            augment_rotate=tcfg["augment_rotate"], augment_flip=tcfg["augment_flip"],
            loss_mode=tcfg["loss"], variety_n=tcfg["variety_n"],
            variety_weight=tcfg["variety_weight"], variety_fde_weight=tcfg["variety_fde_weight"])
        batches = traffic.lane_batches(len(xy_np), S, B, seed)
        first = [next(batches) for _ in range(3)]
        t = time.perf_counter()
        losses = [pop(xy_all, mask_all, first[0][None], [0])]
        mu1 = {k: m.detach().clone() for k, m in zip(optimizer.names, optimizer.mu)}
        _sync(dev)
        phases["eager_step"] = time.perf_counter() - t
        t = time.perf_counter()
        losses.append(pop(xy_all, mask_all, np.stack(first[1:]), [1, 2]))
        after = {k: v.detach().clone() for k, v in params.items()}
        ema_after = {k: v.detach().clone() for k, v in (ema or params).items()}
        first_losses = torch.cat(losses).cpu().numpy().astype(np.float64)
        _sync(dev)
        phases["capture_and_two_steps"] = time.perf_counter() - t
        gc.collect()
        gc.freeze()  # set-up's objects out of the collector's later passes
        print(json.dumps({"setup_phases_s": phases}), file=sys.stderr, flush=True)

        # The window.
        step, chunks, untraced_s, untraced_steps, nonfinite = 3, 0, 0.0, 0, 0
        summary, chunk_s = None, []
        t0, t0_unix = time.perf_counter(), time.time()
        setup_s = t0 - t_start
        t_prev = t0
        while True:
            idx = np.stack([next(batches) for _ in range(M)])
            with tracing.traced(trace and chunks == TRACED_CHUNK) as cap:
                lv = pop(xy_all, mask_all, idx, range(step, step + M)).cpu().numpy()
            t = time.perf_counter()
            chunk_s.append(round(t - t_prev, 4))
            if cap.summary is None:
                untraced_s += t - t_prev
                untraced_steps += M
            else:
                summary = cap.summary
            t_prev = t
            nonfinite += int((~np.isfinite(lv)).sum())
            step += M
            chunks += 1
            if t - t0 >= seconds and (not trace or chunks > TRACED_CHUNK):
                break
        window_s = t_prev - t0
        print(json.dumps({"chunks_s": chunk_s, "window_t0_unix": t0_unix}), file=sys.stderr,
              flush=True)
    finally:
        popmod.objective = objective
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del pop, optimizer, model, params, ema
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    control = hooks.get("control")
    refd = reftrain.follow(init, mcfg, tcfg, dcfg, mean, std, xy_all, mask_all, first, seeds)
    if control == "tf32":  # the reference one precision down, in the program's place
        prog = reftrain.follow(init, mcfg, tcfg, dcfg, mean, std, xy_all, mask_all, first, seeds,
                               tf32=True)
        first_losses, mu1 = prog["loss"], prog["mu1"]
        after = {k: init[k] + v for k, v in prog["change"].items()}
        ema_after = {k: init[k] + v for k, v in prog["ema_change"].items()}
    # Lane s is its own run of the same code.  Each quantity is compared
    # twice: by each lane's worst step or leaf, the median over the lanes
    # (a fault in three lanes or more, in any one leaf), and by each lane's
    # median step or leaf, the worst lane (a fault in any one lane).  A
    # near-tie that rounds the other way in one sampled rollout or at one
    # kink moves one lane, most of all a few of its leaves or one step:
    # the median over lanes passes over it, and the lane's median moves
    # far less than its worst (PERF.md).
    checks = Checks(spec["cell"]["limits"])
    loss = np.abs(first_losses - refd["loss"]) / np.abs(refd["loss"])  # (steps, lanes)
    moved = reftrain.moved_leaves(refd["mu1"])
    change = {k: after[k] - init[k] for k in init}
    ema_change = {k: ema_after[k] - init[k] for k in init}
    lanes = {"loss": [(float(w), "", float(m)) for w, m in zip(loss.max(0), np.median(loss, 0))],
             "grad": reftrain.leaf_gaps(mu1, refd["mu1"]),
             "change": reftrain.leaf_gaps(change, refd["change"], moved),
             "ema": reftrain.leaf_gaps(ema_change, refd["ema_change"], moved)}
    for name, per in lanes.items():
        checks.add(f"{name}_gap", float(np.median([w for w, _, _ in per])))
        checks.add(f"{name}_lane_gap", float(max(m for _, _, m in per)))
    checks.add("nonfinite_losses", nonfinite)
    if hooks.get("witness") == "float64":  # which side double precision takes, lane by lane
        w = reftrain.follow(init, mcfg, tcfg, dcfg, mean, std, xy_all, mask_all, first, seeds,
                            dtype=torch.float64)
        wm = reftrain.moved_leaves(w["mu1"])
        for side, d in (("program", {"loss": first_losses, "mu1": mu1, "change": change,
                                     "ema_change": ema_change}), ("reference", refd)):
            print(json.dumps({"witness_float64": side,
                              "loss": (np.abs(d["loss"] - w["loss"]) / np.abs(w["loss"])).tolist(),
                              **{k: reftrain.leaf_gaps(d[k], w[k], None if k == "mu1" else wm)
                                 for k in ("mu1", "change", "ema_change")}}),
                  file=sys.stderr, flush=True)
    print(json.dumps({"per_lane": {k: [list(x) for x in v] for k, v in lanes.items()},
                      "left_out_leaves": sorted(set(init) - moved)}), file=sys.stderr, flush=True)

    steps_done = chunks * M
    return {"attempted": steps_done * S, "failed": nonfinite, "memory_peak_bytes": peak,
            "end_to_end": {"setup_s": setup_s,
                           "train_windows_per_s": S * B * steps_done / window_s},
            "checks": checks,
            "ctx": {"trace": summary, "traced_steps": M if summary else 0, "lanes": S,
                    "batch": B, "untraced_s": untraced_s, "untraced_steps": untraced_steps}}
