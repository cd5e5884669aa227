"""One model trained step after step: the chunked graphed step that
``mmtraj_torch.train.fit`` runs for ``cli train`` with ``steps_per_dispatch``
M (``make_multi_train_step``: one step captured as a CUDA graph, replayed M
times a chunk).

Set-up builds the program's model from the weights that ``cli train``
seeded with ``--seed`` starts from (the reference's ``init_params``), takes step 0 eagerly (``make_train_step``), then steps 1 and 2 as chunks of
one step (the first captures the graph the window replays), and keeps what
the check reads: each step's loss, its gradient (the parameters' ``.grad``)
and the state before and after it (the parameters, Adam's moments and
count).  The window replays chunks of M steps until ``--seconds`` have
passed, each ending in a read of its losses; ``train_windows_per_s`` is
batch x steps over the time from the window's start to the end of its last
chunk.  With ``--trace 1`` one chunk (the second) runs under the profiler,
for the readers of the whole step, and after the window one eager step runs
under it with the program's spans on, for the readers of its layers
(``ctx["eager"]``: ``perfcells.launches.record``; ``ctx["attn_layer"]``: the
blocks the program counted in that step, None where it counts none).

The check: from the program's state before each of those three steps, the
reference (``perfcells/reference/attn.py``) takes the same step on the same
batch.  Each step gives the loss's relative gap and, element by element, the
worst leaf's gap (``leaf_gap``) of the gradient (the parameters' ``.grad``)
and of the step's change of the parameters (over the elements its gradient
moves, ``moved_elements``); each number is the median over the three steps.
Steps, not a run: from the same weights a run forks where Adam's first step
moves an element whose gradient float32 cannot resolve by the learning rate
in a sign that rounding picks (one element of the decoder GAT's output
projection forks a run by 30% in two steps, PERF.md §2), so each step
starts from the program's own state; the run's losses beside the
reference's are printed for the record.  The median step: a kink (a ReLU's
sign, a radius edge) within rounding of one step's state moves that step's
worst leaf, while a fault moves every step.  Faults the check has to catch
(``hooks.fault``): ``frozen`` (no update), ``half_batch`` (the loss of half
of each batch), ``no_causal`` (the program's temporal attention sees the
future), ``reversed_leaf`` (one leaf, ``REVERSED_LEAF``, steps against its
gradient: the norms of its gradient and change are the reference's).
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time

import numpy as np

from perfcells import data, launches, traffic
from perfcells import trace as tracing
from perfcells.harness import Checks
from perfcells.reference import attn as refattn

TRACED_CHUNK = 1
REVERSED_LEAF = "dec.gat.wo"


def _sees_future(p, x, num_heads, dtype=None):
    """The program's temporal attention (``attn_encoder._temporal_mhsa``)
    without its causal mask: the ``no_causal`` fault."""
    import torch

    from mmtraj_torch.models.layers import matmul

    B, N, T, H = x.shape
    dh = H // num_heads
    xin = x if dtype is None else x.to(dtype)
    q, k, v = (matmul(xin, p[w], dtype).reshape(B, N, T, num_heads, dh)
               for w in ("wq", "wk", "wv"))
    alpha = torch.softmax(torch.einsum("bnthd,bnshd->bnhts", q, k) / math.sqrt(dh), dim=-1)
    out = torch.einsum("bnhts,bnshd->bnthd", alpha, v).reshape(B, N, T, H)
    return matmul(out, p["wo"], dtype) + p["bo"]


def leaf_gap(prog: dict, refd: dict) -> tuple:
    """The worst leaf's gap, element by element: ‖prog - ref‖ over the
    larger of ‖ref‖ and the median leaf's ‖ref‖ (a leaf whose reference is
    near 0, as a GAT score vector's gradient can be, is measured against the
    median leaf's) -> (gap, leaf)."""
    norms = {k: float(v.double().norm()) for k, v in refd.items()}
    floor = max(float(np.median(list(norms.values()))), 1e-30)
    gaps = {k: float((prog[k].double() - v.double()).norm()) / max(norms[k], floor)
            for k, v in refd.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moved_elements(grad: dict, frac: float = 1e-3) -> dict:
    """{leaf: the elements whose gradient is at least ``frac`` of the median
    leaf's RMS element}.  The rest move under Adam by round-off alone: a GAT
    head whose scores all fall on one side of the LeakyReLU's kink in every
    row has a zero ``a_src`` gradient (its scores shift each row's softmax by
    a constant), and Adam turns rounding of either side into moves of its
    own."""
    rms = {k: float(v.double().norm()) / max(v.numel(), 1) ** 0.5 for k, v in grad.items()}
    floor = frac * float(np.median(list(rms.values())))
    return {k: v.abs() >= floor for k, v in grad.items()}


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    import torch

    from mmtraj_torch import train as trmod
    from mmtraj_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models import attn_encoder
    from mmtraj_torch.models.forecaster import Forecaster

    cfgj, mix, hooks = spec["config"], spec["traffic"], spec["hooks"]
    mcfg, dcfg, tcfg = cfgj["model"], cfgj["data"], cfgj["train"]
    B, M = tcfg["batch_size"], tcfg["steps_per_dispatch"]
    obs, pred, n_max = dcfg["obs_len"], dcfg["pred_len"], dcfg["n_max"]
    dev = torch.device(device)
    fault = hooks.get("fault")

    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    train_w, _ = traffic.train_windows(mix, obs, pred)
    if hooks.get("max_windows"):
        train_w = train_w[:hooks["max_windows"]]
    xy_np, mask_np = data.pad(train_w, n_max)
    mean, std = data.norm_stats(train_w, obs)
    xy_all = torch.as_tensor(xy_np, device=dev)
    mask_all = torch.as_tensor(mask_np, device=dev)
    init = {k: v.to(dev) for k, v in  # the weights ``cli train`` seeded so starts from
            refattn.init_params(mcfg, torch.Generator().manual_seed(seed % 2**63)).items()}
    phases["data_and_weights"] = time.perf_counter() - t

    cfg = Config(model=ModelConfig(**mcfg), data=DataConfig(**dcfg), train=TrainConfig(**tcfg))
    model = Forecaster(cfg.model, obs, pred, device=dev, state=init)
    optimizer = trmod.make_optimizer(cfg, model)
    if fault == "frozen":  # a step that leaves its state unchanged
        optimizer.step = lambda *a, **k: None
    elif fault == "reversed_leaf":
        leaf, adam_step = dict(model.named_parameters())[REVERSED_LEAF], optimizer.step

        def reversed_step(*a, **k):
            before = leaf.detach().clone()
            adam_step(*a, **k)
            with torch.no_grad():
                leaf.copy_(2 * before - leaf)

        optimizer.step = reversed_step
    objective, mhsa = trmod.objective, attn_encoder._temporal_mhsa
    if fault == "half_batch":  # the mean over half of each batch
        def half(model_, xy, mask, *a, **k):
            keep = torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2
            return objective(model_, xy, mask & keep[:, None], *a, **k)

        trmod.objective = half
    elif fault == "no_causal":
        attn_encoder._temporal_mhsa = _sees_future
    try:
        kw = dict(augment_rotate=tcfg["augment_rotate"], augment_flip=tcfg["augment_flip"],
                  seed=seed, loss_mode=tcfg["loss"], variety_n=tcfg["variety_n"],
                  variety_weight=tcfg["variety_weight"],
                  variety_fde_weight=tcfg["variety_fde_weight"])
        stats = NormStats(mean, std)
        step = trmod.make_train_step(model, optimizer, stats, **kw)
        multi = trmod.make_multi_train_step(model, optimizer, stats, **kw)
        batches = (b[0] for b in traffic.lane_batches(len(xy_np), 1, B, seed))
        first = [next(batches) for _ in range(3)]

        def state():  # what the program's next step starts from
            return {"params": {k: v.detach().clone() for k, v in model.named_parameters()},
                    "mu": {k: m.detach().clone() for k, m in zip(optimizer.names, optimizer.mu)},
                    "nu": {k: v.detach().clone() for k, v in zip(optimizer.names, optimizer.nu)},
                    "count": int(optimizer.count)}

        def grads():
            return {k: v.grad.detach().clone() for k, v in model.named_parameters()}

        subject = {"state": [state()], "loss": [], "grad": []}
        t = time.perf_counter()
        idx0 = torch.as_tensor(first[0], device=dev)
        subject["loss"].append(float(step(xy_all[idx0], mask_all[idx0], 0)))
        subject["grad"].append(grads())
        subject["state"].append(state())
        phases["eager_step"] = time.perf_counter() - t
        t = time.perf_counter()
        for s in (1, 2):  # the first a capture and a replay, the second a replay
            subject["loss"].append(float(multi(xy_all, mask_all, first[s][None], [s])[0]))
            subject["grad"].append(grads())
            subject["state"].append(state())
        phases["capture_and_two_steps"] = time.perf_counter() - t
        gc.collect()
        gc.freeze()  # set-up's objects out of the collector's later passes
        print(json.dumps({"setup_phases_s": phases}), file=sys.stderr, flush=True)

        # The window.
        at, chunks, untraced_s, untraced_steps, nonfinite = 3, 0, 0.0, 0, 0
        summary, chunk_s = None, []
        t0, t0_unix = time.perf_counter(), time.time()
        setup_s = t0 - t_start
        t_prev = t0
        while True:
            idx = np.stack([next(batches) for _ in range(M)])
            with tracing.traced(trace and chunks == TRACED_CHUNK) as cap:
                lv = multi(xy_all, mask_all, idx, range(at, at + M)).cpu().numpy()
            t = time.perf_counter()
            chunk_s.append(round(t - t_prev, 4))
            if cap.summary is None:
                untraced_s += t - t_prev
                untraced_steps += M
            else:
                summary = cap.summary
            t_prev = t
            nonfinite += int((~np.isfinite(lv)).sum())
            at += M
            chunks += 1
            if t - t0 >= seconds and (not trace or chunks > TRACED_CHUNK):
                break
        window_s = t_prev - t0
        print(json.dumps({"chunks_s": chunk_s, "window_t0_unix": t0_unix}), file=sys.stderr,
              flush=True)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

        # After the window: one eager step with the program's spans on.
        eager, blocks = None, None
        if trace:
            counter = getattr(attn_encoder, "attn_layer", None)
            counter = counter if hasattr(counter, "launches") else None
            before = counter.launches if counter is not None else 0
            idx = torch.as_tensor(next(batches), device=dev)
            eager = launches.record(lambda: step(xy_all[idx], mask_all[idx], at))
            blocks = counter.launches - before if counter is not None else None
            print(json.dumps({"eager_step_device_s": eager["total_s"], "attn_layer": blocks}),
                  file=sys.stderr, flush=True)
    finally:
        trmod.objective, attn_encoder._temporal_mhsa = objective, mhsa
        gc.unfreeze()

    del step, multi, optimizer, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if hooks.get("control") == "tf32":  # the reference one precision down, in the program's place
        subject = refattn.follow(init, mcfg, tcfg, dcfg, mean, std, xy_all, mask_all, first,
                                 tf32=True)
    checks = Checks(spec["cell"]["limits"])
    gaps = {"loss": [], "grad": [], "change": []}
    for s, idx in enumerate(first):
        idx = torch.as_tensor(idx, device=dev)
        before, after = subject["state"][s], subject["state"][s + 1]
        loss, grad, ref_after = refattn.train_step(before, mcfg, tcfg, obs, mean, std,
                                                   xy_all[idx], mask_all[idx])
        keep = moved_elements(grad)
        gaps["loss"].append(abs(subject["loss"][s] - loss) / abs(loss))
        gaps["grad"].append(leaf_gap(subject["grad"][s], grad))
        gaps["change"].append(leaf_gap(
            {k: (v - before["params"][k]) * keep[k] for k, v in after["params"].items()},
            {k: (v - before["params"][k]) * keep[k] for k, v in ref_after["params"].items()}))
    checks.add("loss_gap", float(np.median(gaps["loss"])))
    checks.add("grad_gap", float(np.median([g[0] for g in gaps["grad"]])))
    checks.add("change_gap", float(np.median([g[0] for g in gaps["change"]])))
    checks.add("nonfinite_losses", nonfinite)
    run = refattn.follow(init, mcfg, tcfg, dcfg, mean, std, xy_all, mask_all, first)
    print(json.dumps({"gaps_by_step": gaps, "run_losses": {"program": subject["loss"],
                                                            "reference": run["loss"]}}),
          file=sys.stderr, flush=True)

    steps_done = chunks * M
    return {"attempted": steps_done, "failed": nonfinite, "memory_peak_bytes": peak,
            "end_to_end": {"setup_s": setup_s, "train_windows_per_s": B * steps_done / window_s},
            "checks": checks,
            "ctx": {"trace": summary, "traced_steps": M if summary else 0, "batch": B,
                    "untraced_s": untraced_s, "untraced_steps": untraced_steps,
                    "eager": eager, "eager_steps": 1, "attn_layer": blocks}}
