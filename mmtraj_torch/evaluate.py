"""Best-of-K evaluation over a held-out scene (counterpart of
``mmtraj/evaluate.py``).

The test windows go to the device in fixed-shape batches (the last one padded
with all-invalid windows).  Each batch gives per-window error sums and agent
counts, which stay on the device until the end; then they are copied to the
host once and added with ``math.fsum`` in float64, so padding and batching
never move a reported number.  Every window samples from its own random
stream, seeded from (seed, ensemble member, view, window index) alone
(``window_stream``), so the metrics do not depend on batch size, batch
position or shape buckets.

Protocols, as in the JAX package: ``per_agent`` or ``per_window`` best-of-K;
``oversample`` (R = oversample*K candidates, K kept by endpoint-diverse
selection); ``tta`` orthogonal test-time views; deep ensembles of several
models (``evaluate`` with a list of same-configuration models,
``evaluate_mixed`` with any members); ``rollout="modes"`` (one trajectory
per mixture component); ``buckets`` of agent capacity.  Besides min-ADE/FDE
it reports the miss rate at 2 m, the collision rate at 0.2 m and the
teacher-forced NLL of the ground truth.  Both entry points run under
``torch.no_grad()``: the model's parameters require gradients, and an
evaluation records no autograd graph.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Dict

import numpy as np
import torch

from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.transforms import NormStats, normalize, to_relative
from mmtraj_torch.metrics import collisions, displacement_errors
from mmtraj_torch.models import gmm
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.models.sampling import diverse_select, diverse_select_joint
from mmtraj_torch.parallel.mesh import all_gather_rows, check_mesh, shard_batch


def vmem_friendly_batch(k: int, n_max: int, cap: int = 64, bytes_per_elem: int = 2,
                        vmem_budget: int = 4 * 2**20) -> int:
    """The JAX package's default eval batch: the largest B whose per-head
    attention tensor, (B*k, n_max, n_max) elements of ``bytes_per_elem``,
    fits ``vmem_budget`` (a 4 MiB window of a TPU v5e's vector memory),
    capped at ``cap``.  It was sized for a TPU and is not a measurement of
    this card; the metrics do not depend on it, only the rate does
    (``autotune_eval_batch`` measures the card's own)."""
    rows = vmem_budget // (max(n_max, 1) ** 2 * bytes_per_elem)
    return max(1, min(cap, rows // max(k, 1)))


def _model_bytes_per_elem(model: Forecaster) -> int:
    return 2 if model.cfg.dtype == "bfloat16" else 4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_stats(stats: NormStats, device: torch.device) -> NormStats:
    """The stats as float32 tensors on the device, moved once per call."""
    return NormStats(*(torch.as_tensor(a, dtype=torch.float32, device=device) for a in stats))


def autotune_eval_batch(model: Forecaster, stats: NormStats, n_max: int, k: int = 20,
                        iters: int = 20, candidates=None, verbose: bool = True) -> int:
    """Time ``rollout_k`` on the model's device at a few batch sizes around
    ``vmem_friendly_batch``'s and return the fastest in window-rollouts/s
    (windows times k a second; the JAX package's sweep prints windows a
    second under that name).

    Inputs as the JAX package makes them (numpy seed 0, random-walk
    positions, 75% of the agents valid); each candidate runs one warm-up call,
    then ``iters`` calls between two ``torch.cuda.synchronize``."""
    guess = vmem_friendly_batch(k, n_max, bytes_per_elem=_model_bytes_per_elem(model))
    if candidates is None:
        candidates = sorted({1, max(1, guess // 2), max(1, guess - 1), guess, guess + 1,
                             guess + 3, min(64, 2 * guess), 64})
    stats = _device_stats(stats, model.device)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=model.device).manual_seed(0)
    best_b, best_wps = None, -1.0
    for b in candidates:
        steps = rng.normal(size=(b, n_max, model.obs_len, 2)).astype(np.float32)
        xy_obs = torch.as_tensor(np.cumsum(steps, axis=2) * 0.4, device=model.device)
        mask = torch.as_tensor(rng.random((b, n_max)) < 0.75, device=model.device)
        try:
            model.rollout_k(xy_obs, mask, stats, k, generator=gen)
            _sync(model.device)
            t0 = time.perf_counter()
            for _ in range(iters):
                model.rollout_k(xy_obs, mask, stats, k, generator=gen)
            _sync(model.device)
            wps = b * k * iters / (time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError:
            if verbose:
                print(f"  B={b:3d}: out of device memory", flush=True)
            continue
        if verbose:
            tag = " <- vmem_friendly_batch" if b == guess else ""
            print(f"  B={b:3d}: {wps:10,.0f} window-rollouts/s{tag}", flush=True)
        if wps > best_wps:
            best_b, best_wps = b, wps
    if best_b is None:
        raise RuntimeError(
            f"autotune_eval_batch: no candidate batch succeeded ({list(candidates)}); "
            "try smaller candidates or a smaller n_max")
    if verbose:
        print(f"best eval batch on this device: {best_b} ({best_wps:,.0f} window-rollouts/s)",
              flush=True)
    return int(best_b)


def _tta_mats(tta: int):
    """The ``tta`` orthogonal view matrices: ceil(tta/2) rotations evenly
    spaced over [0, 2pi), then the same rotations followed by a y-reflection.
    View 0 is the identity."""
    n_rot = (tta + 1) // 2
    mats = []
    for t in range(tta):
        a = 2.0 * math.pi * (t % n_rot) / n_rot
        c, s = math.cos(a), math.sin(a)
        mats.append(((c, -s), (s, c)) if t < n_rot else ((c, -s), (-s, -c)))
    return mats


# -- per-window random streams ------------------------------------------------

def window_seed(seed: int, member: int, view: int, window: int) -> int:
    """The generator seed of one window's stream, a function of the tuple
    alone.  ``member`` is 0 for a single model and m + 1 for member m of an
    ensemble, ``view`` 0 for the identity view: the JAX package's chain
    fold_in(fold_in(fold_in(PRNGKey(seed), m), view), window), with the folds
    it skips written as 0."""
    entropy = [int(seed) % 2**64, int(member), int(view), int(window)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def window_stream(model: Forecaster, chain, win_idx, k: int, n: int,
                  sigma_scale: float = 1.0, draw_n: int = None):
    """One batch's rollout randomness, window by window: ``chain`` is
    (seed, member, view), ``win_idx`` the windows' indices in the dataset
    -> (gumbel (k*B, T, n, M), normal (k*B, T, n, 2)) on the model's device.
    The evaluator draws every stream through this function."""
    keys = [window_seed(*chain, int(w)) for w in win_idx]
    return model._per_window_stream(keys, k, n, sigma_scale, draw_n)


# -- one batch -----------------------------------------------------------------

def _candidates(model: Forecaster, obs, mask, stats, chain, win_idx, r: int,
                sigma_scale: float, tta: int, draw_n):
    """One model's tta*r sampled candidates, view 0 first (so [:k] is the
    identity view's joint sample set), and its identity encoder carry."""
    carry0 = model.encode(obs, mask, stats)
    outs = []
    for t in range(tta):
        obs_t, carry_t = obs, carry0
        if t > 0:
            R = torch.tensor(_tta_mats(tta)[t], dtype=torch.float32, device=obs.device)
            obs_t = obs @ R.T
            carry_t = model.encode(obs_t, mask, stats)
        stream = None
        if model.cfg.head == "gmm":
            stream = window_stream(model, chain + (t,), win_idx, r, obs.shape[1],
                                   sigma_scale, draw_n)
        pr = model.rollout_k(obs_t, mask, stats, r, carry=carry_t, stream=stream)
        outs.append(pr if t == 0 else pr @ R)  # R is orthogonal: R^-1 = R^T
    return (outs[0] if tta == 1 else torch.cat(outs)), carry0


def _teacher_nll(model: Forecaster, carry, xy, mask, stats) -> torch.Tensor:
    """Per-step NLL (B, N, Tp) of the ground-truth offsets under the
    teacher-forced mixture."""
    To = model.obs_len
    dxy_n = normalize(to_relative(xy), stats)[:, :, To:]
    return gmm.nll(model.decode_teacher(carry, xy[:, :, To:], dxy_n, mask), dxy_n)


def _batch_sums(models, xy, mask, win_idx, stats, seed: int, k: int, reduction: str,
                sigma_scale: float, rollout: str, oversample: int, tta: int, draw_n,
                pooled: bool) -> torch.Tensor:
    """One batch -> (7, B) per-window (ade, fde, miss, collision, nll sums,
    agents, has-agents) on the device.  ``pooled``: the models are an
    ensemble whose candidates pool member-major; the NLL is then the
    ensemble's predictive NLL, -logsumexp(-nll_m) + log M per step."""
    model = models[0]
    To = model.obs_len
    obs, gt = xy[:, :, :To], xy[:, :, To:]
    r = k * oversample
    nll_m = None
    if pooled:
        pools, nlls = [], []
        for i, member in enumerate(models):
            chain = (seed, 0 if len(models) == 1 else i + 1)
            preds, carry = _candidates(member, obs, mask, stats, chain, win_idx, r,
                                       sigma_scale, tta, draw_n)
            pools.append(preds)
            nlls.append(_teacher_nll(member, carry, xy, mask, stats))
        preds, nll_m = torch.cat(pools), torch.stack(nlls)
        joint_k = pools[0][:k]  # collisions score member 0's identity joint samples
    else:
        if rollout == "modes":
            carry = model.encode(obs, mask, stats)
            preds = model.rollout_modes(obs, mask, stats, carry=carry)
        else:
            preds, carry = _candidates(model, obs, mask, stats, (seed, 0), win_idx, r,
                                       sigma_scale, tta, draw_n)
        joint_k = preds[:k]  # collisions are scored on raw joint samples
    if rollout != "modes" and preds.shape[0] > k:
        preds = (diverse_select_joint(preds, mask, k) if reduction == "per_window"
                 else diverse_select(preds, k))
    ade_k, fde_k = displacement_errors(preds, gt[None])  # (K, B, N)
    m = mask.float()
    n_per_w = m.sum(dim=1)
    has = (n_per_w > 0).float()
    if reduction == "per_window":
        denom = n_per_w.clamp_min(1.0)
        ade_pw = ((ade_k * m).sum(dim=2) / denom).amin(0) * has
        fde_pw = ((fde_k * m).sum(dim=2) / denom).amin(0) * has
    else:
        ade_pw = (ade_k.amin(0) * m).sum(dim=1)
        fde_pw = (fde_k.amin(0) * m).sum(dim=1)
    miss_pw = ((fde_k.amin(0) > 2.0).float() * m).sum(dim=1)
    # Times 1/K, as the JAX package's compiled program divides by a constant.
    coll = (collisions(joint_k, mask).float() * m[None]).sum(dim=(0, 2))
    coll_pw = coll * (1.0 / joint_k.shape[0])
    if nll_m is not None:
        log_m = torch.full((), float(nll_m.shape[0]), device=nll_m.device).log()
        per_step = -torch.logsumexp(-nll_m, dim=0) + log_m
        nll_pw = (per_step.mean(dim=-1) * m).sum(dim=1)
    elif model.cfg.head == "gmm":
        nll_pw = (_teacher_nll(model, carry, xy, mask, stats).mean(dim=-1) * m).sum(dim=1)
    else:
        nll_pw = torch.zeros_like(n_per_w)
    return torch.stack([ade_pw, fde_pw, miss_pw, coll_pw, nll_pw, n_per_w, has])


# -- the window loop and the host reduction ---------------------------------------

def _run_windows(sums, batch_fn, test_ds: WindowDataset, sel, n_b: int, bs: int, device,
                 mesh=None):
    """The windows ``sel`` (dataset indices) at agent capacity ``n_b`` in
    fixed batches of ``bs``; each batch's per-window sums go onto ``sums``.
    Valid agents fill a prefix of the slots, so the first n_b slots hold
    every agent of a window routed here.  With a mesh (``bs`` a multiple of
    its size) this rank runs its rows of each batch."""
    for s in range(0, len(sel), bs):
        idx = sel[s:s + bs]
        xy, mask = test_ds.batch(idx)
        xy, mask = xy[:, :n_b], mask[:, :n_b]
        if len(idx) < bs:  # pad to the fixed shape with invalid windows
            pad = bs - len(idx)
            xy = np.concatenate([xy, np.zeros((pad,) + xy.shape[1:], xy.dtype)])
            mask = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)])
        win_idx = np.pad(np.asarray(idx, np.int64), (0, bs - len(idx)))
        if mesh is not None:
            xy, mask, win_idx = shard_batch((xy, mask, win_idx), mesh)
        sums.append(batch_fn(torch.from_numpy(np.ascontiguousarray(xy)).to(device),
                             torch.from_numpy(np.ascontiguousarray(mask)).to(device),
                             win_idx))


def _metrics(sums, reduction: str, k: int, n: int, n_dropped: int, mesh=None) -> Dict:
    """Copy the per-window sums to the host once and add them exactly.  With
    a mesh every rank's per-window sums are gathered first (every rank has
    as many), so the ``fsum`` is over all windows whatever the mesh."""
    local = torch.cat(sums, dim=1) if sums else None
    if mesh is not None and local is not None:
        local = all_gather_rows(local, mesh).transpose(0, 1).reshape(7, -1)
    per_window = local.cpu().double().numpy() if local is not None else np.zeros((7, 0))
    ade, fde, miss, coll, nll, n_agents, n_win = (math.fsum(row) for row in per_window)
    n_agents = max(n_agents, 1.0)
    # ADE/FDE divide by the reduction's population; the rest are per agent.
    primary = max(n_win, 1.0) if reduction == "per_window" else n_agents
    return {
        "min_ade": ade / primary,
        "min_fde": fde / primary,
        "miss_rate_2m": miss / n_agents,
        "collision_rate": coll / n_agents,
        "nll": nll / n_agents,
        "k": k,
        "reduction": reduction,
        "n_windows": n,
        "n_agents": int(n_agents),
        "n_dropped": n_dropped,
    }


def _round_to_mesh(bs: int, mesh) -> int:
    """``bs`` rounded up to a multiple of the mesh's ranks."""
    return bs if mesh is None else bs + (-bs) % mesh.size()


def _warn_dropped(test_ds: WindowDataset) -> int:
    n_dropped = int(getattr(test_ds, "n_dropped", 0))
    if n_dropped > 0:
        warnings.warn(
            f"evaluation dataset dropped {n_dropped} agents that exceeded "
            f"n_max={test_ds.n_max}; reported metrics cover a reduced "
            "population — raise n_max (cli: --auto-n-max) for protocol-exact numbers",
            stacklevel=3,
        )
    return n_dropped


def _check_protocol(reduction: str, oversample: int, tta: int) -> None:
    if reduction not in ("per_agent", "per_window"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if oversample < 1:
        raise ValueError(f"oversample must be >= 1, got {oversample}")
    if tta < 1:
        raise ValueError(f"tta must be >= 1, got {tta}")


@torch.no_grad()
def evaluate_mixed(members, stats: NormStats, test_ds: WindowDataset, k: int = 20,
                   batch_size: int = None, seed: int = 0, reduction: str = "per_agent",
                   sigma_scale: float = 1.0, oversample: int = 1,
                   tta: int = 1) -> Dict[str, float]:
    """Best-of-K evaluation of a deep ensemble whose members (``Forecaster``s)
    may differ in configuration, as long as each has the GMM head and all
    share the obs/pred horizon.  Every member's tta*oversample*k candidates
    pool per window and endpoint-diverse selection submits K; member m
    samples from (seed, m) and a single member from the plain protocol's
    streams, so one member reproduces ``evaluate`` exactly.  The NLL is the
    ensemble's predictive NLL."""
    members = list(members)
    if len(members) == 0:
        raise ValueError("empty ensemble")
    for model in members:
        if model.cfg.head != "gmm":
            raise ValueError("ensemble evaluation requires sampled GMM rollouts")
        if (model.obs_len, model.pred_len) != (members[0].obs_len, members[0].pred_len):
            raise ValueError("ensemble members must share the obs/pred horizon")
    _check_protocol(reduction, oversample, tta)
    if batch_size is None:
        bpe = max(_model_bytes_per_elem(m) for m in members)
        batch_size = vmem_friendly_batch(k * oversample * tta, test_ds.n_max,
                                         bytes_per_elem=bpe)
    n_dropped = _warn_dropped(test_ds)
    device = members[0].device
    dstats = _device_stats(stats, device)

    def batch_fn(xy, mask, win_idx):
        return _batch_sums(members, xy, mask, win_idx, dstats, seed, k, reduction,
                           float(sigma_scale), "sample", int(oversample), int(tta), None,
                           pooled=True)

    sums = []
    n = len(test_ds)
    _run_windows(sums, batch_fn, test_ds, np.arange(n), test_ds.n_max, batch_size, device)
    return {
        **_metrics(sums, reduction, k, n, n_dropped),
        "ensemble": len(members),
        **({"sigma_scale": float(sigma_scale)} if sigma_scale != 1.0 else {}),
        **({"oversample": int(oversample)} if oversample > 1 else {}),
        **({"tta": int(tta)} if tta > 1 else {}),
    }


@torch.no_grad()
def evaluate(model, stats: NormStats, test_ds: WindowDataset, k: int = 20,
             batch_size: int = None, seed: int = 0, mesh=None, reduction: str = "per_agent",
             sigma_scale: float = 1.0, rollout: str = "sample", oversample: int = 1,
             tta: int = 1, buckets=None) -> Dict[str, float]:
    """Best-of-K min-ADE/FDE in world meters over ``test_ds``, with the miss
    rate at 2 m, the collision rate at 0.2 m and the teacher-forced NLL.

    ``model``: a ``Forecaster``, or a list of them with one configuration
    (a deep ensemble: all candidates pool per window and endpoint-diverse
    selection submits K; the NLL is the ensemble's predictive NLL).
    ``batch_size=None`` takes ``vmem_friendly_batch``, the JAX package's
    default; the metrics do not depend on it.  ``reduction``: "per_agent"
    (min over K per agent, mean over agents) or "per_window" (one joint
    sample per window, mean over windows).  ``sigma_scale`` tempers the
    sampled normals.  ``rollout="modes"``: best-of-M over the mixture
    components.  ``oversample``/``tta``: pool R = oversample*tta*K
    candidates (tta orthogonal views) and select K.  ``buckets``: agent
    capacities, e.g. (16, 32, 64); each window runs at the smallest that
    holds its agents, with its stream drawn at the full n_max, so the
    metrics are the padded protocol's.

    ``mesh`` (``parallel.make_mesh``; every rank of it calls this alike):
    the batch size is rounded up to a multiple of the mesh's ranks (the
    default one first scaled by them, as in the JAX package), each rank runs
    its rows of every batch, with each window's stream drawn from (seed,
    window) alone, and the per-window sums are gathered across the mesh
    before the exact sum, so every rank returns ``evaluate()``'s metrics."""
    if mesh is not None:
        check_mesh(mesh)
    models = list(model) if isinstance(model, (list, tuple)) else [model]
    if len(models) == 0:
        raise ValueError("empty ensemble")
    model = models[0]
    if rollout not in ("sample", "modes"):
        raise ValueError(f"unknown rollout {rollout!r}")
    _check_protocol(reduction, oversample, tta)
    if tta > 1 and (model.cfg.head != "gmm" or rollout != "sample"):
        raise ValueError("tta requires sampled GMM rollouts")
    ensemble = len(models)
    if ensemble > 1:
        if model.cfg.head != "gmm" or rollout != "sample":
            raise ValueError("ensemble evaluation requires sampled GMM rollouts")
        if any((m.cfg, m.obs_len, m.pred_len) != (model.cfg, model.obs_len, model.pred_len)
               for m in models):
            raise ValueError("evaluate's ensemble members share one configuration; "
                             "use evaluate_mixed for members that differ")
    if sigma_scale != 1.0 and (rollout == "modes" or model.cfg.head != "gmm"):
        raise ValueError("sigma_scale applies to sampled GMM rollouts only")
    if rollout == "modes":
        if model.cfg.head != "gmm":
            raise ValueError("rollout='modes' requires the GMM head")
        if oversample > 1:
            raise ValueError("oversample applies to sampled rollouts only")
        k = model.cfg.num_mixtures
    if oversample > 1 and model.cfg.head != "gmm":
        raise ValueError("oversample requires the sampling (GMM) head")
    explicit_batch = batch_size is not None
    bpe = _model_bytes_per_elem(model)
    if batch_size is None:
        batch_size = vmem_friendly_batch(k * oversample * ensemble * tta, test_ds.n_max,
                                         bytes_per_elem=bpe) * (mesh.size() if mesh else 1)
    batch_size = _round_to_mesh(batch_size, mesh)
    n_dropped = _warn_dropped(test_ds)
    device = model.device
    dstats = _device_stats(stats, device)

    def batch_fn_at(draw_n):
        def batch_fn(xy, mask, win_idx):
            return _batch_sums(models, xy, mask, win_idx, dstats, seed, k, reduction,
                               float(sigma_scale), rollout, int(oversample), int(tta), draw_n,
                               pooled=ensemble > 1)
        return batch_fn

    sums = []
    n = len(test_ds)
    buckets_used = None
    if buckets is None:
        _run_windows(sums, batch_fn_at(None), test_ds, np.arange(n), test_ds.n_max,
                     batch_size, device, mesh)
    else:
        n_cap = test_ds.n_max
        bks = sorted({int(b) for b in buckets if 0 < int(b) <= n_cap})
        if not bks or bks[-1] != n_cap:
            bks.append(n_cap)  # the full capacity is always the last resort
        route = np.searchsorted(bks, test_ds.mask.sum(axis=1), side="left")  # smallest fit
        buckets_used = [int(b) for b in bks]
        for bi, n_b in enumerate(bks):
            sel = np.nonzero(route == bi)[0]
            if len(sel) == 0:
                continue
            bs = batch_size if explicit_batch else _round_to_mesh(vmem_friendly_batch(
                k * oversample * ensemble * tta, n_b, bytes_per_elem=bpe) * (
                    mesh.size() if mesh else 1), mesh)
            _run_windows(sums, batch_fn_at(None if n_b == n_cap else n_cap), test_ds, sel,
                         n_b, bs, device, mesh)
    return {
        **_metrics(sums, reduction, k, n, n_dropped, mesh),
        **({"sigma_scale": float(sigma_scale)} if sigma_scale != 1.0 else {}),
        **({"rollout": rollout} if rollout != "sample" else {}),
        **({"oversample": int(oversample)} if oversample > 1 else {}),
        **({"ensemble": int(ensemble)} if ensemble > 1 else {}),
        **({"tta": int(tta)} if tta > 1 else {}),
        **({"buckets": buckets_used} if buckets_used is not None else {}),
    }
