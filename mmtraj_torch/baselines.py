"""Closed-form trajectory baselines: constant velocity and zero velocity
(counterpart of ``mmtraj/baselines.py``; numpy on the host, no device, no
random numbers).

The sanity anchors of ETH/UCY evaluation: a learned model that cannot beat
constant velocity (CV) on a scene is misconfigured, and the CV row also says
how hard a dataset is.  K = 1: the one deterministic trajectory is the
best of K.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mmtraj_torch.data.collate import WindowDataset


def constant_velocity(xy_obs: np.ndarray, pred_len: int) -> np.ndarray:
    """(..., To, 2) absolute positions -> (..., Tp, 2) CV extrapolation of
    the last observed per-frame offset (one frame of velocity, not a fit)."""
    v = xy_obs[..., -1, :] - xy_obs[..., -2, :]  # (..., 2)
    steps = np.arange(1, pred_len + 1, dtype=xy_obs.dtype)
    return xy_obs[..., -1:, :] + steps[:, None] * v[..., None, :]


def zero_velocity(xy_obs: np.ndarray, pred_len: int) -> np.ndarray:
    """(..., To, 2) -> (..., Tp, 2): frozen at the last observed position,
    the weakest anchor."""
    last = xy_obs[..., -1:, :]
    return np.broadcast_to(last, xy_obs.shape[:-2] + (pred_len, 2)).copy()


_BASELINES = {"cv": constant_velocity, "zv": zero_velocity}


def evaluate_baseline(test_ds: WindowDataset, obs_len: int,
                      baseline: str = "cv") -> Dict[str, float]:
    """Masked ADE/FDE of a closed-form baseline over a WindowDataset, with
    ``evaluate``'s per-agent metric in world meters; k = 1 and the
    baseline's name."""
    try:
        fn = _BASELINES[baseline]
    except KeyError:
        raise ValueError(f"unknown baseline {baseline!r} (have {sorted(_BASELINES)})") from None
    xy, mask = test_ds.xy, test_ds.mask  # (W, N, T, 2), (W, N)
    obs, gt = xy[:, :, :obs_len], xy[:, :, obs_len:]
    pred = fn(obs, gt.shape[2])
    dist = np.linalg.norm(pred - gt, axis=-1)  # (W, N, Tp)
    m = mask.astype(np.float64)
    n_agents = max(m.sum(), 1.0)
    return {
        "min_ade": float((dist.mean(axis=-1) * m).sum() / n_agents),
        "min_fde": float((dist[..., -1] * m).sum() / n_agents),
        "k": 1,
        "baseline": baseline,
        "reduction": "per_agent",
        "n_windows": len(test_ds),
        "n_agents": int(n_agents),
        "n_dropped": int(test_ds.n_dropped),
    }
