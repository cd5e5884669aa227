"""Sliding obs+pred windows over a scene (counterpart of
``mmtraj/data/windower.py``).  A window's agents are the pedestrians present
at every one of its frames."""

from __future__ import annotations

from typing import List

import numpy as np

from mmtraj_torch.data.parser import scene_arrays


def make_windows(
    rows: np.ndarray,
    obs_len: int = 8,
    pred_len: int = 12,
    stride: int = 1,
    min_agents: int = 1,
) -> List[np.ndarray]:
    """Rows (R, 4) -> list of (N_i, obs+pred, 2) float32 windows, sliding over
    the scene's sorted unique frames with ``stride``; a window with fewer than
    ``min_agents`` fully present pedestrians is skipped."""
    seq_len = obs_len + pred_len
    positions, presence, _, _ = scene_arrays(rows)
    P, F = presence.shape
    if F < seq_len or P == 0:
        return []
    # present_all[p, s]: pedestrian p is present at every frame s..s+seq_len-1.
    csum = np.concatenate(
        [np.zeros((P, 1), np.int64), np.cumsum(presence, axis=1, dtype=np.int64)], axis=1
    )
    present_all = (csum[:, seq_len:] - csum[:, :-seq_len]) == seq_len
    windows: List[np.ndarray] = []
    for s in range(0, F - seq_len + 1, stride):
        sel = present_all[:, s]
        if int(sel.sum()) < min_agents:
            continue
        windows.append(positions[sel, s : s + seq_len].copy())
    return windows
