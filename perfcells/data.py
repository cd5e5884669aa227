"""Scene files to padded windows, in NumPy, for the benchmark.

The harness reads ``data/<set>/<scene>.txt`` itself (rows ``frame ped x y``,
meters) and hands the same arrays to the program and to the reference, so
that neither side's own data path decides what the other is judged on.  A
window is ``obs_len + pred_len`` consecutive frames of a scene; its agents
are the pedestrians present at every one of them, in the order of their ids.
Padded to ``n_max`` agents, a window with more keeps the ``n_max`` closest to
its centroid at the first frame (the protocol the forecaster is trained and
scored under).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

SCENES = ("eth", "hotel", "univ", "zara1", "zara2")


def read_scene(path: str) -> np.ndarray:
    """One annotation file -> float64 rows (R, 4): frame, ped, x, y."""
    rows = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if rows.size == 0:
        return np.zeros((0, 4))
    if rows.shape[1] < 4:
        raise ValueError(f"{path}: expected 4 columns (frame ped x y), got {rows.shape[1]}")
    return np.ascontiguousarray(rows[:, :4])


def scene_windows(rows: np.ndarray, obs_len: int, pred_len: int,
                  stride: int = 1) -> List[np.ndarray]:
    """Rows -> windows (N_i, obs_len + pred_len, 2) float32 over the sorted
    unique frames, one every ``stride`` frames; windows with no agent present
    at all of their frames are skipped."""
    seq = obs_len + pred_len
    if rows.shape[0] == 0:
        return []
    frames, f_idx = np.unique(rows[:, 0], return_inverse=True)
    peds, p_idx = np.unique(rows[:, 1], return_inverse=True)
    P, F = len(peds), len(frames)
    if F < seq:
        return []
    pos = np.zeros((P, F, 2), np.float32)
    present = np.zeros((P, F), bool)
    pos[p_idx, f_idx] = rows[:, 2:4].astype(np.float32)
    present[p_idx, f_idx] = True
    csum = np.concatenate([np.zeros((P, 1), np.int64), np.cumsum(present, 1, dtype=np.int64)], 1)
    full = (csum[:, seq:] - csum[:, :-seq]) == seq  # (P, F - seq + 1)
    out = []
    for s in range(0, F - seq + 1, stride):
        sel = full[:, s]
        if sel.any():
            out.append(pos[sel, s:s + seq].copy())
    return out


def load_windows(data_dir: str, scenes: Sequence[str], obs_len: int, pred_len: int,
                 stride: int = 1) -> Dict[str, List[np.ndarray]]:
    """{scene: its windows} for ``{data_dir}/{scene}.txt``."""
    return {s: scene_windows(read_scene(os.path.join(data_dir, f"{s}.txt")), obs_len, pred_len,
                             stride) for s in scenes}


def pad(windows: Sequence[np.ndarray], n_max: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windows -> xy (W, n_max, T, 2) float32 and mask (W, n_max) bool, valid
    agents a prefix of the slots; past ``n_max`` the closest to the centroid
    at the first frame are kept."""
    T = windows[0].shape[1]
    xy = np.zeros((len(windows), n_max, T, 2), np.float32)
    mask = np.zeros((len(windows), n_max), bool)
    for w, traj in enumerate(windows):
        if traj.shape[0] > n_max:
            c = traj[:, 0].mean(axis=0)
            traj = traj[np.argsort(((traj[:, 0] - c) ** 2).sum(axis=1), kind="stable")[:n_max]]
        xy[w, :traj.shape[0]] = traj
        mask[w, :traj.shape[0]] = True
    return xy, mask


def norm_stats(windows: Sequence[np.ndarray], obs_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and std (float32, (2,)) of the one-step offsets over the observed
    frames of ``windows``; a std under 1e-6 becomes 1."""
    d = np.concatenate([np.diff(w[:, :obs_len], axis=1).reshape(-1, 2) for w in windows])
    std = d.std(axis=0)
    std = np.where(std < 1e-6, 1.0, std)
    return d.mean(axis=0).astype(np.float32), std.astype(np.float32)
