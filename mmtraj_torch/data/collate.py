"""Padding windows of variable agent counts to a fixed N_max with masks
(counterpart of ``mmtraj/data/collate.py``).  The arrays stay in numpy on the
host; the evaluator moves each batch to the device."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def pad_windows(
    windows: Sequence[np.ndarray], n_max: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """List of (N_i, T, 2) -> (xy (W, n_max, T, 2), mask (W, n_max), n_dropped).

    Valid agents fill a prefix of the n_max slots.  A window with more than
    n_max agents keeps the n_max closest to its centroid at the first frame;
    the overflow count is returned."""
    if not windows:
        raise ValueError("no windows to pad")
    T = windows[0].shape[1]
    W = len(windows)
    xy = np.zeros((W, n_max, T, 2), dtype=np.float32)
    mask = np.zeros((W, n_max), dtype=bool)
    dropped = 0
    for w, traj in enumerate(windows):
        n = traj.shape[0]
        if n > n_max:
            centroid = traj[:, 0].mean(axis=0)
            order = np.argsort(((traj[:, 0] - centroid) ** 2).sum(axis=1))
            traj = traj[order[:n_max]]
            dropped += n - n_max
            n = n_max
        xy[w, :n] = traj
        mask[w, :n] = True
    return xy, mask, dropped


class WindowDataset:
    """A fixed-shape window set in host memory: ``xy (W, n_max, T, 2)``,
    ``mask (W, n_max)``, ``n_dropped``."""

    def __init__(self, windows: List[np.ndarray], n_max: int):
        self.xy, self.mask, self.n_dropped = pad_windows(windows, n_max)
        self.n_windows = self.xy.shape[0]
        self.n_max = n_max
        self.seq_len = self.xy.shape[2]

    def __len__(self) -> int:
        return self.n_windows

    def batch(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.xy[idx], self.mask[idx]

    def epoch_batches(self, batch_size: int, rng: np.random.Generator):
        """Shuffled (xy, mask) batches; the last one is filled up cyclically
        from the permutation, so every batch has the same shape."""
        perm = rng.permutation(self.n_windows)
        if len(perm) == 0:
            return
        pad = (-len(perm)) % batch_size
        if pad:
            perm = np.concatenate([perm, np.resize(perm, pad)])
        for s in range(0, len(perm), batch_size):
            yield self.batch(perm[s : s + batch_size])
