"""Trajectory plots: observed past, ground truth, K sampled futures
(counterpart of ``mmtraj/utils/viz.py``).

One scene window per axes: observed tracks (solid), the ground-truth future
(dashed) and the K sampled rollouts (translucent); ``python -m
mmtraj_torch.cli visualize`` writes them to a PNG.  numpy arrays in, so no
torch here; matplotlib (Agg backend) is imported only when a plot is drawn,
and is needed only where one is.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_window(
    ax,
    xy_obs: np.ndarray,  # (N, To, 2)
    xy_gt: Optional[np.ndarray],  # (N, Tp, 2) or None
    rollouts: Optional[np.ndarray],  # (K, N, Tp, 2) or None
    mask: Optional[np.ndarray] = None,  # (N,)
) -> None:
    n = xy_obs.shape[0]
    if mask is None:
        mask = np.ones(n, bool)
    cmap = _colors(n)
    for i in range(n):
        if not mask[i]:
            continue
        c = cmap[i]
        ax.plot(xy_obs[i, :, 0], xy_obs[i, :, 1], "-", color=c, lw=1.8)
        ax.plot(xy_obs[i, -1, 0], xy_obs[i, -1, 1], "o", color=c, ms=4)
        if rollouts is not None:
            for k in range(rollouts.shape[0]):
                seg = np.concatenate([xy_obs[i, -1:], rollouts[k, i]], axis=0)
                ax.plot(seg[:, 0], seg[:, 1], "-", color=c, lw=0.7, alpha=0.25)
        if xy_gt is not None:
            seg = np.concatenate([xy_obs[i, -1:], xy_gt[i]], axis=0)
            ax.plot(seg[:, 0], seg[:, 1], "--", color=c, lw=1.8)
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")


def render_predictions(
    out_path: str,
    xy: np.ndarray,  # (B, N, To+Tp, 2)
    mask: np.ndarray,  # (B, N)
    rollouts: np.ndarray,  # (K, B, N, Tp, 2)
    obs_len: int,
    max_windows: int = 6,
) -> str:
    """Grid of windows -> PNG at out_path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    b = min(xy.shape[0], max_windows)
    cols = min(b, 3)
    rows = -(-b // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 5 * rows), squeeze=False)
    for w in range(b):
        ax = axes[w // cols][w % cols]
        plot_window(
            ax,
            xy[w, :, :obs_len],
            xy[w, :, obs_len:],
            rollouts[:, w],
            mask[w],
        )
        ax.set_title(f"window {w} (N={int(mask[w].sum())})")
    for w in range(b, rows * cols):
        axes[w // cols][w % cols].axis("off")
    fig.suptitle("solid: observed  dashed: ground truth  faint: K sampled rollouts")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def _colors(n: int):
    import matplotlib.cm as cm

    return [cm.tab20(i % 20) for i in range(n)]
