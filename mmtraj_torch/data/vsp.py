"""UCY ``.vsp`` spline-annotation ingestion -> canonical annotation rows
(counterpart of ``mmtraj/data/vsp.py``).

The raw UCY crowds-by-example distribution (univ/zara scenes) ships
per-scene ``.vsp`` files: per-pedestrian SPLINE CONTROL POINTS in pixel
coordinates (720x576 video, origin at the frame center), not per-frame
world-meter rows.  Layout::

    <n_splines> - the number of splines
    <n_points> - the number of way points
    x_px y_px frame_id gaze_deg
    ...                       (n_points rows)
    <n_points> - ...          (next pedestrian)

Everything after a leading numeric token on a header line is commentary and
ignored.  The canonical format everywhere else (``data/parser.py``, the
registry) is 4 columns ``frame_id ped_id x y`` in world meters at a fixed
frame step (every 10th video frame = 0.4 s).  Conversion therefore:

1. linearly interpolate each pedestrian's control points onto the
   ``frame_step`` grid between its first and last annotated frames;
2. map pixels to meters through a 3x3 homography H acting on homogeneous
   [x_px, y_px, 1] (the UCY scenes' H matrices ship separately, e.g. in the
   OpenTraj collection, as plain 3x3 text files); without one, a
   meters-per-pixel scale gives an axis-aligned approximation.

``python -m mmtraj_torch.cli import-vsp`` runs it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def parse_vsp(path: str) -> List[np.ndarray]:
    """Read a .vsp -> one (n_points, 3) array [x_px, y_px, frame] per ped.

    Tolerates commentary after the numeric token on count lines and blank
    lines; raises ValueError on truncated files (point count promised but
    rows missing)."""
    toks: List[List[str]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                toks.append(parts)
    if not toks:
        raise ValueError(f"{path}: empty .vsp file")
    pos = 0

    def take_count() -> int:
        nonlocal pos
        try:
            n = int(float(toks[pos][0]))
        except (IndexError, ValueError) as e:
            raise ValueError(f"{path}: expected a count line at row {pos}") from e
        pos += 1
        return n

    n_splines = take_count()
    peds: List[np.ndarray] = []
    for _ in range(n_splines):
        n_pts = take_count()
        if pos + n_pts > len(toks):
            raise ValueError(
                f"{path}: truncated spline (promised {n_pts} points, "
                f"{len(toks) - pos} rows left)"
            )
        try:
            rows = np.array(
                [[float(t[0]), float(t[1]), float(t[2])]
                 for t in toks[pos : pos + n_pts]],
                dtype=np.float64,
            )
        except (IndexError, ValueError) as e:
            raise ValueError(
                f"{path}: malformed control-point row near data row {pos} "
                "(expected 'x y frame ...')"
            ) from e
        pos += n_pts
        peds.append(rows)
    return peds


def interpolate_track(points: np.ndarray, frame_step: int = 10) -> np.ndarray:
    """Control points (n, 3) [x, y, frame] -> rows (m, 3) on the frame grid.

    Samples at multiples of ``frame_step`` within [first, last] control
    frame (inclusive of the grid points actually covered), interpolating x/y
    linearly in frame time — the per-segment-linear reading of the UCY
    splines used across this repo family.  Control points are sorted by
    frame first (files store them in drawing order)."""
    pts = points[np.argsort(points[:, 2], kind="stable")]
    f0, f1 = pts[0, 2], pts[-1, 2]
    start = int(np.ceil(f0 / frame_step)) * frame_step
    grid = np.arange(start, f1 + 1e-9, frame_step, dtype=np.float64)
    if grid.size == 0:
        return np.zeros((0, 3))
    x = np.interp(grid, pts[:, 2], pts[:, 0])
    y = np.interp(grid, pts[:, 2], pts[:, 1])
    return np.stack([x, y, grid], axis=1)


def apply_homography(H: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Projective map: (n, 2) pixel points through a 3x3 H -> (n, 2) meters."""
    H = np.asarray(H, dtype=np.float64)
    if H.shape != (3, 3):
        raise ValueError(f"homography must be 3x3, got {H.shape}")
    homog = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)  # (n, 3)
    out = homog @ H.T
    return out[:, :2] / out[:, 2:3]


def convert_vsp(
    src: str,
    dst: str,
    homography: Optional[np.ndarray] = None,
    scale: Optional[float] = None,
    frame_step: int = 10,
) -> int:
    """UCY .vsp -> canonical 4-column annotation txt; returns rows written.

    Exactly one of ``homography`` (3x3 pixel->meter projective map) or
    ``scale`` (meters per pixel, axis-aligned approximation) must be given.
    Output loads with mmtraj_torch.data.parser.read_annotation_file and therefore
    with the whole registry/windower stack (same contract as obsmat.py).
    """
    if (homography is None) == (scale is None):
        raise ValueError("pass exactly one of homography= or scale=")
    rows = []
    for ped_id, pts in enumerate(parse_vsp(src)):
        interp = interpolate_track(pts, frame_step)
        if interp.shape[0] == 0:
            continue
        if homography is not None:
            xy = apply_homography(homography, interp[:, :2])
        else:
            xy = interp[:, :2] * float(scale)
        for (x, y), frame in zip(xy, interp[:, 2]):
            rows.append((frame, float(ped_id), x, y))
    if not rows:  # e.g. every track spans fewer frames than frame_step
        np.savetxt(dst, np.empty((0, 4)), fmt="%.6f")
        return 0
    arr = np.asarray(rows, dtype=np.float64)
    # Canonical files are frame-major like the processed distributions.
    arr = arr[np.lexsort((arr[:, 1], arr[:, 0]))]
    np.savetxt(dst, arr, fmt="%.6f")
    return arr.shape[0]
