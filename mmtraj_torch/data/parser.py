"""ETH/UCY annotation-file parsing on the host, in numpy (counterpart of
``mmtraj/data/parser.py``).

Rows are ``frame_id ped_id x y``, separated by whitespace, tabs or commas:
world coordinates in meters, one row per (frame, pedestrian), frames every
0.4 s.  The native C++ parser (``data/native.py``), which the registry reads
with, gives the same output as this numpy one.
"""

from __future__ import annotations

import re

import numpy as np

# The leading numeric prefix of a token, as strtod accepts it before any
# trailing junk.
_NUM = re.compile(r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")


def _read_tolerant(path: str) -> np.ndarray:
    """Line-by-line parse: blank lines and '#'/'%' comment lines skipped;
    numbers separated by whitespace or commas; a line stops at its first
    non-numeric token; every data line must give >= 4 numbers (else
    ValueError naming the line); the first 4 are kept."""
    rows = []
    with open(path, "r") as f:
        for line_no, line in enumerate(f, 1):
            q = line.strip()
            if not q or q[0] in "#%":
                continue
            vals = []
            for tok in q.replace(",", " ").split():
                m = _NUM.match(tok)
                if m is None:
                    break
                vals.append(float(m.group()))
                if m.end() < len(tok):  # trailing junk glued to the number
                    break
            if len(vals) < 4:
                raise ValueError(
                    f"{path}: malformed line {line_no} (expected >=4 numeric columns)"
                )
            rows.append(vals[:4])
    if not rows:
        return np.zeros((0, 4), dtype=np.float64)
    return np.asarray(rows, dtype=np.float64)


def read_annotation_file(path: str) -> np.ndarray:
    """One annotation file -> float64 array (R, 4): frame_id, ped_id, x, y.

    ``np.loadtxt`` reads the clean format; anything it rejects (comments,
    commas, trailing junk) goes through the tolerant scanner."""
    try:
        rows = np.loadtxt(path, dtype=np.float64, ndmin=2)
    except ValueError:
        rows = _read_tolerant(path)
    if rows.size == 0:
        return np.zeros((0, 4), dtype=np.float64)
    if rows.shape[1] < 4:
        raise ValueError(f"{path}: expected >=4 columns (frame ped x y), got {rows.shape[1]}")
    return np.ascontiguousarray(rows[:, :4])


def scene_arrays(rows: np.ndarray):
    """One scene's rows -> fixed-shape per-pedestrian arrays:
    positions (P, F, 2) float32 (garbage where absent), presence (P, F) bool,
    frames (F,) and peds (P,) float64, the sorted unique raw ids."""
    if rows.shape[0] == 0:
        return (
            np.zeros((0, 0, 2), np.float32),
            np.zeros((0, 0), bool),
            np.zeros((0,), np.float64),
            np.zeros((0,), np.float64),
        )
    frames, f_idx = np.unique(rows[:, 0], return_inverse=True)
    peds, p_idx = np.unique(rows[:, 1], return_inverse=True)
    P, F = len(peds), len(frames)
    positions = np.zeros((P, F, 2), dtype=np.float32)
    presence = np.zeros((P, F), dtype=bool)
    positions[p_idx, f_idx] = rows[:, 2:4].astype(np.float32)
    presence[p_idx, f_idx] = True
    return positions, presence, frames, peds
