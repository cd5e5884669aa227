"""BIWI/ETH ``obsmat`` ingestion -> canonical annotation rows (counterpart of
``mmtraj/data/obsmat.py``).

The raw ETH walking/hotel distribution (BIWI) ships per-scene ``obsmat.txt``
(or MATLAB ``obsmat.mat``) with 8 columns per observation::

    frame_number  pedestrian_ID  pos_x  pos_z  pos_y  v_x  v_z  v_y

where ``pos_z`` is the (unused) height axis and positions are already in
world meters.  The canonical format everywhere else (``data/parser.py``, the
registry) is 4 columns ``frame_id ped_id x y``; this module converts the
former to the latter, so the raw ETH distribution drops in.  Frame numbers
are kept verbatim: the windower indexes sorted *unique* frames
(``data/windower.py``), so raw video frame ids need no renumbering.
"""

from __future__ import annotations

import numpy as np


def read_obsmat(path: str) -> np.ndarray:
    """Read a BIWI obsmat (.txt or .mat) -> canonical rows (R, 4) float64.

    Columns out: ``frame_id, ped_id, x, y`` (meters).  Raises ValueError on
    a matrix without the 8 obsmat columns.
    """
    if path.endswith(".mat"):
        from scipy.io import loadmat

        data = loadmat(path)
        cands = [
            v for k, v in data.items()
            if not k.startswith("__")
            and isinstance(v, np.ndarray) and v.ndim == 2 and v.shape[1] == 8
        ]
        if not cands:
            raise ValueError(
                f"{path}: no 8-column obsmat matrix found "
                f"(keys: {[k for k in data if not k.startswith('__')]})"
            )
        arr = np.asarray(cands[0], dtype=np.float64)
    else:
        arr = np.loadtxt(path, dtype=np.float64, ndmin=2)
        if arr.shape[1] != 8:
            raise ValueError(
                f"{path}: expected 8 obsmat columns "
                f"[frame id x z y vx vz vy], got {arr.shape[1]}"
            )
    # pos_x is column 2, pos_y is column 4 (column 3 is the height axis).
    return arr[:, [0, 1, 2, 4]]


def convert_obsmat(src: str, dst: str) -> int:
    """obsmat file -> canonical whitespace-separated annotation txt.

    Returns the number of rows written.  The output loads with
    mmtraj_torch.data.parser.read_annotation_file and therefore with the whole
    registry/windower stack.
    """
    rows = read_obsmat(src)
    np.savetxt(dst, rows, fmt="%.6f")
    return rows.shape[0]
