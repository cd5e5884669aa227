"""ctypes bindings for the native annotation parser (counterpart of
``mmtraj/data/native.py``).

``read_annotation_file_native(path)`` is a drop-in for
``mmtraj_torch.data.parser.read_annotation_file``; the loader's front door,
``read_annotation_file_fast``, prefers it and falls back to NumPy, with a
one-line notice on stderr, where the library cannot be built or loaded (no
C++ compiler).  Both give the same output, pinned by
``tests/test_torch_native.py``.  Host code: no torch.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        from mmtraj_torch.native.build import build

        path = build()
        lib = ctypes.CDLL(path)
        lib.mmtraj_count_rows.argtypes = [ctypes.c_char_p]
        lib.mmtraj_count_rows.restype = ctypes.c_long
        lib.mmtraj_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_int,
        ]
        lib.mmtraj_parse.restype = ctypes.c_long
        _lib = lib
    except Exception as e:  # no compiler / load failure -> numpy fallback
        _load_error = str(e)
        print(f"mmtraj_torch: native parser unavailable ({e}); using NumPy fallback",
              file=sys.stderr)
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def read_annotation_file_native(path: str) -> np.ndarray:
    """Native parse -> (R, 4) float64 [frame, ped, x, y]."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native parser unavailable: {_load_error}")
    encoded = path.encode("utf-8")
    cap = lib.mmtraj_count_rows(encoded)
    if cap < 0:
        raise FileNotFoundError(f"cannot read {path!r}")
    out = np.zeros((max(cap, 1), 4), dtype=np.float64)
    rows = lib.mmtraj_parse(
        encoded, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap, 4
    )
    if rows == -1:
        raise FileNotFoundError(f"cannot read {path!r}")
    if rows < 0:  # -(line_no + 1): the offset keeps line 1 distinct from -1
        raise ValueError(
            f"{path}: malformed line {-rows - 1} (expected >=4 numeric columns)"
        )
    return out[:rows]


def read_annotation_file_fast(path: str) -> np.ndarray:
    """Native when available, NumPy otherwise, with identical output: the
    NumPy path's tolerant scanner (``parser._read_tolerant``) mirrors the
    native parser on messy files ('#'/'%' comments, commas, trailing junk,
    the per-line >=4-numbers check)."""
    if native_available():
        return read_annotation_file_native(path)
    from mmtraj_torch.data.parser import read_annotation_file

    return read_annotation_file(path)
