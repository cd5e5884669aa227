"""Zarr v2 arrays, the form in which Orbax stores each leaf of a tree.

An array ``name`` is a JSON ``name/.zarray`` (shape, chunks, dtype, order,
compressor, fill value, filters, dimension separator) and one value a chunk,
``name/<i>.<j>`` (``name/0`` for a scalar; ``/`` between the indices where
the separator says so).  Every chunk holds the full chunk shape, also at the
array's edge.  ``read_array`` reads one through ``get(key) -> bytes or
None``, so the same code reads a directory of files and an OCDBT store; a
missing chunk reads as the fill value, zeros where that is null, as
tensorstore reads it.  ``write_array`` writes the one form the checkpoints
need: uncompressed, little-endian, order C, one chunk.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Callable, Optional

import numpy as np

from mmtraj_torch.orbax_io import zstd

DTYPES = {"f4", "f8", "i4", "i8", "b1"}  # kind and size; the byte order is either


def _dtype(spec) -> np.dtype:
    if not isinstance(spec, str) or len(spec) != 3 or spec[0] not in "<>|" or spec[1:] not in DTYPES:
        raise ValueError(f"zarr dtype {spec!r} is not one of {sorted(DTYPES)} in either byte order")
    return np.dtype(spec)


def read_array(get: Callable[[str], Optional[bytes]], name: str) -> np.ndarray:
    """The zarr v2 array ``name``, in native byte order."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"zarr array {name!r} has no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')!r}, expected 2")
    dtype = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    compressor = meta.get("compressor")
    if len(chunks) != len(shape) or any(c < 1 for c in chunks) or any(s < 0 for s in shape):
        raise ValueError(f"{name}: chunks {chunks} do not fit shape {shape}")
    if order not in ("C", "F") or sep not in (".", "/"):
        raise ValueError(f"{name}: order {order!r}, dimension separator {sep!r}")
    if meta.get("filters") is not None:
        raise ValueError(f"{name}: zarr filters {meta['filters']!r} are not supported")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor!r} is not supported (null or zstd)")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype.newbyteorder("="))
    nbytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = get(key)
        if data is None:
            continue
        if compressor is not None:
            try:
                data = zstd.decompress(data)
            except ValueError as e:
                raise ValueError(f"{key}: {e}") from e
        if len(data) != nbytes:
            raise ValueError(f"{key}: {len(data)} bytes, a {chunks} chunk of {dtype} holds {nbytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(l + c, s) for l, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(l, h) for l, h in zip(lo, hi))] = chunk[tuple(slice(0, h - l)
                                                                       for l, h in zip(lo, hi))]
    return out


def write_array(directory: str, name: str, arr: np.ndarray) -> None:
    """Write ``arr`` as the zarr v2 array ``directory/name``: one chunk, no
    compressor, little-endian, order C."""
    arr = np.asarray(arr)
    dtype = _dtype(arr.dtype.newbyteorder("<").str if arr.dtype.itemsize > 1 else arr.dtype.str)
    arr = np.asarray(arr, dtype=dtype, order="C")  # (ascontiguousarray makes a scalar 1-d)
    meta = {"chunks": list(arr.shape), "compressor": None,
            "dimension_separator": ".", "dtype": dtype.str, "fill_value": None, "filters": None,
            "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    path = os.path.join(directory, name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f, separators=(",", ":"), sort_keys=True)
    with open(os.path.join(path, ".".join("0" * arr.ndim) or "0"), "wb") as f:
        f.write(arr.tobytes())
