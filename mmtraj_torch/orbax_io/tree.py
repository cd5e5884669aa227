"""An Orbax checkpoint's tree of arrays, as the JAX package's
``orbax.checkpoint.PyTreeCheckpointer`` writes and restores it.

A checkpoint directory holds ``_METADATA``: JSON whose ``tree_metadata``
maps each leaf's key path, written as a Python tuple (``"('params', 'a',
'w')"``), to its ``key_metadata`` and ``value_metadata``, plus ``use_ocdbt``
and ``use_zarr3``.  Each leaf is a zarr v2 array (``zarr.py``) named by its
keys joined with ``.``: in the OCDBT store of the directory
(``use_ocdbt: true``, ``ocdbt.py``), or as a directory of plain files
(``use_ocdbt: false``), which is the layout ``write_pytree`` writes and
orbax restores.
"""

from __future__ import annotations

import ast
import json
import os
import time
from typing import Dict, Tuple

import numpy as np

from mmtraj_torch.orbax_io.ocdbt import OcdbtReader
from mmtraj_torch.orbax_io.zarr import read_array, write_array

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"
_DICT_KEY = 2  # orbax's key_type of a dict key
_ARRAY_TYPES = ("np.ndarray", "jax.Array")

Leaves = Dict[Tuple[str, ...], np.ndarray]


def _leaf_keys(path: str, entry: dict) -> Tuple[str, ...]:
    keys = ast.literal_eval(path)
    if not isinstance(keys, tuple) or not all(isinstance(k, (str, int)) for k in keys):
        raise ValueError(f"{METADATA}: leaf path {path!r} is not a tuple of keys")
    listed = tuple(k["key"] for k in entry["key_metadata"])
    if tuple(map(str, keys)) != tuple(map(str, listed)):
        raise ValueError(f"{METADATA}: leaf {path!r} lists the keys {listed!r}")
    return tuple(map(str, keys))


def read_pytree(directory: str) -> Leaves:
    """Every leaf of the checkpoint in ``directory``, by its key tuple."""
    with open(os.path.join(directory, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{directory}: zarr v3 leaves are not supported")
    if meta.get("use_ocdbt"):
        get = OcdbtReader(directory).get
    else:
        def get(key: str):
            path = os.path.join(directory, key)
            if not os.path.isfile(path):
                return None
            with open(path, "rb") as f:
                return f.read()
    leaves: Leaves = {}
    for path, entry in meta["tree_metadata"].items():
        keys = _leaf_keys(path, entry)
        value = entry.get("value_metadata", {})
        if value.get("skip_deserialize"):
            continue
        if value.get("value_type") not in _ARRAY_TYPES:
            raise ValueError(f"{METADATA}: leaf {path} is a {value.get('value_type')!r}, not an "
                             "array")
        leaves[keys] = read_array(get, ".".join(keys))
    return leaves


def write_pytree(directory: str, leaves: Leaves) -> None:
    """Write ``leaves`` into the empty or new ``directory`` in orbax's layout
    without OCDBT: ``_METADATA``, ``_CHECKPOINT_METADATA`` and one zarr
    directory a leaf."""
    os.makedirs(directory, exist_ok=True)
    tree = {}
    for keys in sorted(leaves):
        if not keys or not all(isinstance(k, str) and k and "/" not in k for k in keys):
            raise ValueError(f"leaf key {keys!r}: keys must be non-empty strings without '/'")
        tree[str(tuple(keys))] = {
            "key_metadata": [{"key": k, "key_type": _DICT_KEY} for k in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
        write_array(directory, ".".join(keys), leaves[keys])
    with open(os.path.join(directory, METADATA), "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": False, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    now = time.time_ns()
    with open(os.path.join(directory, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
                   "custom_metadata": {}}, f)
