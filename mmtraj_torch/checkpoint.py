"""Checkpoint formats of the port and the front door that picks one
(counterpart of ``mmtraj/checkpoint.py``).

Every format holds the same four things: the parameters as the port's flat
state (``.``-joined JAX keys, float32, JAX ``(in, out)`` orientation), the
normalization stats, the config and the step.  Each is the JAX package's
own layout, so a file written by either package reads in the other:

* ``.npz``: ``params.save_npz``/``params.load_npz`` (``params/<a>/<b>``,
  ``stats/mean|std``, ``meta/step``, ``meta/config_json``); the only format
  that also carries the optimizer's state (``opt/{i}``), so the only one a
  run resumes from;
* ``.pt``/``.pth``: ``torch.save`` of ``{"state_dict": {".-keys": tensors},
  "stats": {"mean", "std"}, "config_json", "step"}``, read with
  ``weights_only=True`` (no code is unpickled);
* ``.h5``/``.hdf5``: HDF5 datasets ``params/<a>/<b>`` and ``stats/mean|std``,
  attributes ``config_json`` and ``step``.  ``h5py`` is imported only by these
  two functions: the package imports without it, and ``load`` of an ``.h5``
  without it raises ``CheckpointError``;
* an Orbax directory, the JAX package's native format (``save_orbax`` /
  ``load_orbax``): the tree ``{"params": ..., "stats": {"mean", "std"},
  "step"}`` as orbax's ``PyTreeCheckpointer`` saves it, and the config in
  ``mmtraj_config.json`` beside it.  ``load_orbax`` reads both of orbax's
  layouts, zarr arrays in an OCDBT store with zstd chunks (what the JAX
  package writes) or one directory of plain files a leaf, through
  ``mmtraj_torch.orbax_io`` and without JAX, orbax or tensorstore;
  ``save_orbax`` writes the second, which the JAX package's ``load`` reads.

Every write goes to a temporary file or directory that is renamed into
place, so a crash never leaves half a checkpoint.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, List, NoReturn, Optional

import numpy as np
import torch

from mmtraj_torch.config import Config, config_from_json
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.orbax_io.tree import read_pytree, write_pytree
from mmtraj_torch.params import (Checkpoint, State, config_to_json, from_jax, load_npz, save_npz,
                                 unflatten)

TORCH_SUFFIXES = (".pt", ".pth")
H5_SUFFIXES = (".h5", ".hdf5")


class CheckpointError(RuntimeError):
    """A checkpoint exists but could not be read; the underlying failure is
    chained as ``__cause__``."""


def _fail(path: str, fmt: str, err: Exception) -> NoReturn:
    raise CheckpointError(
        f"failed to load checkpoint {path!r} as {fmt}: {type(err).__name__}: {err}") from err


def _cpu32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32).contiguous()


def _stats_arrays(stats: NormStats):
    return np.asarray(_cpu32(stats.mean)), np.asarray(_cpu32(stats.std))


# -- torch .pt ----------------------------------------------------------------------

def save_torch(path: str, state: State, stats: NormStats, cfg: Config, step: int = 0) -> None:
    """The JAX package's ``save_torch`` layout (module docstring)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mean, std = _stats_arrays(stats)
    payload = {
        "state_dict": {k: _cpu32(v) for k, v in state.items()},
        "stats": {"mean": torch.from_numpy(mean), "std": torch.from_numpy(std)},
        "config_json": config_to_json(cfg),
        "step": int(step),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_torch(path: str) -> Checkpoint:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = {k: v.to(torch.float32) for k, v in payload["state_dict"].items()}
    stats = NormStats(np.asarray(payload["stats"]["mean"].numpy()),
                      np.asarray(payload["stats"]["std"].numpy()))
    return Checkpoint(state, stats, config_from_json(payload["config_json"]),
                      int(payload["step"]))


# -- HDF5 .h5 -----------------------------------------------------------------------

def save_h5(path: str, state: State, stats: NormStats, cfg: Config, step: int = 0) -> None:
    """The JAX package's ``save_h5`` layout (module docstring); needs h5py."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mean, std = _stats_arrays(stats)
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        for k, v in state.items():
            f.create_dataset("params/" + k.replace(".", "/"), data=np.asarray(_cpu32(v)))
        f.create_dataset("stats/mean", data=mean)
        f.create_dataset("stats/std", data=std)
        f.attrs["config_json"] = config_to_json(cfg)
        f.attrs["step"] = int(step)
    os.replace(tmp, path)


def load_h5(path: str) -> Checkpoint:
    import h5py

    flat: Dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        cfg = config_from_json(f.attrs["config_json"])
        step = int(f.attrs["step"])

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                flat[name] = obj[()]

        f.visititems(visit)
    stats = NormStats(flat.pop("stats/mean"), flat.pop("stats/std"))
    state = {k[len("params/"):].replace("/", "."): torch.from_numpy(np.array(v, np.float32))
             for k, v in flat.items() if k.startswith("params/")}
    return Checkpoint(state, stats, cfg, step)


# -- Orbax directory ------------------------------------------------------------------

CONFIG_FILE = "mmtraj_config.json"


def save_orbax(path: str, state: State, stats: NormStats, cfg: Config, step: int = 0) -> None:
    """The JAX package's ``save_orbax`` tree (module docstring) in orbax's
    layout without OCDBT, written into a temporary directory beside ``path``
    and renamed into place; an existing ``path`` is replaced, as orbax's
    ``force=True`` replaces it."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    mean, std = _stats_arrays(stats)
    leaves = {("params", *k.split(".")): np.asarray(_cpu32(v)) for k, v in state.items()}
    leaves.update({("stats", "mean"): mean, ("stats", "std"): std,
                   ("step",): np.asarray(int(step), np.int64)})
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp-", dir=parent)
    try:
        write_pytree(tmp, leaves)
        with open(os.path.join(tmp, CONFIG_FILE), "w") as f:
            f.write(config_to_json(cfg))
        if os.path.lexists(path):
            old = tempfile.mkdtemp(prefix=os.path.basename(path) + ".old-", dir=parent)
            os.replace(path, os.path.join(old, "ckpt"))
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_orbax(path: str) -> Checkpoint:
    """A checkpoint saved by either package's ``save_orbax``."""
    leaves = read_pytree(path)
    with open(os.path.join(path, CONFIG_FILE)) as f:
        cfg = config_from_json(f.read())
    params = unflatten({".".join(k[1:]): v for k, v in leaves.items() if k[0] == "params"})
    stats = NormStats(leaves[("stats", "mean")], leaves[("stats", "std")])
    return Checkpoint(from_jax(params), stats, cfg, int(leaves[("step",)]))


# -- the front door -------------------------------------------------------------------

def save(path: str, state: State, stats: NormStats, cfg: Config, step: int = 0,
         opt_leaves: Optional[List[Any]] = None) -> None:
    """Write a checkpoint; the suffix picks the format: ``.npz``, ``.pt``/``.pth``,
    ``.h5``/``.hdf5``, and an Orbax directory for any other path, as the JAX
    package's ``save`` picks it.  Only ``.npz`` carries the optimizer's leaves:
    ``opt_leaves`` with another format raises rather than write a checkpoint
    that would resume with a fresh optimizer."""
    if path.endswith(".npz"):
        save_npz(path, state, stats, cfg, step, opt_leaves)
        return
    if opt_leaves is not None:
        raise ValueError(
            f"opt_leaves (the optimizer state) are only serialized by the .npz format; {path!r} "
            "would silently drop them (save weights only with opt_leaves=None, or use .npz "
            "for a checkpoint to resume from)")
    if path.endswith(TORCH_SUFFIXES):
        save_torch(path, state, stats, cfg, step)
    elif path.endswith(H5_SUFFIXES):
        save_h5(path, state, stats, cfg, step)
    else:
        save_orbax(path, state, stats, cfg, step)


def load(path: str) -> Checkpoint:
    """Read a checkpoint of either package, the format chosen explicitly:

    * suffix ``.pt``/``.pth`` -> torch, ``.h5``/``.hdf5`` -> HDF5, ``.npz`` (or a
      bare path whose ``.npz`` exists while the path itself is not a file,
      even where it is a directory) -> npz;
    * a file without a known suffix by its first bytes: ``PK`` (a zip) -> npz,
      ``\\x89HDF`` -> HDF5, anything else a ``CheckpointError``;
    * anything else (a directory, or a path that is not a file) -> Orbax; a
      path that does not exist raises ``CheckpointError`` with the
      ``FileNotFoundError`` chained.

    A file that fails to parse raises ``CheckpointError`` naming it and the
    format, the parse error chained; nothing falls back to another format."""
    if path.endswith(TORCH_SUFFIXES):
        try:
            return load_torch(path)
        except Exception as e:
            _fail(path, "torch .pt", e)
    if path.endswith(H5_SUFFIXES):
        try:
            return load_h5(path)
        except Exception as e:
            _fail(path, "HDF5 .h5", e)
    # The implicit .npz is resolved once, and only when the bare path does not
    # exist itself: if both exist the named file wins (and is sniffed below).
    if path.endswith(".npz") or (os.path.isfile(path + ".npz") and not os.path.isfile(path)):
        resolved = path if path.endswith(".npz") else path + ".npz"
        try:
            return load_npz(resolved)
        except Exception as e:
            _fail(resolved, "numpy .npz", e)
    if os.path.isfile(path):
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic[:2] == b"PK":
            try:
                return load_npz(path)
            except Exception as e:
                _fail(path, "numpy .npz (sniffed zip magic)", e)
        if magic == b"\x89HDF":
            try:
                return load_h5(path)
            except Exception as e:
                _fail(path, "HDF5 (sniffed \\x89HDF magic)", e)
        raise CheckpointError(
            f"checkpoint file {path!r} has unrecognized magic bytes {magic!r}; expected .npz "
            "(zip), .h5 (HDF) or .pt")
    if not os.path.lexists(path):
        _fail(path, "a checkpoint file", FileNotFoundError(f"no such file or directory: {path!r}"))
    try:
        return load_orbax(path)
    except Exception as e:
        _fail(path, "Orbax directory", e)
