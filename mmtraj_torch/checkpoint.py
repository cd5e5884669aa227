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
  without it raises ``CheckpointError``.

Every write goes to a temporary file that is renamed into place, so a crash
never leaves half a checkpoint.  The JAX package's native format, an Orbax
directory, is not read here (Orbax imports JAX): ``load`` of a directory
raises ``CheckpointError`` naming the JAX package's converter, ``python -m
mmtraj.cli convert --src <dir> --dst <file>.npz``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NoReturn, Optional

import numpy as np
import torch

from mmtraj_torch.config import Config, config_from_json
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.params import Checkpoint, State, config_to_json, load_npz, save_npz

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


# -- the front door -------------------------------------------------------------------

def save(path: str, state: State, stats: NormStats, cfg: Config, step: int = 0,
         opt_leaves: Optional[List[Any]] = None) -> None:
    """Write a checkpoint; the suffix picks the format: ``.npz``, ``.pt``/``.pth``
    or ``.h5``/``.hdf5``.  Only ``.npz`` carries the optimizer's leaves:
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
        raise ValueError(
            f"unknown checkpoint suffix in {path!r}: the port writes .npz, .pt/.pth or "
            ".h5/.hdf5 (an Orbax directory is the JAX package's: python -m mmtraj.cli convert)")


def load(path: str) -> Checkpoint:
    """Read a checkpoint of either package, the format chosen explicitly:

    * suffix ``.pt``/``.pth`` -> torch, ``.h5``/``.hdf5`` -> HDF5, ``.npz`` (or a
      bare path whose ``.npz`` exists while the path itself does not) -> npz;
    * a file without a known suffix by its first bytes: ``PK`` (a zip) -> npz,
      ``\\x89HDF`` -> HDF5, anything else a ``CheckpointError``;
    * a directory (an Orbax checkpoint) or a missing path -> ``CheckpointError``.

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
    if os.path.isdir(path):
        raise CheckpointError(
            f"checkpoint {path!r} is a directory, the JAX package's Orbax format, which the port "
            f"does not read; convert it with the JAX package first: python -m mmtraj.cli convert "
            f"--src {path} --dst <file>.npz")
    _fail(path, "a checkpoint file", FileNotFoundError(f"no such file or directory: {path!r}"))
