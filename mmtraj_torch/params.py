"""Parameters of the port: the JAX tree's keys and orientation, as tensors.

A *state* is a flat dict of ``.``-joined JAX keys (``"enc.embed.w"``) to
float32 tensors, every weight in the JAX ``(in, out)`` orientation.  It is
what ``Forecaster.state_dict()`` returns and ``load_state_dict`` takes, and
the layout of the JAX package's ``.pt`` export.  ``load_npz`` reads a
checkpoint written by the JAX package's ``save_npz`` (flat ``/`` keys under
``params/``, ``stats/mean|std``, ``meta/step``, ``meta/config_json``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from mmtraj_torch.config import Config, ModelConfig, config_from_json
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models import gmm
from mmtraj_torch.models.cells import cell_init
from mmtraj_torch.models.gat import gat_init
from mmtraj_torch.models.layers import dense_init

State = Dict[str, torch.Tensor]


class Checkpoint(NamedTuple):
    state: State
    stats: NormStats
    config: Config
    step: int


def not_ported(what: str, roadmap_item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mmtraj_torch yet (ROADMAP.md queue 1: {roadmap_item})")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port cannot run."""
    if cfg.encoder != "rnn":
        raise not_ported(f"encoder={cfg.encoder!r}", "the attention encoder")
    if cfg.cell != "gru":
        raise not_ported(f"cell={cfg.cell!r}", "LSTM, imported GRU biases and bf16")
    if cfg.dtype != "float32":
        raise not_ported(f"dtype={cfg.dtype!r}", "LSTM, imported GRU biases and bf16")
    if cfg.head not in ("gmm", "deterministic"):
        raise ValueError(f"unknown head {cfg.head!r}")


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def unflatten(state: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in state.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def from_jax(tree: Dict[str, Any]) -> State:
    """The JAX parameter tree with numpy leaves (``jax.tree.map(np.asarray,
    params)``) -> the port's state, copied into float32 CPU tensors."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flatten(tree).items()}


def init_params(cfg: ModelConfig, generator: torch.Generator) -> State:
    """Random parameters with the keys and shapes of the JAX package's
    ``init_params`` (glorot-normal weights, zero biases), drawn from
    ``generator`` on its device.  The draws differ from JAX's."""
    check_supported(cfg)
    E, H = cfg.embed_dim, cfg.hidden_dim
    g = generator
    enc = {"embed": dense_init(g, 2, E), "cell": cell_init(g, cfg.cell, E, H)}
    dec = {"embed": dense_init(g, 2, E), "cell": cell_init(g, cfg.cell, E, H)}
    if cfg.social:
        for coder in (enc, dec):
            for li in range(cfg.gat_layers):
                coder["gat" if li == 0 else f"gat_{li}"] = gat_init(g, H, H, cfg.num_heads)
    tree = {"enc": enc, "dec": dec, "bridge_h": dense_init(g, H, H)}
    if cfg.head == "gmm":
        tree["head"] = gmm.head_init(g, H, cfg.num_mixtures)
    else:
        tree["head"] = dense_init(g, H, 2)
    return flatten(tree)


def load_npz(path: str) -> Checkpoint:
    """Read a checkpoint written by the JAX package's ``save_npz``."""
    if not path.endswith(".npz") and not os.path.isfile(path):
        path = path + ".npz"
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    cfg = config_from_json(bytes(flat.pop("meta/config_json")).decode("utf-8"))
    step = int(flat.pop("meta/step"))
    stats = NormStats(flat.pop("stats/mean"), flat.pop("stats/std"))
    state = {k[len("params/"):].replace("/", "."): torch.from_numpy(np.array(v, np.float32))
             for k, v in flat.items() if k.startswith("params/")}
    return Checkpoint(state, stats, cfg, step)
