"""Parameters of the port: the JAX tree's keys and orientation, as tensors.

A *state* is a flat dict of ``.``-joined JAX keys (``"enc.embed.w"``) to
float32 tensors, every weight in the JAX ``(in, out)`` orientation.  It is
what ``Forecaster.state_dict()`` returns and ``load_state_dict`` takes, and
the layout of the JAX package's ``.pt`` export.  ``load_npz`` reads a
checkpoint written by the JAX package's ``save_npz`` (flat ``/`` keys under
``params/``, ``stats/mean|std``, ``meta/step``, ``meta/config_json``), and
``save_npz`` writes that layout, which the JAX package's ``load_npz`` reads.
The optimizer state travels as ``opt/{i}`` leaves in optax's flatten order
(``train.Optimizer.state_leaves``), so a run of either package resumes in the
other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, NamedTuple, Optional

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
    opt_leaves: Optional[List[np.ndarray]] = None  # optax's flatten order; None if absent


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a configuration that does not exist (an
    unknown encoder, cell, dtype or head)."""
    if cfg.encoder not in ("rnn", "attn"):
        raise ValueError(f"unknown encoder {cfg.encoder!r}; choose 'rnn' or 'attn'")
    if cfg.cell not in ("gru", "lstm"):
        raise ValueError(f"unknown cell {cfg.cell!r}; choose 'gru' or 'lstm'")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown dtype {cfg.dtype!r}; choose 'float32' or 'bfloat16'")
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
    if cfg.encoder == "attn":
        from mmtraj_torch.models.attn_encoder import attn_encoder_init

        enc = attn_encoder_init(g, cfg)
    else:
        enc = {"embed": dense_init(g, 2, E), "cell": cell_init(g, cfg.cell, E, H)}
    dec = {"embed": dense_init(g, 2, E), "cell": cell_init(g, cfg.cell, E, H)}
    if cfg.social:
        for coder in ((enc, dec) if cfg.encoder == "rnn" else (dec,)):
            for li in range(cfg.gat_layers):
                coder["gat" if li == 0 else f"gat_{li}"] = gat_init(g, H, H, cfg.num_heads)
    tree = {"enc": enc, "dec": dec, "bridge_h": dense_init(g, H, H)}
    if cfg.cell == "lstm":
        tree["bridge_c"] = dense_init(g, H, H)
    if cfg.head == "gmm":
        tree["head"] = gmm.head_init(g, H, cfg.num_mixtures)
    else:
        tree["head"] = dense_init(g, H, 2)
    return flatten(tree)


def config_to_json(cfg: Config) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def save_npz(path: str, state: State, stats: NormStats, cfg: Config, step: int = 0,
             opt_leaves=None) -> None:
    """Write ``state`` (a flat ``.``-keyed dict, as ``Forecaster.state_dict()``
    gives it) in the JAX package's npz layout, with the optimizer's leaves
    (``opt_leaves``, optax's flatten order) as ``opt/{i}``: to a temporary
    file first, renamed into place, so a crash never leaves half a
    checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {"params/" + k.replace(".", "/"): np.asarray(torch.as_tensor(v).detach().cpu())
            for k, v in state.items()}
    flat["stats/mean"] = np.asarray(torch.as_tensor(stats.mean).cpu())
    flat["stats/std"] = np.asarray(torch.as_tensor(stats.std).cpu())
    flat["meta/step"] = np.asarray(step)
    flat["meta/config_json"] = np.frombuffer(config_to_json(cfg).encode("utf-8"), dtype=np.uint8)
    for i, leaf in enumerate(opt_leaves or ()):
        flat[f"opt/{i}"] = np.asarray(leaf)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path if path.endswith(".npz") else path + ".npz")


def load_npz(path: str) -> Checkpoint:
    """Read a checkpoint written by either package's ``save_npz``, with its
    optimizer leaves where it has them."""
    if not path.endswith(".npz") and not os.path.isfile(path):
        path = path + ".npz"
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    cfg = config_from_json(bytes(flat.pop("meta/config_json")).decode("utf-8"))
    step = int(flat.pop("meta/step"))
    stats = NormStats(flat.pop("stats/mean"), flat.pop("stats/std"))
    state = {k[len("params/"):].replace("/", "."): torch.from_numpy(np.array(v, np.float32))
             for k, v in flat.items() if k.startswith("params/")}
    opt_keys = sorted((k for k in flat if k.startswith("opt/")), key=lambda k: int(k[4:]))
    return Checkpoint(state, stats, cfg, step, [flat[k] for k in opt_keys] or None)
