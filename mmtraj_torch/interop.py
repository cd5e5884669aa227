"""Reference-convention weights in and out of the port: the torch and Keras
layouts (counterpart of ``mmtraj/interop.py``, whose conventions it copies).

Imports return the port's state (a flat dict of ``.``-joined JAX keys to
float32 CPU tensors, ``Forecaster(state=...)``); exports take one.  The
semantics beyond renaming, each a silent-wrongness trap:

* torch ``Linear`` keeps ``weight`` as (out, in); the port's dense is (in, out);
* torch's GRU packs its gates (r, z, n), the port (z, r, n);
* torch's separate recurrent bias puts the n gate's inside the reset
  product, so it cannot fold into one bias: imports carry it as the cell's
  ``bh`` (``models/cells.py``);
* the port adds the LSTM's +1 forget bias inside the sigmoid, torch and Keras
  keep it in the trained bias: imports subtract 1 from the f rows, exports add
  it back;
* Keras's GRU packs (z, r, h) with (in, out) kernels already; ``reset_after=True``
  has a dual bias, (2, 3H), whose second row is ``bh``; ``reset_after=False``
  applies the reset gate to h before the candidate product, imported as the
  cell's ``wh_n`` (``wh`` then covers z and r);
* Keras's legacy ``save_weights`` HDF5 layout: root attribute ``layer_names``,
  a group a layer whose attribute ``weight_names`` names its
  ``<layer>/<weight>:0`` datasets (or the same under ``model_weights``).

Only the RNN encoder family has a reference layout: the attention encoder
raises ``ValueError``.  A missing key raises ``KeyError`` naming it.
Imported ``bh``/``wh_n`` parameters run on the plain decoder; the fused
decoder refuses them.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from mmtraj_torch.config import ModelConfig
from mmtraj_torch.params import State, from_jax, unflatten

Tree = Dict[str, Any]


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _t(w) -> np.ndarray:
    """torch Linear (out, in) -> dense (in, out)."""
    return np.ascontiguousarray(_np32(w).T)


def _gru_w(w_torch) -> np.ndarray:
    """torch GRU weight (3H, din) rows (r, z, n) -> (din, 3H) columns (z, r, n)."""
    r, z, n = np.split(_np32(w_torch), 3, axis=0)
    return np.concatenate([z.T, r.T, n.T], axis=1)


def _gru_b(b_torch) -> np.ndarray:
    r, z, n = np.split(_np32(b_torch), 3)
    return np.concatenate([z, r, n])


def _lstm_b(b, forget_shift: float) -> np.ndarray:
    b = _np32(b).copy()
    H = b.shape[0] // 4
    b[H:2 * H] += forget_shift
    return b


def _tree(state: State) -> Tree:
    """The state as the JAX package's nested dict of float32 numpy arrays."""
    return unflatten({k: _np32(v) for k, v in state.items()})


def _require_rnn_encoder(cfg: ModelConfig, what: str) -> None:
    if cfg.encoder != "rnn":
        raise ValueError(
            f"{what} covers the reference RNN encoder family only; cfg.encoder={cfg.encoder!r} "
            "has no reference convention to map (use the .npz/.pt/.h5 formats of "
            "mmtraj_torch.checkpoint for attention-encoder models)")


# -- torch convention -------------------------------------------------------------------

def _cell_from_torch(sd, prefix: str, kind: str) -> Tree:
    w_ih, w_hh = sd[f"{prefix}.weight_ih_l0"], sd[f"{prefix}.weight_hh_l0"]
    b_ih, b_hh = sd[f"{prefix}.bias_ih_l0"], sd[f"{prefix}.bias_hh_l0"]
    if kind == "gru":
        return {"wx": _gru_w(w_ih), "wh": _gru_w(w_hh), "b": _gru_b(b_ih), "bh": _gru_b(b_hh)}
    # torch's LSTM gate order (i, f, g, o) is the port's: transpose only.
    return {"wx": _t(w_ih), "wh": _t(w_hh), "b": _lstm_b(b_ih, -1.0), "bh": _np32(b_hh)}


def _cell_to_torch(p: Tree, prefix: str, kind: str, out: Dict[str, np.ndarray]) -> None:
    def gru_inv_w(w):  # (din, 3H) columns (z, r, n) -> (3H, din) rows (r, z, n)
        H = w.shape[1] // 3
        return np.concatenate([w[:, H:2 * H].T, w[:, :H].T, w[:, 2 * H:].T], axis=0)

    def gru_inv_b(b):
        H = b.shape[0] // 3
        return np.concatenate([b[H:2 * H], b[:H], b[2 * H:]])

    wx, wh, b = _np32(p["wx"]), _np32(p["wh"]), _np32(p["b"])
    bh = _np32(p.get("bh", np.zeros_like(b)))
    if kind == "gru":
        out[f"{prefix}.weight_ih_l0"] = gru_inv_w(wx)
        out[f"{prefix}.weight_hh_l0"] = gru_inv_w(wh)
        out[f"{prefix}.bias_ih_l0"] = gru_inv_b(b)
        out[f"{prefix}.bias_hh_l0"] = gru_inv_b(bh)
    else:
        out[f"{prefix}.weight_ih_l0"] = wx.T
        out[f"{prefix}.weight_hh_l0"] = wh.T
        out[f"{prefix}.bias_ih_l0"] = _lstm_b(b, +1.0)
        out[f"{prefix}.bias_hh_l0"] = bh


def _gat_from_torch(sd, prefix: str) -> Tree:
    return {"wv": _t(sd[f"{prefix}.value.weight"]), "a_src": _np32(sd[f"{prefix}.attn_src"]),
            "a_dst": _np32(sd[f"{prefix}.attn_dst"]), "wo": _t(sd[f"{prefix}.out_proj.weight"]),
            "bo": _np32(sd[f"{prefix}.out_proj.bias"])}


def _gat_to_torch(p: Tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.value.weight"] = _np32(p["wv"]).T
    out[f"{prefix}.attn_src"] = _np32(p["a_src"])
    out[f"{prefix}.attn_dst"] = _np32(p["a_dst"])
    out[f"{prefix}.out_proj.weight"] = _np32(p["wo"]).T
    out[f"{prefix}.out_proj.bias"] = _np32(p["bo"])


def _linear(sd, name: str) -> Tree:
    return {"w": _t(sd[f"{name}.weight"]), "b": _np32(sd[f"{name}.bias"])}


def import_state_dict(sd: Dict[str, Any], cfg: ModelConfig) -> State:
    """A torch-convention state_dict (tensors or numpy arrays) -> the port's
    state with ``init_params``'s keys, plus ``bh`` on each cell."""
    _require_rnn_encoder(cfg, "import_state_dict")
    tree: Tree = {
        "enc": {"embed": _linear(sd, "encoder.embedding"),
                "cell": _cell_from_torch(sd, "encoder.rnn", cfg.cell)},
        "dec": {"embed": _linear(sd, "decoder.embedding"),
                "cell": _cell_from_torch(sd, "decoder.rnn", cfg.cell)},
        "bridge_h": _linear(sd, "bridge_h"),
    }
    if cfg.cell == "lstm":
        tree["bridge_c"] = _linear(sd, "bridge_c")
    if cfg.social:
        tree["enc"]["gat"] = _gat_from_torch(sd, "encoder.gat")
        tree["dec"]["gat"] = _gat_from_torch(sd, "decoder.gat")
    tree["head"] = _linear(sd, "head")
    return from_jax(tree)


def export_state_dict(state: State, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The inverse of ``import_state_dict``: the port's state -> a
    torch-convention state_dict of numpy arrays."""
    _require_rnn_encoder(cfg, "export_state_dict")
    p = _tree(state)
    out: Dict[str, np.ndarray] = {}
    for name, key in (("encoder.embedding", ("enc", "embed")), ("decoder.embedding", ("dec", "embed")),
                      ("bridge_h", ("bridge_h",)), ("head", ("head",))):
        node = p
        for k in key:
            node = node[k]
        out[f"{name}.weight"] = node["w"].T
        out[f"{name}.bias"] = node["b"]
    _cell_to_torch(p["enc"]["cell"], "encoder.rnn", cfg.cell, out)
    _cell_to_torch(p["dec"]["cell"], "decoder.rnn", cfg.cell, out)
    if cfg.cell == "lstm":
        out["bridge_c.weight"] = p["bridge_c"]["w"].T
        out["bridge_c.bias"] = p["bridge_c"]["b"]
    if cfg.social:
        _gat_to_torch(p["enc"]["gat"], "encoder.gat", out)
        _gat_to_torch(p["dec"]["gat"], "decoder.gat", out)
    return out


def import_reference_checkpoint(path: str, cfg: ModelConfig) -> State:
    """A reference-convention torch ``.pt``, a bare state_dict or a dict with a
    ``state_dict`` entry, read with ``weights_only=True`` -> the port's state."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload.get("state_dict", payload) if isinstance(payload, dict) else payload
    return import_state_dict(sd, cfg)


# -- Keras convention -------------------------------------------------------------------

#: module path -> Keras-convention layer name (legacy save_weights layout).
KERAS_LAYER_NAMES = {
    "enc/embed": "encoder_embedding",
    "enc/cell": "encoder_rnn",
    "enc/gat": "encoder_gat",
    "dec/embed": "decoder_embedding",
    "dec/cell": "decoder_rnn",
    "dec/gat": "decoder_gat",
    "bridge_h": "bridge_h",
    "bridge_c": "bridge_c",
    "head": "head",
}


def _cell_from_keras(weights: Dict[str, Any], kind: str) -> Tree:
    """A Keras cell's {kernel, recurrent_kernel, bias} -> the port's cell.
    The GRU's ``reset_after`` follows from the bias's rank: (2, 3H) True,
    (3H,) False."""
    kernel, rk, bias = (_np32(weights[k]) for k in ("kernel", "recurrent_kernel", "bias"))
    H = rk.shape[0]
    if kind == "gru":
        if bias.ndim == 2:
            return {"wx": kernel, "wh": rk, "b": bias[0], "bh": bias[1]}
        return {"wx": kernel, "wh": np.ascontiguousarray(rk[:, :2 * H]),
                "wh_n": np.ascontiguousarray(rk[:, 2 * H:]), "b": bias}
    return {"wx": kernel, "wh": rk, "b": _lstm_b(bias, -1.0)}


def _cell_to_keras(p: Tree, kind: str) -> Dict[str, np.ndarray]:
    """The inverse of ``_cell_from_keras``: a GRU with ``wh_n`` goes back as
    ``reset_after=False``, any other as the dual-bias ``reset_after=True``; a
    torch-imported LSTM's ``bh`` folds into the single bias (the LSTM's gates
    are sums, so that is exact)."""
    wx, b = _np32(p["wx"]), _np32(p["b"])
    if kind == "gru":
        if "wh_n" in p:
            rk = np.concatenate([_np32(p["wh"]), _np32(p["wh_n"])], axis=1)
            return {"kernel": wx, "recurrent_kernel": rk, "bias": b}
        bh = _np32(p.get("bh", np.zeros_like(b)))
        return {"kernel": wx, "recurrent_kernel": _np32(p["wh"]), "bias": np.stack([b, bh])}
    if "bh" in p:
        b = b + _np32(p["bh"])
    return {"kernel": wx, "recurrent_kernel": _np32(p["wh"]), "bias": _lstm_b(b, +1.0)}


def export_keras_weights(state: State, cfg: ModelConfig) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's state -> {layer name: {weight name: array}} in Keras's
    conventions."""
    _require_rnn_encoder(cfg, "export_keras_weights")
    p, L = _tree(state), KERAS_LAYER_NAMES
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for mod in ("enc", "dec"):
        out[L[f"{mod}/embed"]] = {"kernel": p[mod]["embed"]["w"], "bias": p[mod]["embed"]["b"]}
        out[L[f"{mod}/cell"]] = _cell_to_keras(p[mod]["cell"], cfg.cell)
        if cfg.social:
            g = p[mod]["gat"]
            out[L[f"{mod}/gat"]] = {"value_kernel": g["wv"], "attn_src": g["a_src"],
                                    "attn_dst": g["a_dst"], "out_kernel": g["wo"],
                                    "out_bias": g["bo"]}
    out[L["bridge_h"]] = {"kernel": p["bridge_h"]["w"], "bias": p["bridge_h"]["b"]}
    if cfg.cell == "lstm":
        out[L["bridge_c"]] = {"kernel": p["bridge_c"]["w"], "bias": p["bridge_c"]["b"]}
    out[L["head"]] = {"kernel": p["head"]["w"], "bias": p["head"]["b"]}
    return out


def import_keras_weights(layers: Dict[str, Dict[str, Any]], cfg: ModelConfig) -> State:
    """{layer name: {weight name: array}} in Keras's conventions -> the port's
    state."""
    _require_rnn_encoder(cfg, "import_keras_weights")
    L = KERAS_LAYER_NAMES

    def dense(name):
        return {"w": _np32(layers[name]["kernel"]), "b": _np32(layers[name]["bias"])}

    def gat(name):
        lw = layers[name]
        return {"wv": _np32(lw["value_kernel"]), "a_src": _np32(lw["attn_src"]),
                "a_dst": _np32(lw["attn_dst"]), "wo": _np32(lw["out_kernel"]),
                "bo": _np32(lw["out_bias"])}

    tree: Tree = {
        "enc": {"embed": dense(L["enc/embed"]),
                "cell": _cell_from_keras(layers[L["enc/cell"]], cfg.cell)},
        "dec": {"embed": dense(L["dec/embed"]),
                "cell": _cell_from_keras(layers[L["dec/cell"]], cfg.cell)},
        "bridge_h": dense(L["bridge_h"]),
    }
    if cfg.cell == "lstm":
        tree["bridge_c"] = dense(L["bridge_c"])
    if cfg.social:
        tree["enc"]["gat"] = gat(L["enc/gat"])
        tree["dec"]["gat"] = gat(L["dec/gat"])
    tree["head"] = dense(L["head"])
    return from_jax(tree)


def save_keras_h5(path: str, state: State, cfg: ModelConfig) -> None:
    """Write Keras's legacy ``save_weights`` HDF5 layout (module docstring),
    to a temporary file renamed into place; needs h5py."""
    import h5py

    layers = export_keras_weights(state, cfg)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode("utf8") for n in layers], dtype="S")
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        for lname, weights in layers.items():
            g = f.create_group(lname)
            wnames = [f"{lname}/{w}:0" for w in weights]
            g.attrs["weight_names"] = np.array([n.encode("utf8") for n in wnames], dtype="S")
            for wname, arr in zip(wnames, weights.values()):
                g.create_dataset(wname, data=arr)
    os.replace(tmp, path)


def _text(name) -> str:
    return name.decode("utf8") if isinstance(name, bytes) else str(name)


def load_keras_h5(path: str, cfg: ModelConfig) -> State:
    """Read a legacy Keras ``save_weights`` .h5, bare or under the
    ``model_weights`` group of a whole-model save -> the port's state."""
    import h5py

    layers: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for lname in map(_text, root.attrs["layer_names"]):
            g = root[lname]
            # "<layer>/<weight>:0" -> "<weight>"
            layers[lname] = {_text(w).rsplit("/", 1)[-1].split(":")[0]: np.asarray(g[_text(w)])
                             for w in g.attrs["weight_names"]}
    return import_keras_weights(layers, cfg)
