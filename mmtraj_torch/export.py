"""Ahead-of-time export of the frozen K-sample predictor through
``torch.export`` (counterpart of ``mmtraj/export.py``).

``export_predictor`` closes a trained forecaster over the K-sample rollout
(weights and norm stats held in the program), traces it at static shapes on
the target device and saves it as one ``.pt2`` file.  ``load_predictor``
gives back a plain callable ``(xy_obs, mask, seed) -> (K, B, N, Tp, 2)``
that needs no model code: ``torch.export.load`` needs only the port's
custom ops registered, which importing ``mmtraj_torch.ops``' kernel modules
does (``load_exported``).

An exported program cannot seed a generator from an input, so the random
stream is one of its inputs: the program maps ``(xy_obs (B, N, To, 2) f32,
mask (B, N) bool, gumbel (R*B, Tp, N, M), normal (R*B, Tp, N, 2))``, R =
K * oversample, and ``load_predictor`` draws the stream from
``torch.Generator(device).manual_seed(seed)`` with the distributions of
``Forecaster._rollout_stream``.  The same seed gives the same result, and
the live ``rollout_k`` with a generator seeded alike gives it too.

Route A (``use_pallas`` + ``use_fused_decoder``) keeps ``mmtraj.fused_gat``
and ``mmtraj.fused_decode`` nodes in the program (with the attention encoder
on CUDA also ``mmtraj.layer_norm``), route B ``mmtraj.attend`` nodes, and
"auto" resolves on the target device at trace time
(``models.gat.use_attend_kernel``), which is what the JAX package's static
resolution for ``--platform`` achieves.  The kernels have a CPU
implementation (their plain versions), so any route exports for either
device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Callable, Optional

import torch
from torch import nn

from mmtraj_torch.data.transforms import NormStats

META = "mmtraj_predictor.json"  # the artifact's extra file of metadata


def draw_stream(rows: int, pred_len: int, n: int, num_mixtures: int, seed: int, device):
    """The rollout's random stream for ``rows`` = R*B graphs from one seed:
    (gumbel (rows, Tp, N, M), normal (rows, Tp, N, 2)), drawn as
    ``Forecaster._rollout_stream`` draws from a generator seeded so
    (``fused_decoder.random_stream``)."""
    from mmtraj_torch.ops.fused_decoder import random_stream

    g = torch.Generator(device=device).manual_seed(int(seed))
    return random_stream(rows, pred_len, n, num_mixtures, g, device)


class Predictor(nn.Module):
    """``(xy_obs, mask, gumbel, normal) -> (K, B, N, Tp, 2)`` by
    ``rollout_k(..., stream=(gumbel, normal))``; with ``oversample > 1`` the
    K most endpoint-diverse of K * oversample rollouts per agent
    (``models.sampling.diverse_select``).  The weights are the model's, the
    norm stats buffers on its device."""

    def __init__(self, model, stats: NormStats, k: int, oversample: int = 1):
        super().__init__()
        self.model = model
        self.k, self.oversample = k, oversample
        for name, v in zip(("stats_mean", "stats_std"), stats):
            self.register_buffer(name, torch.as_tensor(v, dtype=torch.float32)
                                 .reshape(2).to(model.device, copy=True))

    def forward(self, xy_obs, mask, gumbel, normal):
        from mmtraj_torch.models.sampling import diverse_select

        stats = NormStats(self.stats_mean, self.stats_std)
        preds = self.model.rollout_k(xy_obs, mask, stats, self.k * self.oversample,
                                     stream=(gumbel, normal))
        if self.oversample > 1:
            preds = diverse_select(preds, self.k)
        return preds


def make_predictor(model, state, stats: NormStats, k: int, oversample: int = 1,
                   device=None) -> Predictor:
    """The frozen predictor of ``model``'s configuration with the weights
    ``state`` (``model``'s own where None) on ``device`` (``model``'s where
    None), its parameters requiring no gradient."""
    from mmtraj_torch.models.forecaster import Forecaster

    frozen = Forecaster(model.cfg, model.obs_len, model.pred_len,
                        device=model.device if device is None else device,
                        state=model.state_dict() if state is None else state)
    return Predictor(frozen.requires_grad_(False), stats, k, oversample).eval()


def export_predictor(path: str, model, state, stats: NormStats, *, k: int = 20,
                     batch: int = 64, n_agents: Optional[int] = None, device=None,
                     oversample: int = 1) -> None:
    """Trace the frozen K-sample predictor at static shapes (``batch``
    windows of ``n_agents`` padded agents) on ``device`` (``model``'s where
    None) and save it to ``path`` as a ``.pt2`` archive, written to
    ``path + ".tmp"`` and renamed.  Its extra file ``META`` holds the
    shapes, K, the oversampling, M, the device and the model config."""
    from mmtraj_torch.models.forecaster import resolve_device

    n = n_agents if n_agents is not None else 0
    if n <= 0:
        raise ValueError("n_agents is required (padded agent capacity)")
    dev = resolve_device(model.device if device is None else device)
    predictor = make_predictor(model, state, stats, k, oversample, dev)
    cfg = model.cfg
    rows, T, M = k * oversample * batch, model.pred_len, cfg.num_mixtures
    args = (torch.zeros((batch, n, model.obs_len, 2), device=dev),
            torch.zeros((batch, n), dtype=torch.bool, device=dev),
            torch.zeros((rows, T, n, M), device=dev), torch.zeros((rows, T, n, 2), device=dev))
    with torch.no_grad():
        program = torch.export.export(predictor, args, strict=False)
    meta = {"batch": batch, "n_agents": n, "obs_len": model.obs_len, "pred_len": T, "k": k,
            "oversample": oversample, "num_mixtures": M, "device": str(dev),
            "config": dataclasses.asdict(cfg)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.export.save(program, f, extra_files={META: json.dumps(meta)})
    os.replace(tmp, path)


def kernel_nodes(program) -> dict:
    """How many calls of each of the port's custom ops (``mmtraj.*``) a
    program's graph holds, by op name."""
    counts = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("mmtraj."):
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    return counts


def input_shapes(program) -> list:
    """The shapes of the program's user inputs, in order."""
    names = set(program.graph_signature.user_inputs)
    return [tuple(node.meta["val"].shape) for node in program.graph.nodes
            if node.op == "placeholder" and node.name in names]


def load_exported(path: str):
    """-> (ExportedProgram, metadata dict) of an artifact written by
    ``export_predictor``, its metadata checked against the program's input
    shapes.  Registers the port's custom ops first; imports no model code."""
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path!r} is not a torch.export artifact of mmtraj_torch (a .pt2 archive); "
            "an artifact of the JAX package (.stablehlo) is served by `python -m mmtraj.cli "
            "serve`")
    # Registers the mmtraj::* ops an artifact's graph may call (building and
    # loading the kernels waits for a launch).
    from mmtraj_torch.ops import (  # noqa: F401  # lint: ok: imported to register the ops
        fused_attend, fused_decoder, fused_gat, fused_layer_norm)

    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    if not extra[META]:
        raise ValueError(f"{path!r} has no {META}: not written by export_predictor")
    meta = json.loads(extra[META])
    b, n, rows = meta["batch"], meta["n_agents"], meta["k"] * meta["oversample"] * meta["batch"]
    want = [(b, n, meta["obs_len"], 2), (b, n), (rows, meta["pred_len"], n, meta["num_mixtures"]),
            (rows, meta["pred_len"], n, 2)]
    got = input_shapes(program)
    if got != want:
        raise ValueError(f"{path!r}: the program's inputs {got} disagree with its metadata {want}")
    return program, meta


def load_predictor(path: str) -> Callable:
    """An artifact as ``predict(xy_obs, mask, seed) -> (K, B, N, Tp, 2)`` on
    its device, the stream drawn from ``seed`` (``draw_stream``)."""
    program, meta = load_exported(path)
    call = program.module()
    device = torch.device(meta["device"])
    rows = meta["k"] * meta["oversample"] * meta["batch"]

    def predict(xy_obs, mask, seed):
        gumbel, normal = draw_stream(rows, meta["pred_len"], meta["n_agents"],
                                     meta["num_mixtures"], seed, device)
        with torch.no_grad():
            return call(torch.as_tensor(xy_obs, dtype=torch.float32, device=device),
                        torch.as_tensor(mask, dtype=torch.bool, device=device), gumbel, normal)

    return predict
