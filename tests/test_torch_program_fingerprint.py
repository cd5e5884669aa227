"""Hot-program fingerprints of the PyTorch port, on the CPU: the counterpart
of ``tests/test_program_fingerprint.py``.

The port's throughput is measured only on the card; these tests pin its
*programs* instead, so a change that perturbs them fails in seconds without
a chip.  At a small config (2 heads, embed 8, hidden 16, 2 mixtures, B = 4,
N = 8, K = 3, the shapes of ``tests/test_torch_export.py``):

  1. node counts by category of the ``torch.export`` graph of the predictor
     (``mmtraj_torch.export.make_predictor``) on route A and on the plain
     route: the port's kernel nodes by op (``export.kernel_nodes``), matrix
     products, control flow, reductions, sorts, gathers and scatters.
     Elementwise counts are not pinned (they shift with harmless algebraic
     refactors and torch point releases), as in the JAX file;
  2. ``torch.utils.flop_counter.FlopCounterMode``'s FLOPs of a plain
     ``rollout_k`` call and of one training step (``make_train_step``, nll,
     config 4's recipe at the small widths), forward and backward.

Update protocol (INTENTIONAL program changes only): run
``python tests/test_torch_program_fingerprint.py`` -- it prints the current
fingerprints -- paste them over the EXPECTED_* constants below, and record
WHY in the commit message.  A torch upgrade that changes what ``export``
records also legitimately re-pins the counts (they were pinned under torch
2.13.0+cpu); the FLOPs are not expected to move.
"""

import collections
import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mmtraj_torch.config import ModelConfig, config4  # noqa: E402
from mmtraj_torch.data.transforms import NormStats  # noqa: E402
from mmtraj_torch.export import kernel_nodes, make_predictor  # noqa: E402
from mmtraj_torch.models.forecaster import Forecaster  # noqa: E402
from mmtraj_torch.params import init_params  # noqa: E402
from mmtraj_torch.train import make_optimizer, make_train_step  # noqa: E402

torch.set_num_threads(2)

B, N, K, TO, TP = 4, 8, 3, 8, 12
SMALL = dict(num_heads=2, embed_dim=8, hidden_dim=16, num_mixtures=2)
ROUTES = {"plain": {}, "A": dict(use_pallas=True, use_fused_decoder=True)}
STATS = NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32))

# The categories, each a pattern on the node's target (``aten.<op>.<overload>``
# or ``higher_order.<op>``): the counterparts of the JAX file's PINNED_OPS.
CATEGORIES = {
    "matmul": r"aten\.(matmul|mm|bmm|addmm|baddbmm|linear|einsum)\.",
    "control": r"higher_order\.",
    "reduce": r"aten\.(sum|mean|amax|amin|max|min|argmax|argmin|logsumexp|prod|any|all)\.",
    "sort": r"aten\.(sort|argsort|topk)\.",
    "gather": r"aten\.(gather|index|index_select|take_along_dim)\.",
    "scatter": r"aten\.(scatter|scatter_add|scatter_reduce|index_put|index_add)\.",
}

EXPECTED_EXPORT = {
    "plain": {"matmul": 193, "control": 0, "reduce": 112, "sort": 0, "gather": 36,
              "scatter": 0, "kernels": {}},
    "A": {"matmul": 25, "control": 0, "reduce": 8, "sort": 0, "gather": 2, "scatter": 0,
          "kernels": {"mmtraj.fused_decode.default": 1, "mmtraj.fused_gat.default": 8}},
}
EXPECTED_ROLLOUT_MFLOPS = 5.7303
EXPECTED_TRAIN_MFLOPS = 9.9154


def _model(**changes):
    mc = ModelConfig(**{**SMALL, **changes})
    return Forecaster(mc, TO, TP, device="cpu",
                      state=init_params(mc, torch.Generator().manual_seed(0)))


def _inputs(t=TO, seed=0):
    rng = np.random.default_rng(seed)
    xy = np.cumsum(rng.normal(size=(B, N, t, 2)).astype(np.float32) * 0.3, axis=2)
    mask = rng.random((B, N)) > 0.2
    mask[:, 0] = True
    return torch.from_numpy(xy), torch.from_numpy(mask)


def export_fingerprint(route="plain", **changes) -> dict:
    """The pinned node counts of the exported predictor of ``route`` (with
    ``changes`` to the small model config)."""
    model = _model(**{**ROUTES[route], **changes})
    predictor = make_predictor(model, None, STATS, K, 1, torch.device("cpu"))
    args = (torch.zeros((B, N, TO, 2)), torch.zeros((B, N), dtype=torch.bool),
            torch.zeros((K * B, TP, N, SMALL["num_mixtures"])), torch.zeros((K * B, TP, N, 2)))
    with torch.no_grad():
        program = torch.export.export(predictor, args, strict=False)
    targets = collections.Counter(str(node.target) for node in program.graph.nodes
                                  if node.op == "call_function")
    out = {cat: sum(c for t, c in targets.items() if re.match(pat, t))
           for cat, pat in CATEGORIES.items()}
    out["kernels"] = dict(sorted(kernel_nodes(program).items()))
    return out


def _mflops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return round(fc.get_total_flops() / 1e6, 4)


def rollout_mflops(**changes) -> float:
    """FLOPs of one plain ``rollout_k`` call (K = 3 samples of B = 4 windows)."""
    model = _model(**changes)
    xy, mask = _inputs()
    with torch.no_grad():
        return _mflops(lambda: model.rollout_k(xy, mask, STATS, K,
                                               generator=torch.Generator().manual_seed(1)))


def train_mflops(**changes) -> float:
    """FLOPs of one plain nll training step on a batch of B windows of
    obs + pred frames (config 4's recipe, the small widths)."""
    cfg = config4()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **SMALL, **changes),
                      train=dataclasses.replace(cfg.train, batch_size=B))
    model = Forecaster(cfg.model, TO, TP, device="cpu",
                       state=init_params(cfg.model, torch.Generator().manual_seed(0)))
    step = make_train_step(model, make_optimizer(cfg, model), STATS)
    xy, mask = _inputs(TO + TP)
    return _mflops(lambda: step(xy, mask, 0))


def test_export_fingerprint():
    for route, want in EXPECTED_EXPORT.items():
        got = export_fingerprint(route)
        assert got == want, (f"the {route} predictor's program drifted: {got} != {want}. If "
                             "intentional, re-pin per the module docstring.")


def test_rollout_flops_fingerprint():
    got = rollout_mflops()
    assert abs(got - EXPECTED_ROLLOUT_MFLOPS) <= 1e-3 * EXPECTED_ROLLOUT_MFLOPS, (
        f"the plain rollout_k's FLOPs drifted: {got} vs {EXPECTED_ROLLOUT_MFLOPS} MFLOP")


def test_train_step_flops_fingerprint():
    got = train_mflops()
    assert abs(got - EXPECTED_TRAIN_MFLOPS) <= 1e-3 * EXPECTED_TRAIN_MFLOPS, (
        f"the training step's FLOPs drifted: {got} vs {EXPECTED_TRAIN_MFLOPS} MFLOP")


def test_fingerprint_is_sensitive():
    """The pins move when the program does: a second GAT layer adds matrix
    products to the plain program and FLOPs to the rollout and the step;
    ``use_pallas`` alone puts the GAT kernel into the plain route's graph in
    place of its products."""
    deeper = export_fingerprint("plain", gat_layers=2)
    assert deeper["matmul"] > EXPECTED_EXPORT["plain"]["matmul"]
    pallas = export_fingerprint("plain", use_pallas=True)
    assert pallas["kernels"].get("mmtraj.fused_gat.default", 0) > 0
    assert pallas["matmul"] < EXPECTED_EXPORT["plain"]["matmul"]
    assert rollout_mflops(gat_layers=2) > EXPECTED_ROLLOUT_MFLOPS
    assert train_mflops(gat_layers=2) > EXPECTED_TRAIN_MFLOPS


if __name__ == "__main__":
    # Re-pin helper: prints the current fingerprints in paste-able form.
    print("EXPECTED_EXPORT = " + repr({r: export_fingerprint(r) for r in ROUTES}))
    print(f"EXPECTED_ROLLOUT_MFLOPS = {rollout_mflops()}")
    print(f"EXPECTED_TRAIN_MFLOPS = {train_mflops()}")
