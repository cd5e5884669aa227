"""The social-graph ablation report of the port
(``experiments/torch_social_ablation_report.py``) against the JAX script
(``experiments/social_ablation_report.py``) on the CPU.

One tiny tree of every arm, in the layout the JAX script hard-codes (the
"on" tree ``runs/r3/loo32k_variety``, ``runs/r4/loo32k_nosocial``,
``rad{2,8,0}_zara1``, ``c4_univ_h{1,4}``), trained once by the port's CLI on
a 30-frame synthetic tree (2 steps, hidden 16).  The JAX script runs
unchanged from the tree's root; the port's report, fed JAX's per-window
streams, gives every evaluate call within 1e-6 of JAX's and every printed
number of JAX's tables within its rounding.  The route rule: the
``--no-social`` and radius-0 trees never reach the fused decoder on route A.
"""

import dataclasses

import pytest
import torch

from mmtraj_torch import checkpoint
from mmtraj_torch.ops import fused_decoder
from torch_experiments import (assert_rows_match, assert_same_metrics, generate, numpy_parser,
                               port_report, run_jax_script, train)

import torch_social_ablation_report as report_mod  # noqa: E402  (experiments/, on the path)
from torch_common import SCENES, route_config  # noqa: E402

torch.set_num_threads(2)
__all__ = ["numpy_parser"]  # the fixture, used by name

FRAMES = 30
SEEDS = ["--seeds", "0", "1", "2", "--vmap-seeds"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("social")
    generate(str(root), FRAMES)
    train(str(root), "runs/r3/loo32k_variety", "--config", "3", "--scene", "all", *SEEDS)
    train(str(root), "runs/r4/loo32k_nosocial", "--config", "3", "--scene", "all", "--no-social",
          *SEEDS)
    for r in ("2", "8", "0"):
        train(str(root), f"runs/r4/rad{r}_zara1", "--config", "3", "--scene", "zara1",
              "--adjacency-radius", r, *SEEDS)
    for h in ("1", "4"):
        train(str(root), f"runs/r4/c4_univ_h{h}", "--config", "4", "--scene", "univ",
              "--num-heads", h, *SEEDS)
    return root


def test_tables_match_the_jax_script(trees, numpy_parser, monkeypatch, capsys):
    jax_seen, jax_out = run_jax_script("social_ablation_report.py", trees, monkeypatch, capsys)
    monkeypatch.chdir(trees)
    tables, seen, out = port_report(report_mod.report, monkeypatch, capsys, "runs",
                                    "runs/r3/loo32k_variety", "data/synthetic", "cpu",
                                    ("plain",))
    assert len(jax_seen) == 5 * 2 * 3 + 4 * 3 + 2 * 3
    assert_same_metrics(seen, jax_seen)
    rows = tables["plain"]
    assert len(rows) == 2 * len(SCENES) + 2 + 4 + 2
    assert all(row["route"] == "plain" for row in rows.values())
    assert_rows_match(rows, jax_out)
    assert "[plain]" in next(ln for ln in out.splitlines() if ln.startswith("num_heads=4"))


def test_route_a_skips_the_fused_decoder_where_the_model_has_no_cover(trees, monkeypatch,
                                                                     capsys):
    """Route A on the CPU runs the kernels' plain versions: the on tree takes
    ``fused_decode``, ``--no-social`` runs plain and radius 0 ``use_pallas``
    alone, and each row says so."""
    calls = []
    real = fused_decoder.fused_decode

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(fused_decoder, "fused_decode", spy)
    for tree, scene, want in (("runs/r4/loo32k_nosocial/s0/eth", "eth", "plain"),
                              ("runs/r4/rad0_zara1/s0", "zara1", "use_pallas"),
                              ("runs/r3/loo32k_variety/s0/eth", "eth", "A")):
        ck = checkpoint.load(str(trees / tree / "checkpoint_ema.npz"))
        mcfg, ran = route_config(ck.config.model, ck.config.data.n_max, "A")
        assert ran == want and mcfg.use_fused_decoder == (want == "A")
        assert mcfg.use_pallas == (want != "plain")
        del calls[:]
        scorer = report_mod.Scorer(str(trees / "data" / "synthetic"), "cpu")
        _, got = scorer.score([str(trees / tree / "checkpoint_ema.npz")], scene, "A")
        assert got == want and bool(calls) == (want == "A")
    plain = dataclasses.replace(ck.config.model, gat_layers=2)
    assert route_config(plain, 64, "A")[1] == "use_pallas"
    assert route_config(ck.config.model, 100, "A")[1] == "use_pallas"  # N not tileable
