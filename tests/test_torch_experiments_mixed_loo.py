"""The five-fold heterogeneous ensemble of the port (``experiments/torch_mixed_loo.py``)
against the JAX script (``experiments/mixed_loo.py``) on the CPU.

Tiny trees trained by the port's CLI on a 30-frame synthetic tree, in the
layouts the JAX script reads (``tests/torch_experiments.py:mixed_trees``:
the rnn tree's seeds 0-2 and the attention encoder's ``s0``, ``s1`` and
flat trees).  Each fold's rnn and attn 3-seed ensembles (``evaluate``) and
the 6-member mixed one (``evaluate_mixed``) of the port fed JAX's streams
within 1e-6 of JAX's, every printed row and average within its rounding.
"""

import pytest
import torch

from torch_experiments import (PRINTED, assert_same_metrics, mixed_trees, numpy_parser,
                               port_report, row_numbers, run_jax_script)

import torch_mixed_loo as report_mod  # noqa: E402  (experiments/, on the path)
from torch_common import SCENES  # noqa: E402

torch.set_num_threads(2)
__all__ = ["numpy_parser"]  # the fixture, used by name


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed_loo")
    mixed_trees(root, (0, 1, 2), 30)
    return root


def test_rows_match_the_jax_script(trees, numpy_parser, monkeypatch, capsys):
    jax_seen, jax_out = run_jax_script("mixed_loo.py", trees, monkeypatch, capsys)
    monkeypatch.chdir(trees)
    tables, seen, out = port_report(report_mod.report, monkeypatch, capsys, "runs",
                                    "data/synthetic", "cpu", ("plain",))
    assert len(jax_seen) == 3 * len(SCENES)
    assert_same_metrics(seen, jax_seen)
    rows = tables["plain"]
    per_fold, averages = jax_out.split("averages over the 5 folds")
    for scene in SCENES:
        for tag in report_mod.TAGS:
            want = row_numbers(per_fold, f"{scene:8s} {tag:12s}")
            row = rows[f"{scene} {tag}"]
            got = [row[k] for k in ("min_ade", "min_fde", "miss_rate_2m")]
            assert all(abs(a - b) <= PRINTED for a, b in zip(got, want)), (scene, tag, got, want)
    for tag in report_mod.TAGS:
        want = row_numbers(averages, f"{tag:12s}")
        got = [rows[f"avg {tag}"][k] for k in ("min_ade", "min_fde")]
        assert all(abs(a - b) <= PRINTED for a, b in zip(got, want)), (tag, got, want)
    assert "recorded rnn ens5 headline: 0.3539 / 0.5031" in out
