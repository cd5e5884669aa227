"""The mixed-ensemble headline experiment of the port
(``experiments/torch_mixed_headline.py``) against the JAX script
(``experiments/mixed_headline.py``) on the CPU.

Tiny trees trained by the port's CLI on a 30-frame synthetic tree
(``tests/torch_experiments.py:mixed_trees``: the rnn tree's seeds 0-4 and
the attention encoder's three).  Each fold's rnn 5-seed ensemble
(``evaluate``), ens5 + 1 attn and ens5 + 3 attn (``evaluate_mixed``) of the
port fed JAX's streams within 1e-6 of JAX's; every printed row, its
difference from ``RECORDED_ENS5`` and every average within its rounding; the
port's copy of ``RECORDED_ENS5`` equal to the JAX script's.
"""

import runpy

import pytest
import torch

from torch_experiments import (EXPERIMENTS, PRINTED, assert_same_metrics, mixed_trees,
                               numpy_parser, port_report, row_numbers, run_jax_script)

import torch_mixed_headline as report_mod  # noqa: E402  (experiments/, on the path)
from torch_common import SCENES  # noqa: E402

torch.set_num_threads(2)
__all__ = ["numpy_parser"]  # the fixture, used by name


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed_headline")
    mixed_trees(root, (0, 1, 2, 3, 4), 30)
    return root


def test_rows_match_the_jax_script(trees, numpy_parser, monkeypatch, capsys):
    jax_seen, jax_out = run_jax_script("mixed_headline.py", trees, monkeypatch, capsys)
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
            if tag == "rnn ens5":  # then the recorded row and the differences from it
                ra, rf = row["recorded"]
                got += [ra, rf, row["min_ade"] - ra, row["min_fde"] - rf]
            assert len(want) == len(got)
            assert all(abs(a - b) <= PRINTED for a, b in zip(got, want)), (scene, tag, got, want)
    for tag in report_mod.TAGS:
        want = row_numbers(averages, f"{tag:12s}")
        got = [rows[f"avg {tag}"][k] for k in ("min_ade", "min_fde")]
        assert all(abs(a - b) <= PRINTED for a, b in zip(got, want)), (tag, got, want)


def test_recorded_rows_are_the_jax_scripts():
    src = (EXPERIMENTS / "mixed_headline.py").read_text()
    start = src.index("RECORDED_ENS5 = {")
    end = src.index("}", start) + 1
    assert runpy._run_code(src[start:end], {})["RECORDED_ENS5"] == report_mod.RECORDED_ENS5
