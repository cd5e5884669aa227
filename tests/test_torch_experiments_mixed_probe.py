"""The zara1 heterogeneous-ensemble probe of the port
(``experiments/torch_mixed_zara1_probe.py``) against the JAX script
(``experiments/mixed_zara1_probe.py``) on the CPU.

Tiny checkpoints trained by the port's CLI on a 30-frame synthetic tree at
the paths the JAX script reads: config 3's rnn on the zara1 fold
(``runs/r3/rnn_zara1_s0``) and two attention encoders of 3 and 4 layers
(``runs/r3/probe_attn_l3``, ``probe_attn_l4``).  Every single-member
(``evaluate``) and mixed (``evaluate_mixed``) row of the port fed JAX's
streams within 1e-6 of JAX's, and every printed number within its rounding.
"""

import pytest
import torch

from torch_experiments import (PRINTED, assert_same_metrics, generate, numpy_parser, port_report,
                               row_numbers, run_jax_script, train)

import torch_mixed_zara1_probe as report_mod  # noqa: E402  (experiments/, on the path)

torch.set_num_threads(2)
__all__ = ["numpy_parser"]  # the fixture, used by name


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe")
    generate(str(root), 30)
    zara1 = ["--config", "3", "--scene", "zara1", "--seed", "0"]
    train(str(root), "runs/r3/rnn_zara1_s0", *zara1)
    for layers in ("3", "4"):
        train(str(root), f"runs/r3/probe_attn_l{layers}", *zara1, "--encoder", "attn",
              "--attn-layers", layers)
    return root


def test_rows_match_the_jax_script(trees, numpy_parser, monkeypatch, capsys):
    jax_seen, jax_out = run_jax_script("mixed_zara1_probe.py", trees, monkeypatch, capsys)
    monkeypatch.chdir(trees)
    tables, seen, out = port_report(report_mod.report, monkeypatch, capsys, "runs",
                                    "data/synthetic", "cpu", ("plain",))
    assert len(jax_seen) == len(report_mod.ROWS)
    assert_same_metrics(seen, jax_seen)
    jax_lines = [ln for ln in jax_out.splitlines() if " os=" in ln]
    rows = tables["plain"]
    assert len(rows) == len(jax_lines) == len(report_mod.ROWS)
    for (tag, members, oversample), line, row in zip(report_mod.ROWS, jax_lines, rows.values()):
        assert line.startswith(tag) and f"os={oversample} " in line
        want = row_numbers(line, f"{tag:28s} os={oversample}")[:3]
        got = [row[k] for k in ("min_ade", "min_fde", "miss_rate_2m")]
        assert all(abs(a - b) <= PRINTED for a, b in zip(got, want)), (tag, got, want)
    assert out.splitlines()[0] == jax_out.splitlines()[0]  # "zara1 fold: n test windows, ..."
