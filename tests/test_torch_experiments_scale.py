"""The scale-out quality report of the port (``experiments/torch_scale_report.py``)
against the JAX script (``experiments/scale_report.py``) on the CPU.

Tiny trees trained by the port's CLI on a 30-frame synthetic tree, in the
layouts the JAX script reads: the control ``runs/r5/dense_control/s0`` and
``scale_b16_f3000`` (config 4), ``scale_b256_f3000_2k`` and ``_4k`` (config
5, its batch cut to 8); ``scale_b256_f6000_4k`` absent, so both print its
"(missing)" row.  Every evaluate call of the port fed JAX's streams within
1e-6 of JAX's, every printed ADE/FDE within its rounding and each run's wall
clock (the last ``t`` of its ``metrics.jsonl``) equal.
"""

import pytest
import torch

from torch_experiments import (PRINTED, assert_same_metrics, generate, numpy_parser, port_report,
                               row_numbers, run_jax_script, train)

import torch_scale_report as report_mod  # noqa: E402  (experiments/, on the path)

torch.set_num_threads(2)
__all__ = ["numpy_parser"]  # the fixture, used by name

TREES = {"dense_control/s0": "4", "scale_b16_f3000": "4", "scale_b256_f3000_2k": "5",
         "scale_b256_f3000_4k": "5"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("scale")
    generate(str(root), 30)
    for tree, config in TREES.items():
        train(str(root), f"runs/r5/{tree}", "--config", config, "--scene", "univ", "--seed", "0",
              "--n-max", "16")
    return root


def test_table_matches_the_jax_script(trees, numpy_parser, monkeypatch, capsys):
    jax_seen, jax_out = run_jax_script("scale_report.py", trees, monkeypatch, capsys)
    monkeypatch.chdir(trees)
    tables, seen, out = port_report(report_mod.report, monkeypatch, capsys, "runs",
                                    "data/synthetic", "cpu", ("plain",))
    assert len(jax_seen) == 2 * len(TREES)
    assert_same_metrics(seen, jax_seen)
    rows = tables["plain"]
    assert list(rows) == [tag for tag, _ in report_mod.CELLS]
    for (tag, tree), row in zip(report_mod.CELLS, rows.values()):
        line = next(ln for ln in jax_out.splitlines() if ln.startswith(tag))
        if tree not in TREES:
            assert row is None and "(missing)" in line
            continue
        want = row_numbers(line, tag)
        got = row["iid"] + row["os6"]
        assert len(want) == 4, line
        assert all(abs(a - b) <= PRINTED for a, b in zip(got, want)), (tag, got, want)
        assert row["wall_s"] == report_mod.wall_of(str(trees / "runs/r5" / tree)) > 0
        assert f"{row['wall_s']:8.0f}" in line
    assert "(missing)" in out
