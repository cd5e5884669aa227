"""``tools/torch_yardstick.py`` on the CPU: the band that holds the port's
rows to RESULTS.md's (each fold's own row; one- and two-sided), the
five-fold average's arithmetic, and the whole tool at a tiny size (2 seeds,
a few steps, a 30-frame synthetic tree): one fold, whose i.i.d. rows are the
training command's own end-of-run table and whose two routes agree, and all
five folds landing in one tree that ``cli eval-loo`` scores as the tool
does.  The tool's full run is on the
card (PERF.md section 6); ``chip_smoke.py`` phase 18 runs it at 200 steps."""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_yardstick  # noqa: E402

torch.set_num_threads(2)


def _rows_of_jax():
    """The JAX rows as if the port had measured them."""
    rows = copy.deepcopy(torch_yardstick.JAX_ROWS)
    return {p: {m: list(v) for m, v in r.items()} for p, r in rows.items()}


def test_band_holds_a_mean_to_the_jax_row():
    rows = _rows_of_jax()
    out = torch_yardstick.bands(rows, 5)
    assert all(b["within"] and b["diff"] == 0.0 for b in out.values())
    sj = torch_yardstick.JAX_ROWS["iid"]["ade"][1]
    assert out["iid_ade"]["band"] == pytest.approx(2 * (2 * sj ** 2 / 5) ** 0.5)
    assert out["ens5_ade"]["band"] == out["os6_ade"]["band"]  # ens5: the os-6 band
    rows["iid"]["ade"][0] += out["iid_ade"]["band"] * 1.01
    rows["ens5"]["fde"][0] -= 0.05  # better than JAX's: one-sided, inside
    worse = torch_yardstick.bands(rows, 5)
    assert not worse["iid_ade"]["within"] and worse["ens5_fde"]["within"]


def test_yardstick_end_to_end_on_the_cpu(tmp_path):
    res = torch_yardstick.run(str(tmp_path), steps=4, n_frames=30, seeds=(0, 1), device="cpu",
                              warmup=1, log=lambda m: None)
    assert res["card"] == "cpu" and res["routes_agree"]
    assert "--vmap-seeds --use-pallas" in res["command"] and "--adjacency-radius 2" in res["command"]
    for route in torch_yardstick.ROUTES:
        rows = res["rows"][route]
        assert [[round(a, 4), round(f, 4)] for a, f in rows["iid"]["per_seed"]] == res["train_table"]
        assert rows["os6"]["per_seed"] != rows["iid"]["per_seed"]
        assert set(res["bands"][route]) == {f"{p}_{m}" for p in ("iid", "os6", "ens5")
                                            for m in ("ade", "fde")}
    assert res["step_ms"] is None  # 4 steps: no logged step past the first chunk


def _fold(scene, per_seed, ens, seeds=(0, 1, 2, 3, 4)):
    """A fold result with the given per-seed (ade, fde) rows, i.i.d. and
    os-6 alike, on both routes."""
    rows = {}
    for route in torch_yardstick.ROUTES:
        r = {p: {"ade": torch_yardstick._mean_std([a for a, _ in per_seed]),
                 "fde": torch_yardstick._mean_std([f for _, f in per_seed]),
                 "per_seed": [list(x) for x in per_seed]} for p in ("iid", "os6")}
        r["ens5"] = {"ade": [ens[0], None], "fde": [ens[1], None]}
        rows[route] = r
    return {"scene": scene, "card": "cpu", "seeds": list(seeds), "command": f"train {scene}",
            "rows": rows}


def test_each_fold_has_its_own_jax_row_and_a_two_sided_test():
    univ = torch_yardstick.JAX_ROWS_BY_SCENE["univ"]
    assert univ["iid"]["ade"] == [0.5337, 0.0024] and univ["ens5"]["fde"] == [0.6270, None]
    assert torch_yardstick.JAX_ROWS is torch_yardstick.JAX_ROWS_BY_SCENE["zara1"]
    assert set(torch_yardstick.JAX_ROWS_BY_SCENE) == set(torch_yardstick.SCENES) | {"average"}
    # Port: univ's os-6 ADE with a spread of 0.0030 over 5 seeds, 0.0100 below JAX's.
    rows = {p: {m: list(v) for m, v in r.items()} for p, r in univ.items()}
    rows["os6"]["ade"] = [0.4696 - 0.0100, 0.0030]
    out = torch_yardstick.bands(rows, 5, univ)
    band = 2 * (0.0030 ** 2 / 5 + 0.0022 ** 2 / 5) ** 0.5  # 0.0033271...
    assert out["os6_ade"]["band"] == pytest.approx(band, abs=1e-12)
    assert out["os6_ade"]["diff"] == pytest.approx(-0.0100, abs=1e-12)
    assert out["os6_ade"]["within"] and not out["os6_ade"]["within_two_sided"]
    assert out["ens5_ade"]["band"] == out["os6_ade"]["band"]
    assert out["iid_ade"]["within_two_sided"]


def test_average_is_the_seeds_five_fold_means():
    # Seed i's ADE on fold j is 0.1 j + 0.01 i, its FDE twice that.
    folds = [_fold(s, [(0.1 * j + 0.01 * i, 0.2 * j + 0.02 * i) for i in range(5)],
                   (0.1 * j, 0.2 * j)) for j, s in enumerate(torch_yardstick.SCENES)]
    avg = torch_yardstick.average(list(reversed(folds)))
    r = avg["rows"]["A"]
    # Seed i's five-fold mean: 0.1 * 2 + 0.01 i -> mean 0.22, sample std 0.01 * sqrt(2.5).
    assert r["iid"]["per_seed"][3] == pytest.approx([0.23, 0.46])
    assert r["os6"]["ade"] == pytest.approx([0.22, 0.01 * 2.5 ** 0.5])
    assert r["iid"]["fde"] == pytest.approx([0.44, 0.02 * 2.5 ** 0.5])
    assert r["ens5"]["ade"] == pytest.approx([0.2, None]) and r["ens5"]["fde"][0] == pytest.approx(0.4)
    jax_avg = torch_yardstick.JAX_ROWS_BY_SCENE["average"]
    b = avg["bands"]["A"]
    assert b["iid_ade"]["band"] == pytest.approx(2 * ((0.01 ** 2 * 2.5) / 5 + 0.0013 ** 2 / 5) ** 0.5)
    # RESULTS.md gives the os-6 average no spread: the port's alone.
    assert b["os6_fde"]["band"] == pytest.approx(2 * ((0.02 ** 2 * 2.5) / 5) ** 0.5)
    assert b["ens5_ade"]["diff"] == pytest.approx(0.2 - jax_avg["ens5"]["ade"][0])
    assert avg["routes_agree"] and avg["scene"] == "average"
    with pytest.raises(ValueError, match="five folds"):
        torch_yardstick.average(folds[:4])


def test_folds_land_in_one_tree_that_eval_loo_scores(tmp_path, monkeypatch, capsys):
    """Two invocations, univ and then the other four folds, fill one
    ``train --scene all`` tree; the second prints the average.  ``cli
    eval-loo --ema --oversample 6`` and ``--ensemble`` on the tree compute
    the tool's os-6 and ens5 rows within 1e-6."""
    from mmtraj_torch import evaluate as ev
    from mmtraj_torch.cli import main as cli_main

    wd = str(tmp_path / "ys")
    common = ["--workdir", wd, "--steps", "2", "--warmup-steps", "1", "--n-frames", "30",
              "--seeds", "0", "1", "--device", "cpu"]
    assert torch_yardstick.main(common + ["--scene", "univ"]) == 0
    first = capsys.readouterr().out.strip().splitlines()
    assert len(first) == 1 and json.loads(first[0])["scene"] == "univ"
    assert sorted(p.name for p in (tmp_path / "ys").glob("s*/*")) == ["univ", "univ"]
    assert torch_yardstick.main(common + ["--scene", "eth", "hotel", "zara1", "zara2"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [r["scene"] for r in lines] == ["eth", "hotel", "zara1", "zara2", "average"]
    folds = {s: json.load(open(tmp_path / "ys" / f"yardstick_{s}.json"))
             for s in torch_yardstick.SCENES}
    assert lines[-1]["rows"] == torch_yardstick.average(list(folds.values()))["rows"]
    assert json.loads((tmp_path / "ys" / "yardstick.json").read_text())["scene"] == "average"
    assert torch_yardstick.main(["--report", "--workdir", wd]) == 0
    assert json.loads(capsys.readouterr().out)["rows"] == lines[-1]["rows"]

    seen = []
    real = ev.evaluate

    def spy(model, *a, **kw):
        m = real(model, *a, **kw)
        seen.append(m)
        return m

    monkeypatch.setattr(ev, "evaluate", spy)
    assert cli_main(["eval-loo", "--loo-dir", wd, "--ema", "--oversample", "6",
                     "--device", "cpu"]) == 0
    os6 = iter(seen)
    for scene in torch_yardstick.SCENES:  # eval-loo's order: a fold's seeds in turn
        for got in folds[scene]["rows"]["A"]["os6"]["per_seed"]:
            m = next(os6)
            assert [m["min_ade"], m["min_fde"]] == pytest.approx(got, abs=1e-6, rel=0)
    seen.clear()
    assert cli_main(["eval-loo", "--loo-dir", wd, "--ema", "--ensemble", "--device", "cpu"]) == 0
    for scene, m in zip(torch_yardstick.SCENES, seen):
        ens = folds[scene]["rows"]["A"]["ens5"]
        assert [m["min_ade"], m["min_fde"]] == pytest.approx([ens["ade"][0], ens["fde"][0]],
                                                             abs=1e-6, rel=0)
    out = capsys.readouterr().out
    assert f"ADE={folds['univ']['rows']['A']['ens5']['ade'][0]:.4f}" in out
