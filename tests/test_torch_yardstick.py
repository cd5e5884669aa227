"""``tools/torch_yardstick.py`` on the CPU: the band that holds the port's
rows to RESULTS.md's, and the whole tool at a tiny size (2 seeds, 4 steps, a
30-frame synthetic tree), whose i.i.d. rows are the training command's own
end-of-run table and whose two routes agree.  The tool's full run is on the
card (PERF.md section 6); ``chip_smoke.py`` phase 18 runs it at 200 steps."""

import copy
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
