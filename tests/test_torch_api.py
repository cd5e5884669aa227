"""The port's top-level API, ``--version``, entry contract
(``mmtraj_torch/entry.py``) and occupancy bench, on the CPU.

The lazy names resolve to the modules' objects and importing
``mmtraj_torch`` imports neither torch nor a kernel module; ``entry()``'s
loss equals JAX ``__graft_entry__.entry()``'s on the same parameters;
``dryrun_multichip(2)`` runs on 2 gloo ranks; the occupancy bench's counts
equal the JAX bench's, and it runs at a tiny size with ``--device cpu``,
its evaluate-wall gate passing."""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as j_entry
from mmtraj.benchmarks import occupancy_bench as j_occ
from mmtraj_torch import cli, entry
from mmtraj_torch.benchmarks import occupancy_bench as occ
from mmtraj_torch.params import from_jax

torch.set_num_threads(2)


def test_lazy_names_resolve():
    import mmtraj_torch
    from mmtraj_torch import checkpoint, config, evaluate, population, serve, train
    from mmtraj_torch.models.forecaster import Forecaster

    assert mmtraj_torch.__version__ == "0.1.0"
    assert mmtraj_torch.get_config is config.get_config and mmtraj_torch.PRESETS is config.PRESETS
    assert (mmtraj_torch.Config, mmtraj_torch.ModelConfig, mmtraj_torch.DataConfig,
            mmtraj_torch.TrainConfig) == (config.Config, config.ModelConfig, config.DataConfig,
                                          config.TrainConfig)
    assert mmtraj_torch.Forecaster is Forecaster
    # Once the submodule is imported its name is the module's attribute, as in
    # the JAX package; the lazy name is what a first access gives.
    assert mmtraj_torch.fit is train.fit
    assert mmtraj_torch.__getattr__("evaluate") is evaluate.evaluate
    assert mmtraj_torch.fit_population is population.fit_population
    assert mmtraj_torch.checkpoint is checkpoint
    assert mmtraj_torch.PredictServer is serve.PredictServer
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        mmtraj_torch.nope


def test_import_loads_no_kernel():
    code = ("import sys, mmtraj_torch; mmtraj_torch.get_config('4'); "
            "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.') "
            "or m.startswith('mmtraj_torch.ops') or m.startswith('mmtraj_torch.models'))); "
            "print(type(mmtraj_torch.evaluate).__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.split() == ["[]", "function"]


def test_version_flag(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == "mmtraj_torch 0.1.0"


def test_entry_loss_equals_jax_entry():
    fn, (params, xy, mask) = entry.entry(device="cpu")
    assert xy.shape == (8, 16, 20, 2) and mask.shape == (8, 16)
    j_fn, (j_params, j_xy, j_mask) = j_entry.entry()
    np.testing.assert_array_equal(xy.numpy(), np.asarray(j_xy))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    state = from_jax(jax.tree.map(np.asarray, j_params))
    loss = fn({f"model.{k}": v for k, v in state.items()}, xy, mask)
    assert loss.ndim == 0 and torch.isfinite(loss)
    assert abs(float(loss) - float(j_fn(j_params, j_xy, j_mask))) <= 1e-5 * abs(float(loss))
    assert torch.isfinite(fn(params, xy, mask))


def test_dryrun_multichip_two_ranks(capsys):
    r = entry.dryrun_multichip(2)
    assert r["mesh"] == (2,) and len(r["multi_losses"]) == 2
    assert all(np.isfinite([r["loss"], r["attn_loss"], r["pop_dp_loss"], *r["multi_losses"]]))
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["sparse", "dense", "mixed"])
def test_workload_counts_equal_jax(name):
    got = occ.workload_counts(name, 500, np.random.default_rng(1))
    want = j_occ.workload_counts(name, 500, np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)
    assert occ.BUCKETS == j_occ.BUCKETS


def test_occupancy_bench_tiny_on_cpu(capsys):
    assert occ.main(["--device", "cpu", "--iters", "1", "--k", "2", "--route", "A"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["card"] == "cpu" and set(res) >= {"A", "buckets", "k"} and "plain" not in res
    rates = res["A"]["rates"]
    assert sorted(rates) == ["16", "32", "64"] and all(r["windows_per_sec"] > 0
                                                      for r in rates.values())
    assert set(res["A"]["workloads"]) == set(occ.WORKLOADS)
    w = res["A"]["workloads"]["sparse"]
    assert w["shares"]["16"] == 1.0 and w["padded_wps"] == rates["64"]["windows_per_sec"]


@pytest.mark.parametrize("route", ["plain", "A"])
def test_evaluate_wall_gate_passes_on_cpu(route):
    out = occ.run_evaluate_wall(k=2, n_windows=24, route=route, device="cpu",
                                workloads=("mixed",))
    r = out["mixed"]
    assert r["ade_delta"] < occ.ADE_GATE and r["padded"]["min_ade"] > 0
    assert r["bucketed"]["windows_per_sec"] > 0
