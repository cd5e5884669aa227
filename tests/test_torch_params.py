"""The port's parameter bridge, config copy and package boundary."""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmtraj import config as jconfig
from mmtraj.checkpoint import save_npz
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import init_params as j_init_params
from mmtraj_torch import config
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import flatten, from_jax, init_params, load_npz, unflatten

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _jax_state(cfg):
    params = j_init_params(jax.random.PRNGKey(0), cfg)
    return params, {k: np.asarray(v) for k, v in flatten(jax.tree.map(np.asarray, params)).items()}


@pytest.mark.parametrize("cls", ["ModelConfig", "DataConfig", "TrainConfig", "Config"])
def test_config_copy_has_the_jax_field_names_and_defaults(cls):
    ours, theirs = getattr(config, cls)(), getattr(jconfig, cls)()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    if cls != "Config":
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(config.config4()) == dataclasses.asdict(jconfig.config4())


@pytest.mark.parametrize("gat_layers", [1, 2])
def test_init_params_has_the_jax_keys_and_shapes(gat_layers):
    jcfg = dataclasses.replace(jconfig.config4().model, gat_layers=gat_layers)
    cfg = config.ModelConfig(**dataclasses.asdict(jcfg))
    _, want = _jax_state(jcfg)
    got = init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32
    # Glorot-normal: std sqrt(2 / (fan_in + fan_out)); zero biases.
    assert abs(got["dec.cell.wh"].std().item() - (2 / (64 + 192)) ** 0.5) < 0.01
    assert not got["dec.cell.b"].any()


def test_from_jax_and_state_dict_round_trip():
    jcfg = dataclasses.replace(jconfig.config4().model, hidden_dim=16, embed_dim=16, num_heads=2)
    params, want = _jax_state(jcfg)
    state = from_jax(jax.tree.map(np.asarray, params))
    model = Forecaster(config.ModelConfig(**dataclasses.asdict(jcfg)), 8, 12, device="cpu",
                       state=state)
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert unflatten(flatten(model.params())).keys() == params.keys()
    model.load_state_dict(state)


def test_load_npz_reads_a_jax_checkpoint(tmp_path):
    jcfg = jconfig.config4()
    params, want = _jax_state(jcfg.model)
    stats = JNormStats(np.array([0.1, -0.2], np.float32), np.array([0.4, 0.5], np.float32))
    path = str(tmp_path / "ckpt.npz")
    save_npz(path, params, stats, jcfg, step=17)
    ckpt = load_npz(path)
    assert ckpt.step == 17
    assert dataclasses.asdict(ckpt.config) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(ckpt.stats.mean, stats.mean)
    np.testing.assert_array_equal(ckpt.stats.std, stats.std)
    assert sorted(ckpt.state) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(ckpt.state[k].numpy(), want[k])
    model = Forecaster(ckpt.config.model, 8, 12, device="cpu", state=ckpt.state)
    assert set(model.state_dict()) == set(want)


def test_forecaster_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Forecaster(config.config4().model, 8, 12, generator=torch.Generator())


def _port_files():
    return sorted((ROOT / "mmtraj_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_parity_rehearsal.py",
        ROOT / "tools" / "torch_yardstick.py"] + sorted((ROOT / "experiments").glob("torch_*.py"))


def test_port_imports_neither_jax_nor_mmtraj():
    files = _port_files()
    assert len(files) > 15
    scanned = {str(p.relative_to(ROOT)) for p in files}
    assert {"mmtraj_torch/checkpoint.py", "mmtraj_torch/interop.py", "mmtraj_torch/__init__.py",
            "mmtraj_torch/cli.py", "mmtraj_torch/entry.py", "mmtraj_torch/baselines.py",
            "mmtraj_torch/data/synthetic.py", "mmtraj_torch/utils/profiling.py",
            "mmtraj_torch/utils/logging.py", "mmtraj_torch/benchmarks/occupancy_bench.py",
            "mmtraj_torch/orbax_io/__init__.py", "mmtraj_torch/orbax_io/zstd.py",
            "mmtraj_torch/orbax_io/crc32c.py", "mmtraj_torch/orbax_io/ocdbt.py",
            "mmtraj_torch/orbax_io/zarr.py", "mmtraj_torch/orbax_io/tree.py",
            "chip_smoke.py", "tools/torch_parity_rehearsal.py", "tools/torch_yardstick.py",
            "experiments/torch_common.py", "experiments/torch_social_ablation.py",
            "experiments/torch_social_ablation_report.py", "experiments/torch_dense_sweep.py",
            "experiments/torch_dense_sweep_report.py", "experiments/torch_scale_quality.py",
            "experiments/torch_scale_report.py", "experiments/torch_mixed_zara1_probe.py",
            "experiments/torch_mixed_loo.py", "experiments/torch_mixed_headline.py"} <= scanned
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "mmtraj", "orbax", "tensorstore", "zstandard"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno}: {name}")
    assert not bad, ("the port must not import JAX, the JAX package, orbax, tensorstore or "
                     "zstandard:\n" + "\n".join(bad))
