"""The port's synthetic generator (``mmtraj_torch/data/synthetic.py``)
against the JAX package's, on the CPU: the same scenes array for array, the
same files byte for byte, the same presets, and ``cli generate-data``
writing JAX's files.  Small scenes (120 frames)."""

import dataclasses
import filecmp

import numpy as np
import pytest

from mmtraj import cli as j_cli
from mmtraj.data import synthetic as j_synthetic
from mmtraj_torch import cli
from mmtraj_torch.config import SCENES
from mmtraj_torch.data import synthetic

N_FRAMES = 120


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_scene_equals_jax(seed):
    for i, scene in enumerate(SCENES):
        preset = dataclasses.replace(synthetic.PRESETS[scene], n_frames=N_FRAMES)
        j_preset = dataclasses.replace(j_synthetic.PRESETS[scene], n_frames=N_FRAMES)
        got = synthetic.generate_scene(seed * 1000 + i, preset)
        want = j_synthetic.generate_scene(seed * 1000 + i, j_preset)
        assert got.dtype == want.dtype and got.shape == want.shape and len(got) > 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_written_files_equal_jax(seed, tmp_path):
    synthetic.write_synthetic_dataset(str(tmp_path / "port"), seed, N_FRAMES)
    j_synthetic.write_synthetic_dataset(str(tmp_path / "jax"), seed, N_FRAMES)
    for scene in SCENES:
        assert filecmp.cmp(tmp_path / "port" / f"{scene}.txt", tmp_path / "jax" / f"{scene}.txt",
                           shallow=False), scene


def test_presets_and_constants_equal_jax():
    assert list(synthetic.PRESETS) == list(j_synthetic.PRESETS) == list(SCENES)
    for scene in SCENES:
        assert (dataclasses.asdict(synthetic.PRESETS[scene])
                == dataclasses.asdict(j_synthetic.PRESETS[scene]))
    assert dataclasses.asdict(synthetic.ScenePreset()) == dataclasses.asdict(
        j_synthetic.ScenePreset())
    assert (synthetic.FRAME_DT, synthetic.FRAME_STEP) == (j_synthetic.FRAME_DT,
                                                          j_synthetic.FRAME_STEP)


def test_cli_generate_data_writes_jax_files(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MMTRAJ_COMPILE_CACHE", "off")
    argv = ["generate-data", "--seed", "2", "--n-frames", str(N_FRAMES)]
    assert cli.main(argv + ["--data-dir", str(tmp_path / "port")]) == 0
    got = capsys.readouterr().out
    assert j_cli.main(argv + ["--data-dir", str(tmp_path / "jax")]) == 0
    want = capsys.readouterr().out
    assert got.replace("port", "jax") == want
    for scene in SCENES:
        assert filecmp.cmp(tmp_path / "port" / f"{scene}.txt", tmp_path / "jax" / f"{scene}.txt",
                           shallow=False), scene
