"""The port's packaging: what an installed ``mmtraj_torch`` needs ships.

The CUDA sources and the native parser's source are package data (both are
compiled at first use, never at install time), and every directory of the
package that holds Python has an ``__init__.py`` (setuptools' ``find`` drops
one that lacks it).  The slow test builds the wheel and reads its file list,
as ``tests/test_packaging.py`` does for the JAX package.
"""

import glob
import os
import subprocess
import sys
import tomllib
import zipfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mmtraj_torch")
CSRC = sorted(f for f in os.listdir(os.path.join(PKG, "csrc")) if f.endswith((".cu", ".cuh")))


@pytest.fixture(scope="module")
def package_data():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]


def _modules():
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "build")]
        yield dirpath, filenames


@pytest.mark.parametrize("package, pattern, path", [
    ("mmtraj_torch.native", "fastparse.cpp", "native/fastparse.cpp"),
    ("mmtraj_torch", "csrc/*.cu", "csrc/gat.cu"),
    ("mmtraj_torch", "csrc/*.cuh", "csrc/attend_common.cuh"),
], ids=["native-parser", "cuda-sources", "cuda-headers"])
def test_sources_are_package_data(package_data, package, pattern, path):
    assert pattern in package_data[package]
    assert os.path.exists(os.path.join(PKG, path))


def test_seven_cuda_sources():
    # Seven before the weight-gradient kernel (csrc/wgrad.cu) made eight, the
    # GAT's backward (csrc/gat_grad.cu) nine and the layer norm
    # (csrc/layer_norm.cu) ten.
    assert CSRC == ["attend.cu", "attend_block.cuh", "attend_common.cuh", "attend_packed.cu",
                    "decoder.cu", "gat.cu", "gat_grad.cu", "layer_norm.cu", "tile_mma.cuh",
                    "wgrad.cu"], CSRC


def test_every_python_directory_is_a_package():
    for dirpath, filenames in _modules():
        if any(f.endswith(".py") for f in filenames):
            assert "__init__.py" in filenames, f"{dirpath} lacks __init__.py"


@pytest.mark.slow
def test_wheel_ships_every_module_and_source(tmp_path):
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-build-isolation", "--no-index",
                    "--no-deps", ROOT, "-w", str(tmp_path)],
                   check=True, capture_output=True, text=True)
    names = set(zipfile.ZipFile(glob.glob(str(tmp_path / "mmtraj-*.whl"))[0]).namelist())
    assert "mmtraj_torch/native/fastparse.cpp" in names
    for f in CSRC:
        assert f"mmtraj_torch/csrc/{f}" in names, f
    for dirpath, filenames in _modules():
        for f in filenames:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert rel in names, f"{rel} missing from the wheel"
