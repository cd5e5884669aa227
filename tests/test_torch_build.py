"""The kernel build of mmtraj_torch (``mmtraj_torch/ops/_build.py``) on the
CPU: which sources a library's name hashes.  Nothing is compiled here."""

import shutil

import pytest

from mmtraj_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build reads instead of the package's."""
    root = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, root)
    monkeypatch.setattr(_build, "CSRC", root)
    return root


@pytest.mark.parametrize("header", ["attend_common.cuh", "tile_mma.cuh"])
def test_editing_any_header_renames_every_library(csrc, header):
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    assert all(after[name] != before[name] for name in _build.KERNELS)


def test_a_new_header_renames_every_library(csrc):
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    assert all(after[name] != before[name] for name in _build.KERNELS)


def test_an_unchanged_tree_keeps_its_library_names(csrc):
    copy = {name: _build.library_path(name) for name in _build.KERNELS}
    for src in csrc.iterdir():
        src.touch()  # a newer time stamp is no edit
    assert {name: _build.library_path(name) for name in _build.KERNELS} == copy


def test_a_kernel_hashes_its_own_source_and_every_header(csrc):
    names = [src.name for src in _build._sources("decoder")]
    assert names[0] == "decoder.cu"
    assert sorted(names[1:]) == sorted(p.name for p in csrc.glob("*.cuh"))
    assert {"attend_common.cuh", "tile_mma.cuh"} <= set(names)
