"""The kernel build and launch path of mmtraj_torch
(``mmtraj_torch/ops/_build.py``) on the CPU: which sources a library's name
hashes; that every wrapper hands ``_build.launch`` the arguments its C entry
point declares in ``csrc/``; and that ``launch`` and ``occupancy`` set an
entry point's signature once and pass tensors, None, ints, floats and the
stream as C wants them.  Nothing is compiled here: the libraries are fakes."""

import contextlib
import ctypes
import re
import shutil
from types import SimpleNamespace

import pytest
import torch

from mmtraj_torch.ops import _build, dense_grad, fused_attend, fused_decoder, fused_gat
from mmtraj_torch.ops import fused_layer_norm
from mmtraj_torch.ops import launch_counters


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


def _prototypes() -> dict:
    """Each ``extern "C"`` entry point of ``csrc/*.cu`` -> (its file's stem,
    its parameters' C types, ``const`` dropped)."""
    protos = {}
    for src in _build.CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            params = [" ".join(p.replace("const ", "").split()[:-1]) for p in m[2].split(",")]
            protos[m[1]] = (src.stem, params)
    return protos


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


H, N = 4, 16


def _wrapper_calls() -> dict:
    """Each wrapper's call of its kernel on small CPU inputs, by label."""
    v, s, att = _t(3, N, 32), _t(3, N, H), _t(3, N, N)
    gat = (_t(3, N, 8), att, _t(8, 32), _t(H, 8), _t(H, 8), _t(32, 6), _t(6))
    lanes = tuple(t.expand((2,) + t.shape).contiguous() for t in gat)
    M, T, E, hid = 5, 4, 8, 12
    shapes = {"embed/w": (2, E), "embed/b": (E,), "cell/wx": (E, 3 * hid),
              "cell/wh": (hid, 3 * hid), "cell/b": (3 * hid,), "gat/wv": (hid, 32),
              "gat/a_src": (H, 8), "gat/a_dst": (H, 8), "gat/wo": (32, hid), "gat/bo": (hid,),
              "head/w": (hid, 6 * M), "head/b": (6 * M,)}
    weights = [_t(*shapes[k]) for k in fused_decoder.WEIGHTS]
    return {
        "attend": lambda: fused_attend._launch("attend", v, s, s, att, H),
        "attend_packed": lambda: fused_attend._launch("attend_packed", v, s, s, att, H),
        "gat": lambda: fused_gat._launch(*gat, H),
        "gat_lanes": lambda: fused_gat._launch_lanes(*lanes, H),
        "gat_grad": lambda: fused_gat._gat_attend_grad_cuda(v, s, s, att, v, H),
        "decode": lambda: fused_decoder._fused_decode_cuda(
            _t(3, N, hid), _t(3, N, 2), torch.ones(3, N, dtype=torch.bool), _t(3, T, N, M),
            _t(3, T, N, 2), weights, _t(4), H, M, 2.0, 1e-3, 0.99),
        "wgrad split": lambda: dense_grad._weight_grad_lanes_cuda(_t(5, 8192, 64),
                                                                  _t(5, 8192, 30)),
        "wgrad one split": lambda: dense_grad._weight_grad_lanes_cuda(_t(1, 40, 2), _t(1, 40, 6)),
        "layer_norm": lambda: fused_layer_norm._layer_norm_cuda(_t(3, N, 64), _t(64), _t(64),
                                                                1e-6),
        "layer_norm_grad": lambda: fused_layer_norm._layer_norm_grad_cuda(
            _t(3, N, 64), _t(64), _t(3, N), _t(3, N), _t(3, N, 64)),
    }


POINTEE = {"float*": torch.float32, "double*": torch.float64, "uint32_t*": torch.int32}


@pytest.mark.parametrize("label", ["attend", "attend_packed", "gat", "gat_lanes", "gat_grad",
                                   "decode", "wgrad split", "wgrad one split", "layer_norm",
                                   "layer_norm_grad"])
def test_every_wrapper_hands_launch_what_its_entry_point_declares(label, monkeypatch):
    """The arguments in the C order: a tensor of the pointee's dtype (or
    None) for each pointer, an int for each ``int``, a float for each
    ``float``, the stream last (``launch`` appends it); the library is the
    entry point's ``.cu`` file, which ``KERNELS`` names."""
    calls = []
    monkeypatch.setattr(_build, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(fused_layer_norm, "_check", lambda *a: None)  # it reads x's device too
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(dense_grad, "_sms", lambda device: 132)
    for counter in launch_counters().values():
        monkeypatch.setattr(counter, "launches", 0)
    _wrapper_calls()[label]()
    [(name, symbol, device, *args)] = calls
    stem, params = _prototypes()[symbol]
    assert name == stem and name in _build.KERNELS and device == torch.device("cpu")
    assert len(args) == len(params) - 1 and params[-1] == "cudaStream_t", (args, params)
    for i, (a, p) in enumerate(zip(args, params)):
        if p.endswith("*"):
            assert a is None or (isinstance(a, torch.Tensor) and a.dtype == POINTEE[p]
                                 and a.is_contiguous()), (i, p, a)
        else:
            assert type(a) is {"int": int, "float": float}[p], (i, p, a)


def test_the_kernels_are_the_cuda_sources():
    assert set(_build.KERNELS) == {src.stem for src in _build.CSRC.glob("*.cu")}
    assert {"attend", "attend_packed", "decoder", "gat", "gat_grad", "layer_norm",
            "wgrad"} <= set(_build.KERNELS)


@pytest.fixture
def fake_lib(monkeypatch):
    """``_build.load`` of one fake library: entry point ``mmtraj_fake`` records
    its arguments and returns ``lib.code``; ``mmtraj_fake_occupancy`` fills
    its info array.  -> the library, with ``loads`` counting ``load`` calls."""
    lib = SimpleNamespace(code=0, calls=[], loads=0)

    def fake(*args):
        lib.calls.append(args)
        return lib.code

    def fake_occupancy(*args):
        args[-1][:] = [5, 90, 0, 41500, lib.cluster, 33]
        return lib.code

    lib.cluster = 4
    lib.mmtraj_fake, lib.mmtraj_fake_occupancy = fake, fake_occupancy
    lib.mmtraj_error_string = lambda code: b"invalid argument"

    def load(name):
        assert name == "fake"
        lib.loads += 1
        return lib

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_entries", {})
    return lib


def test_launch_sets_the_signature_once_and_passes_c_arguments(fake_lib, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=7))
    x = torch.arange(4.0)
    _build.launch("fake", "mmtraj_fake", x.device, x, None, 3, 0.5)
    want = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    assert fake_lib.mmtraj_fake.argtypes == want
    assert fake_lib.mmtraj_fake.restype is ctypes.c_int
    assert fake_lib.calls == [(x.data_ptr(), None, 3, 0.5, 7)]
    fake_lib.mmtraj_fake.argtypes = "set once"
    _build.launch("fake", "mmtraj_fake", x.device, x, x, 4, 1.5)
    assert fake_lib.mmtraj_fake.argtypes == "set once" and fake_lib.loads == 1
    fake_lib.code = 1
    with pytest.raises(RuntimeError, match="mmtraj_fake: CUDA launch failed: invalid argument"):
        _build.launch("fake", "mmtraj_fake", x.device, x, None, 3, 0.5)


@pytest.mark.parametrize("cluster", [4, 0])
def test_occupancy_reads_the_entry_point(fake_lib, cluster):
    fake_lib.cluster = cluster
    got = _build.occupancy("fake", 64, 4)
    want = {"blocks_per_sm": 5, "registers": 90, "spill_bytes": 0, "shared_bytes": 41500}
    assert got == ({**want, "cluster": 4, "active_clusters": 33} if cluster else want)
    assert fake_lib.mmtraj_fake_occupancy.argtypes == [ctypes.c_int] * 2 + [ctypes.c_void_p]
