"""The port's native annotation parser (``mmtraj_torch/native``,
``mmtraj_torch/data/native.py``): every case of ``tests/test_native.py``, each
held equal to the port's numpy parser and to the JAX package's
``read_annotation_file``, and its build under concurrency and without a
compiler.  JAX's own native parser is not called here: its build writes its
library in place and races under several test workers."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mmtraj.data.parser import read_annotation_file as j_read_annotation_file
from mmtraj_torch.data import registry
from mmtraj_torch.data.native import (
    native_available,
    read_annotation_file_fast,
    read_annotation_file_native,
)
from mmtraj_torch.data.parser import read_annotation_file

ROOT = Path(__file__).resolve().parents[1]
READERS = {"native": read_annotation_file_native, "numpy": read_annotation_file,
           "jax": j_read_annotation_file}


@pytest.fixture(autouse=True)
def _native():
    assert native_available(), "the port's native parser did not build (g++ -O3 -shared -fPIC)"


def _same_rows(path):
    out = {name: read(str(path)) for name, read in READERS.items()}
    np.testing.assert_array_equal(out["native"], out["numpy"])
    np.testing.assert_array_equal(out["native"], out["jax"])
    return out["native"]


def _same_error(path, exc, match):
    for read in READERS.values():
        with pytest.raises(exc, match=match):
            read(str(path))


@pytest.mark.parametrize("scene", ["eth", "univ", "zara1"])
def test_native_matches_numpy_on_synthetic(synth_dir, scene):
    rows = _same_rows(f"{synth_dir}/{scene}.txt")
    assert rows.shape[0] > 0 and rows.dtype == np.float64


@pytest.mark.parametrize("text, expect", [
    # comments, blanks, tabs; an extra column ignored; commas tolerated
    ("# header comment\n0\t1\t1.5\t-2.25\n\n10 2 3.0 4.0 99.0\n   \n"
     "% other comment style\n20,  3,  5e-1,  -1e2\n",
     [[0, 1, 1.5, -2.25], [10, 2, 3.0, 4.0], [20, 3, 0.5, -100.0]]),
    # trailing junk tokens and junk glued to the last number
    ("# header\n0\t1\t1.5\t-2.25\n10 2 3.0 4.0 99.0 extra_junk\n% matlab-style comment\n"
     "20,  3,  5e-1,  -1e2\n30 4 7.0 8.0junk\n\n",
     [[0, 1, 1.5, -2.25], [10, 2, 3.0, 4.0], [20, 3, 0.5, -100.0], [30, 4, 7.0, 8.0]]),
    # a glued second number in column 4 keeps the parsed prefix
    ("1 2 3.0 4.5.6\n", [[1, 2, 3.0, 4.5]]),
    ("", np.zeros((0, 4))),
])
def test_native_handles_messy_files(tmp_path, text, expect):
    p = tmp_path / "messy.txt"
    p.write_text(text)
    np.testing.assert_array_equal(_same_rows(p), np.asarray(expect, np.float64).reshape(-1, 4))


@pytest.mark.parametrize("text, line", [
    ("0 1 2.0 3.0\n0 1 oops\n", 2),  # malformed line
    ("% c\n0 1 2.0 3.0\n0, 1, oops\n", 3),  # after a comment, comma-separated
    ("0 1 oops\n0 1 2.0 3.0\n", 1),  # the first line: not the -1 I/O sentinel
    ("1.2.3 4 5 6\n", 1),  # a glued token in column 1 leaves < 4 columns
    ("1 2 3.0 . 4.0\n", 1),  # a bare '.' is no number
])
def test_malformed_line_is_valueerror_naming_it(tmp_path, text, line):
    p = tmp_path / "bad.txt"
    p.write_text(text)
    _same_error(p, ValueError, f"line {line}")


def test_native_missing_file():
    with pytest.raises(FileNotFoundError):
        read_annotation_file_native("/nonexistent/file.txt")


def test_fast_front_door_and_the_registry_read_natively(synth_dir):
    path = f"{synth_dir}/hotel.txt"
    np.testing.assert_array_equal(read_annotation_file_fast(path), _same_rows(path))
    assert registry.read_annotation_file is read_annotation_file_fast


_CHILD = """
import sys, numpy as np
from mmtraj_torch.data.native import native_available, read_annotation_file_fast
from mmtraj_torch.data.parser import read_annotation_file
ok = native_available()
a = read_annotation_file_fast(sys.argv[1])
print(ok, np.array_equal(a, read_annotation_file(sys.argv[1])), a.shape[0],
      'torch' in sys.modules)
"""


def _children(n, env, path):
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, path], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(n)]
    return [(*p.communicate(timeout=120), p.returncode) for p in procs]


def test_four_processes_build_into_one_fresh_directory(tmp_path, synth_dir):
    """Started together on an empty build directory, each process builds (to
    a file of its own, renamed into place), loads and parses equal; torch is
    never imported."""
    cache = tmp_path / "build"
    env = dict(os.environ, MMTRAJ_TORCH_BUILD_CACHE=str(cache))
    path = f"{synth_dir}/zara2.txt"
    rows = len(read_annotation_file(path))
    for out, err, rc in _children(4, env, path):
        assert rc == 0, err
        assert out.split() == ["True", "True", str(rows), "False"], (out, err)
        assert "unavailable" not in err
    assert [p.name for p in cache.iterdir()] == [Path(_native_lib(env)).name]


def _native_lib(env):
    return subprocess.run([sys.executable, "-c", "from mmtraj_torch.native.build import "
                           "library_path; print(library_path())"], cwd=ROOT, env=env,
                          capture_output=True, text=True, check=True).stdout.strip()


def test_without_a_compiler_falls_back_to_numpy_with_a_notice(tmp_path, synth_dir):
    """No g++ on the PATH and nothing built: one line on stderr, the numpy
    parser's output."""
    env = dict(os.environ, MMTRAJ_TORCH_BUILD_CACHE=str(tmp_path / "build"),
               PATH=str(tmp_path / "empty"))
    path = f"{synth_dir}/eth.txt"
    [(out, err, rc)] = _children(1, env, path)
    assert rc == 0, err
    assert out.split() == ["False", "True", str(len(read_annotation_file(path))), "False"]
    assert err.count("\n") == 1 and "native parser unavailable" in err
    assert "using NumPy fallback" in err


def test_host_modules_import_neither_torch_nor_matplotlib():
    """The parser, the importers, the plots and both builds are host code:
    importing them loads no torch (as their JAX counterparts load no JAX)
    and no matplotlib (imported only when a plot is drawn)."""
    code = ("import sys\n"
            "import mmtraj_torch.data.native, mmtraj_torch.data.obsmat, mmtraj_torch.data.vsp\n"
            "import mmtraj_torch.native.build, mmtraj_torch.ops._build\n"
            "import mmtraj_torch.utils.build_cache, mmtraj_torch.utils.viz\n"
            "print(sorted(m for m in ('torch', 'matplotlib', 'jax', 'mmtraj') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
