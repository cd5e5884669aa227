"""Build the CUDA kernels in ``mmtraj_torch/csrc`` at first use and load them.

Each ``csrc/<name>.cu`` (with the shared ``attend_common.cuh``) compiles with
``nvcc`` for Hopper (``sm_90a``) into ``mmtraj_torch/build/lib<name>-<hash>.so``,
a shared library with a plain C interface that ``ctypes`` loads.  The hash
covers the sources and the flags, so an edited source builds anew and an
unchanged one loads from the build directory.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
KERNELS = ("attend", "gat", "decoder")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources(name: str):
    return [CSRC / f"{name}.cu", CSRC / "attend_common.cuh"]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    process each, all started together.  Returns the seconds each took (0.0
    for one found built); the compiler's output goes to ``build/<name>.log``.
    Raises with that output if a build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        so = library_path(name)
        if so.exists():
            seconds[name] = 0.0
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.mmtraj_error_string.argtypes = [ctypes.c_int]
        lib.mmtraj_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check_cuda(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    if code != 0:
        msg = lib.mmtraj_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} (cudaError {code})")
