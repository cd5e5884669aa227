"""Build the CUDA kernels in ``mmtraj_torch/csrc`` at first use and load them.

Each ``csrc/<name>.cu`` (with the shared headers ``csrc/*.cuh``) compiles with
``nvcc`` for Hopper (``sm_90a``) into ``<build dir>/lib<name>-<hash>.so``, a
shared library with a plain C interface that ``ctypes`` loads.  The build
directory is ``mmtraj_torch.utils.build_cache.resolve_cache_dir()``:
``$MMTRAJ_TORCH_BUILD_CACHE`` where set, else ``mmtraj_torch/build/``; the
first build in a process trims it to its cap, sparing the current libraries.
The hash covers the source, every header and the flags, so an edited or added
header builds anew and an unchanged tree loads from the build directory.
``launch`` is the one way a wrapper in ``ops/`` calls into a library.
Nothing is built or loaded at import, and the module imports torch only
inside the functions that take a tensor, so the host-side parser's build
can name these libraries without it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

from mmtraj_torch.utils import build_cache

CSRC = Path(__file__).resolve().parents[1] / "csrc"
KERNELS = tuple(sorted(src.stem for src in CSRC.glob("*.cu")))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources(name: str):
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return Path(build_cache.resolve_cache_dir()) / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    process each, all started together.  Returns the seconds each took (0.0
    for one found built); the compiler's output goes to ``<build dir>/<name>.log``.
    Raises with that output if a build fails."""
    out_dir = build_cache.build_dir()
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
        (out_dir / f"{name}.log").write_text(out)
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


def _entry(name: str, symbol: str, args) -> ctypes._CFuncPtr:
    """Entry point ``symbol`` of ``csrc/<name>.cu``'s library, its signature
    set at its first call from that call's ``args``: a float is a C
    ``float``, an int an ``int``, anything else (a tensor, None, a ctypes
    array) a pointer; it returns an ``int``, the CUDA error code."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = [ctypes.c_float if isinstance(a, float) else
                       ctypes.c_int if isinstance(a, int) else ctypes.c_void_p for a in args]
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def launch(name: str, symbol: str, device: torch.device, *args) -> None:
    """Call ``symbol`` of ``csrc/<name>.cu`` on ``device``'s current stream:
    ``args`` in the C order (a tensor by its address, None as a null
    pointer, ints and floats as C ``int`` and ``float``), the stream last.
    Raises if the launch failed."""
    import torch

    fn = _entry(name, symbol, args + (None,))
    with torch.cuda.device(device):
        code = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                  torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error(name, code, symbol)


def occupancy(name: str, *shape: int) -> Dict[str, int]:
    """What ``mmtraj_<name>_occupancy`` of ``csrc/<name>.cu`` reports for a
    launch at ``shape`` (the kernel's own size arguments): blocks an SM,
    registers and local (spill) bytes a thread, dynamic shared bytes a block;
    for a kernel launched in thread block clusters also the cluster's blocks
    and how many such clusters the card holds at once."""
    names = ("blocks_per_sm", "registers", "spill_bytes", "shared_bytes", "cluster",
             "active_clusters")
    info = (ctypes.c_int * len(names))()
    symbol = f"mmtraj_{name}_occupancy"
    _raise_on_error(name, _entry(name, symbol, shape + (info,))(*shape, info), symbol)
    out = dict(zip(names, info))
    if not out["cluster"]:  # launched without a cluster: the first four only
        del out["cluster"], out["active_clusters"]
    return out


def check_cuda(t: torch.Tensor, name: str, shape, dtype=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (default
    float32) and ``shape``."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on_error(name: str, code: int, what: str) -> None:
    """Raise with the CUDA error's text unless ``code`` (returned by ``what``
    of ``csrc/<name>.cu``) is 0."""
    if code != 0:
        msg = load(name).mmtraj_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} (cudaError {code})")
