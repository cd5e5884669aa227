"""Build the native annotation parser (``fastparse.cpp``) with
``g++ -O3 -shared -fPIC`` (counterpart of ``mmtraj/native/build.py``).

The library goes into the port's build directory
(``mmtraj_torch.utils.build_cache``, shared with the CUDA kernels) as
``libfastparse-<hash>.so``, the hash covering the source and the flags, so an
edited source builds anew.  The compiler writes a file of its own process,
which is then renamed into place: processes that build at once never load a
half-written library.  Host code: nothing here imports torch.  Loading and
the NumPy fallback are in ``mmtraj_torch/data/native.py``.

Usage: ``python -m mmtraj_torch.native.build`` (builds and prints the path).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

from mmtraj_torch.utils import build_cache

SRC = Path(__file__).resolve().with_name("fastparse.cpp")
FLAGS = ["-O3", "-shared", "-fPIC"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return Path(build_cache.resolve_cache_dir()) / f"libfastparse-{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile if the current source is not built yet; returns the .so path.
    Raises (``CalledProcessError``, ``FileNotFoundError`` without g++) on a
    failed build."""
    so = library_path()
    if so.exists():
        return str(so)
    build_cache.build_dir()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return str(so)


if __name__ == "__main__":
    print(build())
