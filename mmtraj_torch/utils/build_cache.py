"""The build directory of the port's native libraries (counterpart of
``mmtraj/utils/compile_cache.py``).

The CUDA kernels (``mmtraj_torch/ops/_build.py``) and the annotation
parser (``mmtraj_torch/native/build.py``) compile into one directory, each
library under a name hashed from its sources and flags
(``lib<name>-<hash>.so``).  An edit of a source therefore adds a library and
never removes the old one, so the directory is size-bounded as the JAX
package's compile cache is: the first build in a process trims it to
``MMTRAJ_TORCH_BUILD_CACHE_MAX_GB`` (default 4 GB; ``0`` never trims),
least recently written entries first, sparing the libraries the checkout
builds now (a trim never forces a rebuild) and builds still in progress.
``python -m mmtraj_torch.cli cache [--clear|--trim-gb X]`` inspects and
manages it by hand.

Where it lives:

  ``MMTRAJ_TORCH_BUILD_CACHE`` unset or empty  ->  ``mmtraj_torch/build/``
  a path                                       ->  that directory

There is no "off" value, unlike ``MMTRAJ_COMPILE_CACHE``: a kernel has to
be built somewhere, so ``0``, ``off``, ``none`` and ``false`` raise
``ValueError``.  The names are not the JAX package's, so that each
package's trim keeps to its own files.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV_DIR = "MMTRAJ_TORCH_BUILD_CACHE"
ENV_MAX_GB = "MMTRAJ_TORCH_BUILD_CACHE_MAX_GB"
DEFAULT_DIR = Path(__file__).resolve().parents[1] / "build"
_OFF = ("0", "off", "none", "false")
_DEFAULT_MAX_GB = 4.0

_trimmed: set = set()  # directories this process has trimmed before building


def resolve_cache_dir(path: Optional[str] = None) -> str:
    """Explicit arg > ``MMTRAJ_TORCH_BUILD_CACHE`` > ``mmtraj_torch/build``.
    Raises ValueError for an "off" value (0, off, none, false, any case)."""
    if path is None:
        path = os.environ.get(ENV_DIR) or None
    if path is not None and path.lower() in _OFF:
        raise ValueError(f"{ENV_DIR}={path!r}: the build directory cannot be turned off "
                         "(the kernels and the parser are built into it); give a path")
    return str(DEFAULT_DIR) if path is None else path


def _entries(path: str) -> list:
    """Files under ``path`` (recursive) as (mtime, size, fullpath), oldest
    first.  Tolerates files vanishing mid-scan (a concurrent trim)."""
    out = []
    for root, _dirs, files in os.walk(path):
        for name in files:
            fp = os.path.join(root, name)
            try:
                st = os.stat(fp)
            except OSError:
                continue
            out.append((st.st_mtime, st.st_size, fp))
    out.sort()
    return out


def current_libraries() -> set:
    """File names of the libraries this checkout's sources build now."""
    from mmtraj_torch.native import build as native_build
    from mmtraj_torch.ops import _build

    return {p.name for p in (*map(_build.library_path, _build.KERNELS),
                             native_build.library_path())}


def cache_stats(path: Optional[str] = None) -> dict:
    """{dir, entries, total_bytes} of the resolved directory (entries 0 when
    it does not exist yet)."""
    resolved = resolve_cache_dir(path)
    if not os.path.isdir(resolved):
        return {"dir": resolved, "entries": 0, "total_bytes": 0}
    ents = _entries(resolved)
    return {"dir": resolved, "entries": len(ents), "total_bytes": sum(e[1] for e in ents)}


def _evict(resolved: str, max_bytes: float, spare) -> tuple[int, int]:
    ents = _entries(resolved)
    total = sum(e[1] for e in ents)
    removed_n = removed_b = 0
    for _mtime, size, fp in ents:  # oldest first
        if total <= max_bytes:
            break
        if spare(os.path.basename(fp)):
            continue
        try:
            os.remove(fp)
        except OSError:
            continue
        total -= size
        removed_n += 1
        removed_b += size
    return removed_n, removed_b


def trim_cache(path: Optional[str] = None,
               max_bytes: Optional[float] = None) -> tuple[int, int]:
    """Remove the least recently written entries (by mtime) until the
    directory is under ``max_bytes``, sparing the current libraries
    (``current_libraries``) and builds in progress (``*.tmp``).  Returns
    (entries_removed, bytes_removed).  ``max_bytes`` defaults to
    ``MMTRAJ_TORCH_BUILD_CACHE_MAX_GB`` GB (else 4; 0 or less: no trim)."""
    resolved = resolve_cache_dir(path)
    if not os.path.isdir(resolved):
        return 0, 0
    if max_bytes is None:
        gb = float(os.environ.get(ENV_MAX_GB) or _DEFAULT_MAX_GB)
        if gb <= 0:
            return 0, 0
        max_bytes = gb * 1e9
    keep = current_libraries()
    return _evict(resolved, max_bytes, lambda name: name in keep or name.endswith(".tmp"))


def clear_cache(path: Optional[str] = None) -> tuple[int, int]:
    """Remove every entry, the current libraries too (the next use builds
    them again); returns (entries_removed, bytes_removed)."""
    resolved = resolve_cache_dir(path)
    if not os.path.isdir(resolved):
        return 0, 0
    return _evict(resolved, -1, lambda name: False)  # -1: empty files go too


def build_dir() -> Path:
    """The resolved directory, created, for a build about to write into it.
    The first call for a directory in a process trims it to the cap
    (``trim_cache``), the counterpart of ``enable_compile_cache``'s trim."""
    resolved = resolve_cache_dir()
    if resolved not in _trimmed:
        os.makedirs(resolved, exist_ok=True)
        trim_cache(resolved)
        _trimmed.add(resolved)
    return Path(resolved)
