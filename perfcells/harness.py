"""What every cell shares: finding a cell's files by name, overrides, the
per-layer metric readers, the device's description, the checks that decide
``correct``, and the result line.

A cell (``cells/<cell>.json``) names its ``config`` (``configs/<name>.json``),
its ``traffic`` (``traffic/<name>.json``), the ``driver`` that runs it
(``drivers/<name>.py``), the metrics it reports and the limits of its
checks.  A per-layer metric is ``metrics/<metric>.py``, with ``UNIT`` and
``read(ctx) -> float | None``; None leaves the metric out of the line.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# What set-up may keep between runs of a checkout (git-ignored): fixed paths
# keyed by what made them.
CACHE_DIR = os.path.join(HERE, "cache")
# Top-level module names that may not be loaded in a run (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "mmtraj")


def read_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as fh:
        return json.load(fh)


def _set(tree: dict, dotted: str, value) -> None:
    *parents, leaf = dotted.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def load_cell(name: str, overrides: Optional[Dict[str, object]] = None) -> dict:
    """-> {"name", "cell", "config", "traffic", "hooks"} with ``overrides``
    (``"config.train.batch_size": 4``, ``"hooks.fault": "half_batch"``)
    applied: development runs and tests only."""
    cell = read_json("cells", name)
    spec = {"name": name, "cell": cell, "config": read_json("configs", cell["config"]),
            "traffic": read_json("traffic", cell["traffic"]), "hooks": {}}
    for k, v in (overrides or {}).items():
        _set(spec, k, v)
    return spec


def parse_override(text: str):
    """``key=value`` with a JSON value (a bare word is a string)."""
    key, _, raw = text.partition("=")
    try:
        return key, json.loads(raw)
    except json.JSONDecodeError:
        return key, raw


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (loaded from its file: a metric's
    name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("perfcells_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def source_digest(package: str = "mmtraj_torch") -> "hashlib._Hash":
    """A sha256 over the relative path and bytes of every source file of
    ``package`` (Python, CUDA and C++; not its build directory)."""
    h = hashlib.sha256()
    top = os.path.join(ROOT, package)
    for dirpath, dirnames, files in os.walk(top):
        dirnames[:] = sorted(d for d in dirnames if d not in ("build", "__pycache__"))
        for f in sorted(files):
            if f.endswith((".py", ".cu", ".cuh", ".cpp", ".h")):
                path = os.path.join(dirpath, f)
                h.update(os.path.relpath(path, top).encode() + b"\0")
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return h


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


class Checks:
    """The numbers compared with the reference, each beside its limit: a
    reading passes at or below its limit."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        self.values[name] = float(value)

    def passed(self) -> bool:
        return all(name in self.values and math.isfinite(self.values[name])
                   and self.values[name] <= lim for name, lim in self.limits.items())

    def line(self) -> dict:
        return {k: {"value": self.values.get(k), "limit": lim} for k, lim in self.limits.items()}

    def text(self) -> List[str]:
        return [f"check {k}: {self.values.get(k)} (limit {lim})" for k, lim in self.limits.items()]


def metric_value(value) -> Optional[float]:
    if value is None:
        return None
    value = float(value)
    return value if math.isfinite(value) else None


def emit(result: dict, checks: Checks) -> None:
    """Checks as the last lines of stderr; the result as the last line of
    stdout, with the checks under its last key."""
    for line in checks.text():
        print(line, file=sys.stderr, flush=True)
    out = dict(result)
    out["checks"] = checks.line()
    print(json.dumps(out), flush=True)
