"""Structured metrics logging: stdout, JSONL and optionally TensorBoard
(counterpart of ``mmtraj/utils/logging.py``).

Every record is printed and appended to ``{out_dir}/metrics.jsonl`` as one
JSON object with the step and the seconds since the logger was made.  With
``tensorboard=True`` its float values are also written as TensorBoard
scalars under ``{out_dir}/tb`` (``torch.utils.tensorboard.SummaryWriter``);
where the ``tensorboard`` package is missing the logger says so and goes on
with JSONL only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, quiet: bool = False,
                 tensorboard: bool = False):
        self.quiet = quiet
        self._fh = None
        self._tb = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    print("[logging] tensorboard requested but it is not installed; "
                          "continuing with JSONL only", flush=True)
                else:
                    self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {"step": step, "t": round(time.time() - self._t0, 3)}
        # Only 0-d values become floats; arrays are written as lists.
        rec.update({
            k: (float(v) if hasattr(v, "__float__") and np.ndim(v) == 0
                else np.asarray(v).tolist() if hasattr(v, "__array__") else v)
            for k, v in metrics.items()
        })
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            for k, v in rec.items():
                if k not in ("step", "t") and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)
        if not self.quiet:
            parts = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("step", "t")
            )
            print(f"[step {step:>6} t={rec['t']:>8.1f}s] {parts}", flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None
