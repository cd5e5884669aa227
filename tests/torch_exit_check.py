"""Processes that close a ``prefetch_to_device`` right after its first
batch and exit at once.  A producer thread still inside a torch call when
the interpreter exits is ended by ``pthread_exit`` in C++ code and aborts
the process (exit 134, "terminate called without an active exception"), so
a close must wait for its producer.  Used by ``tests/test_torch_pipeline.py``
(CPU) and ``tests/test_torch_gpu.py`` (CUDA); run alone it prints how many
of the runs exited 0:

    python tests/torch_exit_check.py --device cuda --runs 6 [--root CHECKOUT]

``--root`` names the checkout whose ``mmtraj_torch`` is imported (default:
this one), so two checkouts can be compared.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys
import numpy as np
from mmtraj_torch.data.pipeline import prefetch_to_device

big = np.ones(4 * 2**20, np.float32)


def endless():
    while True:
        yield big


it = prefetch_to_device(endless(), size=2, device={device!r})
next(it)
it.close()
sys.exit(0)
"""


def exit_after_close(device: str, runs: int = 3, root=ROOT) -> list:
    """-> the ``subprocess.CompletedProcess`` of each run."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    return [subprocess.run([sys.executable, "-c", SCRIPT.format(device=device)], cwd=root,
                           env=env, capture_output=True, text=True, timeout=120)
            for _ in range(runs)]


def clean(r) -> bool:
    return r.returncode == 0 and "terminate called" not in r.stderr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    rs = exit_after_close(args.device, args.runs, Path(args.root).resolve())
    print(f"{args.root} on {args.device}: {sum(map(clean, rs))} of {len(rs)} runs exited 0; "
          f"exit codes {[r.returncode for r in rs]}")


if __name__ == "__main__":
    main()
