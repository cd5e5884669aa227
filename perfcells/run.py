"""The benchmark of mmtraj_torch on one H100: one cell, one run, one line.

    python3 perfcells/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (``perfcells/cells/<cell>.json``: its configuration, traffic,
driver, metrics and check limits), sets it up (weights made on the card from
the seed, kernels from the build directory, the cell's shapes warmed), runs
the program for ``--seconds`` under the cell's traffic, checks what the timed
path produced against the plain reference in ``perfcells/reference``, and
prints one JSON line last on stdout: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
stderr).  Without a card, or where the program or JAX is where it should not
be, it prints no result and exits nonzero.

``--set key=value`` overrides a cell's field (``traffic.arrivals.rate_per_s=450``,
``hooks.control=tf32``, ``hooks.fault=half_batch``): for sweeps, controls and
faults, never in a measured run.  See ``perfcells/README.md``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> tuple:
    """Run ``spec`` (``harness.load_cell``) on ``device`` -> (result dict
    without checks, ``harness.Checks``).  Tests call it on the CPU."""
    import torch

    from perfcells import costs, harness

    cell = spec["cell"]
    driver = importlib.import_module(f"perfcells.drivers.{cell['driver']}")
    out = driver.run(spec, seed, seconds, trace, device, t_start)
    ctx = dict(out["ctx"], spec=spec, costs=costs)
    if trace:
        metrics = {}
        for name in cell["per_layer"]:
            reader = harness.metric_reader(name)
            value = harness.metric_value(reader.read(ctx))
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
    else:
        metrics = {name: {"value": float(out["end_to_end"][name]), "unit": unit}
                   for name, unit in cell["end_to_end"].items()}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"]),
            "power_limit": harness.power_limit() if dev.type == "cuda" else "none"}
    result = {"correct": bool(out["checks"].passed()), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": info}
    summary = ctx.get("trace")
    if trace and summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    return result, out["checks"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args(argv)

    from perfcells import harness

    spec = harness.load_cell(args.workload, dict(harness.parse_override(x) for x in args.set))
    if not os.path.isdir(os.path.join(harness.ROOT, "mmtraj_torch")):
        print("perfcells: no mmtraj_torch package beside perfcells/: nothing to measure",
              file=sys.stderr)
        return 2
    import torch

    chips = int(spec["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfcells: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)  # the host's work is Python's; no intra-op pool beside it
    result, checks = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfcells: modules that may not load in a run were loaded: {bad}",
              file=sys.stderr)
        return 4
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
