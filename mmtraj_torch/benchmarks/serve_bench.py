"""Serving benchmark: what a serving process pays to use an exported
predictor (counterpart of ``mmtraj/benchmarks/serve_bench.py``).

``mmtraj_torch.export`` freezes a forecaster and its K-sample rollout into
one ``torch.export`` artifact; this module measures, per request batch size:

- **cold start**: ``torch.export.load`` plus the first call down to a numpy
  result (what a replica pays once at boot).  The kernels are built before
  it and their build time (``build_s``, 0 when they were built already) is
  reported apart;
- **end-to-end latency**: p50/p95 of one call down to the host-side numpy
  result, the device-to-host copy a server makes before it answers
  included;
- **sustained throughput**: ``scan_iters`` calls dispatched on device
  inputs with distinct seeds, then one fetch of the last result (calls run
  in order on one stream, so it bounds them all): what a server with a
  request queue sustains.  Each call's program runs eagerly, so this rate
  includes the host's dispatch of every op.

``--serve-loop`` measures requests/s of the whole ``serve_lines`` protocol
loop (JSON parse, grouping, device call, b64-npy encode) for a stream of
single-window requests, per ``--aggregates`` setting, each through an
artifact exported with batch = aggregate.  ``--poisson`` offers
wall-paced Poisson arrivals at fractions of the measured closed-loop
capacity and reports p50/p95/p99 latency with the queueing delay.

The model is config 4 at full width (N_max = 64, K = 20) with random weights
from a generator seeded 0 and stats (0, 0.4), on ``--route`` A
(``use_pallas`` + ``use_fused_decoder``, the default), B or plain.  Stdout is
one JSON line, with the card's name and power limit; the log goes to
stderr.  It runs on the card; ``--device cpu`` runs the same code on the CPU
at whatever size is given (a CPU time says nothing of the card).

Run:  python -m mmtraj_torch.benchmarks.serve_bench [--batches 1,8,25,64] [--route A]
      python -m mmtraj_torch.benchmarks.serve_bench --serve-loop [--aggregates 1,8,25]
      python -m mmtraj_torch.benchmarks.serve_bench --poisson [--aggregates 1,8]
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _export(tmp: str, name: str, model, stats, **kw) -> tuple:
    """Export into ``tmp`` -> (path, seconds)."""
    from mmtraj_torch.export import export_predictor

    path = os.path.join(tmp, f"{name}.pt2")
    t0 = time.perf_counter()
    export_predictor(path, model, None, stats, **kw)
    return path, time.perf_counter() - t0


def bench_one(model, stats, tmp: str, *, batch: int, n: int, k: int, oversample: int,
              iters: int, scan_iters: int) -> dict:
    from mmtraj_torch.benchmarks.bench import bench_inputs
    from mmtraj_torch.benchmarks.rollout_bench import _sync
    from mmtraj_torch.export import load_predictor

    path, export_s = _export(tmp, f"b{batch}", model, stats, k=k, batch=batch, n_agents=n,
                             oversample=oversample)
    xy, mask = (t.numpy() for t in bench_inputs(np.random.default_rng(0), batch, n,
                                                 model.obs_len, "cpu"))
    dev = model.device

    # Cold start: what a fresh replica pays before its first response.
    t0 = time.perf_counter()
    predict = load_predictor(path)
    out = predict(xy, mask, 0).cpu().numpy()
    cold_s = time.perf_counter() - t0
    assert out.shape == (k, batch, n, model.pred_len, 2), out.shape
    assert np.isfinite(out[:, mask]).all()

    # Steady state: one request down to its numpy result.
    lat = []
    for i in range(iters):
        t0 = time.perf_counter()
        predict(xy, mask, i + 1).cpu().numpy()
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    p50, p95 = float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 95))

    # Sustained: dispatch scan_iters calls on device inputs, fetch the last.
    xd = torch.as_tensor(xy, device=dev)
    md = torch.as_tensor(mask, device=dev)
    predict(xd, md, 0).cpu()
    times = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        outs = [predict(xd, md, i) for i in range(scan_iters)]
        outs[-1].cpu()
        times.append(time.perf_counter() - t0)
        del outs
    dt = min(times)
    row = {"batch": batch, "k": k, "oversample": oversample,
           "artifact_mb": os.path.getsize(path) / 1e6, "export_s": export_s,
           "cold_start_s": cold_s, "e2e_p50_ms": p50, "e2e_p95_ms": p95,
           "e2e_windows_per_s": batch / (p50 / 1e3),
           "ms_per_call_sustained": dt / scan_iters * 1e3,
           "windows_per_s_sustained": batch * scan_iters / dt}
    log(f"  {row}")
    return row


def _request_lines(n_requests: int, n: int, obs_len: int, input_encoding: str) -> list:
    """Single-window requests of n - 16 agents, seed 4, b64-npy responses."""
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(n_requests):
        xy = np.cumsum(rng.normal(size=(n - 16, obs_len, 2)).astype(np.float32) * 0.4, axis=1)
        if input_encoding == "b64-npy":
            buf = io.BytesIO()
            np.save(buf, xy, allow_pickle=False)
            field = {"xy_b64_npy": base64.b64encode(buf.getvalue()).decode()}
        else:
            field = {"xy": xy.tolist()}
        lines.append(json.dumps({**field, "seed": 4, "encoding": "b64-npy"}))
    return lines


def bench_serve_loop(model, stats, tmp: str, *, n: int, k: int, n_requests: int,
                     aggregates: list, pipeline_encode: bool = True,
                     input_encoding: str = "json") -> list:
    """Requests/s of the ``serve_lines`` loop for a stream of single-window
    requests, per aggregate setting; each level serves through an artifact
    exported with batch = aggregate, the capacity a replica running that
    level would export, loaded before the timing."""
    from mmtraj_torch.serve import PredictServer, serve_lines

    lines = _request_lines(n_requests, n, model.obs_len, input_encoding)
    payload = "\n".join(lines)
    rows = []
    for agg in aggregates:
        server = PredictServer(_export(tmp, f"loop{agg}", model, stats, k=k, batch=agg,
                                     n_agents=n)[0])
        # warm the path (one full group and the remainder)
        serve_lines(server, io.StringIO("\n".join(lines[:agg + 1])), io.StringIO(), io.StringIO(),
                    aggregate=agg, pipeline_encode=pipeline_encode)
        t0 = time.perf_counter()
        served = serve_lines(server, io.StringIO(payload), io.StringIO(), io.StringIO(),
                             aggregate=agg, window_ms=5.0, pipeline_encode=pipeline_encode)
        dt = time.perf_counter() - t0
        assert served == n_requests, (served, n_requests)
        row = {"aggregate": agg, "requests_per_s": n_requests / dt,
               "ms_per_request": dt / n_requests * 1e3, "pipeline_encode": pipeline_encode,
               "input_encoding": input_encoding}
        log(f"  serve-loop {row}")
        rows.append(row)
    return rows


class _PacedStream:
    """Open-loop request source: yields request line i only once its Poisson
    arrival time has passed, whether or not the server has kept up."""

    def __init__(self, lines, arrivals, t0: float):
        self._lines, self._arrivals, self._t0 = lines, arrivals, t0

    def __iter__(self):
        for line, t_a in zip(self._lines, self._arrivals):
            wait = self._t0 + t_a - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            yield line + "\n"


class _TimingStream:
    """Records the wall time at which each response line is complete (the
    write that holds its newline)."""

    def __init__(self, t0: float):
        self._t0 = t0
        self.times: list = []

    def write(self, s: str) -> int:
        if "\n" in s:
            self.times.append(time.monotonic() - self._t0)
        return len(s)

    def flush(self) -> None:
        pass


def bench_poisson(model, stats, tmp: str, *, n: int, k: int, aggregates: list,
                  n_requests: int, rates, pipeline_encode: bool = True, window_ms: float = 5.0,
                  input_encoding: str = "b64-npy") -> list:
    """Latency under offered load: Poisson arrivals at rate lambda, paced by
    the wall clock whatever the server's progress, so p50/p95/p99 include the
    queueing delay that a closed-loop rate hides.  ``rates=None`` offers
    {0.25, 0.5, 0.75, 0.9, 1.1} x the closed-loop capacity measured first."""
    from mmtraj_torch.serve import PredictServer, serve_lines

    lines = _request_lines(n_requests, n, model.obs_len, input_encoding)
    rows = []
    for agg in aggregates:
        server = PredictServer(_export(tmp, f"poisson{agg}", model, stats, k=k, batch=agg,
                                     n_agents=n)[0])
        serve_lines(server, io.StringIO("\n".join(lines[:max(agg + 1, 8)])), io.StringIO(),
                    io.StringIO(), aggregate=agg, pipeline_encode=pipeline_encode)
        cap_n = min(n_requests, 100)
        t0 = time.perf_counter()
        serve_lines(server, io.StringIO("\n".join(lines[:cap_n])), io.StringIO(), io.StringIO(),
                    aggregate=agg, window_ms=window_ms, pipeline_encode=pipeline_encode)
        capacity = cap_n / (time.perf_counter() - t0)
        log(f"  aggregate={agg}: closed-loop capacity {capacity} req/s")
        agg_rates = rates if rates is not None else [
            f * capacity for f in (0.25, 0.5, 0.75, 0.9, 1.1)]
        for rate in agg_rates:
            arrivals = np.cumsum(np.random.default_rng(7).exponential(1.0 / rate, n_requests))
            t0 = time.monotonic()
            out = _TimingStream(t0)
            served = serve_lines(server, _PacedStream(lines, arrivals, t0), out, io.StringIO(),
                                 aggregate=agg, window_ms=window_ms,
                                 pipeline_encode=pipeline_encode)
            total = time.monotonic() - t0
            assert served == n_requests, (served, n_requests)
            lat = np.asarray(out.times[:n_requests]) - arrivals
            row = {"aggregate": agg, "offered_rps": rate, "achieved_rps": n_requests / total,
                   "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                   "p95_ms": float(np.percentile(lat, 95)) * 1e3,
                   "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                   "saturated": bool(n_requests / total < 0.95 * rate)}
            log(f"  poisson {row}")
            rows.append(row)
    return rows


def main(argv=None) -> int:
    from mmtraj_torch.benchmarks.bench import ROUTES, card_line
    from mmtraj_torch.config import config4
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster, resolve_device
    from mmtraj_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,8,25,64")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--route", default="A", choices=sorted(ROUTES))
    ap.add_argument("--oversample", type=int, default=1)
    ap.add_argument("--iters", type=int, default=50,
                    help="end-to-end latency samples per batch size")
    ap.add_argument("--scan-iters", type=int, default=200,
                    help="calls dispatched per sustained-throughput sample")
    ap.add_argument("--serve-loop", action="store_true",
                    help="measure the serve_lines loop (requests/s of single-window request "
                         "streams) per --aggregates")
    ap.add_argument("--aggregates", default="1,8,25",
                    help="aggregate settings for --serve-loop and --poisson")
    ap.add_argument("--requests", type=int, default=200,
                    help="request-stream length for --serve-loop and --poisson")
    ap.add_argument("--no-pipeline-encode", action="store_true",
                    help="serve-loop and poisson: no writer thread (the serial host path)")
    ap.add_argument("--input-encoding", default="json", choices=("json", "b64-npy"),
                    help="serve-loop: send xy as JSON lists or as base64 .npy")
    ap.add_argument("--poisson", action="store_true",
                    help="open-loop latency against offered load (Poisson arrivals) per "
                         "--aggregates")
    ap.add_argument("--poisson-rates", default=None,
                    help="comma-separated offered req/s (default: fractions of the measured "
                         "closed-loop capacity)")
    ap.add_argument("--window-ms", type=float, default=5.0,
                    help="aggregation window for --poisson")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config4()
    n = cfg.data.n_max
    model = Forecaster(dataclasses.replace(cfg.model, **ROUTES[args.route]), cfg.data.obs_len,
                       cfg.data.pred_len, device=dev, generator=torch.Generator().manual_seed(0))
    stats = NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32))
    card = card_line() if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.build()
    build_s = time.perf_counter() - t0
    head = {"card": card, "route": args.route, "n_agents": n, "k": args.k, "build_s": build_s}
    pipe = not args.no_pipeline_encode
    aggs = [int(x) for x in args.aggregates.split(",")]
    log(f"device: {card}  route {args.route}  N={n} K={args.k}  kernel build {build_s:.2f} s")
    with tempfile.TemporaryDirectory(prefix="mmtraj_serve_") as tmp:
        if args.poisson:
            rates = ([float(x) for x in args.poisson_rates.split(",")]
                     if args.poisson_rates else None)
            rows = bench_poisson(model, stats, tmp, n=n, k=args.k, aggregates=aggs,
                                 n_requests=args.requests, rates=rates, window_ms=args.window_ms,
                                 pipeline_encode=pipe)
            print(json.dumps({**head, "poisson": rows}))
        elif args.serve_loop:
            rows = bench_serve_loop(model, stats, tmp, n=n, k=args.k, n_requests=args.requests,
                                    aggregates=aggs, pipeline_encode=pipe,
                                    input_encoding=args.input_encoding)
            print(json.dumps({**head, "serve_loop": rows}))
        else:
            rows = [bench_one(model, stats, tmp, batch=int(b), n=n, k=args.k,
                              oversample=args.oversample, iters=args.iters,
                              scan_iters=args.scan_iters)
                    for b in args.batches.split(",")]
            print(json.dumps({**head, "batches": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
