"""A serving replica under open-loop load: ``mmtraj_torch.serve.serve_lines``,
the ``cli serve`` loop, over an artifact of ``mmtraj_torch.export``.

Set-up makes the weights on the card from the seed, exports the K-sample
predictor at the configuration's static (batch, n_agents) or takes the
export a run of the same seed left in ``perfcells/cache/export/`` (keyed by
a hash of the program's sources, the configuration, the statistics, the
seed and the shapes, as the kernel build keys its libraries), loads it as
the server does, builds every request line (a single window of the traffic's
scene, base64 .npy, one seed shared by all so that the loop may aggregate
them), and runs a few groups through the loop to warm its one shape.  The
window offers the requests at their arrival times, paced by the wall clock
whatever the server's progress, and times each from its due time to the
write that completes its response line.  Offered above what the loop
sustains, the requests queue and the loop answers the backlog after the
window: the rate counts every answered request over the time from the
window's start to the last answer.  A request answered with an error, or
not at all, counts as missing every limit and is not counted as answered.
A traced run profiles the offered window only: the first device call after
its close stops the profiler, and the backlog is answered untraced.

The harness wraps the server's device call to record a span per call (its
dispatch, the windows it carries, the moment its result reached the host),
which also says which call and slot served each request.  The check reads a
sample of the answers back through the reference (``reference/serve.py``):
48 requests drawn from the seed and the 16 with the most agents.
"""

from __future__ import annotations

import base64
import gc
import io
import json
import os
import sys
import time

import numpy as np

from perfcells import costs, harness, traffic
from perfcells import trace as tracing
from perfcells.harness import Checks
from perfcells.reference import model as ref
from perfcells.reference import serve as refserve

SAMPLE_DRAWN, SAMPLE_LARGEST = 48, 16


class PacedStream:
    """Open-loop request source: yields line i once its arrival time has
    passed, whether or not the server has kept up; ``late`` records how far
    behind its due time each line was handed over (seconds)."""

    def __init__(self, lines, arrivals, t0: float):
        self._lines, self._arrivals, self._t0 = lines, arrivals, t0
        self.late: list = []

    def __iter__(self):
        for line, t_a in zip(self._lines, self._arrivals):
            due = self._t0 + t_a
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self.late.append(time.monotonic() - due)
            yield line + "\n"


class TimingStream:
    """The response stream: the time (from ``t0``) at which each response
    line is complete, whether it is an error, and the text of the lines in
    ``keep``."""

    def __init__(self, t0: float, keep):
        self._t0, self._keep = t0, set(keep)
        self.times: list = []
        self.errors: list = []
        self.kept: dict = {}
        self._buf = ""

    def write(self, s: str) -> int:
        if "\n" not in s:
            self._buf += s
            return len(s)
        text, self._buf = self._buf + s.split("\n")[0], ""
        i = len(self.times)
        self.times.append(time.monotonic() - self._t0)
        self.errors.append(text.startswith('{"error"'))
        if i in self._keep:
            self.kept[i] = text
        return len(s)

    def flush(self) -> None:
        pass


def _percentile(lat: np.ndarray, q: float) -> float:
    """The nearest-rank percentile (a failed request is +inf)."""
    return float(np.percentile(lat, q, method="inverted_cdf"))


def artifact_path(mcfg: dict, dcfg: dict, mean, std, seed: int, k: int, batch: int,
                  n_max: int, dev) -> str:
    """The fixed path of the export of these weights (the seed), statistics,
    model and shapes by this program (its sources) under this torch on this
    device."""
    import torch

    h = harness.source_digest()
    h.update(json.dumps({"model": mcfg, "data": dcfg, "seed": int(seed), "k": k, "batch": batch,
                         "n_max": n_max, "torch": torch.__version__,
                         "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else dev.type}, sort_keys=True).encode())
    h.update(np.asarray(mean, np.float32).tobytes() + np.asarray(std, np.float32).tobytes())
    return os.path.join(harness.CACHE_DIR, "export", h.hexdigest()[:40] + ".pt2")


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    import torch

    from mmtraj_torch import serve as serve_mod
    from mmtraj_torch.config import ModelConfig
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.export import export_predictor
    from mmtraj_torch.models.forecaster import Forecaster

    cfgj, mix, hooks = spec["config"], spec["traffic"], spec["hooks"]
    mcfg, dcfg, scfg = cfgj["model"], cfgj["data"], cfgj["serve"]
    obs, pred, n_max = dcfg["obs_len"], dcfg["pred_len"], dcfg["n_max"]
    K, cap_b = scfg["k"], scfg["batch"]
    dev = torch.device(device)

    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    pool, (mean, std) = traffic.request_pool(mix, obs, pred, n_max)
    if hooks.get("max_windows"):
        pool = pool[:hooks["max_windows"]]
    weights = {k: v[0] for k, v in ref.init_params(
        mcfg, 1, torch.Generator(device=dev).manual_seed(seed % 2**63)).items()}
    model = Forecaster(ModelConfig(**mcfg), obs, pred, device=dev, state=weights)
    phases["data_and_weights"] = time.perf_counter() - t
    t = time.perf_counter()
    path = artifact_path(mcfg, dcfg, mean, std, seed, K, cap_b, n_max, dev)
    phases["export_cached"] = os.path.exists(path)
    if not phases["export_cached"]:
        export_predictor(path, model, None, NormStats(mean, std), k=K, batch=cap_b,
                         n_agents=n_max, device=dev)
    del model
    phases["export"] = time.perf_counter() - t
    t = time.perf_counter()
    server = serve_mod.PredictServer(path)
    phases["load"] = time.perf_counter() - t
    t = time.perf_counter()

    arrivals = traffic.arrivals(mix["arrivals"], seconds, mix["pool_seed"], seed)
    n = len(arrivals)
    which = traffic.requests(pool, n, seed)
    req_seed = int(traffic.rng(seed, 5).integers(0, 2**31))
    lines = [traffic.request_line(pool[i], req_seed, mix["encoding"]) for i in which]
    agents = np.array([pool[i].shape[0] for i in which])
    r = traffic.rng(seed, 6)
    largest = np.argsort(-agents, kind="stable")[:SAMPLE_LARGEST]
    rest = np.setdiff1d(np.arange(n), largest)
    sample = np.concatenate([largest, r.choice(rest, min(SAMPLE_DRAWN, len(rest)),
                                               replace=False)])

    agg, wms = scfg["aggregate"], scfg["window_ms"]
    pipe = scfg["pipeline_encode"]
    for _ in range(2):  # the loop's one device shape, full groups and a short one
        warm = "\n".join(lines[:2 * agg + 3])
        serve_mod.serve_lines(server, io.StringIO(warm), io.StringIO(), io.StringIO(),
                              aggregate=agg, window_ms=wms, pipeline_encode=pipe)
    _sync(dev)
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's later passes
    phases["requests_and_warm_up"] = time.perf_counter() - t
    print(json.dumps({"setup_phases_s": phases}), file=sys.stderr, flush=True)

    calls, fetched, capture = [], [], []
    dispatch = server.predict_async
    fault = hooks.get("fault")

    def predict_async(xy, mask=None, seed=0):
        if capture and time.monotonic() >= t_close:
            capture[0].stop()  # the traced window is the offered one
        t = time.perf_counter()
        out, (b, nn) = dispatch(xy, mask, seed)
        if fault == "altered":  # an answer altered where it is produced
            out[0, :, 0, -1, 0] += 0.01
        elif fault == "half_batch":  # half of a call's windows left out
            out[:, (b + 1) // 2:b] = 0.0
        calls.append((t, b))
        return out, (b, nn)

    to_host = serve_mod.to_host

    def timed_to_host(out):
        host = to_host(out)
        fetched.append(time.perf_counter())
        return host

    server.predict_async = predict_async
    serve_mod.to_host = timed_to_host
    try:
        t0 = time.monotonic() + 0.01
        t_close = t0 + seconds
        setup_s = time.perf_counter() - t_start
        paced = PacedStream(lines, arrivals, t0)
        out = TimingStream(t0, sample)
        with tracing.traced(trace) as cap:
            capture.append(cap)
            serve_mod.serve_lines(server, paced, out, io.StringIO(), aggregate=agg,
                                  window_ms=wms, pipeline_encode=pipe)
    finally:
        serve_mod.to_host = to_host
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    lat = np.full(n, np.inf)
    done = np.asarray(out.times[:n])
    ok = ~np.asarray(out.errors[:n], bool)
    lat[:len(done)][ok] = (done - arrivals[:len(done)])[ok] * 1e3
    failed = int((~np.isfinite(lat)).sum())
    # Every request is offered inside the window; the loop then answers the
    # backlog.  The rate counts all the answered requests over all the time
    # from the window's start to the last answer.
    span = max(seconds, float(done.max()) if len(done) else 0.0)
    completed_per_s = int(np.isfinite(lat).sum()) / span
    late = np.asarray(paced.late) * 1e3
    third = max(1, n // 3)
    print(json.dumps({"pacer_late_ms": {"p50": float(np.median(late)),
                                        "p99": float(np.percentile(late, 99)),
                                        "max": float(late.max())},
                      "requests": n, "calls": len(calls), "span_s": span,
                      "completed_per_s": completed_per_s,
                      "p50_ms_first_third": _percentile(lat[:third], 50),
                      "p50_ms_last_third": _percentile(lat[-third:], 50)}),
          flush=True)

    del server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # Which call and slot served each request: calls take requests in order.
    starts = np.concatenate([[0], np.cumsum([b for _, b in calls])])
    call_of = np.searchsorted(starts, np.arange(n), side="right") - 1
    slot = np.arange(n) - starts[np.minimum(call_of, len(calls) - 1)]
    checks = Checks(spec["cell"]["limits"])
    checks.add("failed", failed)
    got = [int(i) for i in sample if int(i) in out.kept]
    R = len(got)
    xy_obs = np.zeros((R, n_max, obs, 2), np.float32)
    mask = np.zeros((R, n_max), bool)
    served = np.zeros((R, K, n_max, pred, 2), np.float32)
    bad = 0
    for j, i in enumerate(got):
        w = pool[which[i]]
        xy_obs[j, :len(w)] = w
        mask[j, :len(w)] = True
        resp = json.loads(out.kept[i])
        if "pred_b64_npy" not in resp:
            bad += 1
            continue
        pr = np.load(io.BytesIO(base64.b64decode(resp["pred_b64_npy"])), allow_pickle=False)
        if pr.shape != (K, len(w), pred, 2):
            bad += 1
            continue
        served[j, :, :len(w)] = pr
    checks.add("bad_answers", bad + len(sample) - R)
    mt = torch.as_tensor(mean, device=dev)
    st = torch.as_tensor(std, device=dev)
    with ref.precision(False):
        g = torch.Generator(device=dev).manual_seed(req_seed)
        gum, nrm = ref.stream(K * cap_b, pred, n_max, mcfg["num_mixtures"], g, dev)
        rows = torch.as_tensor(np.arange(K)[None, :] * cap_b + slot[got][:, None], device=dev)
        gum, nrm = gum[rows], nrm[rows]  # (R, K, T, N, .)
        xo = torch.as_tensor(xy_obs, device=dev)
        mk = torch.as_tensor(mask, device=dev)
        sv = torch.as_tensor(served, device=dev)
        control = hooks.get("control")
        if control in ("tf32", "frozen"):  # the reference in the program's place
            with ref.precision(control == "tf32"):
                sv = refserve.free_rollout(weights, mcfg, xo, mk, mt, st, gum, nrm,
                                           frozen=control == "frozen")
        res = refserve.read_back(weights, mcfg, xo, mk, mt, st, sv, gum, nrm, spec["cell"]["adj_eps"])
    print(json.dumps({"read_back": res}), file=sys.stderr, flush=True)
    checks.add("logit_gap", res["logit_gap"])
    checks.add("pos_gap_m", res["pos_gap_m"])

    flops = sum(costs.forward_products(mcfg, int(a), int(a), K, obs, pred) for a in agents)
    ctx = {"trace": cap.summary, "calls": calls, "fetched": fetched, "window_s": span,
           "model_flops": flops, "k": K, "batch": cap_b, "n_max": n_max, "pred_len": pred,
           "requests": n, "latency_p50_ms": _percentile(lat, 50),
           "latency_p95_ms": _percentile(lat, 95)}
    return {"attempted": n, "failed": failed, "memory_peak_bytes": peak,
            "end_to_end": {"setup_s": setup_s, "serve_completed_per_s": completed_per_s},
            "checks": checks, "ctx": ctx}


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
