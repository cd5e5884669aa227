#!/usr/bin/env python
"""Where the time of the port's config-4 K=20 rollout goes, on one GPU.

For the plain route, route A (whole-layer GAT kernel in the encoder, fused
rollout kernel in the decoder) and route B (the attend kernel in every GAT
call), at chip_smoke.py's shapes (B = 25 windows, N = 64, K = 20, config 4
at full width, random weights from seed 0):

* wall time of one ``rollout_k`` call (host clock around synchronized
  calls, median of 10), the host's enqueue time of it (until the call
  returns, before the synchronize), and the encode share of it (CUDA events);
* under ``torch.profiler``, over 3 calls: device time by kernel name, the
  device's busy share of the profiled wall time (kernels run on one stream,
  so their durations add without overlap; the profiler's own host cost
  lowers the busy share somewhat), and the mean host time of one
  ``cudaLaunchKernel``.

Prints one JSON line per route.  Needs a CUDA device; exits 1 without one.
Usage: python tools/torch_rollout_profile.py
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, N, TO, TP, K = 25, 64, 8, 12, 20


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_rollout_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from mmtraj_torch.config import config4
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    base = dataclasses.replace(config4().model, attend_kernel="xla")
    routes = {
        "plain": base,
        "A": dataclasses.replace(base, use_pallas=True, use_fused_decoder=True),
        "B": dataclasses.replace(base, attend_kernel="pallas"),
    }
    state = Forecaster(base, TO, TP, device=dev,
                       generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    steps = rng.normal(size=(B, N, TO, 2)).astype(np.float32) * 0.4
    xy = torch.tensor(np.cumsum(steps, axis=2) + rng.normal(size=(B, N, 1, 2)) * 5,
                      dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.random((B, N)) < 0.75, device=dev)
    # On the device once, as a serving loop holds them: numpy stats would be
    # copied from host memory, which waits for the stream, on every call.
    stats = NormStats(torch.zeros(2, device=dev), torch.full((2,), 0.4, device=dev))
    device_kind = torch.cuda.get_device_name(0)

    for name, cfg in routes.items():
        model = Forecaster(cfg, TO, TP, device=dev, state=state)
        gen = torch.Generator(device=dev).manual_seed(1)

        def call():
            return model.rollout_k(xy, mask, stats, K, generator=gen)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        walls, enqueue, enc_ms = [], [], []
        for _ in range(10):
            t0 = time.perf_counter()
            call()
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model.encode(xy, mask, stats)
            end.record()
            end.synchronize()
            enc_ms.append(start.elapsed_time(end))

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            prof_wall_us = (time.perf_counter() - t0) * 1e6
        by_kernel = defaultdict(float)
        launches, launch_us = 0, []
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                by_kernel[evt.name] += evt.time_range.elapsed_us()
                launches += 1
            elif evt.name == "cudaLaunchKernel":
                launch_us.append(evt.time_range.elapsed_us())
        busy_us = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({
            "route": name, "device": device_kind,
            "rollout_k_ms": statistics.median(walls),
            "host_enqueue_ms": statistics.median(enqueue),
            "encode_ms": statistics.median(enc_ms),
            "window_rollouts_per_s": B * K / (statistics.median(walls) / 1e3),
            "profiled_calls": 3, "device_kernels_per_call": launches / 3,
            "device_busy_share": busy_us / prof_wall_us if busy_us else None,
            "cuda_launch_kernel_us": statistics.mean(launch_us) if launch_us else None,
            "top_kernels_ms_per_call": [[k[:80], v / 3e3] for k, v in top],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
