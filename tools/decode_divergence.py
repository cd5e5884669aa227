#!/usr/bin/env python
"""Where fused_decode and reference_decode part ways, on the inputs the GPU
tests check (``kernel_inputs.DECODER_CASES``, 100 rollout graphs each), and
on chip_smoke.py's route-A check: config 4 at full width, weights from seed
0, the bench inputs (numpy seed 0, B = 25, N = 64), K = 20 and the stream a
device generator seeded 1 draws for ``rollout_k``; there the kernel starts
from route A's encoder state (``fused_gat``) and the reference from the
plain route's, as the two routes' ``rollout_k`` do, and the float64 run from
the plain route's.

A rollout is a chain of discrete decisions: each agent's Gumbel pick of a
mixture component, and each pair's side of the adjacency radius.  Two
float32 computations that differ only in rounding follow the same chain
unless a decision lies within their rounding of its boundary; then one
rollout of the two takes another branch and ends metres away.  For each
case this prints the kernel's and the float32 reference's largest error
against a float64 run of the same step (``fused_decoder._step_math``), the
number of graphs past 1e-3 m, and, for each graph where the kernel is past
it, the first step and agent past it with the float64 run's margins there:
the agent's Gumbel top-two gap at that step, and the smallest |d^2 - r^2|
of the agent's pairs at that step and the one before.  A gap or margin
near float32's rounding (about 1e-6 of the values) marks a near-tie.

Needs a CUDA device; exits 1 without one.  Usage:
    python tools/decode_divergence.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
from kernel_inputs import DECODER_CASES, decoder_case, rollout_errors  # noqa: E402

TOL = 1e-3


def float64_run(fd, h0, xy0, mask, gumbel, normal, p, hw, hb, *, num_heads, num_mixtures,
                radius, sigma_min, rho_max, stats_mean, stats_std):
    """reference_decode's steps in float64 -> (trajectory (B, T, N, 2), Gumbel
    top-two gap (B, T, N), smallest |d^2 - r^2| over each agent's valid pairs
    after each step's move (B, T, N))."""
    d = torch.float64
    p = {k: {kk: vv.to(d) for kk, vv in v.items()} for k, v in p.items()}
    stats4 = fd._stats4(stats_mean, stats_std, h0.device).to(d)
    h, xy, maskf = h0.to(d), xy0.to(d), mask.to(d)
    pair = mask[:, :, None] & mask[:, None, :] & ~torch.eye(mask.shape[1], dtype=torch.bool,
                                                             device=mask.device)
    outs, gaps, margins = [], [], []
    for t in range(gumbel.shape[1]):
        scores = (h @ hw.to(d) + hb.to(d))[..., :num_mixtures] + gumbel[:, t].to(d)
        top2 = scores.topk(2, dim=-1).values
        gaps.append(top2[..., 0] - top2[..., 1])
        h, xy = fd._step_math(h, xy, maskf, gumbel[:, t].to(d), normal[:, t].to(d), p, hw.to(d),
                              hb.to(d), stats4, num_heads, num_mixtures, radius, sigma_min,
                              rho_max)
        d2 = ((xy[:, :, None] - xy[:, None, :]) ** 2).sum(-1)
        margins.append(torch.where(pair, (d2 - radius ** 2).abs(), torch.inf).amin(-1))
        outs.append(xy)
    return torch.stack(outs, 1), torch.stack(gaps, 1), torch.stack(margins, 1)


def route_a_case(fd):
    """chip_smoke.py's route-A inputs -> (kernel args, reference args, kw)."""
    import dataclasses

    import numpy as np

    from mmtraj_torch.config import config4
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster

    B, N, TO, TP, K = 25, 64, 8, 12, 20
    dev = torch.device("cuda")
    cfg = config4().model
    plain_cfg = dataclasses.replace(cfg, use_pallas=False, attend_kernel="xla",
                                    use_fused_decoder=False)
    plain = Forecaster(plain_cfg, TO, TP, device=dev, generator=torch.Generator().manual_seed(0))
    route_a = Forecaster(dataclasses.replace(plain_cfg, use_pallas=True, use_fused_decoder=True),
                         TO, TP, device=dev, state=plain.state_dict())
    stats = NormStats(torch.zeros(2, device=dev), torch.full((2,), 0.4, device=dev))
    rng = np.random.default_rng(0)
    steps = rng.normal(size=(B, N, TO + TP, 2)).astype(np.float32) * 0.4
    xy = np.cumsum(steps, axis=2) + rng.normal(size=(B, N, 1, 2)).astype(np.float32) * 5
    xy_obs = torch.tensor(xy[:, :, :TO], dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.random((B, N)) < 0.75, device=dev)
    gumbel, normal = plain._rollout_stream(K * B, N, torch.Generator(device=dev).manual_seed(1))
    p = plain.params()
    hw, hb = fd.permute_head(p["head"]["w"], p["head"]["b"], cfg.num_mixtures)
    kw = dict(num_heads=cfg.num_heads, num_mixtures=cfg.num_mixtures,
              radius=cfg.adjacency_radius, sigma_min=cfg.sigma_min, rho_max=cfg.rho_max,
              stats_mean=stats.mean, stats_std=stats.std)

    def args(model):
        h = model.encode(xy_obs, mask, stats).h.repeat(K, 1, 1).contiguous()
        return (h, xy_obs[:, :, -1].repeat(K, 1, 1).contiguous(), mask.repeat(K, 1),
                gumbel.contiguous(), normal.contiguous(), p["dec"], hw, hb)

    return args(route_a), args(plain), kw


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_divergence: no CUDA device is available", file=sys.stderr)
        return 1
    from mmtraj_torch.ops import fused_decoder as fd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    cases = [(list(case), *decoder_case(fd, *case)) for case in DECODER_CASES]
    cases = [(name, args, args, kw) for name, args, kw in cases]
    cases.append(("route A, chip_smoke stream", *route_a_case(fd)))
    rows = []
    for case, args, ref_args, kw in cases:
        mask = args[2]
        got = fd.fused_decode(*args, **kw)
        ref = fd.reference_decode(*ref_args, **kw)
        exact, gap, margin = float64_run(fd, *ref_args, **kw)
        exact = exact.float()
        row = {"case": case, "kernel_vs_ref": rollout_errors(got, ref, mask, TOL),
               "kernel_vs_f64": rollout_errors(got, exact, mask, TOL),
               "ref_vs_f64": rollout_errors(ref, exact, mask, TOL), "past": []}
        err = torch.where(mask[:, None, :, None], (got - ref).abs(), 0.0).amax(-1)  # (B, T, N)
        for b in torch.nonzero(err.flatten(1).amax(1) > TOL).flatten().tolist():
            t = int(torch.nonzero((err[b] > TOL).any(-1)).min())
            for n in torch.nonzero(err[b, t] > TOL).flatten().tolist():
                row["past"].append({
                    "graph": b, "step": t, "agent": n, "err": float(err[b, t, n]),
                    "err_step_before": float(err[b, t - 1, n]) if t else 0.0,
                    "gumbel_gap": float(gap[b, t, n]),
                    "radius_margin": float(margin[b, max(t - 1, 0):t + 1, n].min()),
                    "graph_min_gumbel_gap": float(torch.where(mask[b], gap[b, :t + 1], torch.inf).min()),
                })
        rows.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
