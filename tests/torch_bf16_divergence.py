"""How far two implementations of the bf16 model drift apart, on the CPU.

Under ``ModelConfig.dtype="bfloat16"`` every product's operands are rounded
to bf16.  Two implementations that differ only in float32 summation order
(the port and the JAX package, or two routes of the JAX package) compute an
operand a few float32 ulps apart, and where that lands near a bf16 rounding
boundary they round it one bf16 ulp (2^-8 relative) apart: a rounding flip.
In a rollout the flip moves the next offset by about 2^-8 of a step, and the
sampled chain of Gumbel picks and adjacency sides turns it into a fork.

This module holds the comparisons the bf16 tests (``test_torch_bf16.py``)
use, and prints the measurements behind their design:

* ``rollout_divergence``: config 4 at full width (B = 25, N = 64, K = 20,
  the inputs of ``chip_smoke.py``), on JAX's stream: the port against JAX,
  and JAX's plain route against its own attend-kernel route (the same math
  in another summation order), in float32 and in bf16;
* ``synced_decoder_steps``: the same decoder steps from the same state,
  JAX's, one step at a time, so that a flip cannot carry into the next
  step: rows of the new hidden state past 1e-5 of its largest |value|;
* ``gradient_divergence``: one nll step's gradients, the port against JAX,
  and JAX against itself with the agents permuted and run op by op.

Usage: ``python tests/torch_bf16_divergence.py`` (a few minutes on the CPU;
prints one JSON object).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    jax.config.update("jax_platforms", "cpu")

from mmtraj import config as jconfig  # noqa: E402
from mmtraj.data.transforms import NormStats as JNormStats  # noqa: E402
from mmtraj.data.transforms import denormalize as j_denormalize  # noqa: E402
from mmtraj.models import gmm as jgmm  # noqa: E402
from mmtraj.models.cells import Carry as JCarry  # noqa: E402
from mmtraj.models.forecaster import Forecaster as JForecaster  # noqa: E402
from mmtraj.models.forecaster import _step as j_step  # noqa: E402
from mmtraj_torch import config  # noqa: E402
from mmtraj_torch.data.transforms import NormStats, denormalize  # noqa: E402
from mmtraj_torch.models import forecaster as tf  # noqa: E402
from mmtraj_torch.models import gmm  # noqa: E402
from mmtraj_torch.models.cells import Carry  # noqa: E402
from mmtraj_torch.params import from_jax  # noqa: E402

ROLLOUT_TOL = 1e-3  # meters
ROW_RTOL = 1e-5  # of the largest |value|


def jax_and_port(model_cfg, obs_len, pred_len, seed=0):
    """JAX's model and parameters for ``model_cfg`` (a JAX ``ModelConfig``),
    and the port's model on the same parameters, on the CPU."""
    jm = JForecaster(model_cfg, obs_len, pred_len)
    params = jm.init(jax.random.PRNGKey(seed))
    model = tf.Forecaster(config.ModelConfig(**dataclasses.asdict(model_cfg)), obs_len,
                          pred_len, device="cpu", state=from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, model


def rollout_errors(a, b, mask):
    """Largest |a - b| over each rollout's valid agents -> (K, B)."""
    d = np.where(mask[None, :, :, None, None], np.abs(np.asarray(a) - np.asarray(b)), 0.0)
    return d.reshape(d.shape[0], d.shape[1], -1).max(-1)


def rows_past(got, want, rtol=ROW_RTOL):
    """Rows (the last axis) of ``got`` further than ``rtol`` of the largest
    |want| from ``want`` -> (rows past, rows, largest error of the others over
    that largest |want|)."""
    got, want = (np.asarray(a, np.float64).reshape(-1, np.shape(a)[-1]) for a in (got, want))
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max(-1) / scale
    past = err > rtol
    return int(past.sum()), len(err), float(err[~past].max()) if (~past).any() else 0.0


def synced_decoder_steps(jm, params, model, carry, xy_last, mask, mean, std, stream):
    """The decoder's steps from JAX's state, one at a time: at each step JAX's
    head, sample and ``_step`` and the port's, both from JAX's carry and
    positions; JAX's result carries on.  carry: JAX's (K*B, N, H) carry,
    stream: (gumbel, normal) as numpy -> per step ``rows_past`` of the new
    hidden state."""
    cfg = jm.cfg
    jstats, stats = JNormStats(mean, std), NormStats(mean, std)
    p = model.params()
    pd = tf._round_coder(p["dec"], tf._compute_dtype(model.cfg))
    tmask = torch.from_numpy(np.asarray(mask))
    xy, out = xy_last, []
    with torch.no_grad():
        for t in range(jm.pred_len):
            gum, nrm = stream[0][:, t], stream[1][:, t]
            dxy = jgmm.sample_from(jm._head(params, carry.h), gum, nrm)
            xy_new = xy + j_denormalize(dxy, jstats)
            nxt = j_step(params["dec"], cfg, carry, dxy, xy_new, mask)
            th, tc = (torch.from_numpy(np.array(a)) for a in (carry.h, carry.c))
            tdxy = gmm.sample_from(model._head(p, th), torch.from_numpy(gum),
                                   torch.from_numpy(nrm))
            txy = torch.from_numpy(np.array(xy)) + denormalize(tdxy, stats)
            got = tf._step(pd, model.cfg, Carry(th, tc), tdxy, txy, tmask)
            out.append(rows_past(got.h.numpy(), nxt.h))
            carry, xy = nxt, xy_new
    return out


def chip_inputs(B=25, N=64, TO=8, TP=12):
    """chip_smoke.py's bench inputs: numpy seed 0."""
    rng = np.random.default_rng(0)
    steps = rng.normal(size=(B, N, TO + TP, 2)).astype(np.float32) * 0.4
    xy = np.cumsum(steps, axis=2) + rng.normal(size=(B, N, 1, 2)).astype(np.float32) * 5
    mask = rng.random((B, N)) < 0.75
    return xy[:, :, :TO], mask


def one_ulp_up(a):
    """``a`` moved one float32 ulp up: a perturbation of float32 rounding's size."""
    a = np.asarray(a, np.float32)
    return np.nextafter(a, np.float32(np.inf))


def rollout_divergence(K=20, TO=8, TP=12):
    """Config 4 at full width on JAX's stream: rollouts past ROLLOUT_TOL of
    500 with their median and largest errors, and best-of-K ADE and FDE, for
    the port against JAX, JAX's attend-kernel route against its plain one,
    and JAX on observations one float32 ulp apart, in float32 and bf16; under
    bf16 also route A's split (a bf16 encoder, the float32 decoder), and the
    decoder's steps from JAX's state (``synced_decoder_steps``)."""
    from mmtraj.metrics import best_of_k

    xy_obs, mask = chip_inputs(TO=TO, TP=TP)
    B, N = mask.shape
    rng = np.random.default_rng(1)
    gt = xy_obs[:, :, -1:] + np.cumsum(rng.normal(size=(B, N, TP, 2)).astype(np.float32) * 0.4, 2)
    mean, std = np.zeros(2, np.float32), np.full(2, 0.4, np.float32)
    jstats, stats = JNormStats(mean, std), NormStats(mean, std)
    key = jax.random.PRNGKey(3)
    rows = {}

    def record(label, got, want):
        e = rollout_errors(got, want, mask)
        (ade, fde), (ade_w, fde_w) = best_of_k(got, gt, mask), best_of_k(want, gt, mask)
        rows[label] = {"past": int((e > ROLLOUT_TOL).sum()), "of": e.size,
                       "median_m": float(np.median(e)), "max_m": float(e.max()),
                       "d_ade_m": abs(float(ade) - float(ade_w)),
                       "d_fde_m": abs(float(fde) - float(fde_w))}

    for dtype in ("float32", "bfloat16"):
        mc = dataclasses.replace(jconfig.config4().model, dtype=dtype)
        jm, params, model = jax_and_port(mc, TO, TP)
        want = np.asarray(jm.rollout_k(params, xy_obs, mask, jstats, key, K))
        stream = tuple(np.array(a) for a in jm._rollout_stream(key, K * B, N))
        record(f"{dtype}: port vs JAX",
               model.rollout_k(xy_obs, mask, stats, K, stream=stream).numpy(), want)
        jb = JForecaster(dataclasses.replace(mc, attend_kernel="pallas"), TO, TP)
        record(f"{dtype}: JAX attend route vs JAX plain",
               np.asarray(jb.rollout_k(params, xy_obs, mask, jstats, key, K)), want)
        record(f"{dtype}: JAX on observations one ulp apart",
               np.asarray(jm.rollout_k(params, one_ulp_up(xy_obs), mask, jstats, key, K)), want)
        if dtype != "bfloat16":
            continue
        # Route A's split: JAX's bf16 encoder, then its float32 decoder,
        # against the port's.
        f32 = JForecaster(dataclasses.replace(mc, dtype="float32"), TO, TP)
        carry = jm.encode(params, xy_obs, mask, jstats)
        want = np.asarray(f32.rollout_k(params, xy_obs, mask, jstats, key, K, carry=carry))
        f32_port = tf.Forecaster(dataclasses.replace(model.cfg, dtype="float32"), TO, TP,
                                 device="cpu", state=model.state_dict())
        with torch.no_grad():
            tcarry = model.encode(xy_obs, mask, stats)
        split = f32_port.rollout_k(xy_obs, mask, stats, K, carry=tcarry, stream=stream).numpy()
        record("bfloat16: route A's split (bf16 encoder, float32 decoder), port vs JAX", split,
               want)
        record("bfloat16: route A's split against the bf16 plain route, port", split,
               model.rollout_k(xy_obs, mask, stats, K, stream=stream).numpy())
        past, n_rows, others = rows_past(tcarry.h.numpy(), carry.h)
        rows["bfloat16: encoder's carry h, port vs JAX, rows past 1e-5"] = {
            "past": past, "of": n_rows, "others_max": others}

        def tile(a):
            return np.tile(np.asarray(a), (K,) + (1,) * (np.ndim(a) - 1))

        steps = synced_decoder_steps(jm, params, model, JCarry(tile(carry.h), tile(carry.c)),
                                     tile(xy_obs[:, :, -1]), tile(mask), mean, std, stream)
        rows["bfloat16: decoder steps from JAX's state, rows past 1e-5"] = [
            {"past": p_, "of": n_, "others_max": o_} for p_, n_, o_ in steps]
    return rows


def gradient_divergence(mc, xy, mask, mean, std):
    """One nll step's gradients at ``mc`` (a JAX ModelConfig): per leaf the
    largest error over the leaf's largest |gradient|, for the port against
    JAX's jitted gradients, for JAX with the agents permuted (the same math,
    another float32 order) and for JAX run op by op (``jax.disable_jit``, no
    fusion) against them."""
    from mmtraj_torch.params import flatten

    To = xy.shape[2] // 2
    jm, params, model = jax_and_port(mc, To, xy.shape[2] - To, 1)
    jstats = JNormStats(mean, std)

    def grad(w, m):
        return jax.grad(lambda p: jm.loss(p, w, m, jstats)[0])(params)

    want = flatten(jax.tree.map(np.asarray, jax.jit(grad)(xy, mask)))
    perm = np.random.default_rng(0).permutation(xy.shape[1])
    permuted = flatten(jax.tree.map(np.asarray, jax.jit(grad)(xy[:, perm], mask[:, perm])))
    with jax.disable_jit():
        unfused = flatten(jax.tree.map(np.asarray, grad(xy, mask)))
    model.loss(torch.from_numpy(xy), torch.from_numpy(mask), NormStats(mean, std)).backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    return {k: {"port_vs_jax": rel(got[k], want[k]),
                "jax_agents_permuted": rel(permuted[k], want[k]),
                "jax_op_by_op": rel(unfused[k], want[k])} for k in sorted(want)}


def main() -> None:
    torch.set_num_threads(4)
    out = {"rollouts": rollout_divergence()}
    rng = np.random.default_rng(7)
    xy = np.cumsum(rng.normal(size=(4, 8, 8, 2)).astype(np.float32) * 0.3, axis=2)
    mask = rng.random((4, 8)) < 0.8
    mean, std = np.array([0.02, -0.01], np.float32), np.array([0.3, 0.35], np.float32)
    for encoder in ("rnn", "attn"):
        for dtype in ("float32", "bfloat16"):
            mc = dataclasses.replace(jconfig.config4().model, hidden_dim=16, embed_dim=16,
                                     num_heads=2, encoder=encoder, dtype=dtype)
            g = gradient_divergence(mc, xy, mask, mean, std)
            out[f"gradients, {dtype} {encoder} (hidden 16, B 4, N 8, obs 4 + pred 4)"] = {
                key: max(v[key] for v in g.values())
                for key in ("port_vs_jax", "jax_agents_permuted", "jax_op_by_op")}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
