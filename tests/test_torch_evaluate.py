"""The port's evaluator slice against the JAX package, on the CPU.

Leaves: ``gmm.nll`` and ``mixture_mean`` (1e-5), ``collisions`` (exact
masks), ``miss_rate``.  The teacher-forced decode with its NLL on the plain
route and routes A and B (1e-5), and ``rollout_modes`` (1e-4 m).  The
per-window streams of the port: layout, ``draw_n`` prefix, seeds.  Then
``evaluate`` itself, fed through ``mmtraj_torch.evaluate.window_stream`` the
streams JAX's ``_per_window_stream`` draws for the same key chain, against
JAX ``evaluate`` under ``per_agent``, ``per_window``, ``oversample=2`` and
``rollout="modes"``: min-ADE/FDE and NLL within 1e-4 (float32 differences of
a few ulps; observed about 1e-8), rates and counts equal.  With the port's
own streams, batch-size invariance.  And the JAX guards, error for error.

On the CPU every kernel wrapper runs its plain version; the JAX routes run
their Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.collate import WindowDataset as JWindowDataset
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.data.transforms import normalize as j_normalize
from mmtraj.data.transforms import to_relative as j_to_relative
from mmtraj.evaluate import evaluate as j_evaluate
from mmtraj.metrics import collision_rate as j_collision_rate
from mmtraj.metrics import collisions as j_collisions
from mmtraj.metrics import miss_rate as j_miss_rate
from mmtraj.models import gmm as j_gmm
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch import evaluate as ev
from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.transforms import NormStats, normalize, to_relative
from mmtraj_torch.metrics import collision_rate, collisions, miss_rate
from mmtraj_torch.models import gat, gmm
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.ops import fused_attend, fused_decoder, fused_gat
from mmtraj_torch.params import from_jax
from torch_jax_streams import SMALL, TO, TP, jax_window_stream, random_windows

torch.set_num_threads(2)

ROUTES = {
    "plain": dict(),
    "A": dict(use_pallas=True, use_fused_decoder=True),
    "B": dict(attend_kernel="pallas"),
}
MEAN, STD = np.array([0.01, -0.02], np.float32), np.array([0.3, 0.35], np.float32)
LEAF = dict(atol=1e-5, rtol=1e-5)
METRIC_TOL = 1e-4
K = 3
COUNTS = [3, 1, 5, 2, 6, 4, 2, 3, 1, 6, 5, 2, 4]  # 13 windows, up to 6 agents of 8


@pytest.fixture(scope="module")
def setup():
    jm = JForecaster(JModelConfig(**SMALL), TO, TP)
    params = jm.init(jax.random.PRNGKey(0))
    model = Forecaster(ModelConfig(**SMALL), TO, TP, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    windows = random_windows(np.random.default_rng(3), COUNTS)
    return dict(jm=jm, params=params, model=model, windows=windows,
                jds=JWindowDataset(windows, 8), ds=WindowDataset(windows, 8))


def _with_route(jax_model, route):
    cfg = dataclasses.replace(jax_model.cfg, **ROUTES[route])
    return JForecaster(cfg, jax_model.obs_len, jax_model.pred_len)


def _port(setup, route):
    return Forecaster(ModelConfig(**SMALL, **ROUTES[route]), TO, TP, device="cpu",
                      state=setup["model"].state_dict())


def _full_windows(seed=0, b=3, n=8):
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(b, n, TO + TP, 2)).astype(np.float32) * 0.4
    xy = (np.cumsum(steps, axis=2) + rng.normal(size=(b, n, 1, 2)) * 2).astype(np.float32)
    mask = rng.random((b, n)) < 0.7
    mask[:, 0] = True
    return xy, mask


def _random_gmm(rng, lead, m=5):
    logits = rng.normal(size=lead + (m,)).astype(np.float32) * 2
    mu = rng.normal(size=lead + (m, 2)).astype(np.float32)
    sigma = np.exp(rng.normal(size=lead + (m, 2))).astype(np.float32) * 0.5 + 1e-3
    rho = np.tanh(rng.normal(size=lead + (m,))).astype(np.float32) * 0.99
    return logits, mu, sigma, rho


# -- leaves ---------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_gmm_nll_matches_jax(scale):
    """Targets near the components and far out in their tails."""
    rng = np.random.default_rng(1)
    leaves = _random_gmm(rng, (4, 6, 3))
    target = rng.normal(size=(4, 6, 3, 2)).astype(np.float32) * scale
    want = np.asarray(j_gmm.nll(j_gmm.GMMParams(*leaves), target))
    got = gmm.nll(gmm.GMMParams(*map(torch.from_numpy, leaves)), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), want, **LEAF)
    np.testing.assert_allclose(
        gmm.mixture_mean(gmm.GMMParams(*map(torch.from_numpy, leaves))).numpy(),
        np.asarray(j_gmm.mixture_mean(j_gmm.GMMParams(*leaves))), **LEAF)


def test_collisions_and_miss_rate_match_jax():
    rng = np.random.default_rng(2)
    preds = rng.uniform(0, 1.5, size=(4, 3, 7, TP, 2)).astype(np.float32)
    gt = rng.uniform(0, 3, size=(3, 7, TP, 2)).astype(np.float32)
    mask = rng.random((3, 7)) < 0.7
    got = collisions(torch.from_numpy(preds), torch.from_numpy(mask)).numpy()
    want = np.asarray(j_collisions(preds, mask))
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        collision_rate(torch.from_numpy(preds), torch.from_numpy(mask)).item(),
        float(j_collision_rate(preds, mask)), rtol=1e-6)
    for threshold in (0.5, 2.0):
        np.testing.assert_allclose(
            miss_rate(torch.from_numpy(preds), torch.from_numpy(gt), torch.from_numpy(mask),
                      threshold).item(),
            float(j_miss_rate(preds, gt, mask, threshold)), rtol=1e-6)


# -- teacher-forced decode and mode rollout ------------------------------------------

@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_teacher_and_nll_match_jax(route, setup):
    jm, params = _with_route(setup["jm"], route), setup["params"]
    xy, mask = _full_windows()
    jstats = JNormStats(MEAN, STD)
    dxy_n = j_normalize(j_to_relative(xy), jstats)[:, :, TO:]
    carry = jm.encode(params, xy[:, :, :TO], mask, jstats)
    outs = jm.decode_teacher(params, carry, xy[:, :, TO:], dxy_n, mask)
    want = np.asarray(j_gmm.nll(outs, dxy_n))

    model = _port(setup, route)
    stats = NormStats(MEAN, STD)
    txy, tmask = torch.from_numpy(xy), torch.from_numpy(mask)
    tdxy_n = normalize(to_relative(txy), stats)[:, :, TO:]
    with torch.no_grad():  # both are differentiable now; the evaluator records no graph
        got_outs = model.decode_teacher(model.encode(txy[:, :, :TO], tmask, stats),
                                        txy[:, :, TO:], tdxy_n, tmask)
    for got_leaf, want_leaf in zip(got_outs, outs):
        assert got_leaf.shape == want_leaf.shape
        np.testing.assert_allclose(got_leaf.numpy(), np.asarray(want_leaf), **LEAF)
    np.testing.assert_allclose(gmm.nll(got_outs, tdxy_n).numpy(), want, **LEAF)


@pytest.mark.parametrize("route", ["plain", "A"])
def test_rollout_modes_matches_jax(route, setup):
    jm, params = _with_route(setup["jm"], route), setup["params"]
    xy, mask = _full_windows(1)
    want = np.asarray(jm.rollout_modes(params, xy[:, :, :TO], mask, JNormStats(MEAN, STD)))
    got = _port(setup, route).rollout_modes(xy[:, :, :TO], mask, NormStats(MEAN, STD))
    assert got.shape == (5,) + xy[:, :, TO:].shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# -- the port's per-window streams ----------------------------------------------------

def test_per_window_stream_layout_and_draw_n_prefix(setup):
    """Row kk*B + b is window b's sample kk, drawn from its key alone; a
    stream drawn at draw_n and cut to N is the full stream's first N slots
    (mirrors tests/test_evaluate.py::test_per_window_stream_draw_n_is_prefix)."""
    model = setup["model"]
    keys = [11, 12, 13]
    g, n = model._per_window_stream(keys, 4, 8)
    assert g.shape == (12, TP, 8, 5) and n.shape == (12, TP, 8, 2)
    for b, key in enumerate(keys):
        g1, n1 = model._per_window_stream([key], 4, 8)
        torch.testing.assert_close(g[b::3], g1, atol=0, rtol=0)
        torch.testing.assert_close(n[b::3], n1, atol=0, rtol=0)
    g_cut, n_cut = model._per_window_stream(keys, 4, 3, draw_n=8)
    torch.testing.assert_close(g[:, :, :3], g_cut, atol=0, rtol=0)
    torch.testing.assert_close(n[:, :, :3], n_cut, atol=0, rtol=0)
    _, n_half = model._per_window_stream(keys, 4, 8, sigma_scale=0.5)
    torch.testing.assert_close(n_half, n * 0.5, atol=0, rtol=0)
    with pytest.raises(ValueError, match="draw_n"):
        model._per_window_stream(keys, 4, 8, draw_n=3)


def test_rollout_k_keys_draw_the_per_window_stream(setup):
    model = setup["model"]
    xy, mask = _full_windows(2)
    stats = NormStats(MEAN, STD)
    a = model.rollout_k(xy[:, :, :TO], mask, stats, K, keys=[5, 6, 7], sigma_scale=0.7)
    b = model.rollout_k(xy[:, :, :TO], mask, stats, K,
                        stream=model._per_window_stream([5, 6, 7], K, 8, 0.7))
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_window_seeds_differ_along_every_link_of_the_chain():
    chains = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 2, 0), (0, 0, 1), (0, 1, 1)]
    seeds = {ev.window_seed(*c, w) for c in chains for w in range(50)}
    assert len(seeds) == len(chains) * 50
    assert ev.window_seed(0, 0, 0, 3) == ev.window_seed(0, 0, 0, 3)


# -- evaluate ----------------------------------------------------------------------

def _assert_metrics_match(got, want):
    assert set(got) == set(want)
    for key in ("min_ade", "min_fde", "nll"):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])
    for key in set(want) - {"min_ade", "min_fde", "nll"}:
        assert got[key] == want[key], (key, got[key], want[key])


@pytest.mark.parametrize("protocol", [
    dict(), dict(reduction="per_window"), dict(oversample=2), dict(rollout="modes"),
], ids=["per_agent", "per_window", "oversample2", "modes"])
def test_evaluate_matches_jax_on_jax_streams(protocol, setup, monkeypatch):
    stats = JNormStats(np.zeros(2, np.float32), np.full(2, 0.3, np.float32))
    want = j_evaluate(setup["jm"], setup["params"], stats, setup["jds"], k=K, batch_size=4,
                      seed=0, **protocol)
    monkeypatch.setattr(ev, "window_stream", jax_window_stream(setup["jm"]))
    got = ev.evaluate(setup["model"], NormStats(*stats), setup["ds"], k=K, batch_size=4,
                      seed=0, **protocol)
    _assert_metrics_match(got, want)
    assert all(np.isfinite(got[key]) for key in ("min_ade", "min_fde", "nll"))


def test_evaluate_is_batch_size_invariant_on_its_own_streams(setup):
    """13 windows at batch 13, 4 (last batch padded) and 5: every window
    draws from its own seed, so the metrics agree."""
    stats = NormStats(np.zeros(2, np.float32), np.full(2, 0.3, np.float32))
    runs = [ev.evaluate(setup["model"], stats, setup["ds"], k=K, batch_size=bs, seed=0,
                        oversample=2) for bs in (13, 4, 5)]
    assert runs[0]["n_agents"] == sum(COUNTS) and runs[0]["n_windows"] == len(COUNTS)
    for other in runs[1:]:
        for key in ("min_ade", "min_fde", "miss_rate_2m", "collision_rate", "nll"):
            np.testing.assert_allclose(other[key], runs[0][key], rtol=1e-6, err_msg=key)
    moved = ev.evaluate(setup["model"], stats, setup["ds"], k=K, batch_size=4, seed=1)
    assert moved["min_ade"] != runs[0]["min_ade"]


@pytest.mark.parametrize("route, protocol, n_max, expect", [
    ("A", dict(), 8, {"fused_gat": TO + TP, "fused_decode": 1, "attend": 0}),
    ("A", dict(rollout="modes"), 8, {"fused_gat": TO + 2 * TP, "fused_decode": 0, "attend": 0}),
    ("plain", dict(), 128, {"fused_gat": 0, "fused_decode": 0, "attend": TO + TP}),
    ("plain", dict(), 8, {"fused_gat": 0, "fused_decode": 0, "attend": 0}),
], ids=["A", "A-modes", "auto-N128", "plain"])
def test_evaluate_batch_reaches_its_kernel_wrappers(route, protocol, n_max, expect, setup,
                                                    monkeypatch):
    """One batch: route A's encoder and teacher-forced decode run fused_gat
    at every step and the rollout is one fused_decode (the mode rollout's
    steps run fused_gat too); "auto" at N = 128 runs the attend kernel in the
    encoder and the rollout, never in the teacher-forced decode.  "auto"
    takes the kernel only for a CUDA tensor, so that rule is told the
    tensors are on CUDA; on the CPU every wrapper runs its plain version."""
    calls = dict.fromkeys(expect, 0)

    def spy(module, name):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    spy(fused_gat, "fused_gat")
    spy(fused_decoder, "fused_decode")
    spy(fused_attend, "attend")
    real_rule = gat.use_attend_kernel
    monkeypatch.setattr(gat, "use_attend_kernel",
                        lambda kernel, pallas, n, train, on_cuda: real_rule(kernel, pallas, n,
                                                                            train, True))
    ds = WindowDataset(setup["windows"][:4], n_max)
    m = ev.evaluate(_port(setup, route), NormStats(MEAN, STD), ds, k=K, batch_size=4,
                    **protocol)
    assert calls == expect
    assert np.isfinite(m["min_ade"]) and np.isfinite(m["nll"])


def _deterministic():
    return Forecaster(ModelConfig(**SMALL, head="deterministic"), TO, TP, device="cpu",
                      generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", [
    dict(reduction="bogus"), dict(rollout="bogus"), dict(oversample=0), dict(tta=0),
    dict(tta=2, rollout="modes"), dict(sigma_scale=0.5, rollout="modes"),
    dict(oversample=2, rollout="modes"), dict(ensemble=0), dict(ensemble=2, rollout="modes"),
    dict(head="deterministic", oversample=2), dict(head="deterministic", rollout="modes"),
    dict(head="deterministic", sigma_scale=0.5),
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_evaluate_guards_match_jax(case, setup):
    case = dict(case)
    n_members, head = case.pop("ensemble", None), case.pop("head", "gmm")
    jm, params, model = setup["jm"], setup["params"], setup["model"]
    if head != "gmm":
        jm = JForecaster(dataclasses.replace(jm.cfg, head=head), TO, TP)
        model = _deterministic()
    if n_members is not None:
        params, model = [params] * n_members, [model] * n_members
    stats = JNormStats(MEAN, STD)
    with pytest.raises(Exception) as want:
        j_evaluate(jm, params, stats, setup["jds"], k=K, batch_size=4, **case)
    with pytest.raises(want.type):
        ev.evaluate(model, NormStats(MEAN, STD), setup["ds"], k=K, batch_size=4, **case)


def test_evaluate_unported_options_raise(setup):
    """``mesh=`` takes a ``DeviceMesh`` (``mmtraj_torch.parallel.make_mesh``);
    anything else is a ``TypeError``."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        ev.evaluate(setup["model"], NormStats(MEAN, STD), setup["ds"], mesh=object())
    other = Forecaster(ModelConfig(**SMALL, num_mixtures=3), TO, TP, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="evaluate_mixed"):
        ev.evaluate([setup["model"], other], NormStats(MEAN, STD), setup["ds"])


def test_tta_mats_match_jax():
    from mmtraj.evaluate import _tta_mats as j_tta_mats

    for tta in (1, 2, 3, 4):
        np.testing.assert_allclose(np.array(ev._tta_mats(tta)), np.array(j_tta_mats(tta)),
                                   atol=0, rtol=0)
