"""The port's inference slice end to end against the JAX package.

``rollout_k`` on the plain route, route A (whole-layer GAT kernel plus the
fused rollout kernel) and route B (the attend kernel in every GAT call), fed
the stream that the JAX package's ``_rollout_stream(key, K*B, N)`` draws and
the JAX parameters through ``from_jax``, against JAX ``rollout_k`` under the
same key and flags.  On the CPU every kernel wrapper runs its plain version;
the JAX routes run their Pallas kernels in interpret mode.

Tolerance 1e-4 m on trajectories: float32 differences of a few ulps per
operation pass through 8 encoder steps, 12 recurrent decoder steps and the
position integration (observed max error 1.9e-6 to 2.9e-6 m at this size).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.metrics import best_of_k as j_best_of_k
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.metrics import best_of_k
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.ops import fused_attend, fused_decoder, fused_gat
from mmtraj_torch.params import from_jax

torch.set_num_threads(2)

B, N, K, TO, TP = 2, 8, 4, 8, 12
SMALL = dict(hidden_dim=16, embed_dim=16, num_heads=2)
ROUTES = {
    "plain": dict(),
    "A": dict(use_pallas=True, use_fused_decoder=True),
    "B": dict(attend_kernel="pallas"),
}
TRAJ = dict(atol=1e-4, rtol=1e-4)
MEAN, STD = np.array([0.01, -0.02], np.float32), np.array([0.4, 0.5], np.float32)


def _windows(seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(B, N, TO + TP, 2)).astype(np.float32) * 0.4
    xy = (np.cumsum(steps, axis=2) + rng.normal(size=(B, N, 1, 2)) * 2).astype(np.float32)
    mask = rng.random((B, N)) < 0.75
    mask[:, 0] = True
    return xy[:, :, :TO], xy[:, :, TO:], mask


@pytest.fixture(scope="module")
def jax_model():
    jm = JForecaster(JModelConfig(**SMALL), TO, TP)
    return jm, jm.init(jax.random.PRNGKey(0))


def _run_both(route, jax_model, xy_obs, mask, key_seed=3):
    jm, params = jax_model
    jm = JForecaster(dataclasses.replace(jm.cfg, **ROUTES[route]), TO, TP)
    key = jax.random.PRNGKey(key_seed)
    want = np.asarray(jm.rollout_k(params, xy_obs, mask, JNormStats(MEAN, STD), key, K))
    gumbel, normal = jm._rollout_stream(key, K * B, N)
    model = Forecaster(ModelConfig(**SMALL, **ROUTES[route]), TO, TP, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    got = model.rollout_k(torch.from_numpy(xy_obs), torch.from_numpy(mask),
                          NormStats(MEAN, STD), K,
                          stream=(np.array(gumbel), np.array(normal)))
    return model, got, want


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rollout_k_matches_jax(route, jax_model):
    xy_obs, gt, mask = _windows()
    _, got, want = _run_both(route, jax_model, xy_obs, mask)
    assert got.shape == (K, B, N, TP, 2)
    np.testing.assert_allclose(got.numpy(), want, **TRAJ)
    ade, fde = best_of_k(got, torch.from_numpy(gt), torch.from_numpy(mask))
    j_ade, j_fde = j_best_of_k(want, gt, mask)
    np.testing.assert_allclose([ade.item(), fde.item()], [j_ade, j_fde], **TRAJ)
    assert np.isfinite([ade.item(), fde.item()]).all()


@pytest.mark.parametrize("change", [
    dict(head="deterministic", num_heads=1), dict(gat_layers=2),
    dict(adjacency_radius=0.0), dict(social=False),
])
def test_plain_route_matches_jax_on_other_configs(change):
    """The plain route on configurations beside config 4's: deterministic
    head (no random stream), stacked GAT rounds, a fully connected graph,
    no social layer."""
    jcfg = dataclasses.replace(JModelConfig(**SMALL), **change)
    jm = JForecaster(jcfg, TO, TP)
    params = jm.init(jax.random.PRNGKey(4))
    xy_obs, _, mask = _windows(2)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jm.rollout_k(params, xy_obs, mask, JNormStats(MEAN, STD), key, K))
    model = Forecaster(ModelConfig(**dataclasses.asdict(jcfg)), TO, TP, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    stream = None
    if jcfg.head == "gmm":
        stream = tuple(np.array(a) for a in jm._rollout_stream(key, K * B, N))
    got = model.rollout_k(xy_obs, mask, NormStats(MEAN, STD), K, stream=stream)
    np.testing.assert_allclose(got.numpy(), want, **TRAJ)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_padded_agents_do_not_move_valid_outputs(route, jax_model):
    xy_obs, _, mask = _windows(1)
    model, base, _ = _run_both(route, jax_model, xy_obs, mask)
    noisy = xy_obs.copy()
    noisy[~mask] += np.random.default_rng(9).normal(size=noisy[~mask].shape).astype(np.float32) * 3
    gumbel, normal = model._rollout_stream(K * B, N, torch.Generator().manual_seed(0))
    stats = NormStats(MEAN, STD)
    a = model.rollout_k(xy_obs, mask, stats, K, stream=(gumbel, normal))
    b = model.rollout_k(noisy, mask, stats, K, stream=(gumbel, normal))
    torch.testing.assert_close(a[:, mask], b[:, mask], atol=1e-5, rtol=1e-5)
    assert base.shape == a.shape


@pytest.mark.parametrize("route, expect", [
    ("A", {"fused_gat": 8, "fused_decode": 1, "attend": 0}),
    ("B", {"fused_gat": 0, "fused_decode": 0, "attend": 20}),
    ("plain", {"fused_gat": 0, "fused_decode": 0, "attend": 0}),
])
def test_routes_call_their_kernel_wrappers(route, expect, monkeypatch):
    """Route A reaches the GAT wrapper once per observed frame and the
    rollout wrapper once; route B reaches the attend wrapper in every GAT
    call (8 encoder + 12 decoder steps)."""
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
    xy_obs, _, mask = _windows()
    model = Forecaster(ModelConfig(**SMALL, **ROUTES[route]), TO, TP, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    out = model.rollout_k(xy_obs, mask, NormStats(MEAN, STD), K,
                          generator=torch.Generator().manual_seed(1))
    assert calls == expect
    assert torch.isfinite(out).all()


def test_rollout_stream_distributions():
    model = Forecaster(ModelConfig(**SMALL), TO, TP, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    gumbel, normal = model._rollout_stream(64, 32, torch.Generator().manual_seed(2))
    assert gumbel.shape == (64, TP, 32, 5) and normal.shape == (64, TP, 32, 2)
    # Gumbel(0, 1): mean = Euler's gamma 0.5772, variance pi^2/6; ~123k draws.
    assert abs(gumbel.mean().item() - 0.5772) < 0.02
    assert abs(gumbel.var().item() - np.pi ** 2 / 6) < 0.05
    assert abs(normal.mean().item()) < 0.02 and abs(normal.std().item() - 1.0) < 0.02
    assert torch.isfinite(gumbel).all()
