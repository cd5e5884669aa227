"""Config 3 at full width, the port against the JAX package on the CPU: the
model, its rollouts, the variety loss and the evaluator.

Config 3 (``mmtraj/config.py:222-229``) is the model behind every quality
number of RESULTS.md: a GRU with the GMM head (M = 5) and a GAT of one head
of 64, hidden = embed = 64, N_max = 32, obs 8, pred 12; its recipe
(``RESULTS.md:14-20,55-72``) trains it with a 2 m adjacency radius and
dropout 0.1, among others (``tests/test_torch_config3_train.py`` holds the
training side).  Each piece runs at config 3's widths (batches and K cut
small, the CPU pays for them) from the same numpy inputs, parameters and
random draws:

- ``proximity_adjacency`` at radius 2, exactly;
- ``rollout_k`` on the plain route and routes A and B, at radius 2 and 4,
  fed the stream JAX's ``_rollout_stream`` draws (1e-4 m, as
  ``tests/test_torch_forecaster.py``);
- ``loss_variety`` with n = 8 and JAX's dropout masks (loss 1e-5 relative,
  gradients 1e-4 relative and 1e-6 absolute, as
  ``tests/test_torch_train_step.py``);
- ``evaluate`` with ``oversample=6`` and a 2-member ensemble at K = 20, fed
  JAX's per-window streams: min-ADE/FDE and NLL within 1e-6, rates and
  counts equal.  The metrics are float32 sums of values near 1, whose ulp
  is about 6e-8, so 1e-6 is a few ulps (observed: 5.5e-8 ADE, 1.1e-8 FDE,
  3.5e-7 NLL at 3.7).

On the CPU every kernel wrapper runs its plain version; the JAX routes run
their Pallas kernels in interpret mode.
"""

import jax
import numpy as np
import pytest
import torch

from mmtraj.data.collate import WindowDataset as JWindowDataset
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.evaluate import evaluate as j_evaluate
from mmtraj.graph.adjacency import proximity_adjacency as j_proximity_adjacency
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.models.forecaster import _dropout_masks as j_dropout_masks
from mmtraj_torch import evaluate as ev
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.graph.adjacency import proximity_adjacency
from mmtraj_torch.params import flatten
from torch_config3 import (GRAD, MEAN, METRIC_TOL, RECIPE_MODEL, ROUTES, STD, TO, TP, TRAJ, N,
                           jax_model, port_model, random_windows, recipe_jcfg)
from torch_jax_streams import jax_window_stream

torch.set_num_threads(2)


def test_adjacency_at_the_recipe_radius_matches_jax():
    xy, mask = random_windows(6, seed=1)
    for t in (0, TO - 1, TO + TP - 1):
        want = np.asarray(j_proximity_adjacency(xy[:, :, t], mask, 2.0))
        got = proximity_adjacency(torch.from_numpy(xy[:, :, t]), torch.from_numpy(mask), 2.0)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < (mask[:, :, None] & mask[:, None, :]).sum() - mask.sum()


@pytest.mark.parametrize("route, radius", [("plain", 2.0), ("A", 2.0), ("B", 2.0),
                                           ("plain", 4.0)])
def test_rollout_k_matches_jax(route, radius):
    """B = 3 windows, K = 4, from JAX's ``_rollout_stream``."""
    jcfg = recipe_jcfg(adjacency_radius=radius, **ROUTES[route])
    jm, params = jax_model(jcfg)
    xy, mask = random_windows(3)
    xy_obs = xy[:, :, :TO]
    key, k = jax.random.PRNGKey(11), 4
    want = np.asarray(jm.rollout_k(params, xy_obs, mask, JNormStats(MEAN, STD), key, k))
    gumbel, normal = jm._rollout_stream(key, k * 3, N)
    got = port_model(jcfg.model, params).rollout_k(
        torch.from_numpy(xy_obs), torch.from_numpy(mask), NormStats(MEAN, STD), k,
        stream=(np.array(gumbel), np.array(normal)))
    assert got.shape == (k, 3, N, TP, 2)
    np.testing.assert_allclose(got.numpy(), want, **TRAJ)


@pytest.mark.parametrize("route", ["plain", "use_pallas"])
def test_loss_variety_and_gradients_match_jax(route):
    """n = 8 rollouts of B = 3 windows, encoder dropout 0.1 from JAX's
    ``_dropout_masks``, the rollouts from JAX's stream."""
    jcfg = recipe_jcfg(**RECIPE_MODEL, **({"use_pallas": True} if route == "use_pallas" else {}))
    jm, params = jax_model(jcfg, seed=2)
    xy, mask = random_windows(3, seed=2)
    key, drop_key, n = jax.random.PRNGKey(5), jax.random.PRNGKey(6), 8
    stats = JNormStats(MEAN, STD)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss_variety(p, xy, mask, stats, key, n, drop_key=drop_key))(params)
    drop_enc = {k: torch.from_numpy(np.array(v))
                for k, v in j_dropout_masks(drop_key, jm.cfg, 3, N)[0].items()}
    stream = tuple(np.array(a) for a in jm._rollout_stream(key, n * 3, N))
    model = port_model(jcfg.model, params)
    loss = model.loss_variety(xy, mask, NormStats(MEAN, STD), stream, n, drop=drop_enc)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    for k_, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k_], **GRAD, err_msg=k_)


@pytest.fixture(scope="module")
def eval_setup():
    jcfg = recipe_jcfg(**RECIPE_MODEL)
    jm = JForecaster(jcfg.model, TO, TP)
    params = [jm.init(jax.random.PRNGKey(s)) for s in (0, 7)]
    models = [port_model(jcfg.model, p) for p in params]
    rng = np.random.default_rng(8)
    windows = []
    for n in (5, 17, 32, 9, 24):
        w = np.cumsum(rng.normal(size=(n, TO + TP, 2)).astype(np.float32) * 0.3, axis=1)
        windows.append((w + rng.normal(size=(n, 1, 2)) * 1.5).astype(np.float32))
    return dict(jm=jm, params=params, models=models, jds=JWindowDataset(windows, N),
                ds=WindowDataset(windows, N))


@pytest.mark.parametrize("protocol", ["oversample6", "ensemble2"])
def test_evaluate_matches_jax_on_jax_streams(protocol, eval_setup, monkeypatch):
    """K = 20 at config 3's evaluate batch rule, 5 windows of up to 32
    agents: oversample 6 pools 120 candidates a window, the ensemble 40."""
    s = eval_setup
    ensemble = protocol == "ensemble2"
    params = s["params"] if ensemble else s["params"][0]
    models = s["models"] if ensemble else s["models"][0]
    kw = dict(k=20, batch_size=2, seed=0, **({} if ensemble else {"oversample": 6}))
    want = j_evaluate(s["jm"], params, JNormStats(MEAN, STD), s["jds"], **kw)
    monkeypatch.setattr(ev, "window_stream", jax_window_stream(s["jm"]))
    got = ev.evaluate(models, NormStats(MEAN, STD), s["ds"], **kw)
    assert set(got) == set(want)
    for key in ("min_ade", "min_fde", "nll"):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])
    for key in set(want) - {"min_ade", "min_fde", "nll"}:
        assert got[key] == want[key], (key, got[key], want[key])
    assert ev.vmem_friendly_batch(20, N) == 64  # config 3's evaluate batch
