"""The port's leaf math against the JAX package on the same numpy inputs.

Tolerance 1e-5 throughout: every function here is a handful of float32
operations (at most one product of width 16), so the two frameworks differ
only by summation order and libm rounding, a few ulps at these magnitudes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtraj.data import transforms as jtr
from mmtraj.graph.adjacency import proximity_adjacency as j_adjacency
from mmtraj.metrics import ade_fde as j_ade_fde
from mmtraj.metrics import best_of_k as j_best_of_k
from mmtraj.models import gmm as jgmm
from mmtraj.models.cells import Carry as JCarry
from mmtraj.models.cells import cell_apply as j_cell_apply
from mmtraj.models.layers import dense as j_dense
from mmtraj.models.layers import masked_softmax as j_masked_softmax
from mmtraj_torch import metrics
from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data import transforms
from mmtraj_torch.graph.adjacency import proximity_adjacency
from mmtraj_torch.models import gmm
from mmtraj_torch.models.cells import Carry, cell_apply
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.models.gat import use_attend_kernel
from mmtraj_torch.models.layers import dense, masked_softmax

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_dense_and_masked_softmax():
    rng = np.random.default_rng(1)
    x, w, b = _f32(rng, 3, 5, 16), _f32(rng, 16, 12), _f32(rng, 12)
    _close(dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x)),
           j_dense({"w": w, "b": b}, x))
    logits = _f32(rng, 4, 6, 6, scale=3.0)
    mask = rng.random((4, 6, 6)) < 0.5
    mask[0, 0] = False  # a row with no valid entry gives zeros
    got = masked_softmax(torch.from_numpy(logits), torch.from_numpy(mask))
    _close(got, j_masked_softmax(logits, mask))
    assert np.all(got.numpy()[0, 0] == 0.0)


def test_gru_cell_apply():
    rng = np.random.default_rng(2)
    E, H = 16, 16
    p = {"wx": _f32(rng, E, 3 * H, scale=0.3), "wh": _f32(rng, H, 3 * H, scale=0.3),
         "b": _f32(rng, 3 * H, scale=0.1)}
    x, h = _f32(rng, 2, 8, E), _f32(rng, 2, 8, H)
    want = j_cell_apply(p, "gru", x, JCarry(h=h, c=np.zeros_like(h)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = cell_apply(tp, "gru", torch.from_numpy(x), Carry(torch.from_numpy(h), None))
    _close(got.h, want.h)


@pytest.mark.parametrize("radius", [4.0, 1.5, 0.0, -1.0])
def test_proximity_adjacency(radius):
    rng = np.random.default_rng(3)
    xy = _f32(rng, 3, 8, 2, scale=3.0)
    mask = rng.random((3, 8)) < 0.75
    got = proximity_adjacency(torch.from_numpy(xy), torch.from_numpy(mask), radius)
    want = np.asarray(j_adjacency(jnp.asarray(xy), jnp.asarray(mask), radius))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[:, np.arange(8), np.arange(8)].any()  # no self-loops


def test_gmm_head_apply_and_sample_from():
    rng = np.random.default_rng(4)
    H, M = 16, 5
    p = {"w": _f32(rng, H, 6 * M, scale=2.0), "b": _f32(rng, 6 * M)}
    h = _f32(rng, 2, 8, H, scale=3.0)  # wide raw range: softplus far from 0
    want = jgmm.head_apply(p, h, M, 1e-3, 0.99)
    got = gmm.head_apply({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(h), M, 1e-3, 0.99)
    for g, w in zip(got, want):
        _close(g, w)
    gumbel, z = _f32(rng, 2, 8, M), _f32(rng, 2, 8, 2)
    gumbel[0, 0] = -want.logits[0, 0]  # an exact tie over all M: the first wins
    _close(gmm.sample_from(got, torch.from_numpy(gumbel), torch.from_numpy(z)),
           jgmm.sample_from(want, gumbel, z))


def test_softplus_keeps_the_log_form_above_20():
    x = torch.tensor([25.0, -30.0, 0.0])
    _close(gmm.softplus(x), np.logaddexp(x.numpy(), 0.0))


def test_transforms():
    rng = np.random.default_rng(5)
    xy = _f32(rng, 2, 8, 8, 2, scale=2.0)
    stats = transforms.NormStats(np.array([0.1, -0.2], np.float32),
                                 np.array([0.4, 0.5], np.float32))
    jstats = jtr.NormStats(stats.mean, stats.std)
    rel = transforms.to_relative(torch.from_numpy(xy))
    _close(rel, jtr.to_relative(jnp.asarray(xy)))
    _close(transforms.normalize(rel, stats), jtr.normalize(jtr.to_relative(jnp.asarray(xy)), jstats))
    _close(transforms.denormalize(rel, stats), jtr.denormalize(jnp.asarray(rel.numpy()), jstats))


def test_metrics():
    rng = np.random.default_rng(6)
    preds, gt = _f32(rng, 4, 2, 8, 12, 2), _f32(rng, 2, 8, 12, 2)
    mask = rng.random((2, 8)) < 0.75
    tp, tg, tm = map(torch.from_numpy, (preds, gt, mask))
    for got, want in zip(metrics.best_of_k(tp, tg, tm), j_best_of_k(preds, gt, mask)):
        _close(got, want)
    for got, want in zip(metrics.ade_fde(tp[0], tg, tm), j_ade_fde(preds[0], gt, mask)):
        _close(got, want)


def test_attend_dispatch_rule():
    assert use_attend_kernel("pallas", False, 8, False, on_cuda=False)
    assert not use_attend_kernel("pallas", True, 8, False, on_cuda=True)  # whole layer wins
    assert not use_attend_kernel("xla", False, 256, False, on_cuda=True)
    assert use_attend_kernel("auto", False, 128, False, on_cuda=True)
    assert not use_attend_kernel("auto", False, 64, False, on_cuda=True)
    assert not use_attend_kernel("auto", False, 128, True, on_cuda=True)  # differentiated
    assert not use_attend_kernel("auto", False, 128, False, on_cuda=False)
    with pytest.raises(ValueError):
        use_attend_kernel("fast", False, 64, False, on_cuda=False)


@pytest.mark.parametrize("change", [dict(dtype="bfloat16")])
def test_unsupported_config_raises(change):
    cfg = dataclasses.replace(ModelConfig(hidden_dim=16, embed_dim=16, num_heads=2), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Forecaster(cfg, 8, 12, device="cpu", generator=torch.Generator())


def test_unknown_encoder_raises_value_error():
    cfg = ModelConfig(hidden_dim=16, embed_dim=16, num_heads=2, encoder="transformer")
    with pytest.raises(ValueError, match="unknown encoder"):
        Forecaster(cfg, 8, 12, device="cpu", generator=torch.Generator())


def test_training_flags_and_imported_params_raise():
    """Training runs on the plain decoder: the fused decoder has no backward
    (ValueError, as in JAX).  Imported cell parameters are held to JAX in
    ``test_torch_lstm.py``."""
    cfg = ModelConfig(hidden_dim=16, embed_dim=16, num_heads=2, remat=True)
    model = Forecaster(cfg, 8, 12, device="cpu", generator=torch.Generator().manual_seed(0))
    xy, mask = torch.zeros(1, 4, 8, 2), torch.ones(1, 4, dtype=torch.bool)
    stats = transforms.NormStats(np.zeros(2, np.float32), np.ones(2, np.float32))
    for kw in (dict(train=True), dict(remat=True)):
        assert model.rollout_k(xy, mask, stats, 2, **kw).shape == (2, 1, 4, 12, 2)
    assert model.rollout_k(xy, mask, stats, 2, train=True).requires_grad
    assert not model.rollout_k(xy, mask, stats, 2).requires_grad
    assert model.encode(xy, mask, stats, train=True).h.requires_grad
    fused = Forecaster(dataclasses.replace(cfg, use_fused_decoder=True), 8, 12, device="cpu",
                       state=model.state_dict())
    for kw in (dict(train=True), dict(remat=True)):
        with pytest.raises(ValueError, match="use_fused_decoder"):
            fused.rollout_k(xy, mask, stats, 2, **kw)
