"""The remat policies of the port (``maybe_remat``) against the JAX package's,
on the CPU.

Policies change what the backward pass recomputes, never the math: for
remat off, "full", "dots" and "dots_no_batch" the port's loss and every
gradient leaf equal JAX's (``tests/test_models.py::test_remat_matches_no_remat``)
within 1e-5 and 1e-4 relative.  A ``TorchDispatchMode`` spy counts the
matrix products the backward pass runs: with a policy it runs the
gradients' own products plus what it recomputes, so against remat off
"full" recomputes every product of the checkpointed bodies, "dots" none
and "dots_no_batch" only the batched ones (``bmm``).  The kernels'
``autograd.Function``s are no aten op; every policy recomputes them, which
``test_torch_train_step.py`` counts.
"""

import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models import layers
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import flatten, from_jax
from torch_jax_streams import SMALL, TO, TP, random_windows

torch.set_num_threads(2)

MEAN = np.array([0.02, -0.01], np.float32)
STD = np.array([0.3, 0.35], np.float32)
POLICIES = {"off": dict(remat=False), "full": dict(remat=True, remat_policy="full"),
            "dots": dict(remat=True, remat_policy="dots"),
            "dots_no_batch": dict(remat=True, remat_policy="dots_no_batch")}
ENCODERS = {"rnn": dict(), "attn": dict(encoder="attn")}
PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}


def _batch():
    rng = np.random.default_rng(11)
    counts = [6, 3, 5]
    xy = np.zeros((len(counts), 6, TO + TP, 2), np.float32)
    mask = np.zeros((len(counts), 6), bool)
    for b, w in enumerate(random_windows(rng, counts)):
        xy[b, :len(w)] = w + rng.normal(size=(1, 1, 2)).astype(np.float32)
        mask[b, :len(w)] = True
    return xy, mask


def _port_model(policy, encoder, params):
    cfg = ModelConfig(**SMALL, **POLICIES[policy], **ENCODERS[encoder])
    return Forecaster(cfg, TO, TP, device="cpu", state=from_jax(params))


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_remat_policy_loss_and_gradients_match_jax(policy, encoder):
    jcfg = JModelConfig(**SMALL, **POLICIES[policy], **ENCODERS[encoder])
    jm = JForecaster(jcfg, TO, TP)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    xy, mask = _batch()
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, xy, mask, JNormStats(MEAN, STD))[0])(params)
    model = _port_model(policy, encoder, params)
    loss = model.loss(torch.from_numpy(xy), torch.from_numpy(mask), NormStats(MEAN, STD))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=1e-4, atol=1e-6, err_msg=k)


class _ProductSpy(TorchDispatchMode):
    """Counts the matrix products dispatched, apart those run inside a
    checkpointed body's forward (``inside``)."""

    def __init__(self):
        super().__init__()
        self.counts, self.inside, self.depth = Counter(), Counter(), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in PRODUCTS:
            (self.inside if self.depth else self.counts)[name] += 1
        return func(*args, **(kwargs or {}))


def _products(policy, encoder, monkeypatch):
    """(products inside the checkpointed bodies' forward, products of the
    backward) of one loss."""
    params = jax.tree.map(np.asarray, JForecaster(
        JModelConfig(**SMALL, **ENCODERS[encoder]), TO, TP).init(jax.random.PRNGKey(2)))
    model = _port_model(policy, encoder, params)
    xy, mask = (torch.from_numpy(a) for a in _batch())
    fwd = _ProductSpy()
    real = layers.checkpoint

    def tagged(body, *args, **kw):
        fwd.depth += 1
        try:
            return real(body, *args, **kw)
        finally:
            fwd.depth -= 1

    monkeypatch.setattr(layers, "checkpoint", tagged)
    # Recompute each body whole: by default the recomputation stops once it
    # has what the backward reads, short of a last product (the attention
    # layer's MLP output) whose value no gradient needs.
    with fwd, set_checkpoint_early_stop(False):
        loss = model.loss(xy, mask, NormStats(MEAN, STD))
    with _ProductSpy() as bwd:
        loss.backward()
    return fwd.inside, bwd.counts


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_policy_recomputes_the_products_it_should(policy, encoder, monkeypatch):
    """Against remat off, the backward runs again every product of the
    checkpointed bodies under "full", none under "dots" and the batched
    ones under "dots_no_batch"."""
    inside, bwd = _products(policy, encoder, monkeypatch)
    _, bwd_off = _products("off", encoder, monkeypatch)
    recomputed = Counter(bwd)
    recomputed.subtract(bwd_off)
    recomputed = {k: v for k, v in recomputed.items() if v}
    batched = {k: v for k, v in inside.items() if k in ("bmm", "baddbmm")}
    assert inside["mm"] > 0 and (encoder == "rnn" or batched), inside
    want = {"full": dict(inside), "dots": {}, "dots_no_batch": batched}[policy]
    assert recomputed == want, (inside, bwd, bwd_off)


def test_unknown_remat_policy_raises():
    model = Forecaster(dataclasses.replace(ModelConfig(**SMALL), remat=True, remat_policy="nope"),
                       TO, TP, device="cpu", generator=torch.Generator().manual_seed(0))
    xy, mask = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(ValueError, match="remat_policy"):
        model.loss(xy, mask, NormStats(MEAN, STD))
