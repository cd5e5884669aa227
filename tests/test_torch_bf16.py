"""``ModelConfig.dtype="bfloat16"`` in the port against the JAX package's, on
the CPU.

bf16 rounds the operands of the model's products to bf16 and keeps every
product's result float32 (``jnp.dot(..., preferred_element_type=float32)``).
The product of two bf16 values is exact in float32, so the two packages
differ by float32 summation order, as in float32, until a value that both
compute a few float32 ulps apart lies near a bf16 rounding boundary: they
round it one bf16 ulp (2^-8 relative) apart, a rounding flip, and every
later use of it differs at bf16's resolution.  Such a flip needs a value
that the two sides compute in another order and then round: none can occur
where the rounded operands are inputs.

How far flips carry (``torch_bf16_divergence.py``, config 4 at full width):
the JAX package's own plain and attend-kernel routes, the same math in
another float32 order, put 391 of 500 bf16 rollouts more than 1e-3 m apart
(float32: 0), and an agent permutation moves JAX's own bf16 gradients by up
to 3.7e-3 of a leaf's largest (float32: 4.8e-6).  So a bf16 rollout or
gradient of two implementations agrees elementwise only where no flip
intervened, and the tests hold the port to JAX where a flip cannot carry:

* leaves: within 1e-5 of the output's largest |value| of JAX's, and more
  than 1e-4 of it away from the port's own float32 result (the rounding
  happens); where the leaf rounds an intermediate it computed, at most 1% of
  its rows past that (the flips);
* a product's, a short recurrence's and four encoder steps' gradients:
  within 1e-5 of each leaf's largest |gradient| (the backward rounds where
  JAX's does);
* the decoder's and the encoder's steps, each from JAX's state: the new
  hidden state within 1e-5 of its largest |value| on all but 1% of rows;
* ``rollout_k``, K = 20, on JAX's stream: best-of-K ADE and FDE within
  1e-3 m of JAX's; route A (a bf16 encoder, the float32 decoder) also within
  1e-3 m on valid agents with at most 1% of (window, sample) rollouts past
  it;
* training: losses within 1e-4 relative, gradients within 1e-3 of each
  leaf's largest |gradient|; for the attention encoder within 2^-6 of it,
  since JAX's own jitted and op-by-op (``jax.disable_jit``) gradients are up
  to 8.6e-3 of it apart there (XLA's fusion drops some of the backward's bf16
  roundings, its excess precision);
* ``evaluate`` and ``cli eval --dtype bfloat16`` on JAX's per-window
  streams: metrics within 1e-3 m.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtraj import checkpoint as j_checkpoint
from mmtraj import cli as j_cli
from mmtraj import config as jconfig
from mmtraj.data.collate import WindowDataset as JWindowDataset
from mmtraj.data.parser import read_annotation_file as j_read_annotation_file
from mmtraj.data import transforms as jtr
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.data.windower import make_windows as j_make_windows
from mmtraj.evaluate import evaluate as j_evaluate
from mmtraj.models import attn_encoder as jae
from mmtraj.metrics import best_of_k as j_best_of_k
from mmtraj.models.cells import Carry as JCarry
from mmtraj.models.cells import cell_apply as j_cell_apply
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.models.forecaster import _step as j_step
from mmtraj.models.gat import gat_apply as j_gat_apply
from mmtraj.models.layers import dense as j_dense
from mmtraj.models.layers import mlp as j_mlp
from mmtraj.train import make_train_step as j_make_train_step
from mmtraj_torch import cli, config, train
from mmtraj_torch import evaluate as ev
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.metrics import best_of_k
from mmtraj_torch.models import attn_encoder
from mmtraj_torch.models import forecaster as tf
from mmtraj_torch.models.cells import Carry, cell_apply
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.models.gat import gat_apply
from mmtraj_torch.models.layers import dense, matmul, mlp
from mmtraj_torch.ops import fused_attend, fused_decoder, fused_gat
from mmtraj_torch.params import flatten, from_jax
from torch_bf16_divergence import rows_past, synced_decoder_steps
from torch_jax_streams import (SMALL, grad_keeper, jax_step_draws, jax_window_stream,
                               random_windows)

torch.set_num_threads(2)

BF16 = torch.bfloat16
LEAF_RTOL = 1e-5  # of the output's largest |value|
ROUNDED_RTOL = 1e-4  # bf16 must move the output at least this far from float32
MAX_FLIPPED = 0.01  # share of rows a rounding flip may move past LEAF_RTOL
ROLLOUT_TOL, MAX_DIVERGED = 1e-3, 0.01
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3
# The attention encoder's gradients: JAX's own jitted step and the same step
# run op by op (jax.disable_jit) are up to 8.6e-3 of a leaf's largest apart,
# because XLA drops some bf16 roundings of the backward's sums where it fuses
# them (torch_bf16_divergence.py).
ATTN_GRAD_RTOL = 2.0 ** -6
METRIC_TOL = 1e-3
MEAN, STD = np.array([0.02, -0.01], np.float32), np.array([0.3, 0.35], np.float32)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _check_leaf(got, want, f32, name="", flips=False):
    """bf16 within LEAF_RTOL of JAX's bf16, and away from float32.  ``flips``:
    the leaf rounds an intermediate it computed, so a rounding flip may move
    up to MAX_FLIPPED of its rows (the last axis) past LEAF_RTOL."""
    got, want, f32 = (np.asarray(a, np.float64) for a in (got, want, f32))
    past, rows, _ = rows_past(got, want, LEAF_RTOL)
    allowed = int(MAX_FLIPPED * rows) if flips else 0
    assert past <= allowed, f"{name}: {past} of {rows} rows past {LEAF_RTOL} of JAX's bf16"
    moved = np.abs(got - f32).max() / np.abs(want).max()
    assert moved > ROUNDED_RTOL, f"{name}: only {moved:.3e} from the float32 result"


# -- leaves ---------------------------------------------------------------------------

def test_dense_and_mlp():
    rng = np.random.default_rng(1)
    x = _f32(rng, 3, 50, 16)
    p = {"w": _f32(rng, 16, 48, scale=0.3), "b": _f32(rng, 48, scale=0.1)}
    tp = _torch_tree(p)
    got = dense(tp, torch.from_numpy(x), BF16)
    assert got.dtype == torch.float32
    _check_leaf(got, j_dense(p, x, jnp.bfloat16), dense(tp, torch.from_numpy(x)), "dense")
    mp = {f"l{i}": {"w": _f32(rng, a, b, scale=0.3), "b": _f32(rng, b, scale=0.1)}
          for i, (a, b) in enumerate(((16, 64), (64, 16)))}
    tmp = _torch_tree(mp)
    _check_leaf(mlp(tmp, torch.from_numpy(x), BF16), j_mlp(mp, x, jnp.bfloat16),
                mlp(tmp, torch.from_numpy(x)), "mlp", flips=True)


def test_matmul_rounds_the_operands_not_the_result():
    """The result is the float32 product of the rounded operands, to float32
    summation: no bf16 rounding of the output (what autocast would add)."""
    rng = np.random.default_rng(2)
    x, w = torch.from_numpy(_f32(rng, 40, 16)), torch.from_numpy(_f32(rng, 16, 24))
    got = matmul(x, w, BF16)
    want = x.to(BF16).double() @ w.to(BF16).double()
    assert (got.double() - want).abs().max() <= 1e-6 * want.abs().max()
    assert not torch.equal(got, got.to(BF16).float())
    with pytest.raises(ValueError, match="bfloat16"):
        matmul(x, w, torch.float16)


def _cell_params(kind, rng, din=16, h=16):
    g = 4 if kind == "lstm" else 3
    p = {"wx": _f32(rng, din, g * h, scale=0.3), "wh": _f32(rng, h, g * h, scale=0.3),
         "b": _f32(rng, g * h, scale=0.1)}
    if kind == "gru+bh":
        p["bh"] = _f32(rng, 3 * h, scale=0.1)
    if kind == "gru+wh_n":
        p["wh"] = p["wh"][:, :2 * h]
        p["wh_n"] = _f32(rng, h, h, scale=0.3)
    return p


@pytest.mark.parametrize("kind", ["gru", "lstm", "gru+bh", "gru+wh_n"])
def test_cell_apply(kind):
    rng = np.random.default_rng(3)
    p = _cell_params(kind, rng)
    x, h, c = _f32(rng, 4, 20, 16), _f32(rng, 4, 20, 16, scale=0.5), _f32(rng, 4, 20, 16)
    cell = kind.split("+")[0]
    want = j_cell_apply(p, cell, x, JCarry(h=h, c=c), jnp.bfloat16)
    tp = _torch_tree(p)
    args = (tp, cell, torch.from_numpy(x), Carry(torch.from_numpy(h), torch.from_numpy(c)))
    got, f32 = cell_apply(*args, BF16), cell_apply(*args)
    _check_leaf(got.h, want.h, f32.h, f"{kind} h", flips=kind == "gru+wh_n")
    if cell == "lstm":
        _check_leaf(got.c, want.c, f32.c, f"{kind} c")


def test_wh_n_rounds_the_reset_product_in_bf16():
    """Keras's reset-before GRU: r * h is a bf16 product, rounded before the
    candidate product, bit for bit as JAX rounds it."""
    rng = np.random.default_rng(4)
    r, h = _f32(rng, 6, 16), _f32(rng, 6, 16)
    want = np.asarray((jnp.asarray(r).astype(jnp.bfloat16)
                       * jnp.asarray(h).astype(jnp.bfloat16)).astype(jnp.float32))
    got = (torch.from_numpy(r).to(BF16) * torch.from_numpy(h).to(BF16)).float()
    np.testing.assert_array_equal(got.numpy(), want)


GAT_ROUTES = {"plain": dict(), "use_pallas": dict(use_pallas=True),
              "attend": dict(attend_kernel="pallas")}


@pytest.mark.parametrize("route", sorted(GAT_ROUTES))
def test_gat_apply(route):
    """Only h is rounded; on the CPU each kernel wrapper runs its plain
    version, JAX's Pallas kernels run in interpret mode."""
    rng = np.random.default_rng(5)
    b, n, d, heads = 3, 12, 16, 2
    p = {"wv": _f32(rng, d, d, scale=0.3), "a_src": _f32(rng, heads, d // heads),
         "a_dst": _f32(rng, heads, d // heads), "wo": _f32(rng, d, d, scale=0.3),
         "bo": _f32(rng, d, scale=0.1)}
    h = _f32(rng, b, n, d)
    adj = rng.random((b, n, n)) < 0.4
    mask = rng.random((b, n)) < 0.8
    want = j_gat_apply(p, h, adj, mask, heads, jnp.bfloat16, **GAT_ROUTES[route])
    args = (_torch_tree(p), torch.from_numpy(h), torch.from_numpy(adj), torch.from_numpy(mask),
            heads)
    _check_leaf(gat_apply(*args, BF16, **GAT_ROUTES[route]), want,
                gat_apply(*args, **GAT_ROUTES[route]), route)


def _attn_cfg(**change):
    return dataclasses.replace(jconfig.config4().model, **SMALL, encoder="attn", **change)


def test_temporal_mhsa():
    rng = np.random.default_rng(6)
    H = 16
    p = {k: _f32(rng, H, H, scale=0.4) for k in ("wq", "wk", "wv", "wo")}
    p["bo"] = _f32(rng, H, scale=0.1)
    x = _f32(rng, 2, 8, 8, H)
    want = jae._temporal_mhsa(p, x, 2, jnp.bfloat16)
    tp, tx = _torch_tree(p), torch.from_numpy(x)
    _check_leaf(attn_encoder._temporal_mhsa(tp, tx, 2, BF16), want,
                attn_encoder._temporal_mhsa(tp, tx, 2), "temporal mhsa", flips=True)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "use_pallas"])
def test_attn_encode(use_pallas):
    cfg = _attn_cfg(use_pallas=use_pallas)
    params = jae.attn_encoder_init(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(7)
    xy = np.cumsum(_f32(rng, 2, 8, 8, 2, scale=0.4), axis=2) + _f32(rng, 2, 8, 1, 2, scale=2)
    dxy = _f32(rng, 2, 8, 8, 2)
    mask = rng.random((2, 8)) < 0.8
    want = jae.attn_encode(params, cfg, xy, dxy, mask, compute_dtype=jnp.bfloat16)
    mc = config.ModelConfig(**dataclasses.asdict(cfg))
    args = (_torch_tree(params), mc, *(torch.from_numpy(a) for a in (xy, dxy, mask)))
    got = attn_encoder.attn_encode(*args, compute_dtype=BF16)
    assert got.dtype == torch.float32
    _check_leaf(got, want, attn_encoder.attn_encode(*args), "attn_encode", flips=True)


def _grads_close(got, want, name):
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= LEAF_RTOL, f"{name}: gradient {err:.3e} of its largest from JAX's"


def test_dense_gradients_round_as_jax():
    """JAX's transpose of a bf16 product: each operand's gradient computed in
    float32 and rounded to bf16 (then the bias's in float32)."""
    rng = np.random.default_rng(8)
    x, w, b, up = _f32(rng, 30, 16), _f32(rng, 16, 24), _f32(rng, 24), _f32(rng, 30, 24)
    want = jax.grad(lambda x_, w_, b_: (j_dense({"w": w_, "b": b_}, x_, jnp.bfloat16) * up).sum(),
                    argnums=(0, 1, 2))(x, w, b)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    out = dense({"w": leaves[1], "b": leaves[2]}, leaves[0], BF16)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(up))
    _grads_close(got, want, "dense")
    assert torch.equal(got[1], got[1].to(BF16).float())  # rounded to bf16


@pytest.mark.parametrize("once", [False, True], ids=["raw", "rounded_once"])
def test_recurrence_gradients_round_at_every_step(once):
    """Four GRU steps on one weight, as the encoder's steps use it: JAX casts
    the weight inside every step, so each step's weight gradient is rounded
    on its own and the steps add up in float32.  ``rounded_once``: the
    weights rounded once for the forward call (``layers.bf16_weight``, as
    ``Forecaster`` does) give the same gradients."""
    from mmtraj_torch.models.layers import bf16_weight

    rng = np.random.default_rng(9)
    p = _cell_params("gru", rng)
    xs, h0 = _f32(rng, 4, 6, 16), _f32(rng, 6, 16, scale=0.5)

    def j_run(p_):
        c = JCarry(h=h0, c=np.zeros_like(h0))
        for x in xs:
            c = j_cell_apply(p_, "gru", x, c, jnp.bfloat16)
        return jnp.sin(c.h).sum()

    want = jax.grad(j_run)(p)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tp = ({k: bf16_weight(v) if k in ("wx", "wh") else v for k, v in leaves.items()} if once
          else leaves)
    c = Carry(torch.from_numpy(h0), torch.zeros(6, 16))
    for x in xs:
        c = cell_apply(tp, "gru", torch.from_numpy(x), c, BF16)
    got = torch.autograd.grad(torch.sin(c.h).sum(), list(leaves.values()))
    _grads_close(got, [want[k] for k in leaves], f"gru recurrence ({'once' if once else 'raw'})")


def test_encoder_step_gradients_match_jax():
    """Four encoder steps (embedding, GRU, GAT residual) on weights rounded
    once for the call, against JAX's scan of its ``_step``: gradients of
    every encoder leaf within 1e-5 of its largest."""
    jmc = dataclasses.replace(jconfig.config4().model, **SMALL, dtype="bfloat16")
    jm = JForecaster(jmc, TO, TP)
    params = jm.init(jax.random.PRNGKey(1))
    model = Forecaster(config.ModelConfig(**dataclasses.asdict(jmc)), TO, TP, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(10)
    xy = np.cumsum(_f32(rng, 4, 8, 4, 2, scale=0.3), axis=2)
    dxy, up = _f32(rng, 4, 8, 4, 2), _f32(rng, 4, 8, 16)
    mask = rng.random((4, 8)) < 0.8

    def j_loss(pe):
        def body(c, x):
            return j_step(pe, jmc, c, x[0], x[1], mask), None

        c0 = JCarry(h=jnp.zeros((4, 8, 16)), c=jnp.zeros((4, 8, 16)))
        c, _ = jax.lax.scan(body, c0, (jnp.moveaxis(dxy, 2, 0), jnp.moveaxis(xy, 2, 0)))
        return (c.h * up).sum()

    want = flatten(jax.tree.map(np.asarray, jax.jit(jax.grad(j_loss))(params["enc"])))
    pe = tf._round_coder(model.params()["enc"], BF16)
    c = Carry(torch.zeros(4, 8, 16), torch.zeros(4, 8, 16))
    for t in range(4):
        c = tf._step(pe, model.cfg, c, torch.from_numpy(dxy[:, :, t]),
                     torch.from_numpy(xy[:, :, t]), torch.from_numpy(mask))
    (c.h * torch.from_numpy(up)).sum().backward()
    got = {k[len("enc."):]: p.grad for k, p in model.named_parameters() if k.startswith("enc.")}
    assert sorted(got) == sorted(want)
    _grads_close([got[k] for k in want], list(want.values()), "encoder steps")


# -- rollouts ---------------------------------------------------------------------------

B, N, K, TO, TP = 3, 8, 20, 8, 12
ROUTES = {"plain": dict(), "A": dict(use_pallas=True, use_fused_decoder=True)}


def _windows(seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(B, N, TO + TP, 2)).astype(np.float32) * 0.4
    xy = (np.cumsum(steps, axis=2) + rng.normal(size=(B, N, 1, 2)) * 2).astype(np.float32)
    mask = rng.random((B, N)) < 0.75
    mask[:, 0] = True
    return xy[:, :, :TO], mask


def _pair(encoder, route, dtype="bfloat16", seed=0):
    """The JAX model and its parameters, and the port's model on them."""
    jmc = dataclasses.replace(jconfig.config4().model, **SMALL, encoder=encoder, dtype=dtype,
                              **ROUTES[route])
    jm = JForecaster(jmc, TO, TP)
    params = jm.init(jax.random.PRNGKey(seed))
    model = Forecaster(config.ModelConfig(**dataclasses.asdict(jmc)), TO, TP, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, model


def _diverged(got, want, mask):
    """-> (largest error of the rollouts within ROLLOUT_TOL, rollouts past it)."""
    d = np.where(mask[None, :, :, None, None], np.abs(got - want), 0.0)
    per = d.reshape(d.shape[0], d.shape[1], -1).max(-1)
    return per[per <= ROLLOUT_TOL].max(), int((per > ROLLOUT_TOL).sum())


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("encoder", ["rnn", "attn"])
def test_rollout_k_matches_jax(encoder, route):
    """Best-of-K ADE and FDE within 1e-3 m of JAX's; on route A, whose
    decoder is float32, also every rollout within 1e-3 m but 1%; and away
    from the float32 model's rollouts."""
    jm, params, model = _pair(encoder, route)
    xy_obs, mask = _windows()
    key = jax.random.PRNGKey(3)
    jstats = JNormStats(MEAN, STD)
    want = np.asarray(jm.rollout_k(params, xy_obs, mask, jstats, key, K))
    stream = tuple(np.array(a) for a in jm._rollout_stream(key, K * B, N))
    got = model.rollout_k(torch.from_numpy(xy_obs), torch.from_numpy(mask), NormStats(MEAN, STD),
                          K, stream=stream).numpy()
    assert got.shape == (K, B, N, TP, 2) and np.isfinite(got).all()
    gt = xy_obs[:, :, -1:] + np.cumsum(
        np.random.default_rng(2).normal(size=(B, N, TP, 2)).astype(np.float32) * 0.4, axis=2)
    for g, w in zip(best_of_k(*(torch.from_numpy(a) for a in (got, gt, mask))),
                    j_best_of_k(want, gt, mask)):
        assert abs(float(g) - float(w)) <= METRIC_TOL, (float(g), float(w))
    if route == "A":
        err, n_bad = _diverged(got, want, mask)
        assert n_bad <= MAX_DIVERGED * K * B, f"{n_bad} of {K * B} rollouts past {ROLLOUT_TOL} m"
        assert err <= ROLLOUT_TOL
    _, _, f32 = _pair(encoder, route, "float32")
    f32_roll = f32.rollout_k(torch.from_numpy(xy_obs), torch.from_numpy(mask),
                             NormStats(MEAN, STD), K, stream=stream).numpy()
    assert np.abs(np.where(mask[None, :, :, None, None], got - f32_roll, 0)).max() > 1e-4


def test_encoder_and_decoder_steps_match_jax():
    """Each step from JAX's state, so that no rounding flip carries over: the
    encoder's 8 steps on the observations and the decoder's 12 sampled steps
    on JAX's stream, the new hidden state within 1e-5 of its largest |value|
    on all but 1% of rows."""
    jm, params, model = _pair("rnn", "plain")
    xy_obs, mask = _windows()
    jstats, stats = JNormStats(MEAN, STD), NormStats(MEAN, STD)
    dxy_n = np.asarray(jtr.normalize(jtr.to_relative(xy_obs), jstats))
    pe = tf._round_coder(model.params()["enc"], BF16)
    carry = JCarry(h=np.zeros((B, N, 16), np.float32), c=np.zeros((B, N, 16), np.float32))
    steps = []
    with torch.no_grad():
        for t in range(TO):
            nxt = j_step(params["enc"], jm.cfg, carry, dxy_n[:, :, t], xy_obs[:, :, t], mask)
            got = tf._step(pe, model.cfg, Carry(*(torch.from_numpy(np.array(a)) for a in carry)),
                           torch.from_numpy(dxy_n[:, :, t]), torch.from_numpy(xy_obs[:, :, t]),
                           torch.from_numpy(mask))
            steps.append(rows_past(got.h.numpy(), nxt.h))
            carry = nxt
    carry = jm.encode(params, xy_obs, mask, jstats)
    stream = tuple(np.array(a) for a in jm._rollout_stream(jax.random.PRNGKey(3), K * B, N))

    def tile(a):
        return np.tile(np.asarray(a), (K,) + (1,) * (np.ndim(a) - 1))

    steps += synced_decoder_steps(jm, params, model, JCarry(tile(carry.h), tile(carry.c)),
                                  tile(xy_obs[:, :, -1]), tile(mask), MEAN, STD, stream)
    assert len(steps) == TO + TP
    for t, (past, rows, others) in enumerate(steps):
        assert past <= MAX_FLIPPED * rows, f"step {t}: {past} of {rows} rows past {LEAF_RTOL}"
        assert others <= LEAF_RTOL


@pytest.mark.parametrize("encoder", ["rnn", "attn"])
def test_route_a_is_a_bf16_encoder_and_the_float32_decoder(encoder, monkeypatch):
    """Route A under bf16 runs the bf16 encoder, then ``fused_decode`` on the
    float32 parameters: equal to the bit to ``reference_decode`` (the
    kernel's plain version, which its wrapper runs on the CPU) of the bf16
    carry."""
    _, _, model = _pair(encoder, "A")
    xy_obs, mask = _windows(1)
    xy_t, mask_t, stats = torch.from_numpy(xy_obs), torch.from_numpy(mask), NormStats(MEAN, STD)
    stream = model._rollout_stream(K * B, N, torch.Generator().manual_seed(4))
    calls = []
    real = fused_decoder.fused_decode
    monkeypatch.setattr(fused_decoder, "fused_decode",
                        lambda *a, **kw: calls.append(a[5]) or real(*a, **kw))
    got = model.rollout_k(xy_t, mask_t, stats, K, stream=stream)
    assert len(calls) == 1
    p = model.params()
    # the float32 decoder parameters themselves, none rounded
    assert all(calls[0]["cell"][k] is p["dec"]["cell"][k] for k in p["dec"]["cell"])
    with torch.no_grad():
        carry = model.encode(xy_t, mask_t, stats)
        f32_carry = Forecaster(dataclasses.replace(model.cfg, dtype="float32"), TO, TP,
                               device="cpu", state=model.state_dict()).encode(xy_t, mask_t, stats)
        assert (carry.h - f32_carry.h).abs().max() > 1e-5  # the encoder ran in bf16
        M = model.cfg.num_mixtures
        hw, hb = fused_decoder.permute_head(p["head"]["w"], p["head"]["b"], M)
        want = fused_decoder.reference_decode(
            carry.h.repeat(K, 1, 1), xy_t[:, :, -1].repeat(K, 1, 1), mask_t.repeat(K, 1),
            *stream, p["dec"], hw, hb, num_heads=model.cfg.num_heads, num_mixtures=M,
            radius=model.cfg.adjacency_radius, sigma_min=model.cfg.sigma_min,
            rho_max=model.cfg.rho_max, stats_mean=MEAN, stats_std=STD)
    assert torch.equal(got.reshape(K * B, N, TP, 2), want.permute(0, 2, 1, 3))


def test_kernel_wrappers_are_called_as_in_float32(monkeypatch):
    """bf16 changes no route: route A calls ``fused_gat`` TO times and
    ``fused_decode`` once, the attend pin ``attend`` TO + TP times, as in
    float32 (the card's launch counts, chip_smoke.py phase 12)."""
    xy_obs, mask = _windows()
    counts = {}
    for module, name in ((fused_gat, "fused_gat"), (fused_decoder, "fused_decode"),
                         (fused_attend, "attend")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _r=real, **kw: (
            counts.__setitem__(_n, counts.get(_n, 0) + 1), _r(*a, **kw))[1])
    for change, want in ((ROUTES["A"], {"fused_gat": TO, "fused_decode": 1}),
                         (dict(attend_kernel="pallas"), {"attend": TO + TP})):
        for dtype in ("float32", "bfloat16"):
            mc = config.ModelConfig(**SMALL, dtype=dtype, **change)
            model = Forecaster(mc, TO, TP, device="cpu", generator=torch.Generator().manual_seed(0))
            counts.clear()
            model.rollout_k(xy_obs, mask, NormStats(MEAN, STD), 2)
            assert counts == want, (dtype, change, counts)


# -- training ---------------------------------------------------------------------------

TB, TN, SEED, STEP, VARIETY_N = 4, 8, 3, 5, 2
TTO, TTP = 4, 3


def _batch():
    rng = np.random.default_rng(7)
    xy = np.zeros((TB, TN, TTO + TTP, 2), np.float32)
    mask = np.zeros((TB, TN), bool)
    for b, w in enumerate(random_windows(rng, [8, 5, 3, 6], TTO + TTP)):
        xy[b, :len(w)] = w + rng.normal(size=(1, 1, 2)).astype(np.float32) * 2
        mask[b, :len(w)] = True
    return xy, mask


TRAIN_ROUTES = {"plain": dict(), "use_pallas": dict(use_pallas=True),
                "attn": dict(encoder="attn")}


@pytest.mark.parametrize("route", sorted(TRAIN_ROUTES))
@pytest.mark.parametrize("loss_mode", ["nll", "variety", "hybrid"])
def test_train_step_loss_and_gradients_match_jax(loss_mode, route, monkeypatch):
    """A step of ``make_train_step`` under bf16, with dropout and augment on,
    on JAX's draws; JAX's loss and gradients from its own step."""
    jmc = dataclasses.replace(jconfig.config4().model, **SMALL, remat=True, dropout=0.2,
                              dtype="bfloat16", **TRAIN_ROUTES[route])
    jm = JForecaster(jmc, TTO, TTP)
    params = jm.init(jax.random.PRNGKey(1))
    state = from_jax(jax.tree.map(np.asarray, params))
    xy, mask = _batch()
    kw = dict(augment_rotate=True, augment_flip=True, seed=SEED, loss_mode=loss_mode,
              variety_n=VARIETY_N, variety_weight=0.7, variety_fde_weight=0.5)
    keeper = grad_keeper()
    jstep = j_make_train_step(jm, keeper, JNormStats(MEAN, STD), **kw)
    _, jgrads, jloss = jstep(params, keeper.init(params), jnp.asarray(xy), jnp.asarray(mask),
                             jnp.int32(STEP))
    draws = jax_step_draws(jm)(None, SEED, STEP, TB, TN, True, True,
                               VARIETY_N if loss_mode != "nll" else 0)
    monkeypatch.setattr(train, "step_draws", lambda *a, **k: draws)
    mc = config.ModelConfig(**dataclasses.asdict(jmc))
    model = Forecaster(mc, TTO, TTP, device="cpu", state=state)
    step = train.make_train_step(model, train.make_optimizer(config.config4().replace(model=mc),
                                                             model),
                                 NormStats(MEAN, STD), **kw)
    loss = step(torch.from_numpy(xy), torch.from_numpy(mask), STEP)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    tol = ATTN_GRAD_RTOL if route == "attn" else GRAD_RTOL
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        err = np.abs(got[k].numpy() - want[k]).max() / scale
        assert err <= tol, f"{k}: {err:.3e} of its largest |gradient|"



# -- the evaluator and the eval command ----------------------------------------------------

ETO, ETP, EK = 4, 3, 3
COUNTS = [2, 6, 3, 8, 2, 5, 1, 4]


@pytest.fixture(scope="module")
def eval_setup():
    jmc = jconfig.ModelConfig(**SMALL, dtype="bfloat16")
    jm = JForecaster(jmc, ETO, ETP)
    params = jm.init(jax.random.PRNGKey(0))
    model = Forecaster(config.ModelConfig(**SMALL, dtype="bfloat16"), ETO, ETP, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    windows = random_windows(np.random.default_rng(5), COUNTS, ETO + ETP)
    return dict(jm=jm, params=params, model=model, jds=JWindowDataset(windows, 8),
                ds=WindowDataset(windows, 8))


@pytest.mark.parametrize("protocol", [dict(), dict(rollout="modes")], ids=["sample", "modes"])
def test_evaluate_matches_jax(protocol, eval_setup, monkeypatch):
    s = eval_setup
    want = j_evaluate(s["jm"], s["params"], JNormStats(MEAN, STD), s["jds"], k=EK, batch_size=4,
                      seed=0, **protocol)
    monkeypatch.setattr(ev, "window_stream", jax_window_stream(s["jm"]))
    got = ev.evaluate(s["model"], NormStats(MEAN, STD), s["ds"], k=EK, batch_size=4, seed=0,
                      **protocol)
    for key in ("min_ade", "min_fde", "nll"):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])
    assert got["n_agents"] == want["n_agents"] and got["n_windows"] == want["n_windows"]


_LINE = re.compile(r"([\w@.]+)=([-\d.]+)m?")


def _write_scene(path, rng, n_peds=7, n_frames=30):
    rows = []
    for ped in range(n_peds):
        start = int(rng.integers(0, n_frames - ETO - ETP))
        stop = int(rng.integers(start + ETO + ETP, n_frames + 1))
        xy = np.cumsum(rng.normal(size=(stop - start, 2)) * 0.3, axis=0) + rng.normal(size=2) * 2
        rows += [(10 * f, ped, *xy[f - start]) for f in range(start, stop)]
    with open(path, "w") as f:
        f.writelines(f"{fr}\t{p}\t{x:.4f}\t{y:.4f}\n" for fr, p, x, y in rows)


def test_cli_eval_dtype_bfloat16_prints_the_jax_line(eval_setup, tmp_path, monkeypatch, capsys):
    """A float32 checkpoint scored with ``--dtype bfloat16`` by both CLIs."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    _write_scene(data_dir / "zara1.txt", np.random.default_rng(11))
    ckpt = str(tmp_path / "ckpt.npz")
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**SMALL),
                          data=jconfig.DataConfig(data_dir=str(data_dir), scene="zara1",
                                                  obs_len=ETO, pred_len=ETP, n_max=8),
                          train=jconfig.TrainConfig(k_samples=EK))
    j_checkpoint.save_npz(ckpt, eval_setup["params"], JNormStats(MEAN, STD), jcfg, step=5)
    argv = ["eval", "--ckpt", ckpt, "--batch-size", "4", "--dtype", "bfloat16"]

    def load_eval_dataset(cfg, auto_n_max, context):
        assert cfg.model.dtype == "bfloat16"
        rows = j_read_annotation_file(str(data_dir / "zara1.txt"))
        return JWindowDataset(j_make_windows(rows, ETO, ETP), cfg.data.n_max), cfg.data.n_max

    monkeypatch.setenv("MMTRAJ_COMPILE_CACHE", "off")
    monkeypatch.setattr(j_cli, "_load_eval_dataset", load_eval_dataset)
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]

    seen = []
    real = ev.evaluate
    monkeypatch.setattr(ev, "evaluate", lambda model, *a, **kw: seen.append(model.cfg.dtype)
                        or real(model, *a, **kw))
    monkeypatch.setattr(ev, "window_stream", jax_window_stream(eval_setup["jm"]))
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert seen == ["bfloat16"]
    assert _LINE.sub("", got) == _LINE.sub("", want)
    got_nums, want_nums = dict(_LINE.findall(got)), dict(_LINE.findall(want))
    assert got_nums.keys() == want_nums.keys() and "ADE" in got_nums
    for key in ("ADE", "FDE"):
        assert abs(float(got_nums[key]) - float(want_nums[key])) <= METRIC_TOL, (got, want)


def test_train_bench_dtype_counts_the_float32_flops(capsys):
    """``train_bench --dtype bfloat16`` trains the bf16 model and counts the
    FLOPs of the plain float32 step: the same products."""
    from mmtraj_torch.benchmarks import train_bench

    kw = dict(n_max=8, iters=1, min_seconds=0, warmup=1, device="cpu")
    f32 = train_bench.bench_train_step(2, **kw)
    b16 = train_bench.bench_train_step(2, model_kw={"dtype": "bfloat16"}, **kw)
    assert f32.model == "config4" and b16.model == "dtype=bfloat16"
    assert b16.flops_per_step == f32.flops_per_step > 0
    assert b16.mfu is None  # no MFU on the CPU
    train_bench.main(["--dtype", "bfloat16", "--device", "cpu", "--batch", "2", "--n-max", "8",
                      "--iters", "1", "--min-seconds", "0"])
    assert "model=dtype=bfloat16" in capsys.readouterr().out
