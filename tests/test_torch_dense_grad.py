"""The weight gradient of the port's float32 dense products
(``mmtraj_torch/ops/dense_grad.py``), on the CPU.

- ``_DenseProduct`` against autograd of ``x @ w``: float64 ``gradcheck``
  and float32 gradients for 2-D, 3-D and 4-D x, din = 2 and dout = 30 among
  them; ``dense_product`` keeps the plain product outside ``torch.func.vmap``
  and where no gradient is recorded, and a sequential training step calls
  no op.
- Under ``torch.func.vmap`` over 5 lanes with their own weights (the
  Function), and with one shared weight (the plain product), the gradients
  against a loop over the lanes; the vmap rule of ``mmtraj::weight_grad``
  reaching ``weight_grad_lanes`` once for all lanes, a shared operand among
  them.
- The ops' schemas, fakes and vmap rule (``torch.library.opcheck``), their
  FLOPs under ``FlopCounterMode``, their counters in
  ``ops.launch_counters()``, and the launch ``plan`` at config 3's shapes.
- A config-3 recipe population step of 5 lanes: every lane's gradient
  against the same step with the products left to autograd (as before the
  kernel), within 1e-6 relative, and the calls a step makes of each op.

The CPU runs each op's plain version; ``tests/test_torch_gpu.py`` holds
the kernel to it on the card.
"""

import math
import warnings

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mmtraj_torch import population, train
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models import layers
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.ops import dense_grad, fused_gat
from torch_config3 import MEAN, RECIPE_MODEL, STD, TO, TP, port_config, random_windows, recipe_jcfg

torch.set_num_threads(2)

S = 5
SHAPES = [((7,), 4, 6), ((3, 7), 2, 64), ((2, 3, 7), 64, 30), ((5,), 64, 192)]


@pytest.fixture
def spies():
    """Counting CPU kernels of both ops -> their call counts."""
    calls = {"weight_grad": 0, "weight_grad_lanes": 0}

    def one(x, g):
        calls["weight_grad"] += 1
        return dense_grad.weight_grad_math(x, g)

    def lanes(x, g):
        calls["weight_grad_lanes"] += 1
        return x.transpose(1, 2) @ g

    lib = torch.library.Library("mmtraj", "IMPL")
    with warnings.catch_warnings():  # "Overriding a previously registered kernel"
        warnings.simplefilter("ignore", UserWarning)
        lib.impl("weight_grad", one, "CPU")
        lib.impl("weight_grad_lanes", lanes, "CPU")
    yield calls
    lib._destroy()


def _inputs(rows, din, dout, dtype=torch.float64, lanes=()):
    g = torch.Generator().manual_seed(din * 100 + dout)
    x = torch.randn(lanes + rows + (din,), generator=g, dtype=dtype, requires_grad=True)
    w = torch.randn(lanes + (din, dout), generator=g, dtype=dtype, requires_grad=True)
    return x, w


def _loss(product):
    return lambda w, x: (torch.tanh(product(x, w)) ** 2).sum()


@pytest.mark.parametrize("rows, din, dout", SHAPES)
def test_dense_product_gradients_equal_autograd_of_the_product(rows, din, dout, spies):
    x, w = _inputs(rows, din, dout)
    product = dense_grad._DenseProduct.apply
    assert torch.autograd.gradcheck(product, (x, w))
    x32, w32 = (t.detach().float().requires_grad_() for t in (x, w))
    spies["weight_grad"] = 0
    got = torch.autograd.grad(_loss(product)(w32, x32), (x32, w32))
    assert spies["weight_grad"] == 1
    want = torch.autograd.grad(_loss(torch.matmul)(w32, x32), (x32, w32))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)


def test_without_a_recorded_gradient_the_product_is_plain(spies):
    """No gradient, or no vmap lanes (a single product, whose weight
    gradient cuBLAS's mm computes as fast): the plain product, and no op
    call (under vmap: ``test_vmapped_lanes_equal_a_loop_over_lanes``)."""
    x, w = _inputs((3, 7), 64, 30, torch.float32)
    with torch.no_grad():
        got = dense_grad.dense_product(x, w)
    assert got.grad_fn is None and torch.equal(got, x.detach() @ w.detach())
    y = dense_grad.dense_product(x.detach(), w.detach())
    assert y.grad_fn is None
    y = dense_grad.dense_product(x, w)
    assert type(y.grad_fn).__name__ != "_DenseProductBackward" and torch.equal(y, x @ w)
    y.sum().backward()
    assert spies == {"weight_grad": 0, "weight_grad_lanes": 0}


def test_a_sequential_step_keeps_the_plain_products(spies):
    """A sequential config-3 recipe step (GRU, GAT, variety loss) records
    every gradient but calls neither op: its products are no vmap lanes."""
    cfg = port_config(recipe_jcfg(**RECIPE_MODEL, use_pallas=True))
    xy, mask = (torch.from_numpy(a) for a in random_windows(4, seed=6))
    model = Forecaster(cfg.model, TO, TP, device="cpu", generator=torch.Generator().manual_seed(0))
    t = cfg.train
    step = train.make_train_step(model, train.make_optimizer(cfg, model), NormStats(MEAN, STD),
                                 loss_mode=t.loss, variety_n=t.variety_n)
    loss = step(xy, mask, 0)
    assert torch.isfinite(torch.as_tensor(loss))
    assert all(p.grad is not None for p in model.parameters())
    assert spies == {"weight_grad": 0, "weight_grad_lanes": 0}


@pytest.mark.parametrize("rows, din, dout", SHAPES)
@pytest.mark.parametrize("shared", [False, True], ids=["own", "shared"])
def test_vmapped_lanes_equal_a_loop_over_lanes(rows, din, dout, shared, spies):
    x, w = _inputs(rows, din, dout, lanes=(S,))
    if shared:
        w = w[0].detach().requires_grad_()
    in_dims = (None if shared else 0, 0)
    torch.func.vmap(_loss(dense_grad.dense_product), in_dims=in_dims)(w, x).sum().backward()
    assert spies == {"weight_grad": 0, "weight_grad_lanes": 0 if shared else 1}
    got = (x.grad, w.grad)
    x.grad = w.grad = None
    sum(_loss(torch.matmul)(w if shared else w[s], x[s]) for s in range(S)).backward()
    for a, b in zip(got, (x.grad, w.grad)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("in_dims", [(None, 0), (0, None), (1, 0)])
def test_weight_grad_vmap_rule_equals_a_loop_in_one_call(in_dims, spies):
    """One ``weight_grad_lanes`` call for the lanes: a shared x or g is
    expanded to them, and a batched operand may carry its lanes on another
    axis (here x on axis 1)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 7, 4) if in_dims[0] is None else (3, S, 7, 4) if in_dims[0] == 1
                    else (S, 3, 7, 4), generator=gen, dtype=torch.float64)
    g = torch.randn((3, 7, 6) if in_dims[1] is None else (S, 3, 7, 6), generator=gen,
                    dtype=torch.float64)
    got = torch.func.vmap(dense_grad.weight_grad, in_dims=in_dims)(x, g)
    assert spies == {"weight_grad": 0, "weight_grad_lanes": 1}

    def lane(t, d, s):
        return t if d is None else t.select(d, s)

    want = torch.stack([dense_grad.weight_grad_math(lane(x, in_dims[0], s),
                                                    lane(g, in_dims[1], s)) for s in range(S)])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("op, args", [
    (torch.ops.mmtraj.weight_grad.default, ((3, 7, 2), (3, 7, 30))),
    (torch.ops.mmtraj.weight_grad_lanes.default, ((S, 21, 64), (S, 21, 30)))])
def test_the_ops_pass_opcheck_and_count_their_flops(op, args):
    tensors = [torch.randn(s) for s in args]
    torch.library.opcheck(op, tuple(tensors), test_utils=("test_schema", "test_faketensor"))
    with FlopCounterMode(display=False) as fc:
        op(*tensors)
    assert fc.get_total_flops() == 2 * math.prod(args[0]) * args[1][-1]


def test_launch_counters_list_the_weight_gradient_kernel():
    """A graphed step's capture counts and the benchmarks' launch counts
    read ``ops.launch_counters()``: the kernel's wrapper is in it, and the
    unbatched op, which launches no kernel, is not."""
    from mmtraj_torch.ops import launch_counters

    counters = launch_counters()
    assert "weight_grad" not in counters
    assert counters["weight_grad_lanes"] is dense_grad.weight_grad_lanes
    assert all(isinstance(c.launches, int) for c in counters.values())


@pytest.mark.parametrize("s, r, din, dout", [(5, 8192, 64, 192), (5, 1024, 64, 192),
                                             (5, 8192, 2, 64), (5, 8192, 64, 30), (1, 8192, 64, 64),
                                             (1, 1024, 64, 192), (3, 2048, 128, 384), (1, 0, 64, 64),
                                             (1, 100, 64, 64)])
def test_the_plan_covers_every_row_and_fills_the_card(s, r, din, dout):
    sms = 132
    tm, tn, splits, rows = dense_grad.plan(s, r, din, dout, sms)
    assert (tm, tn) == (16 if din <= 16 else 64, 32 if dout <= 32 else 64)
    assert rows % dense_grad.STAGE_ROWS == 0 and splits >= 1
    assert splits * rows >= r and (splits == 1 or (splits - 1) * rows < r)
    tiles = math.ceil(din / tm) * math.ceil(dout / tn) * s
    most = dense_grad.BLOCKS_PER_SM * sms
    if r // dense_grad.MIN_SPLIT_ROWS >= most // tiles:  # the card filled, never past `most`
        assert 0.85 * most <= tiles * splits <= most
    else:  # too few rows for that: splits of the fewest rows
        assert splits == max(1, r // dense_grad.MIN_SPLIT_ROWS)
    if splits > 1:
        assert rows >= dense_grad.MIN_SPLIT_ROWS


def _population_grads(route: bool, spies):
    """One config-3 recipe step of 5 lanes at B = 4 -> (lane losses, each
    leaf's gradient, op calls); with ``route`` False the two modules that
    take ``dense_product`` get the plain product, and ``_FusedGat``'s
    backward the plain weight gradient, as before the kernel."""
    plain = (lambda x, w: x @ w)
    product = dense_grad.dense_product if route else plain
    layers.dense_product = fused_gat.dense_product = product
    if not route:
        fused_gat.dense_weight_grad = lambda x, g, w: dense_grad.weight_grad_math(x, g)
    try:
        cfg = port_config(recipe_jcfg(**RECIPE_MODEL, use_pallas=True))
        seeds = list(range(S))
        xy, mask = (torch.from_numpy(a) for a in random_windows(8, seed=6))
        idx = np.array([[np.random.default_rng(s).permutation(8)[:4] for s in seeds]])
        states = [Forecaster(cfg.model, TO, TP, device="cpu",
                             generator=torch.Generator().manual_seed(s)).state_dict()
                  for s in seeds]
        params = population.stack_lanes(states, "cpu")
        t = cfg.train
        pop = population.make_population_step(
            population.lane_model(cfg, "cpu"), params, train.Optimizer(params, cfg, lanes=True),
            NormStats(MEAN, STD), seeds, None, 0.0, t.augment_rotate, t.augment_flip, t.loss,
            t.variety_n)
        spies.update(weight_grad=0, weight_grad_lanes=0)
        losses = pop(xy, mask, idx, [7])
        return losses, {k: v.grad.clone() for k, v in params.items()}, dict(spies)
    finally:
        layers.dense_product = fused_gat.dense_product = dense_grad.dense_product
        fused_gat.dense_weight_grad = dense_grad.dense_weight_grad


def test_population_step_gradients_equal_the_plain_products(spies):
    """Calls a step, all on ``weight_grad_lanes``: every product of the
    encoder's TO steps (embed, wx, wh, the GAT's wv and wo; the first step's
    wh with the zero state every lane shares expanded to the lanes) and
    bridge_h, the rollout's TP heads and the other five products of its first
    TP - 1 steps (the last step's update feeds no loss)."""
    l0, g0, calls0 = _population_grads(False, spies)
    l1, g1, calls1 = _population_grads(True, spies)
    assert calls0 == {"weight_grad": 0, "weight_grad_lanes": 0}
    assert calls1 == {"weight_grad": 0, "weight_grad_lanes": 5 * TO + 1 + TP + 5 * (TP - 1)}
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    assert sorted(g1) == sorted(g0)
    for k in g0:
        scale = g0[k].abs().amax(dim=tuple(range(1, g0[k].ndim)), keepdim=True)
        assert ((g1[k] - g0[k]).abs() <= 1e-6 * scale).all(), k
