"""The backward of ``fused_gat`` (``_FusedGat``) through
``mmtraj::gat_attend_grad``, on the CPU, where the op is its plain version
(``fused_gat.attend_grad_math``: ``torch.func.vjp`` of ``attend_math``).

- Every input gradient of ``_FusedGat`` against ``torch.func.vjp`` of
  ``gat_math``, within 1e-12 of each leaf's largest entry in float64 and
  2e-6 in float32, at (N, H, dh) = (32, 1, 64), (64, 4, 16), (64, 4, 32)
  and (128, 4, 16), with padded agents (no edge in or out), isolated agents
  (a self edge alone) and logits exactly 0 (head 0's a_dst = -a_src: every
  self edge's logit), and with h or the weights left without a gradient.
- Under ``torch.func.vmap`` over 5 lanes with their own weights (a
  population) and with shared weights: the gradients against a loop over
  the lanes, one op call for all lanes, and the weight gradients on
  ``weight_grad_lanes`` for the lanes' own weights only.
- ``attend`` that requires a gradient takes the plain VJP (no op call) and
  gets its gradient.
- The op's schema, its fake's shapes and types under ``FakeTensorMode``
  against the CPU version's, and its counter in ``ops.launch_counters()``.

``tests/test_torch_gpu.py`` holds the kernels to the float64 VJP on the card.
"""

import warnings

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mmtraj_torch.ops import dense_grad, fused_gat, launch_counters

torch.set_num_threads(2)

CASES = [(32, 1, 64), (64, 4, 16), (64, 4, 32), (128, 4, 16)]
TOL = {torch.float64: 1e-12, torch.float32: 2e-6}
S = 5


@pytest.fixture
def spies():
    """Counting CPU kernels of ``gat_attend_grad`` and ``weight_grad_lanes``
    -> their call counts."""
    calls = {"gat_attend_grad": 0, "weight_grad_lanes": 0}

    def attend_grad(*args):
        calls["gat_attend_grad"] += 1
        return fused_gat.attend_grad_math(*args)

    def lanes(x, g):
        calls["weight_grad_lanes"] += 1
        return x.transpose(1, 2) @ g

    lib = torch.library.Library("mmtraj", "IMPL")
    with warnings.catch_warnings():  # "Overriding a previously registered kernel"
        warnings.simplefilter("ignore", UserWarning)
        lib.impl("gat_attend_grad", attend_grad, "CPU")
        lib.impl("weight_grad_lanes", lanes, "CPU")
    yield calls
    lib._destroy()


def _inputs(n, heads, dh, dtype, b=3, seed=0):
    """One GAT call's inputs: b graphs of n agents, edges at density 0.3
    with self edges; the last 3 agents of graph 0 padded (no edge in or
    out), agent 1 of every graph isolated (its self edge alone), and head
    0's a_dst = -a_src, so that every self edge's logit is exactly 0."""
    rng = np.random.default_rng(seed + n + heads)
    d, hd, dout = 24, heads * dh, 20

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale).to(dtype)

    att = torch.from_numpy((rng.random((b, n, n)) < 0.3).astype(np.float64)).to(dtype)
    att = torch.maximum(att, torch.eye(n, dtype=dtype))
    att[:, 1] = 0.0
    att[:, :, 1] = 0.0
    att[:, 1, 1] = 1.0
    att[0, n - 3:] = 0.0
    att[0, :, n - 3:] = 0.0
    a_src, a_dst = t(heads, dh, scale=0.5), t(heads, dh, scale=0.5)
    a_dst[0] = -a_src[0]
    return (t(b, n, d), att, t(d, hd, scale=0.3), a_src, a_dst, t(hd, dout, scale=0.3),
            t(dout, scale=0.1)), t(b, n, dout)


def _vjp_of_gat_math(args, heads, up, which):
    """``torch.func.vjp`` of ``gat_math`` for the inputs ``which`` indexes."""
    def fn(*wanted):
        full = list(args)
        for i, x in zip(which, wanted):
            full[i] = x
        return fused_gat.gat_math(*full, heads)

    _, vjp = torch.func.vjp(fn, *(args[i] for i in which))
    return vjp(up)


def _assert_leaf_close(got, want, tol, name):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol * max(scale, 1e-30), msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n, heads, dh", CASES)
def test_backward_matches_the_vjp_of_gat_math(n, heads, dh, dtype, spies):
    args, up = _inputs(n, heads, dh, dtype)
    which = [0, 2, 3, 4, 5, 6]
    leaves = [a.clone().requires_grad_() if i in which else a for i, a in enumerate(args)]
    out = fused_gat.fused_gat(*leaves, heads)
    got = torch.autograd.grad(out, [leaves[i] for i in which], up)
    assert spies["gat_attend_grad"] == 1
    want = _vjp_of_gat_math(args, heads, up, which)
    names = ["h", "wv", "a_src", "a_dst", "wo", "bo"]
    for g, w, name in zip(got, want, names):
        _assert_leaf_close(g, w, TOL[dtype], name)
    # padded agents take no gradient and give none to h
    assert not got[0][0, n - 3:].any()


@pytest.mark.parametrize("which", [[2, 3, 4, 5, 6], [0], [3, 4]], ids=["weights", "h", "scores"])
def test_backward_gives_only_the_gradients_asked_for(which):
    args, up = _inputs(64, 4, 16, torch.float64, seed=3)
    leaves = [a.clone().requires_grad_() if i in which else a for i, a in enumerate(args)]
    got = torch.autograd.grad(fused_gat.fused_gat(*leaves, 4), [leaves[i] for i in which], up)
    for g, w in zip(got, _vjp_of_gat_math(args, 4, up, which)):
        _assert_leaf_close(g, w, 1e-12, str(which))


@pytest.mark.parametrize("shared", [False, True], ids=["lane weights", "shared weights"])
@pytest.mark.parametrize("n, heads, dh", [(32, 1, 64), (64, 4, 16)])
def test_vmapped_lanes_equal_a_loop_in_one_call(n, heads, dh, shared, spies):
    """A population's lanes (their own weights: the lanes' weight gradients
    on ``weight_grad_lanes``, wv's and wo's) and lanes that share the
    weights (the plain products); either way one ``gat_attend_grad`` call
    for all lanes."""
    lanes = [_inputs(n, heads, dh, torch.float64, b=2, seed=10 * s) for s in range(S)]
    h, att, *ws = (torch.stack(x) for x in zip(*(a for a, _ in lanes)))
    up = torch.stack([u for _, u in lanes])
    if shared:
        ws = [w[0] for w in ws]
    leaves = [x.clone().requires_grad_() for x in (h, *ws)]
    w_dim = None if shared else 0
    out = torch.func.vmap(lambda h_, a_, *w: fused_gat.fused_gat(h_, a_, *w, heads),
                          in_dims=(0, 0) + (w_dim,) * 5)(leaves[0], att, *leaves[1:])
    got = torch.autograd.grad(out, leaves, up)
    assert spies == {"gat_attend_grad": 1, "weight_grad_lanes": 0 if shared else 2}
    per_lane = [_vjp_of_gat_math((h[s], att[s], *(w if shared else w[s] for w in ws)), heads,
                                 up[s], [0, 2, 3, 4, 5, 6]) for s in range(S)]
    for k, g in enumerate(got):
        lane_grads = torch.stack([p[k] for p in per_lane])
        _assert_leaf_close(g, lane_grads.sum(0) if shared and k else lane_grads, 1e-12, str(k))


def test_attend_that_requires_a_gradient_takes_the_plain_vjp(spies):
    args, up = _inputs(64, 4, 16, torch.float64, seed=5)
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(fused_gat.fused_gat(*leaves, 4), leaves, up)
    assert spies["gat_attend_grad"] == 0
    for i, (g, w) in enumerate(zip(got, _vjp_of_gat_math(args, 4, up, range(7)))):
        _assert_leaf_close(g, w, 1e-12, str(i))
    assert got[1].abs().max() > 0


def test_the_op_schema_and_its_fake_give_the_real_shapes():
    """The fake (``torch.export``'s) gives each output's shape and type as the
    CPU version computes it.  (``torch.library.opcheck`` cannot run the CPU
    version: its modes do not look inside ``torch.func.vjp``.)"""
    (h, att, wv, a_src, a_dst, *_), up = _inputs(32, 4, 8, torch.float32, b=2)
    v = h @ wv
    args = (v, v @ fused_gat._block_diag(a_src), v @ fused_gat._block_diag(a_dst), att,
            torch.randn_like(v), 4)
    op = torch.ops.mmtraj.gat_attend_grad.default
    assert str(op._schema) == (
        "mmtraj::gat_attend_grad(Tensor v, Tensor s_src, Tensor s_dst, Tensor attend, "
        "Tensor d_agg, SymInt num_heads) -> (Tensor, Tensor, Tensor, Tensor)")
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert [(tuple(o.shape), o.dtype) for o in fake] == [(tuple(o.shape), o.dtype) for o in real]
    assert [tuple(o.shape) for o in real] == [(2, 32, 32), (2, 32, 32), (2, 32, 4), (2, 32, 4)]


def test_launch_counters_list_the_backward_kernel():
    counters = launch_counters()
    assert counters["fused_gat_grad"] is fused_gat.fused_gat_grad
    assert isinstance(fused_gat.fused_gat_grad.launches, int)
    assert counters["weight_grad_lanes"] is dense_grad.weight_grad_lanes
