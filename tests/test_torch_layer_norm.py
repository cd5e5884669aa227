"""The layer norm's kernel pair (``ops/fused_layer_norm.py``: the ops
``mmtraj::layer_norm`` and ``mmtraj::layer_norm_grad``, the Function
``_FusedLayerNorm``) on the CPU, where each op is its plain version
(``layer_norm_math``, the chain of ``models.layers.layer_norm``; and
``layer_norm_grad_math``, the closed-form gradient the backward kernel
computes).

- The Function's forward and gradients against ``torch.func.vjp`` of
  ``models.layers.layer_norm`` in float32 (within 2e-6 of each leaf's largest
  entry), and of the same chain kept in float64 (``layer_norm_math``, which
  the model's ``layer_norm`` runs in float32 whatever x is) within 1e-12, at
  H = 64 and 128, with a constant row (zero variance) and on a strided
  input (the readout's ``x[:, :, -1]``, read without a copy), and with x,
  or scale and bias, left without a gradient.
- The ops' schemas, and their fakes' shapes and types under
  ``FakeTensorMode`` against the CPU versions'; the two counters in
  ``ops.launch_counters()``; the backward's launch plan.
- Under ``torch.func.vmap`` the ops' vmap rules (one forward call for lanes
  sharing scale and bias, one a lane otherwise; one backward call a lane);
  the wrapper calls the op at any width, and the CUDA check refuses a width
  outside ``WIDTHS`` and a float64 x; ``attn_encode`` under ``use_pallas``
  on the CPU keeps the plain chain (no op call).

``tests/test_torch_gpu.py`` holds the kernels to the float64 chain on the
card and counts their launches in a config4-attn3 step.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mmtraj_torch.config import ModelConfig
from mmtraj_torch.models import attn_encoder
from mmtraj_torch.models.layers import layer_norm
from mmtraj_torch.ops import fused_layer_norm as fln
from mmtraj_torch.ops import launch_counters

torch.set_num_threads(2)

TOL = {torch.float64: 1e-12, torch.float32: 2e-6}


@pytest.fixture
def spies():
    """Counting CPU kernels of ``mmtraj::layer_norm`` and
    ``mmtraj::layer_norm_grad`` -> their call counts."""
    calls = {"layer_norm": 0, "layer_norm_grad": 0}

    def forward(*args):
        calls["layer_norm"] += 1
        return fln.layer_norm_math(*args)

    def backward(*args):
        calls["layer_norm_grad"] += 1
        return fln.layer_norm_grad_math(*args)

    lib = torch.library.Library("mmtraj", "IMPL")
    with warnings.catch_warnings():  # "Overriding a previously registered kernel"
        warnings.simplefilter("ignore", UserWarning)
        lib.impl("layer_norm", forward, "CPU")
        lib.impl("layer_norm_grad", backward, "CPU")
    yield calls
    lib._destroy()


def _inputs(h, dtype, case, seed=0):
    """x (3, 5, 4, h) with a row of its own scale a row, scale, bias and an
    upstream gradient like the output; "constant": row (0, 0, 0) one value;
    "strided": x[:, :, -1], the readout's slice."""
    rng = np.random.default_rng(seed + h)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale).to(dtype)

    x = t(3, 5, 4, h) * torch.from_numpy(rng.uniform(0.1, 3.0, (3, 5, 4, 1))).to(dtype) + 0.5
    if case == "constant":
        x[0, 0, 0] = 1.7
    if case == "strided":
        x = x[:, :, -1]
    return x, 1.0 + t(h, scale=0.3), t(h, scale=0.2), t(*x.shape)


def _plain(dtype):
    """The chain to hold the Function to: ``models.layers.layer_norm`` in
    float32, the same chain in float64 (``layer_norm_math``)."""
    if dtype == torch.float32:
        return lambda x, s, b: layer_norm({"scale": s, "bias": b}, x)
    return lambda x, s, b: fln.layer_norm_math(x, s, b)[0]


def _assert_leaf_close(got, want, tol, name):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol * max(scale, 1e-30), msg=name)


@pytest.mark.parametrize("case", ["random", "constant", "strided"])
@pytest.mark.parametrize("h", fln.WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_backward_matches_the_vjp_of_the_plain_chain(dtype, h, case, spies):
    x, scale, bias, up = _inputs(h, dtype, case)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y = fln.fused_layer_norm(*leaves)
    got = torch.autograd.grad(y, leaves, up)
    assert spies == {"layer_norm": 1, "layer_norm_grad": 1}
    want_y, vjp = torch.func.vjp(_plain(dtype), x, scale, bias)
    assert torch.equal(y, want_y)  # the same chain on the CPU
    for g, w, name in zip(got, vjp(up), ("x", "scale", "bias")):
        _assert_leaf_close(g, w, TOL[dtype], name)


@pytest.mark.parametrize("which", [[0], [1, 2], [0, 1]], ids=["x", "scale and bias", "x, scale"])
def test_backward_gives_only_the_gradients_asked_for(which, spies):
    x, scale, bias, up = _inputs(64, torch.float64, "random", seed=3)
    args = [t.clone().requires_grad_() if i in which else t for i, t in enumerate((x, scale, bias))]
    got = torch.autograd.grad(fln.fused_layer_norm(*args), [args[i] for i in which], up)
    assert spies["layer_norm_grad"] == 1
    _, vjp = torch.func.vjp(_plain(torch.float64), x, scale, bias)
    want = vjp(up)
    for g, i in zip(got, which):
        _assert_leaf_close(g, want[i], 1e-12, str(i))


def test_the_readouts_slice_is_read_without_a_copy():
    x = torch.randn(3, 5, 4, 64)
    rows = fln._rows(x[:, :, -1])
    assert rows.data_ptr() == x[:, :, -1].data_ptr() and rows.stride() == (4 * 64, 1)
    assert fln._rows(x.transpose(1, 2)).is_contiguous()  # no single row stride: a copy


def test_no_gradient_calls_the_forward_op_alone(spies):
    x, scale, bias, _ = _inputs(64, torch.float32, "strided")
    with torch.no_grad():
        y = fln.fused_layer_norm(x, scale, bias)
    assert spies == {"layer_norm": 1, "layer_norm_grad": 0}
    assert torch.equal(y, layer_norm({"scale": scale, "bias": bias}, x))


def _lanes(seeds, h=64):
    """S lanes of ``_inputs`` stacked on a leading axis -> (x, scale, bias, up)."""
    lanes = [_inputs(h, torch.float64, "random", seed=s) for s in seeds]
    return tuple(torch.stack(t) for t in zip(*lanes))


@pytest.mark.parametrize("own", [False, True], ids=["shared scale and bias", "lanes' own"])
def test_vmap_calls_the_ops_and_gives_each_lanes_gradients(own, spies):
    """Under ``torch.func.vmap`` over 3 lanes the ops take their vmap rules:
    lanes sharing scale and bias fold into one forward call, lanes with their
    own take one each; the backward takes one a lane.  Values and gradients
    are each lane's own (a shared leaf gets the lanes' sum), within 1e-12 in
    float64 of the plain chain's vjp."""
    x, scale, bias, up = _lanes(range(3))
    if not own:
        scale, bias = scale[0], bias[0]
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    dims = (0, 0, 0) if own else (0, None, None)
    y = torch.func.vmap(fln.fused_layer_norm, in_dims=dims)(*leaves)
    assert spies == {"layer_norm": 3 if own else 1, "layer_norm_grad": 0}
    got = torch.autograd.grad(y, leaves, up)
    assert spies["layer_norm_grad"] == 3
    want_y, vjp = torch.func.vjp(torch.func.vmap(_plain(torch.float64), in_dims=dims),
                                 x, scale, bias)
    _assert_leaf_close(y, want_y, 1e-12, "y")
    for g, w, name in zip(got, vjp(up), ("x", "scale", "bias")):
        _assert_leaf_close(g, w, 1e-12, name)


def test_the_wrapper_calls_the_op_at_any_width_and_the_card_check_refuses_others(spies):
    """``fused_layer_norm`` keeps no plain route of its own: at H = 48 it calls
    ``mmtraj::layer_norm`` (the plain version on the CPU), and the CUDA
    implementation's check raises for that width and for a float64 x."""
    x, scale, bias, _ = _inputs(48, torch.float32, "random")
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y = fln.fused_layer_norm(*leaves)
    y.sum().backward()
    assert spies == {"layer_norm": 1, "layer_norm_grad": 1}
    assert torch.equal(y, layer_norm({"scale": scale, "bias": bias}, x))
    with pytest.raises(ValueError, match="H in"):
        fln._check(x, scale)
    x64, scale64, _, _ = _inputs(64, torch.float64, "random")
    with pytest.raises(ValueError, match="float32 CUDA tensor"):
        fln._check(x64, scale64)


def test_attn_encode_under_use_pallas_on_the_cpu_keeps_the_plain_chain(spies):
    """The gate (``attn_encoder._layer_norm``) sends only CUDA tensors to
    the kernels; at H = 64 nothing else would keep them off."""
    cfg = ModelConfig(hidden_dim=64, embed_dim=64, num_heads=4, encoder="attn", remat=True,
                      use_pallas=True)
    params = attn_encoder.attn_encoder_init(torch.Generator().manual_seed(0), cfg)
    leaves = [t.requires_grad_() for t in params["layers"]["l0"]["ln1"].values()]
    rng = np.random.default_rng(2)
    xy = torch.from_numpy(np.cumsum(rng.normal(size=(2, 6, 8, 2)), 2).astype(np.float32))
    mask = torch.ones(2, 6, dtype=torch.bool)
    counters = launch_counters()
    before = {k: counters[k].launches for k in ("fused_layer_norm", "fused_layer_norm_grad")}
    feat = attn_encoder.attn_encode(params, cfg, xy, xy * 0.1, mask, train=True)
    feat.sum().backward()
    plain = attn_encoder.attn_encode(params, dataclasses.replace(cfg, use_pallas=False), xy,
                                     xy * 0.1, mask, train=True)
    assert torch.equal(feat, plain) and all(t.grad is not None for t in leaves)
    assert spies == {"layer_norm": 0, "layer_norm_grad": 0}
    assert {k: counters[k].launches for k in before} == before


def test_the_ops_schemas_and_fakes_give_the_real_shapes():
    x, scale, bias, up = _inputs(64, torch.float32, "strided")
    fwd, bwd = torch.ops.mmtraj.layer_norm.default, torch.ops.mmtraj.layer_norm_grad.default
    assert str(fwd._schema) == ("mmtraj::layer_norm(Tensor x, Tensor scale, Tensor bias, "
                                "float eps) -> (Tensor, Tensor, Tensor)")
    assert str(bwd._schema) == ("mmtraj::layer_norm_grad(Tensor x, Tensor scale, Tensor mu, "
                                "Tensor rstd, Tensor dy) -> (Tensor, Tensor, Tensor)")
    real = fwd(x, scale, bias, fln.EPS)
    real_grad = bwd(x, scale, real[1], real[2], up)
    with FakeTensorMode() as mode:
        fake = fwd(mode.from_tensor(x), mode.from_tensor(scale), mode.from_tensor(bias), fln.EPS)
        fake_grad = bwd(*(mode.from_tensor(t) for t in (x, scale, real[1], real[2], up)))
    for f, r in zip((*fake, *fake_grad), (*real, *real_grad)):
        assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype)
    assert [tuple(o.shape) for o in (*real, *real_grad)] == [
        (3, 5, 64), (3, 5), (3, 5), (3, 5, 64), (64,), (64,)]


def test_launch_counters_list_both_kernels():
    counters = launch_counters()
    assert counters["fused_layer_norm"] is fln.fused_layer_norm
    assert counters["fused_layer_norm_grad"] is fln.fused_layer_norm_grad
    assert isinstance(fln.fused_layer_norm.launches, int)
    assert isinstance(fln.fused_layer_norm_grad.launches, int)


@pytest.mark.parametrize("rows", [0, 1, 15, 16, 17, 4096, 8192, 8193, 65536, 65536 * 3 + 5])
def test_the_backward_plan_covers_every_row_and_leaves_no_block_empty(rows):
    blocks, rows_a_warp = fln.plan(rows)
    per_block = fln.BWD_WARPS * rows_a_warp
    assert 1 <= blocks <= fln.MAX_BLOCKS and blocks * per_block >= rows
    assert rows == 0 or (blocks - 1) * per_block < rows
    assert rows_a_warp == 1 or (rows_a_warp - 1) * fln.BWD_WARPS * fln.MAX_BLOCKS < rows
