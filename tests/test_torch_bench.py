"""The port's benchmarks and the kernels' autograd wiring, on the CPU.

* The copied numpy denominators give the JAX package's outputs exactly on
  the same parameters, inputs and numpy generator.
* ``python -m mmtraj_torch.benchmarks.bench --device cpu`` prints exactly one
  JSON line with the headline keys; ``train_bench`` runs a step and counts
  its FLOPs.
* ``fused_gat``, ``attend`` and the packed ``attend`` are
  ``torch.autograd.Function``s on the card.
  Here their forward takes the plain version, so the tests pin the wiring:
  the Function's gradients equal autograd of the plain math exactly, and
  ``gradcheck`` passes in float64.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmtraj import config as jconfig
from mmtraj.benchmarks.reference_loop import ReferenceStyleForecaster as JRef
from mmtraj.benchmarks.vectorized_host import VectorizedHostForecaster as JVec
from mmtraj.models.forecaster import init_params as j_init_params
from mmtraj_torch.benchmarks import train_bench
from mmtraj_torch.benchmarks.reference_loop import ReferenceStyleForecaster
from mmtraj_torch.benchmarks.vectorized_host import VectorizedHostForecaster
from mmtraj_torch.config import ModelConfig
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.ops import fused_attend, fused_gat
from mmtraj_torch.params import from_jax

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_vectorized_host", "route",
                 "device", "tflops_per_sec", "mfu_pct", "mfu_peak"}


@pytest.mark.parametrize("loop", ["reference", "vectorized"])
def test_numpy_denominators_equal_jax(loop):
    jmc = dataclasses.replace(jconfig.config4().model, hidden_dim=16, embed_dim=16, num_heads=2)
    params = j_init_params(jax.random.PRNGKey(0), jmc)
    model = Forecaster(ModelConfig(**dataclasses.asdict(jmc)), 4, 3, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    args = (jmc.num_heads, jmc.num_mixtures, jmc.adjacency_radius, jmc.sigma_min, jmc.rho_max,
            np.zeros(2, np.float32), np.full(2, 0.4, np.float32))
    rng = np.random.default_rng(0)
    xy = np.cumsum(rng.normal(size=(2, 6, 4, 2)).astype(np.float32) * 0.4, axis=2)
    mask = rng.random((2, 6)) < 0.75
    if loop == "reference":
        ours, theirs = ReferenceStyleForecaster(model.params(), *args), JRef(params, *args)
        got = ours.rollout(xy[0][mask[0]], k=3, pred_len=3, rng=np.random.default_rng(1))
        want = theirs.rollout(xy[0][mask[0]], k=3, pred_len=3, rng=np.random.default_rng(1))
    else:
        ours, theirs = VectorizedHostForecaster(model.params(), *args), JVec(params, *args)
        got = ours.rollout_batch(xy, mask, k=3, pred_len=3, rng=np.random.default_rng(1))
        want = theirs.rollout_batch(xy, mask, k=3, pred_len=3, rng=np.random.default_rng(1))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_bench_on_the_cpu_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "mmtraj_torch.benchmarks.bench", "--device", "cpu", "--batch", "2",
         "--k", "2", "--n-max", "8", "--iters", "1", "--host-batch", "2", "--ref-iters", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=300, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert HEADLINE_KEYS <= set(rec)
    assert rec["metric"] == "rollouts_per_sec_per_chip_k20" and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["route"].endswith("-eager") and rec["mfu_pct"] is None
    assert set(rec["rates"]) == {"plain-eager", "A-eager", "B-eager"}
    assert "route A eager" in out.stderr


def test_train_bench_times_a_step_and_counts_its_flops():
    r = train_bench.bench_train_step(batch_size=2, n_max=8, iters=1, warmup=1, min_seconds=0,
                                     loss_mode="hybrid", variety_n=2, device="cpu")
    assert r.steps_per_sec > 0 and r.windows_per_sec == 2 * r.steps_per_sec
    assert r.flops_per_step > 0 and r.mfu is None and r.device == "cpu"


def _gat_inputs(dtype, b=3, n=6, d=8, heads=2, hd=8, dout=8):
    g = torch.Generator().manual_seed(0)
    h, wv, a_src, a_dst, wo, bo = (torch.randn(s, generator=g, dtype=dtype) * 0.5 for s in (
        (b, n, d), (d, hd), (heads, hd // heads), (heads, hd // heads), (hd, dout), (dout,)))
    att = (torch.rand((b, n, n), generator=g) < 0.5).to(dtype)
    att[:, -1] = 0.0  # a padded row, without edges
    return h, att, wv, a_src, a_dst, wo, bo, heads


def _grads(fn, inputs, upstream):
    leaves = [x.detach().requires_grad_(x.is_floating_point() and i != 1)
              for i, x in enumerate(inputs[:-1])]
    torch.autograd.backward(fn(*leaves, inputs[-1]), upstream)
    return [x.grad for x in leaves]


def test_fused_gat_function_backward_is_autograd_of_gat_math():
    inputs = _gat_inputs(torch.float32)
    up = torch.randn((3, 6, 8), generator=torch.Generator().manual_seed(1))
    got = _grads(fused_gat._FusedGat.apply, inputs, up)
    want = _grads(fused_gat.gat_math, inputs, up)
    assert got[1] is None and want[1] is None  # the 0/1 tile asks for none
    for a, b in zip(got, want):
        if b is not None:
            assert torch.equal(a, b)
    # The tile's gradient, where a caller asks for one, is gat_math's, as JAX's VJP gives it.
    att = inputs[1].clone().requires_grad_()
    fused_gat._FusedGat.apply(inputs[0], att, *inputs[2:]).backward(up)
    att_ref = inputs[1].clone().requires_grad_()
    fused_gat.gat_math(inputs[0], att_ref, *inputs[2:]).backward(up)
    assert torch.equal(att.grad, att_ref.grad)


def test_attend_function_backward_is_autograd_of_attend_math():
    h, att, wv, a_src, _, _, _, heads = _gat_inputs(torch.float32)
    v = h @ wv
    s_src, s_dst = v[..., :heads], v[..., heads:2 * heads]
    up = torch.randn(v.shape, generator=torch.Generator().manual_seed(2))
    inputs = (v, s_src.contiguous(), s_dst.contiguous(), att, heads)

    def grads(fn):
        leaves = [x.detach().requires_grad_() for x in inputs[:3]]
        fn(*leaves, att, heads).backward(up)
        return [x.grad for x in leaves]

    for a, b in zip(grads(fused_attend._Attend.apply), grads(fused_attend.attend_math)):
        assert torch.equal(a, b)


def test_plain_versions_and_functions_pass_gradcheck_in_float64():
    h, att, wv, a_src, a_dst, wo, bo, heads = _gat_inputs(torch.float64, b=2, n=4, d=4, hd=4,
                                                          dout=4)
    diff = [x.requires_grad_() for x in (h, wv, a_src, a_dst, wo, bo)]
    for fn in (fused_gat.gat_math, fused_gat._FusedGat.apply):
        assert torch.autograd.gradcheck(
            lambda h_, wv_, s_, d_, wo_, bo_: fn(h_, att, wv_, s_, d_, wo_, bo_, heads), diff)
    v = (h @ wv).detach().requires_grad_()
    s_src = torch.randn((2, 4, heads), dtype=torch.float64, requires_grad=True)
    s_dst = torch.randn((2, 4, heads), dtype=torch.float64, requires_grad=True)
    for fn in (fused_attend.attend_math, fused_attend._Attend.apply):
        assert torch.autograd.gradcheck(lambda a, b, c: fn(a, b, c, att, heads),
                                        (v, s_src, s_dst))


def test_packed_attend_refuses_a_gradient():
    """It refuses none: ``_AttendPacked`` passes ``gradcheck`` in float64,
    the wrapper takes it where a gradient is recorded, and its gradients
    equal autograd of the plain math exactly (on the CPU the op's forward is
    ``attend_math``)."""
    h, att, wv, _, _, _, _, heads = _gat_inputs(torch.float64, b=2, n=4, d=4, hd=4, dout=4)
    v = (h @ wv).detach().requires_grad_()
    s_src = torch.randn((2, 4, heads), dtype=torch.float64, requires_grad=True)
    s_dst = torch.randn((2, 4, heads), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fused_attend._AttendPacked.apply(a, b, c, att, heads), (v, s_src, s_dst))
    out = fused_attend.attend(v, s_src, s_dst, att, heads, 8, True)
    assert out.grad_fn is not None and "AttendPacked" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out.sum(), (v, s_src, s_dst))
    want = torch.autograd.grad(fused_attend.attend_math(v, s_src, s_dst, att, heads).sum(),
                               (v, s_src, s_dst))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
