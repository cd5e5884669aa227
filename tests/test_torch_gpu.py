"""The CUDA kernels of mmtraj_torch against their plain PyTorch versions, on
the card.  Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider

Tolerances: 1e-4 for one attend chain or GAT layer (float32; the kernel sums
in another order and divides once per row instead of once per weight);
1e-3 m for rollouts, where those differences pass through 12 recurrent steps,
with at most 1% of the rollouts further off: a Gumbel pick within rounding
of a tie may take another component, and the change spreads through that
graph.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.ops import fused_attend, fused_decoder, fused_gat

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import kernel_inputs  # noqa: E402  (the inputs tools/kernel_times.py times)
import torch_exit_check  # noqa: E402

pytestmark = pytest.mark.gpu

KERNEL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


_t, _attend_tile = kernel_inputs.tensor, kernel_inputs.attend_tile


@pytest.mark.parametrize("n, heads, hd", [(8, 2, 16), (64, 4, 64), (100, 4, 64), (256, 8, 64),
                                           (40, 4, 48), (24, 1, 72), (32, 1, 64), (64, 4, 128),
                                           (128, 4, 128)])
def test_attend_kernel_matches_plain(cuda, n, heads, hd):
    rng = np.random.default_rng(n)
    v, s_src, s_dst = _t(rng, 6, n, hd), _t(rng, 6, n, heads, scale=2), _t(rng, 6, n, heads, scale=2)
    att = _attend_tile(rng, 6, n, cuda)
    before = fused_attend.attend.launches
    got = fused_attend.attend(v, s_src, s_dst, att, heads)
    torch.cuda.synchronize()
    assert fused_attend.attend.launches == before + 1
    torch.testing.assert_close(got, fused_attend.attend_math(v, s_src, s_dst, att, heads), **KERNEL)
    assert not got[:, -1].any()


@pytest.mark.parametrize("b", [1, 12])
@pytest.mark.parametrize("n", [100, 128, 256])
def test_attend_kernel_row_blocks(cuda, b, n):
    """16-row blocks, the last one ragged at N = 100; graph 0 has an
    all-masked row in a middle block, which must come out zero."""
    rng = np.random.default_rng(b * n)
    v, s_src, s_dst = _t(rng, b, n, 64), _t(rng, b, n, 4, scale=2), _t(rng, b, n, 4, scale=2)
    att = _attend_tile(rng, b, n, cuda)
    att[0, n // 2 + 3] = 0.0
    got = fused_attend.attend(v, s_src, s_dst, att, 4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_attend.attend_math(v, s_src, s_dst, att, 4), **KERNEL)
    assert not got[0, n // 2 + 3].any()
    assert not got[:, -1].any()


@pytest.mark.parametrize("b", [7, 1])
@pytest.mark.parametrize("n", [8, 64, 100, 256])
def test_packed_attend_kernel_matches_plain(cuda, n, b):
    """A pair of graphs a block; an odd B (7, and 1) leaves the last block
    one graph.  Graph 0 has an all-masked row, which must come out zero."""
    rng = np.random.default_rng(n + 1)
    v, s_src, s_dst = _t(rng, b, n, 64), _t(rng, b, n, 4, scale=2), _t(rng, b, n, 4, scale=2)
    att = _attend_tile(rng, b, n, cuda)
    att[0, n // 2] = 0.0
    before = (fused_attend.attend.launches, fused_attend.attend_packed.launches)
    got = fused_attend.attend(v, s_src, s_dst, att, 4, 8, True)
    torch.cuda.synchronize()
    assert (fused_attend.attend.launches, fused_attend.attend_packed.launches) == (
        before[0], before[1] + 1)
    torch.testing.assert_close(got, fused_attend.attend_math(v, s_src, s_dst, att, 4), **KERNEL)
    assert not got[0, n // 2].any()
    assert not got[:, -1].any()


@pytest.mark.parametrize("b, n", [(7, 64), (12, 100), (500, 64)])
def test_packed_attend_gradient_matches_autograd_of_plain(cuda, b, n):
    """``_AttendPacked``: the kernel's forward, one launch, and the VJP of
    ``attend_math`` (JAX's ``custom_vjp``) for v, s_src and s_dst."""
    rng = np.random.default_rng(b + n)
    v, s_src, s_dst = _t(rng, b, n, 64), _t(rng, b, n, 4, scale=2), _t(rng, b, n, 4, scale=2)
    att = _attend_tile(rng, b, n, cuda)
    up = _t(rng, b, n, 64)
    leaves = [x.requires_grad_() for x in (v, s_src, s_dst)]
    before = fused_attend.attend_packed.launches
    got = torch.autograd.grad(fused_attend.attend(*leaves, att, 4, 8, True), leaves, up)
    want = torch.autograd.grad(fused_attend.attend_math(*leaves, att, 4), leaves, up)
    torch.cuda.synchronize()
    assert fused_attend.attend_packed.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **KERNEL)


@pytest.mark.parametrize("s, b, n", [(3, 7, 64), (4, 500, 64), (2, 5, 32)])
def test_packed_attend_lanes_in_one_launch_equal_a_launch_a_lane(cuda, s, b, n):
    """Under ``torch.func.vmap`` the op's rule folds the S lanes into the
    graphs of one launch; with an odd B a block pairs the last graph of a
    lane with the first of the next, and still each graph's result is that
    of its own launch, to the bit."""
    rng = np.random.default_rng(s * b + n)
    v, s_src, s_dst = _t(rng, s * b, n, 64), _t(rng, s * b, n, 4), _t(rng, s * b, n, 4)
    v, s_src, s_dst = (x.reshape((s, b) + x.shape[1:]) for x in (v, s_src, s_dst))
    att = _attend_tile(rng, b, n, cuda)
    before = fused_attend.attend_packed.launches
    folded = torch.func.vmap(lambda a, c, d: fused_attend.attend(a, c, d, att, 4, 8, True))(
        v, s_src, s_dst)
    torch.cuda.synchronize()
    assert fused_attend.attend_packed.launches == before + 1
    apart = torch.stack([fused_attend.attend(v[i], s_src[i], s_dst[i], att, 4, 8, True)
                         for i in range(s)])
    assert torch.equal(folded, apart)


def test_packed_attend_refuses_an_odd_group_on_the_card(cuda):
    rng = np.random.default_rng(2)
    v, s = _t(rng, 4, 64, 64), _t(rng, 4, 64, 4)
    att = _attend_tile(rng, 4, 64, cuda)
    before = (fused_attend.attend.launches, fused_attend.attend_packed.launches)
    with pytest.raises(ValueError, match="even group"):
        fused_attend.attend(v, s, s, att, 4, 3, True)
    assert (fused_attend.attend.launches, fused_attend.attend_packed.launches) == before


@pytest.mark.parametrize("n, d, heads, hd, b, padded", [
    (8, 16, 2, 16, 5, 0), (64, 64, 4, 64, 5, 0), (128, 64, 4, 64, 5, 0), (256, 64, 4, 64, 5, 0),
    (64, 32, 4, 48, 5, 0),
    (16, 64, 4, 64, 5, 0),   # one slab: a cluster of one block
    (100, 64, 4, 64, 5, 0),  # a ragged last slab, a cluster of 7
    (200, 64, 4, 64, 5, 0),  # two slabs a block, a cluster of 7
    (64, 64, 4, 64, 1, 0),   # B = 1
    (100, 32, 4, 48, 3, 9),  # an all-masked row and 9 padded agents
    (32, 64, 1, 64, 32, 0),  # config 3: one head of 64, a cluster of 2, its training batch
    (32, 64, 1, 64, 256, 0),  # config 3's variety rollout: 8 x 32 graphs
])
def test_gat_kernel_matches_plain(cuda, n, d, heads, hd, b, padded):
    """A graph's 16-row slabs are the blocks of one thread block cluster.
    Rows without edges (every graph's last row, and with ``padded`` an
    all-masked row of graph 0 and the last agents, with no edge in or out)
    come out as exactly bo."""
    rng = np.random.default_rng(n + d)
    args = (_t(rng, b, n, d), _attend_tile(rng, b, n, cuda), _t(rng, d, hd, scale=0.3),
            _t(rng, heads, hd // heads, scale=0.3), _t(rng, heads, hd // heads, scale=0.3),
            _t(rng, hd, 40, scale=0.3), _t(rng, 40, scale=0.1))
    bare = [(slice(None), n - 1)]
    if padded:
        args[1][0, n // 2] = 0.0
        args[1][:, n - padded:] = 0.0
        args[1][:, :, n - padded:] = 0.0
        bare += [(0, n // 2), (slice(None), slice(n - padded, None))]
    before = fused_gat.fused_gat.launches
    got = fused_gat.fused_gat(*args, heads)
    torch.cuda.synchronize()
    assert fused_gat.fused_gat.launches == before + 1
    torch.testing.assert_close(got, fused_gat.gat_math(*args, heads), **KERNEL)
    for rows in bare:
        assert torch.equal(got[rows], args[6].expand_as(got[rows]))


@pytest.mark.parametrize("s, b, n, heads", [(5, 16, 64, 4), (3, 2, 100, 4), (2, 1, 8, 4),
                                             (5, 32, 32, 1)])
def test_gat_lanes_kernel_matches_plain(cuda, s, b, n, heads):
    """S lanes with their own weights in one launch of the GAT kernel,
    against ``gat_math`` lane by lane; under ``torch.func.vmap``
    ``fused_gat`` reaches it once for all lanes.  (5, 32, 32) with one head
    is config 3's population of 5 seeds."""
    rng = np.random.default_rng(s * n)
    d, hd, dout = 64, 64, 64
    h = torch.stack([_t(rng, b, n, d) for _ in range(s)])
    att = torch.stack([_attend_tile(rng, b, n, cuda) for _ in range(s)])
    ws = [torch.stack([_t(rng, *shape, scale=0.3) for _ in range(s)]) for shape in (
        (d, hd), (heads, hd // heads), (heads, hd // heads), (hd, dout), (dout,))]
    before = (fused_gat.fused_gat.launches, fused_gat.fused_gat_lanes.launches)
    got = fused_gat.fused_gat_lanes(h, att, *ws, heads)
    vmapped = torch.func.vmap(lambda *a: fused_gat.fused_gat(*a, heads))(h, att, *ws)
    torch.cuda.synchronize()
    assert (fused_gat.fused_gat.launches, fused_gat.fused_gat_lanes.launches) == (
        before[0] + 2, before[1] + 2)
    want = torch.stack([fused_gat.gat_math(h[i], att[i], *(w[i] for w in ws), heads)
                        for i in range(s)])
    torch.testing.assert_close(got, want, **KERNEL)
    assert torch.equal(vmapped, got)


@pytest.mark.parametrize("s, b, n, heads", [(5, 16, 64, 4), (3, 2, 100, 4), (2, 1, 8, 4),
                                             (5, 32, 32, 1)])
def test_gat_lanes_kernel_lane_equals_a_single_launch(cuda, s, b, n, heads):
    """Lane i of ``fused_gat_lanes`` runs the code of a single ``fused_gat``
    launch on lane i's graphs and weights (``gat.cu``'s ``Dims::lane``
    offsets only the weight pointers), so it equals that launch to the bit."""
    rng = np.random.default_rng(7 * s + n)
    d, hd, dout = 64, 64, 64
    h = torch.stack([_t(rng, b, n, d) for _ in range(s)])
    att = torch.stack([_attend_tile(rng, b, n, cuda) for _ in range(s)])
    ws = [torch.stack([_t(rng, *shape, scale=0.3) for _ in range(s)]) for shape in (
        (d, hd), (heads, hd // heads), (heads, hd // heads), (hd, dout), (dout,))]
    got = fused_gat.fused_gat_lanes(h, att, *ws, heads)
    for i in range(s):
        one = fused_gat.fused_gat(h[i], att[i], *(w[i] for w in ws), heads)
        torch.cuda.synchronize()
        assert torch.equal(got[i], one), (i, (got[i] - one).abs().max().item())


# The experiments' config-4 variants (experiments/torch_*.py) at N = 64:
# dense-sweep cell A's hidden 128 (4 heads of 32, D = HD = Dout = 128) and the
# social ablation's one head of 64, at the training batch (16) and the
# evaluate batch (25).
EXPERIMENT_GAT = [(16, 128, 4), (25, 128, 4), (16, 64, 1), (25, 64, 1)]


def _gat_args(rng, b, n, d, heads, device):
    return (_t(rng, b, n, d), _attend_tile(rng, b, n, device), _t(rng, d, d, scale=0.3),
            _t(rng, heads, d // heads, scale=0.3), _t(rng, heads, d // heads, scale=0.3),
            _t(rng, d, d, scale=0.3), _t(rng, d, scale=0.1))


@pytest.mark.parametrize("b, d, heads", EXPERIMENT_GAT)
def test_gat_kernel_at_the_experiments_shapes(cuda, b, d, heads):
    """One launch against ``gat_math``; every graph's last row has no edge
    and comes out exactly bo."""
    rng = np.random.default_rng(b + d + heads)
    args = _gat_args(rng, b, 64, d, heads, cuda)
    before = fused_gat.fused_gat.launches
    got = fused_gat.fused_gat(*args, heads)
    torch.cuda.synchronize()
    assert fused_gat.fused_gat.launches == before + 1
    torch.testing.assert_close(got, fused_gat.gat_math(*args, heads), **KERNEL)
    assert torch.equal(got[:, -1], args[6].expand_as(got[:, -1]))


@pytest.mark.parametrize("s, b, d, heads", [(3, 16, 128, 4), (3, 16, 64, 1)])
def test_gat_lanes_at_the_experiments_shapes(cuda, s, b, d, heads):
    """Dense-sweep cell A's population (3 seeds, B = 16, D = 128) and arm C's
    at one head: ``fused_gat_lanes`` against ``gat_math`` lane by lane, and
    each lane equal to a single ``fused_gat`` launch to the bit."""
    rng = np.random.default_rng(s * b + d)
    lanes = [_gat_args(rng, b, 64, d, heads, cuda) for _ in range(s)]
    h, att, *ws = (torch.stack(x) for x in zip(*lanes))
    before = fused_gat.fused_gat_lanes.launches
    got = fused_gat.fused_gat_lanes(h, att, *ws, heads)
    torch.cuda.synchronize()
    assert fused_gat.fused_gat_lanes.launches == before + 1
    for i in range(s):
        torch.testing.assert_close(got[i], fused_gat.gat_math(*lanes[i], heads), **KERNEL)
        one = fused_gat.fused_gat(*lanes[i], heads)
        torch.cuda.synchronize()
        assert torch.equal(got[i], one), (i, (got[i] - one).abs().max().item())


@pytest.mark.parametrize("b, d, heads", [(16, 128, 4), (128, 128, 4), (16, 64, 1), (128, 64, 1)])
def test_functions_at_the_experiments_training_shapes(cuda, b, d, heads):
    """``fused_gat`` and ``attend`` as the autograd Functions that
    ``use_pallas`` training runs, at the experiments' training batch (16) and
    variety rollout (8 x 16): forward and every input's gradient against
    autograd of the plain math."""
    rng = np.random.default_rng(b + d)
    h, att, wv, a_src, a_dst, wo, bo = _gat_args(rng, b, 64, d, heads, cuda)
    up = _t(rng, b, 64, d)
    v = h @ wv
    cases = (
        (fused_gat.fused_gat, fused_gat.gat_math, [h, wv, a_src, a_dst, wo, bo],
         lambda fn, xs: fn(xs[0], att, *xs[1:], heads)),
        (fused_attend.attend, fused_attend.attend_math,
         [v, v @ fused_gat._block_diag(a_src), v @ fused_gat._block_diag(a_dst)],
         lambda fn, xs: fn(*xs, att, heads)),
    )
    for kernel, plain, inputs, run in cases:
        leaves = [x.contiguous().clone().requires_grad_() for x in inputs]
        out_k, out_p = run(kernel, leaves), run(plain, leaves)
        g_k = torch.autograd.grad(out_k, leaves, up)
        g_p = torch.autograd.grad(out_p, leaves, up)
        torch.cuda.synchronize()
        torch.testing.assert_close(out_k, out_p, **KERNEL)
        for a, c in zip(g_k, g_p):
            torch.testing.assert_close(a, c, **KERNEL)


@pytest.mark.parametrize("hidden, heads", [(128, 4), (64, 1)])
def test_experiment_configs_route_a_matches_the_plain_route(cuda, hidden, heads):
    """Config 4 at hidden 128 (4 heads of 32) and at one head of 64: route A's
    ``rollout_k`` at the evaluate batch (B = 25, N = 64, K = 20) launches 8
    ``fused_gat`` and 1 ``fused_decode`` and stays within 1e-3 m of the plain
    route on one stream (at most 1% of the rollouts further off)."""
    from mmtraj_torch.config import config4

    mc = dataclasses.replace(config4().model, hidden_dim=hidden, num_heads=heads)
    plain = Forecaster(mc, 8, 12, device=cuda, generator=torch.Generator().manual_seed(hidden))
    model = Forecaster(dataclasses.replace(mc, use_pallas=True, use_fused_decoder=True), 8, 12,
                       device=cuda, state=plain.state_dict())
    rng = np.random.default_rng(heads)
    b, n, k = 25, 64, 20
    xy = torch.cumsum(_t(rng, b, n, 8, 2, scale=0.4), dim=2) + _t(rng, b, n, 1, 2, scale=5)
    mask = torch.from_numpy(rng.random((b, n)) < 0.75).to(cuda)
    stats = NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32))
    stream = plain._rollout_stream(k * b, n, torch.Generator(device=cuda).manual_seed(6))
    before = (fused_gat.fused_gat.launches, fused_decoder.fused_decode.launches)
    got = model.rollout_k(xy, mask, stats, k, stream=stream)
    torch.cuda.synchronize()
    assert (fused_gat.fused_gat.launches, fused_decoder.fused_decode.launches) == (
        before[0] + 8, before[1] + 1)
    want = plain.rollout_k(xy, mask, stats, k, stream=stream)
    assert torch.isfinite(got).all() and got.shape == (k, b, n, 12, 2)
    err = torch.where(mask[None, :, :, None, None], (got - want).abs(), 0.0).flatten(2).amax(2)
    assert int((err > 1e-3).sum()) <= 0.01 * err.numel(), err.max().item()


@pytest.mark.parametrize("n_cap", [16, 32, 64])
def test_occupancy_bench_route_a_matches_plain(cuda, n_cap):
    """The occupancy bench's route A (``fused_gat`` and ``fused_decode``) at
    each bucket capacity, at the bucket's batch and on the bench's inputs,
    against its plain route on one stream: within 1e-3 m on valid agents,
    at most 1% of the rollouts further off; each kernel launched."""
    from mmtraj_torch.benchmarks import occupancy_bench as occ

    model_a, stats = occ.make_model("A", cuda)
    plain, _ = occ.make_model("plain", cuda)
    k = 20
    b = occ.bucket_batch(model_a, k, n_cap)
    xy_obs, mask = occ.rate_inputs(model_a, n_cap, b, np.array([n_cap]),
                                   np.random.default_rng(n_cap))
    stream = plain._rollout_stream(k * b, n_cap, torch.Generator(device=cuda).manual_seed(3))
    before = (fused_gat.fused_gat.launches, fused_decoder.fused_decode.launches)
    got = model_a.rollout_k(xy_obs, mask, stats, k, stream=stream)
    torch.cuda.synchronize()
    assert (fused_gat.fused_gat.launches, fused_decoder.fused_decode.launches) == (
        before[0] + 8, before[1] + 1)
    want = plain.rollout_k(xy_obs, mask, stats, k, stream=stream)
    assert torch.isfinite(got).all() and got.shape == (k, b, n_cap, 12, 2)
    err = torch.where(mask[None, :, :, None, None], (got - want).abs(), 0.0).flatten(2).amax(2)
    assert int((err > 1e-3).sum()) <= 0.01 * err.numel(), err.max().item()


def _model(device, **flags):
    cfg = ModelConfig(hidden_dim=32, embed_dim=32, num_heads=4, **flags)
    return Forecaster(cfg, 8, 12, device=device, generator=torch.Generator().manual_seed(0))


def _check_decode(args, kw):
    """fused_decode launches once, stays finite, and at most 1% of its rollout
    graphs are further than 1e-3 m from the plain version's on valid agents."""
    before = fused_decoder.fused_decode.launches
    got = fused_decoder.fused_decode(*args, **kw)
    torch.cuda.synchronize()
    assert fused_decoder.fused_decode.launches == before + 1
    assert torch.isfinite(got).all()
    want = fused_decoder.reference_decode(*args, **kw)
    worst, past = kernel_inputs.rollout_errors(got, want, args[2])
    assert past <= 0.01 * args[0].shape[0], (worst, past)


@pytest.mark.parametrize("n", [8, 64, 128])
def test_decoder_kernel_matches_plain(cuda, n):
    model = _model(cuda)
    p = model.params()
    rng = np.random.default_rng(n)
    bk = 40
    h0, xy0 = _t(rng, bk, n, 32), _t(rng, bk, n, 2, scale=3)
    mask = torch.from_numpy(rng.random((bk, n)) < 0.75).to(cuda)
    gumbel, normal = model._rollout_stream(bk, n, torch.Generator(device=cuda).manual_seed(n))
    hw, hb = fused_decoder.permute_head(p["head"]["w"], p["head"]["b"], 5)
    kw = dict(num_heads=4, num_mixtures=5, radius=2.0, sigma_min=1e-3, rho_max=0.99,
              stats_mean=np.array([0.01, -0.02], np.float32),
              stats_std=np.array([0.4, 0.5], np.float32))
    _check_decode((h0, xy0, mask, gumbel, normal, p["dec"], hw, hb), kw)


@pytest.mark.parametrize("n, hidden, embed, hd, m, heads", kernel_inputs.DECODER_CASES)
def test_decoder_kernel_at_tile_edges(cuda, n, hidden, embed, hd, m, heads):
    """Config-4 widths at N = 64 and 128, widths off the 8-column tiles, and
    config 3's one head of 64 at N = 32, with glorot-normal weights as the
    model draws them."""
    _check_decode(*kernel_inputs.decoder_case(fused_decoder, n, hidden, embed, hd, m, heads,
                                              device=cuda))


@pytest.mark.parametrize("flags, counts", [
    (dict(use_pallas=True, use_fused_decoder=True), {"fused_gat": 8, "fused_decode": 1}),
    (dict(attend_kernel="pallas"), {"attend": 20}),
])
def test_routes_launch_their_kernels_and_match_the_plain_route(cuda, flags, counts):
    plain = _model(cuda)
    model = Forecaster(dataclasses.replace(plain.cfg, **flags), 8, 12, device=cuda,
                       state=plain.state_dict())
    rng = np.random.default_rng(0)
    xy = torch.cumsum(_t(rng, 6, 64, 8, 2, scale=0.4), dim=2) + _t(rng, 6, 64, 1, 2, scale=3)
    mask = torch.from_numpy(rng.random((6, 64)) < 0.75).to(cuda)
    stats = NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32))
    wrappers = {"attend": fused_attend.attend, "fused_gat": fused_gat.fused_gat,
                "fused_decode": fused_decoder.fused_decode}
    before = {k: w.launches for k, w in wrappers.items()}
    got = model.rollout_k(xy, mask, stats, 4, generator=torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    launched = {k: w.launches - before[k] for k, w in wrappers.items()}
    assert launched == {k: counts.get(k, 0) for k in wrappers}
    want = plain.rollout_k(xy, mask, stats, 4, generator=torch.Generator(device=cuda).manual_seed(1))
    err = torch.where(mask[None, :, :, None, None], (got - want).abs(), 0.0).flatten(2).amax(2)
    assert int((err > 1e-3).sum()) <= 0.01 * err.numel() + 1, err


def test_config3_route_a_matches_the_plain_route(cuda):
    """Config 3 (one head of 64, N_max = 32) at the recipe's 2 m radius:
    route A's ``rollout_k`` at config 3's evaluate batch of 64 windows and
    K = 20 (1,280 rollout graphs in one ``fused_decode``) launches 8
    ``fused_gat`` and 1 ``fused_decode`` and stays within 1e-3 m of the
    plain route on one stream (at most 1% of the rollouts further off)."""
    from mmtraj_torch.config import config3

    mc = dataclasses.replace(config3().model, adjacency_radius=2.0)
    plain = Forecaster(mc, 8, 12, device=cuda, generator=torch.Generator().manual_seed(3))
    model = Forecaster(dataclasses.replace(mc, use_pallas=True, use_fused_decoder=True), 8, 12,
                       device=cuda, state=plain.state_dict())
    rng = np.random.default_rng(3)
    b, n, k = 64, 32, 20
    xy = torch.cumsum(_t(rng, b, n, 8, 2, scale=0.4), dim=2) + _t(rng, b, n, 1, 2, scale=2)
    mask = torch.from_numpy(rng.random((b, n)) < 0.4).to(cuda)
    mask[:, 0] = True
    stats = NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32))
    stream = plain._rollout_stream(k * b, n, torch.Generator(device=cuda).manual_seed(5))
    before = (fused_gat.fused_gat.launches, fused_decoder.fused_decode.launches)
    got = model.rollout_k(xy, mask, stats, k, stream=stream)
    torch.cuda.synchronize()
    assert (fused_gat.fused_gat.launches, fused_decoder.fused_decode.launches) == (
        before[0] + 8, before[1] + 1)
    want = plain.rollout_k(xy, mask, stats, k, stream=stream)
    assert torch.isfinite(got).all() and got.shape == (k, b, n, 12, 2)
    err = torch.where(mask[None, :, :, None, None], (got - want).abs(), 0.0).flatten(2).amax(2)
    assert int((err > 1e-3).sum()) <= 0.01 * err.numel(), err.max().item()


@pytest.mark.parametrize("encoder, count", [("rnn", 8 + 12), ("attn", 2 + 12)])
def test_dense_crowd_auto_route_launches_attend(cuda, encoder, count):
    """At N = 128 "auto" takes the attend kernel in every GAT call: 8
    encoder steps (rnn) or 2 layers over all frames (attn), and 12 decoder
    steps; never the packed kernel."""
    plain = _model(cuda, encoder=encoder, attend_kernel="xla")
    model = Forecaster(dataclasses.replace(plain.cfg, attend_kernel="auto"), 8, 12, device=cuda,
                       state=plain.state_dict())
    rng = np.random.default_rng(3)
    xy = torch.cumsum(_t(rng, 3, 128, 8, 2, scale=0.4), dim=2) + _t(rng, 3, 128, 1, 2, scale=5)
    mask = torch.from_numpy(rng.random((3, 128)) < 0.75).to(cuda)
    stats = NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32))
    before = (fused_attend.attend.launches, fused_attend.attend_packed.launches)
    got = model.rollout_k(xy, mask, stats, 4, generator=torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert (fused_attend.attend.launches, fused_attend.attend_packed.launches) == (
        before[0] + count, before[1])
    want = plain.rollout_k(xy, mask, stats, 4, generator=torch.Generator(device=cuda).manual_seed(1))
    err = torch.where(mask[None, :, :, None, None], (got - want).abs(), 0.0).flatten(2).amax(2)
    assert int((err > 1e-3).sum()) <= 0.01 * err.numel() + 1, err


def test_visualize_rollouts_route_a_launches_and_matches_plain(cuda, tmp_path):
    """``cli visualize``'s rollouts (``cli.visualize_rollouts``) of a route-A
    checkpoint: ``fused_gat`` x8 and ``fused_decode`` x1 a call, and within
    1e-3 m of the plain route's from one stream (at most 1% further)."""
    from mmtraj_torch.cli import visualize_rollouts
    from mmtraj_torch.config import config4
    from mmtraj_torch.data.synthetic import write_synthetic_dataset
    from mmtraj_torch.params import Checkpoint

    write_synthetic_dataset(str(tmp_path), seed=0, n_frames=120)
    cfg = config4()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_dir=str(tmp_path)))
    plain = Forecaster(cfg.model, 8, 12, device=cuda, generator=torch.Generator().manual_seed(0))
    ck = Checkpoint(plain.state_dict(), NormStats(np.zeros(2, np.float32),
                                                  np.full(2, 0.4, np.float32)), cfg, 0)
    route_a = cfg.replace(model=dataclasses.replace(cfg.model, use_pallas=True,
                                                    use_fused_decoder=True))
    b, k = 6, cfg.train.k_samples
    stream = plain._rollout_stream(k * b, cfg.data.n_max,
                                   torch.Generator(device=cuda).manual_seed(4))
    before = (fused_gat.fused_gat.launches, fused_decoder.fused_decode.launches)
    xy, mask, got = visualize_rollouts(ck, route_a, b, 0, cuda, stream=stream)
    assert (fused_gat.fused_gat.launches, fused_decoder.fused_decode.launches) == (
        before[0] + 8, before[1] + 1)
    xy_p, mask_p, want = visualize_rollouts(ck, cfg, b, 0, cuda, stream=stream)
    np.testing.assert_array_equal(xy, xy_p)
    assert np.isfinite(got).all() and got.shape == (k, b, cfg.data.n_max, 12, 2)
    err = np.where(mask[None, :, :, None, None], np.abs(got - want), 0.0).reshape(k, b, -1).max(2)
    assert int((err > 1e-3).sum()) <= 0.01 * err.size, err.max()


def test_wrappers_raise_instead_of_falling_back(cuda):
    rng = np.random.default_rng(1)
    v, s = _t(rng, 2, 8, 16), _t(rng, 2, 8, 2)
    att = _attend_tile(rng, 2, 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_attend.attend(v.double(), s, s, att, 2)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attend.attend(v, s.cpu(), s, att, 2)
    with pytest.raises(ValueError, match="N <= 256"):
        big = _t(rng, 1, 300, 16)
        fused_attend.attend(big, _t(rng, 1, 300, 2), _t(rng, 1, 300, 2),
                            _attend_tile(rng, 1, 300, cuda), 2)


def test_prefetch_close_lets_the_process_exit_cleanly(cuda):
    # Pinned copies on a side stream: a producer still in one when the
    # interpreter exits aborts the process (exit 134).
    for r in torch_exit_check.exit_after_close("cuda", runs=3):
        assert torch_exit_check.clean(r), (r.returncode, r.stderr[-2000:])


def test_graphed_chunk_records_its_spans(cuda):
    """``train.run_chunk`` under a profiler: a chunk records ``train.chunk``,
    one ``train.upload``, a ``train.step`` a step (its id) with a
    ``train.draw`` and a ``train.replay``, and ``train.capture`` only on
    the chunk that captured the graph."""
    from torch.profiler import ProfilerActivity, profile

    from mmtraj_torch import config, population, train
    from mmtraj_torch.utils import profiling

    base = config.config4()
    cfg = base.replace(model=dataclasses.replace(base.model, hidden_dim=32, embed_dim=32,
                                                 num_heads=4, use_pallas=True))
    seeds = [0, 1]
    model = population.lane_model(cfg, cuda)
    params = population.stack_lanes([Forecaster(cfg.model, 8, 12, device="cpu",
                                                generator=torch.Generator().manual_seed(s))
                                     .state_dict() for s in seeds], cuda)
    g = torch.Generator().manual_seed(0)
    xy = torch.cumsum(torch.randn((16, 16, 20, 2), generator=g) * 0.3, 2).to(cuda)
    mask = torch.ones((16, 16), dtype=torch.bool, device=cuda)
    pop = population.make_population_step(
        model, params, train.Optimizer(params, cfg, lanes=True),
        NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32)), seeds)
    rng = np.random.default_rng(0)
    idx = np.stack([np.stack([rng.permutation(16)[:4] for _ in seeds]) for _ in range(6)])
    for k in range(2):
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            losses = pop(xy, mask, idx[3 * k:3 * k + 3], range(3 * k, 3 * k + 3))
            torch.cuda.synchronize()
        spans = profiling.spans()
        profiling.clear_spans()
        assert torch.isfinite(losses).all()
        names = [x.name for x in spans]
        assert names.count("train.chunk") == names.count("train.upload") == 1
        assert names.count("train.capture") == (1 if k == 0 else 0)
        steps = [(i, x) for i, x in enumerate(spans) if x.name == "train.step"]
        assert [x.ids["step"] for _, x in steps] == list(range(3 * k, 3 * k + 3))
        for i, x in steps:
            assert spans[x.parent].name == "train.chunk"
            assert sorted(d.name for d in spans if d.parent == i) == ["train.draw",
                                                                     "train.replay"]
