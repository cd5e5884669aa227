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
                                           (40, 4, 48), (24, 1, 72)])
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


@pytest.mark.parametrize("s, b, n", [(5, 16, 64), (3, 2, 100), (2, 1, 8)])
def test_gat_lanes_kernel_matches_plain(cuda, s, b, n):
    """S lanes with their own weights in one launch of the GAT kernel,
    against ``gat_math`` lane by lane; under ``torch.func.vmap``
    ``fused_gat`` reaches it once for all lanes."""
    rng = np.random.default_rng(s * n)
    d, heads, hd, dout = 64, 4, 64, 64
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


@pytest.mark.parametrize("n, hidden, embed, hd, m", kernel_inputs.DECODER_CASES)
def test_decoder_kernel_at_tile_edges(cuda, n, hidden, embed, hd, m):
    """Config-4 widths at N = 64 and 128, and widths off the 8-column tiles,
    with glorot-normal weights as the model draws them."""
    _check_decode(*kernel_inputs.decoder_case(fused_decoder, n, hidden, embed, hd, m, device=cuda))


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
