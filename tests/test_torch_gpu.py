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

import numpy as np
import pytest
import torch

from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.ops import fused_attend, fused_decoder, fused_gat

pytestmark = pytest.mark.gpu

KERNEL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, *shape, scale=1.0, device="cuda"):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)


def _attend_tile(rng, b, n, device):
    att = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    att[:, -1] = 0.0  # padded rows: every logit masked, output zero
    return torch.from_numpy(att).to(device)


@pytest.mark.parametrize("n, heads, hd", [(8, 2, 16), (64, 4, 64), (100, 4, 64), (256, 8, 64)])
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


@pytest.mark.parametrize("n, d, heads, hd", [(8, 16, 2, 16), (64, 64, 4, 64), (128, 64, 4, 64),
                                             (256, 64, 4, 64), (64, 32, 4, 48)])
def test_gat_kernel_matches_plain(cuda, n, d, heads, hd):
    rng = np.random.default_rng(n + d)
    args = (_t(rng, 5, n, d), _attend_tile(rng, 5, n, cuda), _t(rng, d, hd, scale=0.3),
            _t(rng, heads, hd // heads, scale=0.3), _t(rng, heads, hd // heads, scale=0.3),
            _t(rng, hd, 40, scale=0.3), _t(rng, 40, scale=0.1))
    before = fused_gat.fused_gat.launches
    got = fused_gat.fused_gat(*args, heads)
    torch.cuda.synchronize()
    assert fused_gat.fused_gat.launches == before + 1
    torch.testing.assert_close(got, fused_gat.gat_math(*args, heads), **KERNEL)


def _model(device, **flags):
    cfg = ModelConfig(hidden_dim=32, embed_dim=32, num_heads=4, **flags)
    return Forecaster(cfg, 8, 12, device=device, generator=torch.Generator().manual_seed(0))


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
    args = (h0, xy0, mask, gumbel, normal, p["dec"], hw, hb)
    before = fused_decoder.fused_decode.launches
    got = fused_decoder.fused_decode(*args, **kw)
    torch.cuda.synchronize()
    assert fused_decoder.fused_decode.launches == before + 1
    want = fused_decoder.reference_decode(*args, **kw)
    err = torch.where(mask[:, None, :, None], (got - want).abs(), 0.0).flatten(1).amax(1)
    assert int((err > 1e-3).sum()) <= 0.01 * bk, err


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
