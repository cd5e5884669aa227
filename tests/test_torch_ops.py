"""The port's kernel modules against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version, which is held against
the JAX reference math and against the JAX Pallas kernel (interpret mode).
tests/test_torch_gpu.py holds each CUDA kernel against its plain version.

Tolerances: 1e-5 for one attend chain or GAT layer (float32, sums of at most
16 terms, exp and a division: a few ulps apart between the frameworks);
1e-4 for a 12-step rollout, where those differences pass through 12
recurrent steps and the position integration.
"""

import jax
import numpy as np
import pytest
import torch

from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.models.gat import gat_apply as j_gat_apply
from mmtraj.ops import fused_attend as jfa
from mmtraj.ops import fused_decoder as jfd
from mmtraj.ops import fused_gat as jfg
from mmtraj_torch.models.gat import gat_apply
from mmtraj_torch.ops import fused_attend, fused_decoder, fused_gat

torch.set_num_threads(2)

LEAF = dict(atol=1e-5, rtol=1e-5)
TRAJ = dict(atol=1e-4, rtol=1e-4)
H, DH = 2, 8
HD = H * DH


def _attend_inputs(rng, B=3, N=8):
    v = rng.normal(size=(B, N, HD)).astype(np.float32)
    s_src = rng.normal(size=(B, N, H)).astype(np.float32) * 2
    s_dst = rng.normal(size=(B, N, H)).astype(np.float32) * 2
    att = (rng.random((B, N, N)) < 0.5).astype(np.float32)
    att[0, 1] = 0.0  # a padded row: every logit masked, output zero
    return v, s_src, s_dst, att


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def test_attend_math_matches_jax_and_pallas():
    v, s_src, s_dst, att = _attend_inputs(np.random.default_rng(0))
    got = fused_attend.attend(*_t(v, s_src, s_dst, att), H).numpy()
    np.testing.assert_allclose(got, fused_attend.attend_math(*_t(v, s_src, s_dst, att), H).numpy())
    np.testing.assert_allclose(got, jfa.attend_math(v, s_src, s_dst, att, H), **LEAF)
    np.testing.assert_allclose(got, jfa.attend_pallas(v, s_src, s_dst, att, H, 4), **LEAF)
    assert np.all(got[0, 1] == 0.0)


def _gat_params(rng, D=16, Dout=16):
    return dict(
        wv=rng.normal(size=(D, HD)).astype(np.float32) * 0.3,
        a_src=rng.normal(size=(H, DH)).astype(np.float32) * 0.3,
        a_dst=rng.normal(size=(H, DH)).astype(np.float32) * 0.3,
        wo=rng.normal(size=(HD, Dout)).astype(np.float32) * 0.3,
        bo=rng.normal(size=(Dout,)).astype(np.float32) * 0.1,
    )


def test_block_diag_and_gat_math_match_jax_and_pallas():
    rng = np.random.default_rng(1)
    p = _gat_params(rng)
    h = rng.normal(size=(4, 8, 16)).astype(np.float32)
    att = (rng.random((4, 8, 8)) < 0.5).astype(np.float32)
    args = [p[k] for k in ("wv", "a_src", "a_dst", "wo", "bo")]
    np.testing.assert_array_equal(fused_gat._block_diag(torch.from_numpy(p["a_src"])).numpy(),
                                  jfg._block_diag(p["a_src"]))
    got = fused_gat.fused_gat(*_t(h, att, *args), H).numpy()
    np.testing.assert_allclose(got, jfg.gat_math(h, att, *args, H), **LEAF)
    np.testing.assert_allclose(got, jfg.fused_gat(h, att, *args, H), **LEAF)


@pytest.mark.parametrize("route", [
    dict(), dict(use_pallas=True), dict(attend_kernel="pallas"),
])
def test_gat_apply_matches_jax(route):
    rng = np.random.default_rng(2)
    p = _gat_params(rng)
    h = rng.normal(size=(3, 8, 16)).astype(np.float32)
    mask = rng.random((3, 8)) < 0.75
    adj = (rng.random((3, 8, 8)) < 0.4) & mask[:, :, None] & mask[:, None, :]
    want = j_gat_apply(p, h, adj, mask, H, **route)
    got = gat_apply({k: torch.from_numpy(v) for k, v in p.items()}, *_t(h, adj, mask), H,
                    **route)
    np.testing.assert_allclose(got.numpy(), want, **LEAF)
    assert np.all(got.numpy()[~mask] == 0.0)


def _decoder_setup(B=4, N=8, T=12):
    cfg = JModelConfig(hidden_dim=16, embed_dim=16, num_heads=H)
    params = JForecaster(cfg, 8, T).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    h0 = rng.normal(size=(B, N, 16)).astype(np.float32)
    xy0 = (rng.normal(size=(B, N, 2)) * 3).astype(np.float32)
    mask = rng.random((B, N)) > 0.25
    gumbel = np.asarray(jax.random.gumbel(jax.random.PRNGKey(7), (B, T, N, cfg.num_mixtures)))
    normal = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (B, T, N, 2)))
    kw = dict(num_heads=H, num_mixtures=cfg.num_mixtures, radius=cfg.adjacency_radius,
              sigma_min=cfg.sigma_min, rho_max=cfg.rho_max,
              stats_mean=np.array([0.01, -0.02], np.float32),
              stats_std=np.array([0.4, 0.5], np.float32))
    return cfg, params, (h0, xy0, mask, gumbel, normal), kw


def _torch_tree(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def test_permute_head_matches_jax():
    rng = np.random.default_rng(4)
    w, b = rng.normal(size=(16, 30)).astype(np.float32), rng.normal(size=(30,)).astype(np.float32)
    tw, tb = fused_decoder.permute_head(torch.from_numpy(w), torch.from_numpy(b), 5)
    jw, jb = jfd.permute_head(w, b, 5)
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(tb.numpy(), jb)


def test_reference_decode_matches_jax_reference_and_pallas():
    cfg, params, inputs, kw = _decoder_setup()
    hw, hb = jfd.permute_head(params["head"]["w"], params["head"]["b"], cfg.num_mixtures)
    want_ref = jfd.reference_decode(*inputs, params["dec"], hw, hb, **kw)
    want_kernel = jfd.fused_decode(*inputs, params["dec"], hw, hb, **kw)
    got = fused_decoder.fused_decode(*_t(*inputs), _torch_tree(params["dec"]),
                                     *_t(np.asarray(hw), np.asarray(hb)), **kw)
    assert got.shape == (4, 12, 8, 2)
    np.testing.assert_allclose(got.numpy(), want_ref, **TRAJ)
    np.testing.assert_allclose(got.numpy(), want_kernel, **TRAJ)


def test_fused_decode_keeps_the_reference_asserts():
    cfg, params, (h0, xy0, mask, gumbel, normal), kw = _decoder_setup(N=6)
    dec = _torch_tree(params["dec"])
    hw, hb = _t(*jfd.permute_head(np.asarray(params["head"]["w"]),
                                  np.asarray(params["head"]["b"]), 5))
    with pytest.raises(AssertionError, match="agent count"):
        fused_decoder.fused_decode(*_t(h0, xy0, mask, gumbel, normal), dec, hw, hb, **kw)
    with pytest.raises(AssertionError, match="radius"):
        fused_decoder.fused_decode(*_t(h0, xy0, mask, gumbel, normal), dec, hw, hb,
                                   **{**kw, "radius": 0.0})
