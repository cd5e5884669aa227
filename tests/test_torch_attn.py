"""The dense-crowd slice of the port against the JAX package: the lane-packed
attend path, the attention encoder family and the rollout benchmark module.

On the CPU every kernel wrapper runs its plain version; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_pallas.py runs them.

Tolerances: 1e-5 for one attend chain, layer norm, MLP or attention block
(float32, sums of at most 64 terms, exp, rsqrt and a division: a few ulps
apart between the frameworks); 1e-5 for the encoder's features too (two
pre-LN blocks of those at width 16); 1e-4 m for a 12-step rollout, where the
differences pass through 12 recurrent steps and the position integration.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mmtraj.checkpoint import save_npz
from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.config import config4 as j_config4
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models import attn_encoder as jae
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.models.forecaster import init_params as j_init_params
from mmtraj.models.gat import _attend_group as j_attend_group
from mmtraj.models.layers import layer_norm as j_layer_norm
from mmtraj.models.layers import mlp as j_mlp
from mmtraj.ops import fused_attend as jfa
from mmtraj_torch.benchmarks import rollout_bench
from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models import attn_encoder
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.models.gat import _attend_group, gat_apply
from mmtraj_torch.models.layers import layer_norm, layer_norm_init, mlp, mlp_init
from mmtraj_torch.ops import fused_attend
from mmtraj_torch.params import flatten, from_jax, init_params, load_npz

torch.set_num_threads(2)

LEAF = dict(atol=1e-5, rtol=1e-5)
TRAJ = dict(atol=1e-4, rtol=1e-4)
B, N, K, TO, TP = 2, 8, 4, 8, 12
SMALL = dict(hidden_dim=16, embed_dim=16, num_heads=2, encoder="attn")
MEAN, STD = np.array([0.01, -0.02], np.float32), np.array([0.4, 0.5], np.float32)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


# -- the lane-packed attend path ------------------------------------------------

def _attend_inputs(b, n=16, heads=4, dh=8):
    """As tests/test_pallas.py makes them for the packed kernel: row 3 of
    graph 0 all masked."""
    rng = np.random.default_rng(b)
    v = _f32(rng, b, n, heads * dh)
    ss, sd = _f32(rng, b, n, heads, scale=2), _f32(rng, b, n, heads, scale=2)
    att = (rng.random((b, n, n)) < 0.5).astype(np.float32)
    att[0, 3] = 0.0
    return v, ss, sd, att


@pytest.mark.parametrize("b", [12, 11])
def test_packed_attend_matches_jax_packed_kernel(b):
    v, ss, sd, att = _attend_inputs(b)
    got = fused_attend.attend(*_t(v, ss, sd, att), 4, 8, True).numpy()
    np.testing.assert_allclose(got, jfa.attend_pallas(v, ss, sd, att, 4, 8, True), **LEAF)
    np.testing.assert_allclose(got, jfa.attend_math(v, ss, sd, att, 4), **LEAF)
    assert np.all(got[0, 3] == 0.0)


@pytest.mark.parametrize("group", [3, 1])
def test_packed_attend_refuses_an_odd_group_as_jax_does(group):
    v, ss, sd, att = _attend_inputs(6)
    with pytest.raises(ValueError, match="even group"):
        jfa.attend_pallas(v, ss, sd, att, 4, group, True)
    with pytest.raises(ValueError, match="even group"):
        fused_attend.attend(*_t(v, ss, sd, att), 4, group, True)
    # The unpacked path takes any group, and the group changes no result.
    got = fused_attend.attend(*_t(v, ss, sd, att), 4, group).numpy()
    np.testing.assert_array_equal(got, fused_attend.attend(*_t(v, ss, sd, att), 4).numpy())


@pytest.mark.parametrize("n", [8, 64, 128, 256])
def test_attend_group_matches_jax(n):
    assert _attend_group(n, 4, 16) == j_attend_group(n, 4, 16)


def test_gat_apply_passes_the_jax_group_to_attend(monkeypatch):
    seen = []
    real = fused_attend.attend

    def spy(*a, **kw):
        seen.append(a[5:])
        return real(*a, **kw)

    monkeypatch.setattr(fused_attend, "attend", spy)
    rng = np.random.default_rng(0)
    n, d, heads = 16, 16, 2
    p = {"wv": _f32(rng, d, d, scale=0.3), "a_src": _f32(rng, heads, d // heads),
         "a_dst": _f32(rng, heads, d // heads), "wo": _f32(rng, d, d, scale=0.3),
         "bo": np.zeros(d, np.float32)}
    h, mask = _f32(rng, 2, n, d), rng.random((2, n)) < 0.8
    adj = rng.random((2, n, n)) < 0.5
    gat_apply(_torch_tree(p), *_t(h, adj, mask), heads, attend_kernel="pallas")
    assert seen == [(j_attend_group(n, heads, d // heads),)]


# -- the attention encoder's leaves ----------------------------------------------

def test_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = _f32(rng, 3, 5, 16, scale=3.0) + 2.0
    p = {"scale": _f32(rng, 16), "bias": _f32(rng, 16)}
    np.testing.assert_allclose(layer_norm(_torch_tree(p), torch.from_numpy(x)).numpy(),
                               j_layer_norm(p, x), **LEAF)
    init = layer_norm_init(16)
    assert init.keys() == {"scale", "bias"}
    np.testing.assert_allclose(layer_norm(init, torch.from_numpy(x)).numpy(),
                               j_layer_norm({k: v.numpy() for k, v in init.items()}, x), **LEAF)


def test_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = _f32(rng, 3, 5, 16)
    p = {f"l{i}": {"w": _f32(rng, a, b, scale=0.3), "b": _f32(rng, b, scale=0.1)}
         for i, (a, b) in enumerate([(16, 64), (64, 16)])}
    np.testing.assert_allclose(mlp(_torch_tree(p), torch.from_numpy(x)).numpy(),
                               j_mlp(p, x), **LEAF)
    init = mlp_init(torch.Generator().manual_seed(0), (16, 64, 16))
    assert {k: tuple(v["w"].shape) for k, v in init.items()} == {"l0": (16, 64), "l1": (64, 16)}


@pytest.mark.parametrize("h", [16, 15])
def test_sinusoidal_positions_match_jax(h):
    got = attn_encoder.sinusoidal_positions(8, h)
    assert got.shape == (8, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jae.sinusoidal_positions(8, h), **LEAF)
    if h % 2:
        assert not got[:, -1].any()


def test_temporal_mhsa_matches_jax():
    rng = np.random.default_rng(3)
    H = 16
    p = {k: _f32(rng, H, H, scale=0.3) for k in ("wq", "wk", "wv", "wo")}
    p["bo"] = _f32(rng, H, scale=0.1)
    x = _f32(rng, 2, 3, TO, H)
    got = attn_encoder._temporal_mhsa(_torch_tree(p), torch.from_numpy(x), 2)
    np.testing.assert_allclose(got.numpy(), jae._temporal_mhsa(p, x, 2), **LEAF)
    # Causal: step 0 is a function of step 0 alone.
    x2 = x.copy()
    x2[:, :, 1:] += 5.0
    again = attn_encoder._temporal_mhsa(_torch_tree(p), torch.from_numpy(x2), 2)
    np.testing.assert_allclose(again[:, :, 0].numpy(), got[:, :, 0].numpy(), **LEAF)


# -- the attention encoder end to end ------------------------------------------------

def _windows(seed=0, b=B, n=N):
    rng = np.random.default_rng(seed)
    steps = _f32(rng, b, n, TO + TP, 2, scale=0.4)
    xy = (np.cumsum(steps, axis=2) + rng.normal(size=(b, n, 1, 2)) * 2).astype(np.float32)
    mask = rng.random((b, n)) < 0.75
    mask[:, 0] = True
    return xy[:, :, :TO], xy[:, :, TO:], mask


def _dxy_n(xy_obs):
    d = np.concatenate([np.zeros_like(xy_obs[:, :, :1]), np.diff(xy_obs, axis=2)], axis=2)
    return ((d - MEAN) / STD).astype(np.float32)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("social", [True, False])
def test_attn_encode_matches_jax(layers, social):
    jcfg = JModelConfig(**SMALL, attn_layers=layers, social=social)
    params = jae.attn_encoder_init(jax.random.PRNGKey(layers), jcfg)
    xy_obs, _, mask = _windows(1)
    want = jae.attn_encode(params, jcfg, xy_obs, _dxy_n(xy_obs), mask)
    enc = _torch_tree(jax.tree.map(np.asarray, params))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    got = attn_encoder.attn_encode(enc, cfg, *_t(xy_obs, _dxy_n(xy_obs), mask))
    assert got.shape == (B, N, 16)
    np.testing.assert_allclose(got.numpy(), want, **LEAF)
    assert not got.numpy()[~mask].any()


def test_attn_encode_ignores_padded_agents():
    jcfg = JModelConfig(**SMALL)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    enc = _torch_tree(jax.tree.map(np.asarray, jae.attn_encoder_init(jax.random.PRNGKey(0), jcfg)))
    xy_obs, _, mask = _windows(2)
    noisy = xy_obs.copy()
    noisy[~mask] += _f32(np.random.default_rng(9), *noisy[~mask].shape, scale=50.0)
    a = attn_encoder.attn_encode(enc, cfg, *_t(xy_obs, _dxy_n(xy_obs), mask))
    b = attn_encoder.attn_encode(enc, cfg, *_t(noisy, _dxy_n(noisy), mask))
    torch.testing.assert_close(a[torch.from_numpy(mask)], b[torch.from_numpy(mask)], **LEAF)


ROUTES = {
    "plain": dict(),
    "A": dict(use_pallas=True, use_fused_decoder=True),
    "B": dict(attend_kernel="pallas"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_attn_rollout_k_matches_jax(route):
    jcfg = JModelConfig(**SMALL, **ROUTES[route])
    jm = JForecaster(jcfg, TO, TP)
    params = jm.init(jax.random.PRNGKey(0))
    xy_obs, _, mask = _windows()
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm.rollout_k(params, xy_obs, mask, JNormStats(MEAN, STD), key, K))
    gumbel, normal = jm._rollout_stream(key, K * B, N)
    model = Forecaster(ModelConfig(**dataclasses.asdict(jcfg)), TO, TP, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    got = model.rollout_k(xy_obs, mask, NormStats(MEAN, STD), K,
                          stream=(np.array(gumbel), np.array(normal)))
    assert got.shape == (K, B, N, TP, 2)
    np.testing.assert_allclose(got.numpy(), want, **TRAJ)


def test_attn_routes_call_their_kernel_wrappers(monkeypatch):
    """encoder="attn" under "pallas": one attend call a layer over all B·T
    frame graphs, and one a decoder step."""
    calls = []
    real = fused_attend.attend

    def spy(v, *a, **kw):
        calls.append(tuple(v.shape))
        return real(v, *a, **kw)

    monkeypatch.setattr(fused_attend, "attend", spy)
    model = Forecaster(ModelConfig(**SMALL, attend_kernel="pallas"), TO, TP, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    xy_obs, _, mask = _windows()
    out = model.rollout_k(xy_obs, mask, NormStats(MEAN, STD), K,
                          generator=torch.Generator().manual_seed(1))
    assert calls == [(B * TO, N, 16)] * 2 + [(K * B, N, 16)] * TP
    assert torch.isfinite(out).all()


# -- parameters ------------------------------------------------------------------------

@pytest.mark.parametrize("social", [True, False])
def test_attn_init_params_has_the_jax_keys_and_shapes(social):
    jcfg = dataclasses.replace(j_config4().model, encoder="attn", social=social)
    want = {k: np.asarray(v).shape
            for k, v in flatten(jax.tree.map(np.asarray,
                                             j_init_params(jax.random.PRNGKey(0), jcfg))).items()}
    got = init_params(ModelConfig(**dataclasses.asdict(jcfg)), torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    assert "enc.layers.l1.attn.wq" in got and ("enc.layers.l0.gat.wv" in got) == social
    for k in want:
        assert tuple(got[k].shape) == want[k], k
    assert not got["enc.ln_out.bias"].any() and bool((got["enc.ln_out.scale"] == 1).all())


def test_attn_weights_come_across_from_jax_and_npz(tmp_path):
    jcfg = dataclasses.replace(j_config4(), model=dataclasses.replace(
        j_config4().model, **SMALL))
    params = j_init_params(jax.random.PRNGKey(1), jcfg.model)
    want = flatten(jax.tree.map(np.asarray, params))
    model = Forecaster(ModelConfig(**dataclasses.asdict(jcfg.model)), TO, TP, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    path = str(tmp_path / "attn.npz")
    save_npz(path, params, JNormStats(MEAN, STD), jcfg, step=3)
    ckpt = load_npz(path)
    assert ckpt.config.model.encoder == "attn"
    for k in want:
        np.testing.assert_array_equal(ckpt.state[k].numpy(), want[k])


# -- the benchmark module ------------------------------------------------------------

@pytest.mark.parametrize("encoder", ["rnn", "attn"])
def test_bench_rollout_runs_on_the_cpu(encoder):
    rate = rollout_bench.bench_rollout(n_max=8, kernel="xla", batch=2, k=2, iters=2,
                                       verbose=False, encoder=encoder, device="cpu")
    assert np.isfinite(rate) and rate > 0


def test_op_sweep_runs_on_the_cpu(capsys):
    rows = rollout_bench.op_sweep(num_heads=2, dh=8, iters=2, device="cpu",
                                  ns=(8, 128), bs=(3,))
    assert [(r["N"], r["B"]) for r in rows] == [(8, 3), (128, 3)]
    assert rows[0]["packed_us"] > 0 and rows[1]["packed_us"] is None  # 2N > 128: not packed
    assert all(r["plain_us"] > 0 and r["attend_us"] > 0 for r in rows)
    assert capsys.readouterr().out.count("N=") == 2


def test_bench_main_parses_the_jax_flags(capsys):
    rollout_bench.main(["--end-to-end", "--n-max", "8", "--batch", "2", "--k", "2",
                        "--kernel", "auto", "--iters", "1", "--encoder", "attn",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "encoder=attn kernel=auto" in out
