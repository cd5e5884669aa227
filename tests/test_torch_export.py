"""The port's kernels as ``torch.library`` custom ops, and the frozen
predictor of ``mmtraj_torch/export.py`` against the live model and against
the JAX package's ``mmtraj.export.make_predictor``.

On the CPU every op runs its plain version; ``torch.library.opcheck`` checks
each op's schema, its fake (meta) implementation against the real output and
its use under ``torch.compile``'s dispatcher.  The artifacts are exported
for the CPU at the JAX serving tests' size (hidden 16, embed 8, 2 heads,
M = 2; capacity 4 windows of 8 agents, K = 3).

Tolerances: an artifact fed a stream equals the live ``rollout_k`` fed it
within 1e-6 m (the same float32 ops in the same order; observed 0); against
JAX, 1e-4 m on valid agents, the trajectory tolerance of the port's parity
tests (float32 ulps carried through 8 encoder and 12 decoder steps).
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

from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.export import make_predictor as j_make_predictor
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch.config import ModelConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.export import (META, draw_stream, export_predictor, kernel_nodes,
                                 load_exported, load_predictor, make_predictor)
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.ops import fused_attend, fused_decoder, fused_gat
from mmtraj_torch.params import from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
B_CAP, N_CAP, K, TO, TP = 4, 8, 3, 8, 12
SMALL = dict(num_heads=2, embed_dim=8, hidden_dim=16, num_mixtures=2)
ROUTES = {"plain": dict(), "A": dict(use_pallas=True, use_fused_decoder=True)}
STATS = NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32))
LIVE = dict(atol=1e-6, rtol=0)
TRAJ = dict(atol=1e-4, rtol=1e-4)


def _walk(rng, b, n, t=TO):
    return np.cumsum(rng.normal(size=(b, n, t, 2)).astype(np.float32) * 0.3, axis=2)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.random((B_CAP, N_CAP)) > 0.2
    mask[:, 0] = True
    return _walk(rng, B_CAP, N_CAP), mask


@pytest.fixture(scope="module")
def jax_params():
    return JForecaster(JModelConfig(**SMALL), TO, TP).init(jax.random.PRNGKey(0))


def _model(route, jax_params):
    return Forecaster(ModelConfig(**SMALL, **ROUTES[route]), TO, TP, device="cpu",
                      state=from_jax(jax.tree.map(np.asarray, jax_params)))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, jax_params):
    """(route, oversample) -> artifact path, exported on first use."""
    root = tmp_path_factory.mktemp("export")
    made = {}

    def get(route, oversample=1):
        if (route, oversample) not in made:
            path = str(root / f"{route}-{oversample}.pt2")
            export_predictor(path, _model(route, jax_params), None, STATS, k=K, batch=B_CAP,
                             n_agents=N_CAP, oversample=oversample)
            made[route, oversample] = path
        return made[route, oversample]

    return get


@pytest.fixture(scope="module")
def programs(artifacts):
    """(route, oversample) -> ``load_exported`` of the artifact, loaded once."""
    loaded = {}

    def get(route, oversample=1):
        if (route, oversample) not in loaded:
            loaded[route, oversample] = load_exported(artifacts(route, oversample))
        return loaded[route, oversample]

    return get


# -- the custom ops ------------------------------------------------------------

def _op_cases():
    g = torch.Generator().manual_seed(0)
    B, N, D, H, HD = 3, 8, 8, 2, 8

    def r(*shape):
        return torch.randn(shape, generator=g)

    att = (torch.rand((B, N, N), generator=g) < 0.5).float()
    att = torch.maximum(att, torch.eye(N))
    v, s = r(B, N, HD), r(B, N, H)
    gat = (r(B, N, D), att, r(D, HD), r(H, HD // H), r(H, HD // H), r(HD, D), r(D), H)
    T, M, E = 4, 2, 8
    weights = [r(2, E), r(E), r(E, 3 * D), r(D, 3 * D), r(3 * D), r(D, HD), r(H, HD // H),
               r(H, HD // H), r(HD, D), r(D), r(D, 6 * M), r(6 * M)]
    decode = (r(B, N, D), r(B, N, 2) * 2, torch.rand((B, N), generator=g) < 0.8,
              r(B, T, N, M), r(B, T, N, 2), weights, torch.tensor([0.0, 0.0, 0.4, 0.4]),
              H, M, 4.0, 1e-3, 0.99)
    return {"attend": (torch.ops.mmtraj.attend, (v, s, s.flip(1), att, H)),
            "attend_packed": (torch.ops.mmtraj.attend_packed, (v, s, s.flip(1), att, H)),
            "fused_gat": (torch.ops.mmtraj.fused_gat, gat),
            "fused_decode": (torch.ops.mmtraj.fused_decode, decode)}


@pytest.mark.parametrize("name", ["attend", "attend_packed", "fused_gat", "fused_decode"])
def test_op_passes_opcheck(name):
    """Schema, the fake implementation's shapes and dtypes against the real
    output, and the op under the dispatcher's tracing; the CPU output is the
    plain version's."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    out = op(*args)
    if name == "fused_decode":
        h0, xy0, mask, gumbel, normal, weights, st = args[:7]
        dec, hw, hb = fused_decoder._unflatten(weights)
        want = fused_decoder.reference_decode(
            h0, xy0, mask, gumbel, normal, dec, hw, hb, num_heads=args[7], num_mixtures=args[8],
            radius=args[9], sigma_min=args[10], rho_max=args[11], stats_mean=st[:2],
            stats_std=st[2:])
        assert out.shape == normal.shape  # (B*K, T, N, 2), permuted by the caller
    elif name == "fused_gat":
        want = fused_gat.gat_math(*args)
    else:
        want = fused_attend.attend_math(*args)
    assert torch.equal(out, want)


def test_wrappers_call_the_ops_and_count_no_cpu_launch():
    """The wrappers reach their ops on the CPU (no launch is counted there),
    and a recorded gradient goes through the autograd Functions."""
    _, (h, att, *rest) = _op_cases()["fused_gat"]
    before = {k: f.launches for k, f in (("gat", fused_gat.fused_gat),
                                        ("attend", fused_attend.attend))}
    with torch.no_grad():
        out = fused_gat.fused_gat(h, att, *rest)
    assert torch.equal(out, fused_gat.gat_math(h, att, *rest))
    hg = h.clone().requires_grad_()
    fused_gat.fused_gat(hg, att, *rest).sum().backward()
    hr = h.clone().requires_grad_()
    fused_gat.gat_math(hr, att, *rest).sum().backward()
    assert torch.equal(hg.grad, hr.grad)
    assert fused_gat.fused_gat.launches == before["gat"]
    assert fused_attend.attend.launches == before["attend"]


# -- the artifact against the live model -------------------------------------

@pytest.mark.parametrize("route, nodes", [
    ("plain", {}),
    ("A", {"mmtraj.fused_gat.default": TO, "mmtraj.fused_decode.default": 1}),
])
def test_artifact_equals_live_rollout(route, nodes, artifacts, programs, jax_params):
    assert not Path(artifacts(route) + ".tmp").exists()
    program, meta = programs(route)
    assert kernel_nodes(program) == nodes
    assert (meta["batch"], meta["n_agents"], meta["k"], meta["obs_len"], meta["pred_len"],
            meta["num_mixtures"], meta["device"]) == (B_CAP, N_CAP, K, TO, TP, 2, "cpu")
    assert meta["config"] == dataclasses.asdict(ModelConfig(**SMALL, **ROUTES[route]))
    xy, mask = _inputs()
    model = _model(route, jax_params)
    gumbel, normal = draw_stream(K * B_CAP, TP, N_CAP, 2, 5, "cpu")
    with torch.no_grad():
        got = program.module()(torch.from_numpy(xy), torch.from_numpy(mask), gumbel, normal)
    want = model.rollout_k(xy, mask, STATS, K, stream=(gumbel, normal))
    assert got.shape == (K, B_CAP, N_CAP, TP, 2)
    torch.testing.assert_close(got, want, **LIVE)


@pytest.mark.parametrize("rows, n, seed", [(K * B_CAP, N_CAP, 5), (7, 3, 2**31 + 1)])
def test_draw_stream_is_the_models_stream_to_the_bit(rows, n, seed, jax_params):
    """``draw_stream`` from a seed and ``Forecaster._rollout_stream`` from a
    generator seeded so draw one stream: Gumbel noise and normals equal to
    the bit."""
    got = draw_stream(rows, TP, n, SMALL["num_mixtures"], seed, "cpu")
    want = _model("plain", jax_params)._rollout_stream(rows, n,
                                                       torch.Generator().manual_seed(seed))
    assert got[0].shape == (rows, TP, n, SMALL["num_mixtures"]) and got[1].shape == (rows, TP, n, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_seed_draws_the_live_stream_and_reproduces(artifacts, jax_params):
    """``load_predictor`` draws the stream from the seed as ``rollout_k``
    draws it from a generator so seeded; the same seed reproduces, another
    differs."""
    predict = load_predictor(artifacts("A"))
    xy, mask = _inputs(1)
    a, b, c = (predict(xy, mask, s) for s in (3, 3, 4))
    live = _model("A", jax_params).rollout_k(xy, mask, STATS, K,
                                             generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, live, **LIVE)
    assert torch.equal(a, b)
    assert not torch.allclose(a[:, mask], c[:, mask])
    assert torch.isfinite(a[:, mask]).all()


@pytest.mark.parametrize("oversample", [1, 3])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_artifact_matches_jax_make_predictor(route, oversample, programs, jax_params):
    """JAX's frozen predictor with the seed, against the port's artifact fed
    the stream JAX's ``_rollout_stream(PRNGKey(seed), R*B, N)`` draws."""
    jm = JForecaster(dataclasses.replace(JModelConfig(**SMALL), **ROUTES[route]), TO, TP)
    xy, mask = _inputs(2)
    seed = 7
    want = np.asarray(j_make_predictor(jm, jax_params, JNormStats(*STATS), K, oversample)(
        xy, mask, seed))
    gumbel, normal = (torch.from_numpy(np.array(a)) for a in jm._rollout_stream(
        jax.random.PRNGKey(seed), K * oversample * B_CAP, N_CAP))
    program, meta = programs(route, oversample)
    assert meta["oversample"] == oversample
    with torch.no_grad():
        got = program.module()(torch.from_numpy(xy), torch.from_numpy(mask), gumbel, normal)
    assert got.shape == want.shape == (K, B_CAP, N_CAP, TP, 2)
    np.testing.assert_allclose(got.numpy()[:, mask], want[:, mask], **TRAJ)


def test_oversample_artifact_selects_from_more_samples(artifacts):
    xy, mask = _inputs(3)
    sel = load_predictor(artifacts("A", 3))(xy, mask, 2)
    plain = load_predictor(artifacts("A"))(xy, mask, 2)
    assert sel.shape == plain.shape
    assert not torch.allclose(sel[:, mask], plain[:, mask])


def test_artifact_loads_and_answers_without_model_code(artifacts, tmp_path):
    """A fresh interpreter loads a route-A artifact and answers from it
    having imported neither ``mmtraj_torch.models`` nor JAX nor the JAX
    package: ``load_exported`` registers the ops by importing the kernel
    modules alone."""
    path = artifacts("A")
    xy, mask = _inputs(4)
    np.save(tmp_path / "xy.npy", xy)
    np.save(tmp_path / "mask.npy", mask)
    script = (
        "import sys, numpy as np\n"
        "from mmtraj_torch.export import load_predictor\n"
        f"d = {str(tmp_path)!r}\n"
        f"out = load_predictor({path!r})(np.load(d + '/xy.npy'), np.load(d + '/mask.npy'), 9)\n"
        "np.save(d + '/out.npy', out.numpy())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mmtraj')\n"
        "             or m.startswith('mmtraj_torch.models'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    want = load_predictor(path)(xy, mask, 9).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


def test_export_requires_n_agents(jax_params, tmp_path):
    with pytest.raises(ValueError, match="n_agents"):
        export_predictor(str(tmp_path / "p.pt2"), _model("plain", jax_params), None, STATS)


def test_load_checks_metadata_against_the_program(programs, tmp_path):
    program, meta = programs("A")
    bad = tmp_path / "bad.pt2"
    with open(bad, "wb") as f:
        torch.export.save(program, f, extra_files={META: json.dumps({**meta, "batch": 5})})
    with pytest.raises(ValueError, match="disagree"):
        load_exported(str(bad))


def test_make_predictor_freezes_a_copy(jax_params):
    model = _model("plain", jax_params)
    pred = make_predictor(model, None, STATS, K)
    assert not any(p.requires_grad for p in pred.parameters())
    assert all(p.requires_grad for p in model.parameters())
    xy, mask = _inputs(5)
    gumbel, normal = draw_stream(K * B_CAP, TP, N_CAP, 2, 1, "cpu")
    torch.testing.assert_close(
        pred(torch.from_numpy(xy), torch.from_numpy(mask), gumbel, normal),
        model.rollout_k(xy, mask, STATS, K, stream=(gumbel, normal)), **LIVE)


def test_the_import_scan_covers_the_new_modules():
    """``test_torch_params.py``'s scan for JAX and ``mmtraj`` imports reads
    every file of the port, export and serving included."""
    from test_torch_params import _port_files

    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"mmtraj_torch/export.py", "mmtraj_torch/serve.py",
            "mmtraj_torch/benchmarks/serve_bench.py", "chip_smoke.py"} <= names
