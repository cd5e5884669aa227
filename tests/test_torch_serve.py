"""The port's serving surface (``mmtraj_torch/serve.py``) against the JAX
package's contract: every case of ``tests/test_serve.py`` on the port's
server, the JAX server's validation error lines byte for byte, and ``cli
export``/``cli serve`` through ``main()``.

The artifacts are exported for the CPU at the JAX serving tests' size
(hidden 16, embed 8, 2 heads, M = 2; capacity 4 windows of 8 agents, K = 3).
The main one runs route A (``use_pallas`` + ``use_fused_decoder``, whose
program holds the ``mmtraj.*`` ops and loads fastest); the bucketed cases
add a plain artifact of 4 agents, which route A's fused decoder does not
take.
"""

import io
import json
import sys

import jax
import numpy as np
import pytest
import torch

from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.export import export_predictor as j_export_predictor
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.serve import serve_lines as j_serve_lines
from mmtraj_torch.config import Config, DataConfig, ModelConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.export import export_predictor, load_predictor
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import save_npz
from mmtraj_torch.serve import BucketedPredictServer, PredictServer, serve_lines

torch.set_num_threads(2)

B_CAP, N_CAP, K = 4, 8, 3
SMALL = dict(num_heads=2, embed_dim=8, hidden_dim=16, num_mixtures=2)
ROUTE_A = dict(use_pallas=True, use_fused_decoder=True)
STATS = NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32))


def _model(**route):
    return Forecaster(ModelConfig(**SMALL, **route), 8, 12, device="cpu",
                      generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "predictor.pt2")
    export_predictor(path, _model(**ROUTE_A), None, STATS, k=K, batch=B_CAP, n_agents=N_CAP)
    return path


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    jm = JForecaster(JModelConfig(**SMALL), 8, 12)
    path = str(tmp_path_factory.mktemp("serve_jax") / "predictor.stablehlo")
    j_export_predictor(path, jm, jm.init(jax.random.PRNGKey(0)), JNormStats(*STATS), k=K,
                       batch=B_CAP, n_agents=N_CAP, platform="cpu")
    return path


def _walk(rng, b, n, t=8):
    steps = rng.normal(size=(b, n, t, 2)).astype(np.float32) * 0.3
    return np.cumsum(steps, axis=2)


# -- the cases of tests/test_serve.py ----------------------------------------

def test_server_reads_capacity_from_artifact(artifact):
    s = PredictServer(artifact)
    assert (s.batch, s.n_agents, s.obs_len, s.k, s.pred_len) == \
        (B_CAP, N_CAP, 8, K, 12)


def test_small_request_matches_manual_padding(artifact, rng):
    """A (2,3) request must return exactly what a caller doing the padding
    by hand would get from the raw artifact — padding is transparent."""
    s = PredictServer(artifact)
    xy = _walk(rng, 2, 3)
    mask = np.array([[True, True, False], [True, False, True]])
    got = s.predict(xy, mask, seed=11)
    assert got.shape == (K, 2, 3, 12, 2)

    xy_p = np.zeros((B_CAP, N_CAP, 8, 2), np.float32)
    xy_p[:2, :3] = xy
    mask_p = np.zeros((B_CAP, N_CAP), bool)
    mask_p[:2, :3] = mask
    want = load_predictor(artifact)(xy_p, mask_p, 11).numpy()[:, :2, :3]
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got[:, mask]).all()


def test_request_validation(artifact, rng):
    s = PredictServer(artifact)
    with pytest.raises(ValueError, match="exceeds artifact capacity"):
        s.predict(_walk(rng, B_CAP + 1, 2))
    with pytest.raises(ValueError, match="exceeds artifact capacity"):
        s.predict(_walk(rng, 1, N_CAP + 1))
    with pytest.raises(ValueError, match="obs_len mismatch"):
        s.predict(_walk(rng, 1, 2, t=5))
    with pytest.raises(ValueError, match="mask shape"):
        s.predict(_walk(rng, 2, 3), mask=np.ones((2, 2), bool))
    with pytest.raises(ValueError, match="xy must be"):
        s.predict(np.zeros((2, 3, 8), np.float32))


def test_serve_lines_protocol(artifact, rng):
    """One loop survives: a single-window request (no batch axis), a batched
    masked request, malformed JSON, and an over-capacity request."""
    single = _walk(rng, 1, 2)[0]
    batched = _walk(rng, 2, 3)
    requests = "\n".join([
        json.dumps({"xy": single.tolist(), "seed": 5}),
        json.dumps({"xy": batched.tolist(),
                    "mask": [[True, True, False], [True, True, True]]}),
        "{not json",
        json.dumps({"xy": _walk(rng, B_CAP + 2, 2).tolist()}),
        "",  # blank lines are skipped, not answered
    ])
    out, log = io.StringIO(), io.StringIO()
    served = serve_lines(artifact, io.StringIO(requests), out, log)
    assert served == 2
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 4
    r0, r1, r2, r3 = (json.loads(x) for x in lines)
    assert np.asarray(r0["pred"]).shape == (K, 2, 12, 2)  # batch axis echoed off
    assert r0["k"] == K
    assert np.asarray(r1["pred"]).shape == (K, 2, 3, 12, 2)
    assert "error" in r2 and "JSONDecodeError" in r2["error"]
    assert "error" in r3 and "exceeds artifact capacity" in r3["error"]
    assert "capacity" in log.getvalue()


def test_pipeline_encode_bytes_identical(artifact, rng):
    """The writer-thread path (default) must produce byte-identical stdout,
    in the same order, as the serial escape hatch — over a mix of good,
    b64-encoded, malformed, and over-capacity requests, with and without
    aggregation."""
    single = _walk(rng, 1, 2)[0]
    batched = _walk(rng, 2, 3)
    requests = "\n".join([
        json.dumps({"xy": single.tolist(), "seed": 5}),
        json.dumps({"xy": single.tolist(), "seed": 5,
                    "encoding": "b64-npy"}),
        "{not json",
        json.dumps({"xy": batched.tolist()}),
        json.dumps({"xy": _walk(rng, B_CAP + 2, 2).tolist()}),
        json.dumps({"xy": single.tolist(), "seed": 5}),
    ])
    server = PredictServer(artifact)
    for agg in (1, 3):
        outs, serveds = [], []
        for pipe in (True, False):
            out, log = io.StringIO(), io.StringIO()
            serveds.append(serve_lines(server, io.StringIO(requests), out,
                                       log, aggregate=agg,
                                       pipeline_encode=pipe))
            outs.append(out.getvalue())
        assert serveds[0] == serveds[1]
        assert outs[0] == outs[1], f"pipelined bytes differ (aggregate={agg})"


def test_serve_lines_binary_encoding_matches_json(artifact, rng):
    """b64-npy responses decode losslessly to the json-encoded prediction;
    an unknown encoding answers {error}, not a dead replica."""
    import base64

    xy = _walk(rng, 2, 3)
    requests = "\n".join([
        json.dumps({"xy": xy.tolist(), "seed": 9}),
        json.dumps({"xy": xy.tolist(), "seed": 9, "encoding": "b64-npy"}),
        json.dumps({"xy": xy.tolist(), "encoding": "protobuf"}),
    ])
    out = io.StringIO()
    served = serve_lines(artifact, io.StringIO(requests), out, io.StringIO())
    assert served == 2
    as_json, as_bin, bad = (json.loads(x) for x in
                            out.getvalue().strip().splitlines())
    decoded = np.load(io.BytesIO(base64.b64decode(as_bin["pred_b64_npy"])))
    assert decoded.shape == tuple(as_bin["shape"]) == (K, 2, 3, 12, 2)
    np.testing.assert_array_equal(decoded, np.asarray(as_json["pred"],
                                                      np.float32))
    assert "error" in bad and "unknown encoding" in bad["error"]


def _b64(arr):
    import base64

    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode()


def test_serve_lines_binary_input_matches_json_input(artifact, rng):
    """xy_b64_npy requests answer byte-identically to the equivalent json-list
    request (single and batched, f32 and f64 payloads); sending both keys or
    a bad-rank payload answers {error}, not a dead replica."""
    single = _walk(rng, 1, 2)[0]
    batched = _walk(rng, 2, 3)
    pairs = "\n".join([
        json.dumps({"xy": single.tolist(), "seed": 5}),
        json.dumps({"xy_b64_npy": _b64(single), "seed": 5}),
        json.dumps({"xy": batched.tolist(), "seed": 1,
                    "encoding": "b64-npy"}),
        json.dumps({"xy_b64_npy": _b64(batched.astype(np.float64)), "seed": 1,
                    "encoding": "b64-npy"}),
        json.dumps({"xy": single.tolist(), "xy_b64_npy": _b64(single)}),
        json.dumps({"xy_b64_npy": _b64(single[0])}),  # rank 2: rejected
    ])
    out = io.StringIO()
    served = serve_lines(artifact, io.StringIO(pairs), out, io.StringIO())
    assert served == 4
    l1, l2, l3, l4, both, rank = out.getvalue().strip().splitlines()
    assert l1 == l2 and l3 == l4
    assert "exactly one of" in json.loads(both)["error"]
    assert "must be" in json.loads(rank)["error"]


def test_serve_lines_same_seed_reproduces(artifact, rng):
    xy = _walk(rng, 1, 2)
    req = json.dumps({"xy": xy.tolist(), "seed": 3}) + "\n"
    server = PredictServer(artifact)
    outs = []
    for _ in range(2):
        out = io.StringIO()
        serve_lines(server, io.StringIO(req), out, io.StringIO())
        outs.append(json.loads(out.getvalue()))
    np.testing.assert_array_equal(outs[0]["pred"], outs[1]["pred"])


def test_aggregation_equals_client_side_batching(artifact, rng):
    """Three single-window same-seed requests under --aggregate must each
    get exactly the slice they'd get from sending the three windows as ONE
    batched request (the documented aggregation contract), in order."""
    xs = [_walk(rng, 1, n)[0] for n in (2, 3, 1)]  # ragged N across requests
    reqs = "\n".join(json.dumps({"xy": x.tolist(), "seed": 4}) for x in xs)
    out = io.StringIO()
    served = serve_lines(artifact, io.StringIO(reqs), out, io.StringIO(),
                         aggregate=4, window_ms=50.0)
    assert served == 3
    got = [np.asarray(json.loads(x)["pred"], np.float32)
           for x in out.getvalue().strip().splitlines()]

    n_g = max(x.shape[0] for x in xs)
    xy_b = np.zeros((3, n_g, 8, 2), np.float32)
    mask_b = np.zeros((3, n_g), bool)
    for j, x in enumerate(xs):
        xy_b[j, :x.shape[0]] = x
        mask_b[j, :x.shape[0]] = True
    want = PredictServer(artifact).predict(xy_b, mask_b, seed=4)
    for j, x in enumerate(xs):
        assert got[j].shape == (K, x.shape[0], 12, 2)
        np.testing.assert_array_equal(got[j], want[:, j, :x.shape[0]])


def test_aggregation_preserves_order_with_mixed_requests(artifact, rng):
    """A seed change, a batched request, and a malformed line each flush the
    pending group; every answer still lands on its request's line."""
    s1, s2 = _walk(rng, 1, 2)[0], _walk(rng, 1, 2)[0]
    batched = _walk(rng, 2, 2)
    reqs = "\n".join([
        json.dumps({"xy": s1.tolist(), "seed": 0}),
        json.dumps({"xy": s2.tolist(), "seed": 7}),     # seed change: flush
        json.dumps({"xy": batched.tolist(), "seed": 7}),  # batched: own call
        "{not json",                                     # error in order
        json.dumps({"xy": s1.tolist(), "seed": 0}),
    ])
    server = PredictServer(artifact)
    out, log = io.StringIO(), io.StringIO()
    served = serve_lines(server, io.StringIO(reqs), out, log,
                         aggregate=8, window_ms=20.0)
    assert served == 4
    lines = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    assert len(lines) == 5
    assert np.asarray(lines[0]["pred"]).shape == (K, 2, 12, 2)
    assert np.asarray(lines[1]["pred"]).shape == (K, 2, 12, 2)
    assert np.asarray(lines[2]["pred"]).shape == (K, 2, 2, 12, 2)
    assert "error" in lines[3]
    assert np.asarray(lines[4]["pred"]).shape == (K, 2, 12, 2)
    # requests 1 and 5 share seed 0 but are separated by flushes — the lone
    # request answers identically to the unaggregated loop (G=1 group).
    solo = io.StringIO()
    serve_lines(server, io.StringIO(json.dumps({"xy": s1.tolist(), "seed": 0})),
                solo, io.StringIO())
    np.testing.assert_array_equal(
        np.asarray(lines[0]["pred"]), np.asarray(json.loads(solo.getvalue())["pred"])
    )


def test_stats_lines_report_counts_and_group_size(artifact, rng):
    """--stats-every N: one operational line per N answered requests, with
    cumulative ok/err and (under aggregation) the mean device-call group."""
    good = json.dumps({"xy": _walk(rng, 1, 2)[0].tolist(), "seed": 0})
    reqs = "\n".join([good, good, "{bad", good])
    log = io.StringIO()
    served = serve_lines(artifact, io.StringIO(reqs), io.StringIO(), log,
                         aggregate=2, window_ms=20.0, stats_every=2)
    assert served == 3
    stats = [x for x in log.getvalue().splitlines() if x.startswith("stats:")]
    assert len(stats) == 2  # 4 answered -> lines at 2 and 4
    assert "answered=2 ok=2 err=0" in stats[0] and "mean_group=2.0" in stats[0]
    # Interval 2 answered one error line and one 1-request group: the error
    # line must not inflate mean_group (lines-per-successful-call, not
    # answered-per-call).
    assert "answered=4 ok=3 err=1" in stats[1] and "mean_group=1.0" in stats[1]
    assert "qps=" in stats[0]


def test_cli_serve_subcommand(artifact, rng, monkeypatch, capsys):
    from mmtraj_torch.cli import main

    req = json.dumps({"xy": _walk(rng, 1, 2)[0].tolist(), "seed": 1}) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(req))
    assert main(["serve", "--artifact", artifact]) == 0
    cap = capsys.readouterr()
    resp = json.loads(cap.out.strip().splitlines()[-1])
    assert np.asarray(resp["pred"]).shape == (K, 2, 12, 2)
    assert "served 1 request(s)" in cap.err


def test_fetch_failure_is_per_request_not_fatal(artifact, rng, monkeypatch):
    """A fetch-time device failure on the pipelined path must answer
    {"error": ...} on that request's line and keep serving — the same
    contract as a blocking predict() failing inside the serial path's try."""

    class _BoomBuf:
        """Stands in for a device result whose copy to the host raises (a
        CUDA error surfacing at ``.cpu()`` on the writer thread)."""

        def cpu(self):
            raise RuntimeError("device exploded at fetch time")

    real = PredictServer.predict_async
    calls = {"n": 0}

    def flaky(self, xy, mask=None, seed=0):
        calls["n"] += 1
        if calls["n"] == 1:
            xy, mask = self.check(xy, mask)
            return _BoomBuf(), mask.shape
        return real(self, xy, mask, seed)

    monkeypatch.setattr(PredictServer, "predict_async", flaky)
    single = _walk(rng, 1, 2)[0]
    requests = "\n".join(
        json.dumps({"xy": single.tolist(), "seed": 5}) for _ in range(3))
    out, log = io.StringIO(), io.StringIO()
    serve_lines(artifact, io.StringIO(requests), out, log)
    lines = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    assert len(lines) == 3
    assert "error" in lines[0] and "device exploded" in lines[0]["error"]
    assert "pred" in lines[1] and "pred" in lines[2]  # replica survived


def test_dead_writer_does_not_deadlock_dispatch_loop(artifact, rng):
    """If the writer thread dies on a stream-write error (client closed
    stdout) while the dispatch loop keeps filling the bounded FIFO, the loop
    must surface the error instead of blocking forever in put()."""

    class _BrokenStream(io.StringIO):
        def write(self, s):
            raise BrokenPipeError("client closed stdout")

    single = _walk(rng, 1, 2)[0]
    # More requests than the FIFO holds (maxsize 8): without the bounded
    # puts this would hang on request ~10 with a dead consumer.
    requests = "\n".join(
        json.dumps({"xy": single.tolist(), "seed": 5}) for _ in range(15))
    with pytest.raises(BrokenPipeError):
        serve_lines(artifact, io.StringIO(requests), _BrokenStream(),
                    io.StringIO())


def test_bucketed_server_routes_to_smallest_fit(artifact, rng, tmp_path):
    """Requests route to the smallest artifact capacity that holds them;
    capacity errors are judged against the combined capacity; each response
    equals sending the same request straight to the routed artifact."""
    small = str(tmp_path / "small.pt2")
    export_predictor(small, _model(), None, STATS, k=K, batch=2, n_agents=4)
    bucketed = BucketedPredictServer([artifact, small])
    assert (bucketed.batch, bucketed.n_agents) == (B_CAP, N_CAP)

    # (2,3) fits the small artifact -> must be answered by it, bit-exact.
    xy = _walk(rng, 2, 3)
    got = bucketed.predict(xy, seed=5)
    want = PredictServer(small).predict(xy, seed=5)
    np.testing.assert_array_equal(got, want)

    # (2,6) only fits the big one.
    xy6 = _walk(rng, 2, 6)
    np.testing.assert_array_equal(bucketed.predict(xy6, seed=5),
                                  PredictServer(artifact).predict(xy6, seed=5))

    # Over COMBINED capacity -> error mentions the combined max.
    with pytest.raises(ValueError, match="every artifact"):
        bucketed.predict(_walk(rng, 2, N_CAP + 1))

    # serve_lines accepts the artifact list and serves both shapes.
    reqs = "\n".join([
        json.dumps({"xy": _walk(rng, 1, 3)[0].tolist(), "seed": 1}),
        json.dumps({"xy": _walk(rng, 1, 7)[0].tolist(), "seed": 1}),
    ])
    out = io.StringIO()
    assert serve_lines([artifact, small], io.StringIO(reqs), out,
                       io.StringIO()) == 2
    lines = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    assert np.asarray(lines[0]["pred"]).shape == (K, 3, 12, 2)
    assert np.asarray(lines[1]["pred"]).shape == (K, 7, 12, 2)


def test_bucketed_server_rejects_mismatched_heads(artifact, tmp_path):
    other_k = str(tmp_path / "otherk.pt2")
    export_predictor(other_k, _model(**ROUTE_A), None, STATS, k=K + 1, batch=2, n_agents=8)
    with pytest.raises(ValueError, match="disagree"):
        BucketedPredictServer([artifact, other_k])


# -- against the JAX server, and the CLI ----------------------------------------

def test_validation_error_lines_equal_the_jax_servers(artifact, jax_artifact, rng):
    """For the same malformed requests the port's loop writes the JAX
    server's lines byte for byte, under both loops."""
    single = _walk(rng, 1, 2)[0]
    requests = "\n".join([
        "{not json",
        json.dumps({"xy": _walk(rng, B_CAP + 2, 2).tolist()}),
        json.dumps({"xy": _walk(rng, 1, N_CAP + 1).tolist()}),
        json.dumps({"xy": _walk(rng, 1, 2, t=5)[0].tolist()}),
        json.dumps({"xy": single.tolist(), "mask": [True, False, True]}),
        json.dumps({"xy": np.zeros((2, 3, 8), np.float32)[0, 0].tolist()}),
        json.dumps({"xy": single.tolist(), "encoding": "protobuf"}),
        json.dumps({"xy": single.tolist(), "xy_b64_npy": _b64(single)}),
        json.dumps({"xy_b64_npy": _b64(single[0])}),
        json.dumps({"seed": 3}),
    ])
    for agg in (1, 4):
        port, jax_out = io.StringIO(), io.StringIO()
        assert serve_lines(artifact, io.StringIO(requests), port, io.StringIO(),
                           aggregate=agg) == 0
        assert j_serve_lines(jax_artifact, io.StringIO(requests), jax_out, io.StringIO(),
                             aggregate=agg) == 0
        lines = port.getvalue().splitlines()
        assert len(lines) == 10 and all("error" in json.loads(x) for x in lines)
        assert port.getvalue() == jax_out.getvalue()


def test_a_jax_artifact_is_refused_naming_the_jax_server(jax_artifact):
    with pytest.raises(ValueError, match="python -m mmtraj.cli serve"):
        PredictServer(jax_artifact)


def test_cli_export_then_serve(tmp_path, rng, monkeypatch, capsys):
    """``cli export`` of a route-A checkpoint, then ``cli serve`` of the
    artifact with aggregation: the answers are the artifact's."""
    from mmtraj_torch.cli import main

    model = _model(**ROUTE_A)
    ckpt = str(tmp_path / "ckpt.npz")
    save_npz(ckpt, model.state_dict(), STATS,
             Config(model=model.cfg, data=DataConfig(n_max=N_CAP)))
    out = str(tmp_path / "cli.pt2")
    assert main(["export", "--ckpt", ckpt, "--out", out, "--batch", str(B_CAP), "--k", str(K),
                 "--device", "cpu"]) == 0
    assert "exported" in capsys.readouterr().out
    xs = [_walk(rng, 1, n)[0] for n in (2, 3)]
    reqs = "\n".join(json.dumps({"xy": x.tolist(), "seed": 6}) for x in xs) + "\n{bad\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(reqs))
    assert main(["serve", "--artifact", out, "--aggregate", "2", "--window-ms", "50"]) == 0
    cap = capsys.readouterr()
    lines = [json.loads(x) for x in cap.out.strip().splitlines()]
    assert "served 2 request(s)" in cap.err
    assert "error" in lines[2]
    xy_b = np.zeros((2, 3, 8, 2), np.float32)
    mask_b = np.zeros((2, 3), bool)
    for j, x in enumerate(xs):
        xy_b[j, :len(x)], mask_b[j, :len(x)] = x, True
    want = PredictServer(out).predict(xy_b, mask_b, seed=6)
    for j, x in enumerate(xs):
        np.testing.assert_array_equal(np.asarray(lines[j]["pred"], np.float32),
                                      want[:, j, :len(x)])


@pytest.mark.parametrize("mode", [[], ["--serve-loop", "--aggregates", "1,2", "--requests", "3"]])
def test_serve_bench_prints_one_json_line(mode, capsys):
    """``serve_bench`` at a tiny size on the CPU: one JSON line on stdout with
    a row per batch size (or aggregate setting)."""
    from mmtraj_torch.benchmarks import serve_bench

    assert serve_bench.main(["--device", "cpu", "--batches", "2", "--k", "2", "--iters", "1",
                             "--scan-iters", "1", *mode]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    row = json.loads(out[0])
    assert (row["card"], row["route"], row["k"]) == ("cpu", "A", 2)
    rows = row["serve_loop"] if mode else row["batches"]
    assert len(rows) == (2 if mode else 1)
    if mode:
        assert all(r["requests_per_s"] > 0 for r in rows)
    else:
        assert rows[0]["batch"] == 2 and rows[0]["e2e_p50_ms"] > 0
