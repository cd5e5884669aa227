"""The port's data parallelism (``mmtraj_torch/parallel``) on the CPU.

Two gloo processes (``torch_dist.run_ranks``, one spawn for the module)
against one process on the same whole batch: a step's loss and gradients
and the parameters after 3 steps within 1e-6, for nll and variety with
augment, flip and dropout on, plain and ``use_pallas``.  The batch puts 15
valid agents on rank 0 and 3 on rank 1, so averaging per-rank means would
miss by far more.  A 2-rank ``fit`` (resident, and streamed with each rank
prefetching its rows) against the single-process ``fit``.  A 2-rank
``evaluate(mesh=)`` against ``evaluate()`` and JAX's ``evaluate``, fed JAX's
per-window streams, at a batch size the mesh divides and one it does not:
within 1e-12 of ``evaluate()`` and 1e-7 of JAX (float32 rounding of two
implementations, about 1e-8).  The world-size-1 mesh, in this process, against JAX's
``make_train_step`` (loss 1e-5 relative, gradients 1e-4), and
``shard_batch``'s rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtraj import config as jconfig
from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.collate import WindowDataset as JWindowDataset
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.evaluate import evaluate as j_evaluate
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.train import make_train_step as j_make_train_step
from mmtraj_torch import cli, config, train
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.parallel import make_mesh, shard_batch
from mmtraj_torch.params import flatten, from_jax
from torch_dist import evaluate_runs, evaluate_worker, parallel_worker, run_ranks, train_steps
from torch_jax_streams import (SMALL, TO, TP, grad_keeper, jax_step_draws, jax_window_stream,
                               random_windows, write_scenes)

torch.set_num_threads(2)

B, N = 4, 8
STATS = (np.array([0.02, -0.01], np.float32), np.array([0.3, 0.35], np.float32))
DATA = dict(n_max=N, obs_len=TO, pred_len=TP)
STEP_TRAIN = dict(augment_rotate=True, augment_flip=True, seed=3, variety_n=2, lr=3e-3)
STEP_CASES = {f"{loss}-{route}": {
    "model": dict(SMALL, dropout=0.2, **({"use_pallas": True} if route == "use_pallas" else {})),
    "data": DATA, "train": dict(STEP_TRAIN, loss=loss)}
    for loss in ("nll", "variety") for route in ("plain", "use_pallas")}
TOL = dict(rtol=1e-6, atol=1e-6)
# The port's metrics against JAX's on JAX's streams: float32 rounding of the
# per-window sums in two implementations (1.05e-8 observed on min-FDE).
JAX_METRIC_TOL = 1e-7


def _batch():
    """15 valid agents in rank 0's two windows, 3 in rank 1's."""
    rng = np.random.default_rng(7)
    xy = np.zeros((B, N, TO + TP, 2), np.float32)
    mask = np.zeros((B, N), bool)
    for b, w in enumerate(random_windows(rng, [8, 7, 2, 1])):
        xy[b, :len(w)] = w + rng.normal(size=(1, 1, 2)).astype(np.float32) * 2
        mask[b, :len(w)] = True
    return xy, mask


def _state(seed=1):
    return Forecaster(config.ModelConfig(**SMALL), TO, TP, device="cpu",
                      generator=torch.Generator().manual_seed(seed)).state_dict()


def _fit_cases(data_dir):
    base = dict(model=dict(SMALL, dropout=0.1), data=dict(DATA, data_dir=data_dir),
                train=dict(batch_size=4, steps=6, eval_every=0, log_every=1, k_samples=2,
                           out_dir="", loss="hybrid", variety_n=2, augment_rotate=True,
                           augment_flip=True, ema_decay=0.9))
    stream = dict(base, train=dict(base["train"], stream=True))
    return {"resident": base, "stream": stream}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 2-rank run of every step and fit case."""
    data_dir = write_scenes(tmp_path_factory.mktemp("scenes"))
    xy, mask = _batch()
    fit_cases = _fit_cases(data_dir)
    per_rank = run_ranks(parallel_worker, 2, STEP_CASES, xy, mask, _state(), STATS, fit_cases)
    return dict(per_rank=per_rank, xy=xy, mask=mask, fit_cases=fit_cases)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_two_rank_step_equals_the_single_process_step(case, ranks):
    want = train_steps(STEP_CASES[case], ranks["xy"], ranks["mask"], _state(), STATS)
    for steps, _ in ranks["per_rank"]:
        got = steps[case]
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
        for k in want["grads"]:
            np.testing.assert_allclose(got["grads"][k], want["grads"][k], **TOL, err_msg=k)
        for k in want["params"]:
            np.testing.assert_allclose(got["params"][k], want["params"][k], **TOL, err_msg=k)


def test_a_mean_of_rank_means_would_fail_the_batch():
    """The batch is one a per-rank mean gets wrong: the ranks' agent counts differ."""
    _, mask = _batch()
    assert mask[:2].sum() == 15 and mask[2:].sum() == 3


@pytest.mark.parametrize("ingest", ["resident", "stream"])
def test_two_rank_fit_equals_the_single_process_fit(ingest, ranks):
    """Hybrid loss, dropout, augment and EMA; streamed, each rank prefetches
    its own rows and counts the whole batch's agents on the host."""
    from torch_dist import fit_run

    case = ranks["fit_cases"][ingest]
    single = dict(case, train=dict(case["train"], stream=False))
    want = fit_run(single)
    for _, fits in ranks["per_rank"]:
        got = fits[ingest]
        assert [s for s, _ in got["history"]] == [s for s, _ in want["history"]]
        np.testing.assert_allclose([v for _, v in got["history"]],
                                   [v for _, v in want["history"]], rtol=1e-5)
        for k in want["state"]:
            np.testing.assert_allclose(got["state"][k], want["state"][k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_world_size_one_step_matches_jax(monkeypatch):
    """The data-parallel step on a mesh of one rank (gloo, this process)
    against JAX's ``make_train_step`` on the same batch and draws."""
    jmc = dataclasses.replace(jconfig.config4().model, **SMALL, remat=True, dropout=0.2)
    mc = config.ModelConfig(**dataclasses.asdict(jmc))
    jm = JForecaster(jmc, TO, TP)
    params = jm.init(jax.random.PRNGKey(1))
    state = from_jax(jax.tree.map(np.asarray, params))
    xy, mask = _batch()
    kw = dict(augment_rotate=True, augment_flip=True, seed=3, loss_mode="variety", variety_n=2)
    keeper = grad_keeper()
    jstep = j_make_train_step(jm, keeper, JNormStats(*STATS), **kw)
    _, jgrads, jloss = jstep(params, keeper.init(params), jnp.asarray(xy), jnp.asarray(mask),
                             jnp.int32(5))
    draws = jax_step_draws(jm)(None, 3, 5, B, N, True, True, 2)
    monkeypatch.setattr(train, "step_draws", lambda *a, **k: draws)
    model = Forecaster(mc, TO, TP, device="cpu", state=state)
    cfg = config.config4().replace(model=mc)
    step = train.make_train_step(model, train.make_optimizer(cfg, model), NormStats(*STATS),
                                 mesh=make_mesh(device="cpu"), **kw)
    loss = step(torch.from_numpy(xy), torch.from_numpy(mask), 5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_make_mesh_at_world_size_one_and_shard_batch_rows():
    mesh = make_mesh(device="cpu")
    assert (mesh.size(), mesh.get_local_rank()) == (1, 0)
    assert mesh.mesh_dim_names == ("data",)
    with pytest.raises(ValueError, match="needs a process group of 2"):
        make_mesh(2, device="cpu")
    xy = torch.arange(12.0).reshape(6, 2)
    rows = shard_batch({"xy": xy, "n": torch.tensor(3.0), "m": (xy[:, 0], None)}, mesh)
    assert torch.equal(rows["xy"], xy) and rows["n"].item() == 3.0 and rows["m"][1] is None

    class Two:  # rank 1 of a mesh of 2
        def size(self):
            return 2

        def get_local_rank(self):
            return 1

    assert torch.equal(shard_batch(xy, Two()), xy[3:])
    assert np.array_equal(shard_batch(np.arange(4), Two()), [2, 3])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(torch.zeros(5), Two())


def _eval_setup():
    jm = JForecaster(JModelConfig(**SMALL), TO, TP)
    params = jm.init(jax.random.PRNGKey(0))
    windows = random_windows(np.random.default_rng(3), [3, 1, 5, 2, 6, 4, 2, 3, 1])
    k = 3
    draw = jax_window_stream(jm)
    streams = [tuple(a.reshape((k,) + a.shape[1:]).numpy()
                     for a in draw(None, (0, 0, 0), [w], k, N)) for w in range(len(windows))]
    return jm, params, windows, k, streams


def test_two_rank_evaluate_equals_evaluate_and_jax():
    """Batch sizes 4 (divided by the mesh) and 5 (rounded up to 6)."""
    jm, params, windows, k, streams = _eval_setup()
    state = from_jax(jax.tree.map(np.asarray, params))
    sizes = [4, 5]
    want = j_evaluate(jm, params, JNormStats(*STATS), JWindowDataset(windows, N), k=k,
                      batch_size=4)
    single = evaluate_runs(SMALL, state, windows, N, STATS, k, sizes, streams)
    per_rank = run_ranks(evaluate_worker, 2, SMALL, state, windows, N, STATS, k, sizes, streams)
    for got in [*single, *(m for r in per_rank for m in r)]:
        assert got["n_windows"] == want["n_windows"] and got["n_agents"] == want["n_agents"]
        for key in ("min_ade", "min_fde", "miss_rate_2m", "collision_rate", "nll"):
            assert abs(got[key] - want[key]) <= JAX_METRIC_TOL, (key, got[key], want[key])
    for r in per_rank:
        for got, ref in zip(r, single):
            for key in ("min_ade", "min_fde", "miss_rate_2m", "collision_rate", "nll"):
                assert abs(got[key] - ref[key]) <= 1e-12, (key, got[key], ref[key])


def test_eval_data_parallel_runs_on_the_cpu(tmp_path, capsys):
    """``cli eval --data-parallel --device cpu``: a mesh of one gloo rank
    here, the same line as without it."""
    from mmtraj_torch.params import save_npz

    data_dir = write_scenes(tmp_path)
    mc = config.ModelConfig(**SMALL)
    model = Forecaster(mc, TO, TP, device="cpu", generator=torch.Generator().manual_seed(0))
    cfg = config.config4().replace(model=mc, data=dataclasses.replace(
        config.config4().data, data_dir=data_dir, **DATA),
        train=dataclasses.replace(config.config4().train, k_samples=2))
    ckpt = str(tmp_path / "ck.npz")
    save_npz(ckpt, model.state_dict(), NormStats(*STATS), cfg, 0)
    argv = ["eval", "--ckpt", ckpt, "--device", "cpu", "--batch-size", "3"]
    assert cli.main(argv) == 0
    plain = capsys.readouterr().out.strip().splitlines()[-1]
    assert cli.main(argv + ["--data-parallel"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == plain
