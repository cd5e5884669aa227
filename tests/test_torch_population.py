"""Population training of the port (``mmtraj_torch/population.py``) and the
kernels under ``torch.func.vmap``, on the CPU.

- The vmap rules of ``mmtraj::fused_gat`` (lanes with their own weights:
  ``fused_gat_lanes``; lanes sharing them: folded into one call) and
  ``mmtraj::attend``, forward and backward, against a per-lane loop, and a
  vmapped call reaching ``fused_gat_lanes`` once for all lanes.
- Each lane against the port's sequential ``fit`` of its seed after 5
  steps (loss and parameters within 1e-5), for nll and variety with augment,
  flip, dropout and EMA on, plain and ``use_pallas``; the sequential runs
  keep config 4's remat, the population runs without it.
- The per-lane clip; one population step of 2 lanes and 2 steps against
  JAX's ``make_population_step`` from the same parameters (1e-5); the
  ``s{seed}/`` tree through ``checkpoint.load`` and a resumed ``fit``; the
  guards; ``cli train --seeds --vmap-seeds`` against ``--seeds``; and a
  2-rank gloo population against the single-process one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtraj import config as jconfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.population import make_population_step as j_make_population_step
from mmtraj.train import make_optimizer as j_make_optimizer
from mmtraj_torch import checkpoint, cli, config, population, train
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.ops import fused_attend, fused_gat
from mmtraj_torch.params import flatten, from_jax
from torch_dist import population_run, population_worker, run_ranks
from torch_jax_streams import SMALL, TO, TP, random_windows, write_scenes

torch.set_num_threads(2)

SEEDS = [0, 3]
LANE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_scenes(tmp_path_factory.mktemp("scenes"))


def _case(data_dir, **train_kw):
    return dict(model=dict(SMALL, dropout=0.1, **train_kw.pop("model", {})),
                data=dict(data_dir=data_dir, n_max=8, obs_len=TO, pred_len=TP),
                train=dict(dict(batch_size=4, steps=5, eval_every=0, log_every=1, k_samples=2,
                                out_dir="", loss="nll", variety_n=2, augment_rotate=True,
                                augment_flip=True, ema_decay=0.9), **train_kw))


def _config(case):
    from torch_dist import _cfg

    return _cfg(case)


# -- the kernels under vmap -------------------------------------------------------

def _lane_inputs(S=3, B=2, n=6, d=8, heads=2, hd=8, dout=8):
    g = torch.Generator().manual_seed(0)
    h = torch.randn((S, B, n, d), generator=g)
    att = (torch.rand((S, B, n, n), generator=g) < 0.5).float()
    att[:, :, -1] = 0.0  # a padded row
    ws = [torch.randn((S,) + s, generator=g) * 0.5 for s in (
        (d, hd), (heads, hd // heads), (heads, hd // heads), (hd, dout), (dout,))]
    return h, att, ws, heads


@pytest.mark.parametrize("weights", ["per-lane", "shared"])
def test_fused_gat_vmap_rule_equals_a_per_lane_loop(weights, monkeypatch):
    h, att, ws, heads = _lane_inputs()
    S = h.shape[0]
    if weights == "shared":
        ws = [w[0] for w in ws]
    calls = []
    real = torch.ops.mmtraj.fused_gat_lanes
    monkeypatch.setattr(torch.ops.mmtraj, "fused_gat_lanes",
                        lambda *a: calls.append(a[0].shape) or real(*a), raising=False)
    leaves = [t.clone().requires_grad_() for t in (h, *ws)]
    in_w = 0 if weights == "per-lane" else None
    out = torch.func.vmap(lambda x, a, *w: fused_gat.fused_gat(x, a, *w, heads),
                          in_dims=(0, 0) + (in_w,) * 5)(leaves[0], att, *leaves[1:])
    up = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    out.backward(up)
    ref_leaves = [t.clone().requires_grad_() for t in (h, *ws)]
    ref = torch.stack([fused_gat.gat_math(ref_leaves[0][s], att[s],
                                          *(w[s] if in_w == 0 else w for w in ref_leaves[1:]),
                                          heads) for s in range(S)])
    ref.backward(up)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)
    assert calls == ([(S, 2, 6, 8)] if weights == "per-lane" else [])


def test_attend_vmap_rule_equals_a_per_lane_loop():
    h, att, ws, heads = _lane_inputs()
    g = torch.Generator().manual_seed(2)
    v = (h @ ws[0][:, None]).detach()
    s_src, s_dst = torch.randn(v.shape[:-1] + (heads,), generator=g), torch.randn(
        v.shape[:-1] + (heads,), generator=g)
    leaves = [t.clone().requires_grad_() for t in (v, s_src, s_dst)]
    out = torch.func.vmap(lambda a, b, c, m: fused_attend.attend(a, b, c, m, heads))(
        *leaves, att)
    up = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    out.backward(up)
    ref_leaves = [t.clone().requires_grad_() for t in (v, s_src, s_dst)]
    ref = torch.stack([fused_attend.attend_math(*(t[s] for t in ref_leaves), att[s], heads)
                       for s in range(v.shape[0])])
    ref.backward(up)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def test_fused_gat_lanes_is_gat_math_lane_by_lane():
    h, att, ws, heads = _lane_inputs()
    out = fused_gat.fused_gat_lanes(h, att, *ws, heads)
    for s in range(h.shape[0]):
        assert torch.equal(out[s], fused_gat.gat_math(h[s], att[s], *(w[s] for w in ws), heads))


# -- lanes against sequential runs ---------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "use_pallas"])
@pytest.mark.parametrize("loss", ["nll", "variety"])
def test_each_lane_equals_its_sequential_fit(loss, route, data_dir):
    case = _case(data_dir, loss=loss, model={"use_pallas": route == "use_pallas"})
    cfg = _config(case)
    pop = population.fit_population(cfg, SEEDS, device="cpu")
    for seed, lane in zip(SEEDS, pop):
        seq = train.fit(cfg.replace(train=dataclasses.replace(cfg.train, seed=seed)),
                        device="cpu")
        assert [s for s, _ in lane.history] == [s for s, _ in seq.history] == list(range(1, 6))
        np.testing.assert_allclose([v for _, v in lane.history], [v for _, v in seq.history],
                                   **LANE_TOL)
        for k in seq.state:
            np.testing.assert_allclose(lane.state[k].numpy(), seq.state[k].numpy(), **LANE_TOL,
                                       err_msg=k)
        assert lane.config.train.seed == seed
    assert not all(torch.equal(pop[0].state[k], pop[1].state[k]) for k in pop[0].state)


def test_the_clip_is_per_lane():
    """Lane 0's gradients scaled by 1e4 clip lane 0 only: lane 1's update
    is that of its own optimizer."""
    cfg = config.config4()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, grad_clip=1.0))
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((2, 3, 4), generator=g), "b": torch.randn((2, 5), generator=g)}
    grads = [torch.randn(p.shape, generator=g) * 0.1 for p in params.values()]
    lane_opt = train.Optimizer({k: v.clone() for k, v in params.items()}, cfg, lanes=True)
    big = [gr.clone() for gr in grads]
    for gr in big:
        gr[0] *= 1e4
    lane_opt.step(big)
    one = train.Optimizer({k: v[1].clone() for k, v in params.items()}, cfg)
    one.step([gr[1] for gr in grads])
    for p_lanes, p_one in zip(lane_opt.params, one.params):
        torch.testing.assert_close(p_lanes[1], p_one, rtol=0, atol=1e-7)
    alone = train.Optimizer({k: v[0].clone() for k, v in params.items()}, cfg)
    alone.step([gr[0] for gr in big])
    for p_lanes, p_alone in zip(lane_opt.params, alone.params):
        torch.testing.assert_close(p_lanes[0], p_alone, rtol=0, atol=1e-7)
    assert lane_opt.state_leaves(1)[1].shape == one.state_leaves()[1].shape


def test_one_population_step_matches_jax():
    """S = 2 lanes, a chunk of M = 2 steps, nll, no augment or dropout: the
    lane losses and the parameters after the chunk, from JAX's own initial
    parameters, against ``mmtraj.population.make_population_step``."""
    jmc = dataclasses.replace(jconfig.config4().model, **SMALL)
    jcfg = jconfig.config4().replace(model=jmc, train=dataclasses.replace(
        jconfig.config4().train, lr=3e-3))
    jm = JForecaster(jmc, TO, TP)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    jparams = jax.vmap(jm.init)(keys)
    rng = np.random.default_rng(5)
    windows = random_windows(rng, [3, 5, 2, 6, 4, 1, 3, 2])
    xy = np.zeros((8, 8, TO + TP, 2), np.float32)
    mask = np.zeros((8, 8), bool)
    for w, a in enumerate(windows):
        xy[w, :len(a)], mask[w, :len(a)] = a, True
    idx = np.stack([rng.permutation(8)[:4].reshape(1, 4).repeat(2, 0) for _ in range(2)])
    idx[:, 1] = idx[:, 1, ::-1]  # the lanes' batches differ
    stats = (np.array([0.02, -0.01], np.float32), np.array([0.3, 0.35], np.float32))
    jopt = j_make_optimizer(jcfg)
    step_fn, _ = j_make_population_step(jm, jopt, JNormStats(*stats))
    host_params = jax.tree.map(np.asarray, jparams)  # the step donates its inputs
    jp, _, _, jlosses = step_fn(jparams, jax.vmap(jopt.init)(jparams), None, jnp.asarray(xy),
                                jnp.asarray(mask), jnp.asarray(idx),
                                jnp.arange(2, dtype=jnp.int32),
                                jnp.stack([jax.random.PRNGKey(s ^ 0x5EED) for s in SEEDS]))

    base = config.config4()
    cfg = base.replace(model=config.ModelConfig(**dataclasses.asdict(jmc)),
                       data=dataclasses.replace(base.data, obs_len=TO, pred_len=TP),
                       train=dataclasses.replace(base.train, lr=3e-3))
    lanes = [from_jax(jax.tree.map(lambda a, i=i: a[i], host_params)) for i in range(2)]
    params = population.stack_lanes(lanes, "cpu")
    model = population.lane_model(cfg, "cpu")
    pop = population.make_population_step(model, params, train.Optimizer(params, cfg, lanes=True),
                                          NormStats(*stats), SEEDS)
    losses = pop(torch.from_numpy(xy), torch.from_numpy(mask), idx, [0, 1])
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    want = flatten(jax.tree.map(np.asarray, jp))
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_eager_population_step_records_a_step_span_with_its_draw():
    """Under a profiler each eager step of ``pop`` records one
    ``train.step`` (its step id) with one ``train.draw`` child."""
    from torch.profiler import ProfilerActivity, profile

    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.utils import profiling

    base = config.config4()
    cfg = base.replace(model=dataclasses.replace(base.model, **SMALL),
                       data=dataclasses.replace(base.data, obs_len=TO, pred_len=TP))
    model = population.lane_model(cfg, "cpu")
    params = population.stack_lanes([Forecaster(cfg.model, TO, TP, device="cpu",
                                                generator=torch.Generator().manual_seed(s))
                                     .state_dict() for s in SEEDS], "cpu")
    rng = np.random.default_rng(2)
    windows = random_windows(rng, [3, 5, 2, 6, 4, 1])
    xy = np.zeros((6, 8, TO + TP, 2), np.float32)
    mask = np.zeros((6, 8), bool)
    for w, a in enumerate(windows):
        xy[w, :len(a)], mask[w, :len(a)] = a, True
    idx = np.stack([np.stack([rng.permutation(6)[:3] for _ in SEEDS]) for _ in range(3)])
    pop = population.make_population_step(
        model, params, train.Optimizer(params, cfg, lanes=True),
        NormStats(np.zeros(2, np.float32), np.full(2, 0.4, np.float32)), SEEDS)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        losses = pop(torch.from_numpy(xy), torch.from_numpy(mask), idx, [4, 5, 6])
    spans = profiling.spans()
    profiling.clear_spans()
    assert losses.shape == (3, len(SEEDS)) and torch.isfinite(losses).all()
    steps = [(i, x) for i, x in enumerate(spans) if x.name == "train.step"]
    assert [x.ids["step"] for _, x in steps] == [4, 5, 6]
    for i, x in steps:
        assert x.parent is None and x.end_ns is not None
        draws = [d for d in spans if d.name == "train.draw" and d.parent == i]
        assert len(draws) == 1 and draws[0].ids == {"step": x.ids["step"]}
        assert x.start_ns <= draws[0].start_ns <= draws[0].end_ns <= x.end_ns
    assert {x.name for x in spans} == {"train.step", "train.draw"}


# -- the tree, the guards, the CLI, data parallelism ----------------------------------

def test_seed_tree_loads_and_resumes(data_dir, tmp_path):
    """Checkpoints at step 3 and at the end (5) in ``s{seed}/``, with each
    lane's optimizer state; resuming lane 3's from step 3 to 5 reaches the
    population's own step-5 parameters."""
    cfg = _config(_case(data_dir, out_dir=str(tmp_path / "pop"), ckpt_every=3))
    pop = population.fit_population(cfg, SEEDS, device="cpu")
    for seed, lane in zip(SEEDS, pop):
        ck = checkpoint.load(str(tmp_path / "pop" / f"s{seed}" / "checkpoint.npz"))
        assert ck.step == 5 and ck.config.train.seed == seed
        assert ck.config.train.out_dir == str(tmp_path / "pop" / f"s{seed}")
        assert ck.config.model == cfg.model  # remat as given
        assert len(ck.opt_leaves) == 1 + 2 * len(ck.state)
        ema = checkpoint.load(str(tmp_path / "pop" / f"s{seed}" / "checkpoint_ema.npz"))
        for k in ema.state:
            assert np.array_equal(ema.state[k], lane.state[k].numpy()), k
    # Cut the seed-3 tree back to its step-3 checkpoint and resume it.
    cut = population.fit_population(
        cfg.replace(train=dataclasses.replace(cfg.train, steps=3,
                                              out_dir=str(tmp_path / "cut"))), SEEDS,
        device="cpu")
    assert [s for s, _ in cut[1].history] == [1, 2, 3]
    resumed = train.fit(cfg.replace(train=dataclasses.replace(
        cfg.train, seed=3, out_dir=str(tmp_path / "cut" / "s3"))), resume=True, device="cpu")
    for k in resumed.state:
        np.testing.assert_allclose(resumed.state[k].numpy(), pop[1].state[k].numpy(),
                                   **LANE_TOL, err_msg=k)


@pytest.mark.parametrize("guard", ["duplicate seeds", "stream", "one seed"])
def test_population_guards(guard, data_dir):
    cfg = _config(_case(data_dir, steps=1))
    if guard == "duplicate seeds":
        with pytest.raises(ValueError, match="duplicate seeds"):
            population.fit_population(cfg, [1, 1], device="cpu")
    elif guard == "stream":
        with pytest.raises(ValueError, match="resident ingest"):
            population.fit_population(cfg.replace(train=dataclasses.replace(
                cfg.train, stream=True)), SEEDS, device="cpu")
    else:
        with pytest.raises(SystemExit):
            cli.main(["train", "--config", "4", "--data-dir", data_dir, "--seeds", "1",
                      "--vmap-seeds", "--device", "cpu"])


def test_cli_vmap_seeds_equals_sequential_seeds(data_dir, tmp_path, capsys):
    argv = ["train", "--config", "4", "--data-dir", data_dir, "--scene", "zara1",
            "--n-max", "8", "--obs-len", str(TO), "--pred-len", str(TP), "--hidden-dim", "16",
            "--num-heads", "2", "--steps", "3", "--batch-size", "4", "--k", "2",
            "--eval-every", "0", "--seeds", "0", "3", "--device", "cpu"]
    assert cli.main(argv + ["--out-dir", str(tmp_path / "seq")]) == 0
    seq = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(("final", "over"))]
    assert cli.main(argv + ["--out-dir", str(tmp_path / "pop"), "--vmap-seeds"]) == 0
    pop = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(("final", "over"))]
    assert len(seq) == 3 and seq[0].startswith("final (seed 0)")
    assert pop == seq
    for s in SEEDS:
        a = checkpoint.load(str(tmp_path / "seq" / f"s{s}" / "checkpoint.npz"))
        b = checkpoint.load(str(tmp_path / "pop" / f"s{s}" / "checkpoint.npz"))
        assert a.step == b.step == 3
        for k in a.state:
            np.testing.assert_allclose(b.state[k], a.state[k], **LANE_TOL, err_msg=k)


def test_two_rank_population_equals_the_single_process_one(data_dir):
    """Each rank takes its 2 rows of every lane's batch of 4."""
    case = _case(data_dir, loss="variety", steps=4)
    want = population_run(case, SEEDS)
    dp = dict(case, train=dict(case["train"], data_parallel=True))
    for got in run_ranks(population_worker, 2, dp, SEEDS):
        for g, w in zip(got, want):
            np.testing.assert_allclose([v for _, v in g["history"]],
                                       [v for _, v in w["history"]], **LANE_TOL)
            for k in w["state"]:
                np.testing.assert_allclose(g["state"][k], w["state"][k], **LANE_TOL, err_msg=k)



