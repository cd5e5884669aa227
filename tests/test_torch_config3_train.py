"""Config 3's training recipe at full width, the port against the JAX package
on the CPU.

RESULTS.md's recipe (``RESULTS.md:14-20,55-72``) trains config 3 (one GAT
head of 64, N_max = 32) with the variety loss over 8 rollouts, rotate and
flip augmentation, dropout 0.1, AdamW's weight decay 1e-4, the EMA at
0.995, the cosine schedule, chunks of 50 steps and a 2 m adjacency radius,
5 seeds as one population.  Here, from the same numpy inputs, parameters and
random draws (``tests/test_torch_config3.py`` holds the model side):

- one recipe step from one mid-run state (Adam's moments, the schedule's
  count in the cosine decay, an EMA apart from the parameters), JAX's draws:
  loss 1e-5 relative, parameters and EMA by ``chip_smoke.py``'s
  ``PARAM_TOL`` rule (every element within 2 lr, 99% within 1e-4);
- a population step of 2 lanes against each lane's sequential step
  (1e-5 relative, 1e-6 absolute: the lanes run without remat);
- ``cli train --config 3`` with every recipe flag: the same configuration
  as the JAX package's command line, and a population run of 2 seeds in
  chunks that writes each seed's checkpoints.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtraj import cli as j_cli
from mmtraj import config as jconfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.train import make_optimizer as j_make_optimizer
from mmtraj.train import make_train_step as j_make_train_step
from mmtraj_torch import checkpoint, cli, config, population, train
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import flatten, from_jax
from torch_config3 import (LANE_TOL, MEAN, PARAM_TOL, RECIPE_MODEL, SEED, STD, STEP, TO, TP, N,
                           jax_model, port_config, port_model, random_windows, recipe_jcfg)
from torch_jax_streams import jax_step_draws

torch.set_num_threads(2)


def _param_rule(got, want, lr, what):
    """``chip_smoke.py``'s rule for two runs' parameters after a step: Adam
    moves an element whose gradient is within rounding of 0 by up to lr
    either way, so every element within 2 lr, and 99% within PARAM_TOL."""
    d = np.abs(got - want)
    assert d.max() <= 2 * lr, (what, d.max(), lr)
    assert (d > PARAM_TOL).mean() <= 0.01, (what, (d > PARAM_TOL).mean())


@pytest.mark.parametrize("route", ["plain", "use_pallas"])
def test_one_recipe_step_from_one_state_matches_jax(route, monkeypatch):
    """The whole recipe in one step at STEP: rotate and flip, dropout 0.1,
    variety n = 8, clip, AdamW with weight decay 1e-4 at the cosine
    schedule's count 500 (past the warm-up of 100), the EMA at 0.995.  Both
    start from JAX's parameters, one set of random Adam moments and an EMA
    apart from the parameters; the port takes JAX's draws."""
    jcfg = recipe_jcfg(**RECIPE_MODEL, **({"use_pallas": True} if route == "use_pallas" else {}))
    cfg = port_config(jcfg)
    jm, params = jax_model(jcfg, seed=4)
    host = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(9)
    ema_host = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.01).astype(np.float32),
                            host)
    model = port_model(jcfg.model, host)
    ema = Forecaster(cfg.model, TO, TP, device="cpu", state=from_jax(ema_host))
    opt = train.make_optimizer(cfg, model)
    count = 500
    leaves = ([np.int32(count)] + [(rng.normal(size=p.shape) * 1e-3).astype(np.float32)
                                   for p in opt.params]
              + [(np.abs(rng.normal(size=p.shape)) * 1e-6).astype(np.float32)
                 for p in opt.params] + [np.int32(count)])
    opt.load_state_leaves(leaves)
    tx = j_make_optimizer(jcfg)
    treedef = jax.tree.structure(tx.init(params))
    assert treedef.num_leaves == len(leaves)
    j_opt = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in leaves])
    xy, mask = random_windows(4, seed=4)
    kw = dict(augment_rotate=True, augment_flip=True, seed=SEED, loss_mode="variety",
              variety_n=8)
    jstep = j_make_train_step(jm, tx, JNormStats(MEAN, STD), ema_decay=0.995, **kw)
    jp, _, je, jloss = jstep(params, j_opt, jax.tree.map(jnp.asarray, ema_host),
                             jnp.asarray(xy), jnp.asarray(mask), jnp.int32(STEP))

    monkeypatch.setattr(train, "step_draws", jax_step_draws(jm))
    step = train.make_train_step(model, opt, NormStats(MEAN, STD), ema, 0.995, **kw)
    loss = step(torch.from_numpy(xy), torch.from_numpy(mask), STEP)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    lr = float(train.lr_schedule(cfg)(count))
    assert 0.9 * cfg.train.lr < lr < cfg.train.lr  # in the cosine decay
    for got, want, what in ((dict(model.named_parameters()), jp, "params"),
                            (dict(ema.named_parameters()), je, "ema")):
        want = flatten(jax.tree.map(np.asarray, want))
        assert sorted(got) == sorted(want)
        for k in want:
            _param_rule(got[k].detach().numpy(), want[k], lr, f"{what} {k}")
    assert int(opt.count) == count + 1 and int(opt.schedule_count) == count + 1


def test_population_step_of_two_lanes_equals_their_sequential_steps():
    """Two seeds, the recipe's step (remat off in the lanes, on in the
    sequential runs), two steps from step STEP: each lane's losses, its
    parameters and its EMA against its seed's sequential run on the same
    batches, all with the port's own draws."""
    cfg = port_config(recipe_jcfg(**RECIPE_MODEL, use_pallas=True))
    seeds, steps = [0, 5], [STEP, STEP + 1]
    xy, mask = (torch.from_numpy(a) for a in random_windows(8, seed=6))
    idx = np.array([[[0, 2, 4, 6], [1, 3, 5, 7]], [[7, 1, 0, 3], [2, 2, 6, 4]]])  # (M, S, B)
    stats = NormStats(MEAN, STD)
    states = [Forecaster(cfg.model, TO, TP, device="cpu",
                         generator=torch.Generator().manual_seed(s)).state_dict() for s in seeds]
    params = population.stack_lanes(states, "cpu")
    ema = {k: v.detach().clone() for k, v in params.items()}
    opt = train.Optimizer(params, cfg, lanes=True)
    t = cfg.train
    pop = population.make_population_step(
        population.lane_model(cfg, "cpu"), params, opt, stats, seeds, ema, t.ema_decay,
        t.augment_rotate, t.augment_flip, t.loss, t.variety_n)
    losses = pop(xy, mask, idx, steps).numpy()
    for i, seed in enumerate(seeds):
        assert cfg.model.remat
        model = Forecaster(cfg.model, TO, TP, device="cpu", state=states[i])
        ema_i = Forecaster(cfg.model, TO, TP, device="cpu", state=states[i])
        step = train.make_train_step(model, train.make_optimizer(cfg, model), stats, ema_i,
                                     t.ema_decay, t.augment_rotate, t.augment_flip, seed, t.loss,
                                     t.variety_n)
        seq = [float(step(xy[idx[m, i]], mask[idx[m, i]], s)) for m, s in enumerate(steps)]
        np.testing.assert_allclose(losses[:, i], seq, **LANE_TOL)
        for lanes, single in ((params, model), (ema, ema_i)):
            for k, p in single.named_parameters():
                np.testing.assert_allclose(lanes[k][i].detach().numpy(), p.detach().numpy(),
                                           **LANE_TOL, err_msg=k)


# RESULTS.md's radius-2 recipe with zara1 held out, 5 seeds as one population.
RECIPE_ARGV = ["train", "--config", "3", "--loss", "variety", "--variety-n", "8", "--augment",
               "--augment-flip", "--dropout", "0.1", "--weight-decay", "1e-4", "--ema-decay",
               "0.995", "--lr-schedule", "cosine", "--steps", "32000", "--steps-per-dispatch",
               "50", "--adjacency-radius", "2", "--scene", "zara1", "--seeds", "0", "1", "2",
               "3", "4", "--vmap-seeds"]


def test_cli_recipe_flags_make_the_jax_packages_config():
    """The JAX package's command line has no ``--use-pallas`` (its kernel
    choice is ``attend_kernel``); the port's adds ``use_pallas`` and nothing
    else."""
    want = j_cli._apply_overrides(jconfig.get_config("3"),
                                  j_cli.build_parser().parse_args(RECIPE_ARGV))
    got = cli._apply_overrides(config.get_config("3"), cli.build_parser().parse_args(RECIPE_ARGV))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.num_heads == 1 and got.model.remat and got.data.n_max == N
    pallas = cli._apply_overrides(config.get_config("3"),
                                  cli.build_parser().parse_args(RECIPE_ARGV + ["--use-pallas"]))
    assert pallas == got.replace(model=dataclasses.replace(got.model, use_pallas=True))


def test_cli_train_config3_recipe_population_runs(tmp_path, capsys):
    """``cli train --config 3`` with every recipe flag on synthetic scenes
    (the generator's 60 frames), shortened to 4 steps in chunks of 2 at
    batch 4 with warm-up 1: a population of 2 seeds, each seed's
    checkpoint and EMA checkpoint at step 4 with the recipe's config, and
    its final line."""
    from mmtraj_torch.data.synthetic import write_synthetic_dataset

    data = tmp_path / "data"
    write_synthetic_dataset(str(data), seed=0, n_frames=60)
    argv = RECIPE_ARGV + ["--use-pallas"]
    argv[argv.index("--steps") + 1] = "4"
    argv[argv.index("--steps-per-dispatch") + 1] = "2"
    argv[argv.index("--seeds") + 1:argv.index("--vmap-seeds")] = ["0", "1"]
    argv += ["--data-dir", str(data), "--batch-size", "4", "--warmup-steps", "1", "--k", "2",
             "--eval-every", "0", "--out-dir", str(tmp_path / "run"), "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    finals = [ln for ln in out.splitlines() if ln.startswith("final (seed")]
    assert len(finals) == 2, out
    for s in (0, 1):
        for name in ("checkpoint.npz", "checkpoint_ema.npz"):
            ck = checkpoint.load(str(tmp_path / "run" / f"s{s}" / name))
            assert ck.step == 4 and ck.config.train.seed == s
            assert ck.config.model.num_heads == 1 and ck.config.model.adjacency_radius == 2.0
            assert ck.config.model.dropout == 0.1 and ck.config.model.use_pallas
            assert (ck.config.train.loss, ck.config.train.ema_decay) == ("variety", 0.995)
            assert all(np.isfinite(np.asarray(v)).all() for v in ck.state.values())
