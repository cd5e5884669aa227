"""Run a function on every rank of a gloo process group on the CPU, for the
port's data-parallel tests (``test_torch_{parallel,population}.py``).

``run_ranks(fn, world, *args)`` starts ``world`` processes (spawned, so
nothing of the caller's state is shared), each joins a gloo group on a free
127.0.0.1 port through ``mmtraj_torch.parallel.init_distributed`` and calls
``fn(rank, *args)``; the results come back in rank order.  ``fn`` must be a
module-level function and its results picklable (numpy, not tensors).  This
module imports no JAX, so the workers start quickly.
"""

import traceback

import torch
import torch.multiprocessing as mp


def _entry(fn, rank, world, port, queue, args):
    import torch.distributed as dist

    from mmtraj_torch.parallel import init_distributed

    torch.set_num_threads(1)
    try:
        init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        queue.put((rank, fn(rank, *args), None))
    except BaseException:  # noqa: BLE001 -- reported by the parent
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, *args, timeout=600):
    from mmtraj_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, queue, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results, errors = {}, []
        for _ in procs:
            rank, out, err = queue.get(timeout=timeout)
            results[rank] = out
            if err:
                errors.append(f"rank {rank}:\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


# -- the workers ----------------------------------------------------------------

def _cfg(case: dict):
    """config 4 with the case's model and train fields over it."""
    import dataclasses

    from mmtraj_torch import config

    cfg = config.config4()
    return cfg.replace(model=dataclasses.replace(cfg.model, **case.get("model", {})),
                       data=dataclasses.replace(cfg.data, **case.get("data", {})),
                       train=dataclasses.replace(cfg.train, **case.get("train", {})))


def train_steps(case: dict, xy, mask, state, stats, mesh=None, steps=3) -> dict:
    """``steps`` steps of ``make_train_step`` from ``state`` on one batch ->
    the losses, the first step's gradients and the final parameters."""
    from mmtraj_torch import train
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster

    cfg = _cfg(case)
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device="cpu",
                       state=state)
    t = cfg.train
    step = train.make_train_step(
        model, train.make_optimizer(cfg, model), NormStats(*stats),
        augment_rotate=t.augment_rotate, augment_flip=t.augment_flip, seed=t.seed,
        loss_mode=t.loss, variety_n=t.variety_n, mesh=mesh)
    out = {"losses": []}
    for s in range(steps):
        out["losses"].append(float(step(torch.from_numpy(xy), torch.from_numpy(mask), s)))
        if s == 0:
            out["grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    out["params"] = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return out


def fit_run(case: dict, mesh=None) -> dict:
    """``train.fit`` of the case on the CPU -> its history and final state."""
    from mmtraj_torch import train

    res = train.fit(_cfg(case), device="cpu", mesh=mesh)
    return {"history": res.history, "state": {k: v.numpy() for k, v in res.state.items()},
            "eval": res.eval_metrics}


def parallel_worker(rank, step_cases, xy, mask, state, stats, fit_cases):
    from mmtraj_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    steps = {name: train_steps(c, xy, mask, state, stats, mesh) for name, c in step_cases.items()}
    fits = {name: fit_run(c, mesh) for name, c in fit_cases.items()}
    return steps, fits


def lookup_stream(streams):
    """A stand-in for ``evaluate.window_stream`` that returns each window's
    pre-drawn (gumbel, normal) of shape (k, T, n, ...) from ``streams``."""
    def draw(model, chain, win_idx, k, n, sigma_scale=1.0, draw_n=None):
        g = torch.stack([torch.from_numpy(streams[int(w)][0]) for w in win_idx], 1)
        z = torch.stack([torch.from_numpy(streams[int(w)][1]) for w in win_idx], 1)
        return g.reshape((-1,) + g.shape[2:]), z.reshape((-1,) + z.shape[2:])
    return draw


def evaluate_runs(model_cfg, state, windows, n_max, stats, k, batch_sizes, streams,
                  mesh=None) -> list:
    """``evaluate`` at each batch size, fed ``streams`` -> the metrics."""
    from mmtraj_torch import evaluate as ev
    from mmtraj_torch.config import ModelConfig
    from mmtraj_torch.data.collate import WindowDataset
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster

    mc = ModelConfig(**model_cfg)
    model = Forecaster(mc, 4, 3, device="cpu", state=state)
    ds = WindowDataset(windows, n_max)
    real = ev.window_stream
    ev.window_stream = lookup_stream(streams)
    try:
        return [ev.evaluate(model, NormStats(*stats), ds, k, batch_size=bs, mesh=mesh)
                for bs in batch_sizes]
    finally:
        ev.window_stream = real


def evaluate_worker(rank, *args):
    from mmtraj_torch.parallel import make_mesh

    return evaluate_runs(*args, mesh=make_mesh(device="cpu"))


def population_run(case: dict, seeds, mesh=None) -> list:
    from mmtraj_torch.population import fit_population

    return [{"history": r.history, "state": {k: v.numpy() for k, v in r.state.items()},
             "eval": r.eval_metrics}
            for r in fit_population(_cfg(case), seeds, device="cpu", mesh=mesh)]


def population_worker(rank, case, seeds):
    return population_run(case, seeds)  # the case asks for data_parallel
