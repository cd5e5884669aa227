"""The port's entry contract (counterpart of the root ``__graft_entry__.py``).

``entry()`` returns a forward step with example arguments: the training
loss of config 4 at full width (B = 8, N = 16), with the whole GAT layer
through the Hopper kernel where it runs on the card, as the JAX function
uses Pallas on the TPU.  ``dryrun_multichip(n)`` runs the JAX contract's
four programs on ``n`` ranks of a ``torch.distributed`` group, each a gloo
process on the CPU: one data-parallel training step, a chunk of 2 steps
gathered from a resident window set, an attention-encoder step, and a
2-lane seed population, each with the batch split over the ranks and the
gradients summed across them.
"""

from __future__ import annotations

import dataclasses
import traceback

import numpy as np
import torch

DRYRUN_TIMEOUT_S = 600


def _flagship(batch: int, n_agents: int, use_pallas: bool = False, encoder: str = "rnn",
              device="cuda"):
    """Config 4 (``use_pallas``/``encoder`` over it), weights from seed 0,
    stats (0, 0.4), random-walk windows with 80% of the agents valid ->
    (cfg, model, stats, xy, mask)."""
    from mmtraj_torch.config import get_config
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster

    cfg = get_config("4")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_pallas=use_pallas,
                                                encoder=encoder))
    to, tp = cfg.data.obs_len, cfg.data.pred_len
    model = Forecaster(cfg.model, to, tp, device=device,
                       generator=torch.Generator().manual_seed(0))
    dev = model.device
    stats = NormStats(torch.zeros(2, device=dev), torch.full((2,), 0.4, device=dev))
    rng = np.random.default_rng(0)
    steps = rng.normal(size=(batch, n_agents, to + tp, 2)).astype(np.float32) * 0.4
    xy = torch.tensor(np.cumsum(steps, axis=2), device=dev)
    mask = torch.tensor(rng.random((batch, n_agents)) < 0.8, device=dev)
    return cfg, model, stats, xy, mask


class _Loss(torch.nn.Module):
    """The forecaster's training loss as a module's forward, so that
    ``torch.func.functional_call`` runs it on given parameters."""

    def __init__(self, model, stats):
        super().__init__()
        self.model = model
        self.stats = stats

    def forward(self, xy, mask):
        return self.model.loss(xy, mask, self.stats)


def entry(device="cuda"):
    """(fn, example_args): ``fn(params, xy, mask)`` -> config 4's nll loss
    (a 0-d tensor) at B = 8, N = 16; ``params`` maps the loss module's
    parameter names to tensors.  On the card the GAT layer runs the Hopper
    kernel (``use_pallas``); on the CPU its plain version."""
    use_pallas = torch.device(device).type == "cuda"
    _, model, stats, xy, mask = _flagship(batch=8, n_agents=16, use_pallas=use_pallas,
                                          device=device)
    module = _Loss(model, stats)

    def fn(params, xy, mask):
        return torch.func.functional_call(module, params, (xy, mask))

    params = {k: v.detach() for k, v in module.named_parameters()}
    return fn, (params, xy, mask)


def _check_finite(name: str, t: torch.Tensor) -> None:
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError(f"non-finite {name}: {t}")


def _dryrun_rank(world: int) -> dict:
    """The four programs on this rank of the group -> their losses."""
    from mmtraj_torch import train
    from mmtraj_torch.parallel import make_mesh
    from mmtraj_torch.params import init_params
    from mmtraj_torch.population import lane_model, make_population_step, stack_lanes

    mesh = make_mesh(device="cpu")
    B = 2 * world

    # One data-parallel step of the whole training step (loss, backward, update).
    cfg, model, stats, xy, mask = _flagship(B, 8, device="cpu")
    step = train.make_train_step(model, train.make_optimizer(cfg, model), stats, mesh=mesh)
    loss = step(xy, mask, 0)
    _check_finite("loss", loss)

    # A chunk of 2 steps, each gathering windows 0 and 1 of a resident set.
    idx = np.zeros((2, B), np.int64)
    idx[:, 1] = 1
    multi = train.make_multi_train_step(model, train.make_optimizer(cfg, model), stats,
                                        mesh=mesh)
    losses = multi(xy, mask, idx, [1, 2])
    _check_finite("multi-step losses", losses)

    # The attention encoder family, one step.
    cfg_a, model_a, stats_a, xy_a, mask_a = _flagship(B, 8, encoder="attn", device="cpu")
    step_a = train.make_train_step(model_a, train.make_optimizer(cfg_a, model_a), stats_a,
                                   mesh=mesh)
    loss_a = step_a(xy_a, mask_a, 0)
    _check_finite("attention-encoder loss", loss_a)

    # A population of 2 seed lanes over the mesh, one 2-step chunk.
    seeds = (0, 1)
    params = stack_lanes([init_params(cfg.model, torch.Generator().manual_seed(s))
                          for s in seeds], "cpu")
    pop = make_population_step(lane_model(cfg, "cpu"), params,
                               train.Optimizer(params, cfg, lanes=True), stats, seeds,
                               mesh=mesh)
    pop_losses = pop(xy, mask, np.stack([idx, idx], axis=1), [0, 1])
    _check_finite("population losses", pop_losses)
    return {"loss": float(loss), "multi_losses": [round(float(x), 4) for x in losses],
            "attn_loss": float(loss_a), "pop_dp_loss": float(pop_losses.mean()),
            "mesh": (mesh.size(),)}


def _rank_main(rank: int, world: int, port: int, queue) -> None:
    import torch.distributed as dist

    from mmtraj_torch.parallel import init_distributed

    torch.set_num_threads(1)
    try:
        init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        queue.put((rank, _dryrun_rank(world), None))
    except BaseException:  # noqa: BLE001 -- sent to the parent, which raises it
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> dict:
    """The four training programs on ``n_devices`` gloo ranks on the CPU,
    each rank a spawned process -> rank 0's losses (every rank's are the
    same: the gradients and losses are summed across the group)."""
    import torch.multiprocessing as mp

    from mmtraj_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n_devices, port, queue))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    try:
        results, errors = {}, []
        for _ in procs:
            rank, out, err = queue.get(timeout=DRYRUN_TIMEOUT_S)
            results[rank] = out
            if err:
                errors.append(f"rank {rank}:\n{err}")
        if errors:
            raise RuntimeError("dryrun_multichip failed\n" + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    r = results[0]
    print(f"dryrun_multichip({n_devices}): ok, loss={r['loss']:.4f}, "
          f"multi_losses={r['multi_losses']}, attn_loss={r['attn_loss']:.4f}, "
          f"pop_dp_loss={r['pop_dp_loss']:.4f}, mesh={r['mesh']}")
    return r

