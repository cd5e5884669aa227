"""Data parallelism over ``torch.distributed`` (counterpart of
``mmtraj/parallel/mesh.py``).

One strategy, as in the JAX package: a 1-D mesh named ``"data"`` over the
processes, one device each; the batch's leading axis split over it; the
parameters, the optimizer state and the resident window set replicated.
JAX derives the gradient's ``psum`` from the shardings; here the trainer
sums its gradients across the mesh explicitly with ``all_reduce_sum``, one
``all_reduce`` over a flat buffer, which a CUDA graph can capture over NCCL.
The model is not wrapped in ``DistributedDataParallel``: the trainer calls
an objective of the model, never its ``forward``, where DDP's reducer is
armed.

The backend follows the device the caller asks for: NCCL for CUDA, gloo for
the CPU.  ``make_mesh`` without a process group first starts one of a single
process on a TCP store at 127.0.0.1, so that ``train --data-parallel`` runs
without a launcher, as the JAX package's runs without ``jax.distributed``.
Several processes (one a GPU, or gloo processes on the CPU) each call
``init_distributed`` with one coordinator address, the world size and their
rank, then ``make_mesh``.
"""

from __future__ import annotations

import socket
from typing import Any, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda") -> None:
    """Join the process group: ``coordinator`` "host:port" of rank 0's TCP
    store (default: the ``MASTER_ADDR``/``MASTER_PORT`` environment, as
    ``torchrun`` sets it), ``num_processes`` the world size, ``process_id``
    this process's rank.  NCCL for a CUDA ``device`` (the process then uses
    card ``rank % device_count``), gloo for the CPU."""
    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}" if coordinator
                            else "env://", **kw)


def make_mesh(n: Optional[int] = None, device="cuda"):
    """The 1-D ``DeviceMesh`` named ``"data"`` over the process group's
    ranks (``n``, if given, must be the world size).  Without a group, one
    of a single process is started first."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device)
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks needs a process group of {n}, got {world}")
    backend = dist.get_backend()
    if backend != _backend(device):
        raise ValueError(f"the process group runs {backend}, which cannot serve a {device} "
                         "mesh")
    return init_device_mesh(torch.device(device).type, (world,), mesh_dim_names=(DATA_AXIS,))


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a DeviceMesh from mmtraj_torch.parallel.make_mesh, got "
                        f"{type(mesh).__name__}")


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's rows of the leading axis of every tensor or array in
    ``batch`` (a tensor, an array, or a tuple, list or dict of them): rank r
    of W takes rows [r B / W, (r + 1) B / W); a 0-d value passes as it is.
    B must divide by W."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if batch is None or getattr(batch, "ndim", 1) == 0:
        return batch
    w, r = mesh.size(), mesh.get_local_rank()
    b = batch.shape[0]
    if b % w:
        raise ValueError(f"a batch of {b} rows does not split over {w} ranks")
    rows = b // w
    return batch[r * rows:(r + 1) * rows]


def all_reduce_sum(tensors: List[torch.Tensor], mesh) -> None:
    """Sum ``tensors`` across the mesh in place: one ``all_reduce`` over a
    flat float32 buffer of them all, then each copied back.  Nothing reads
    back to the host, so a CUDA graph captures it over NCCL."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group())
    for t, chunk in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(chunk.view_as(t))


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """(L, ...) on every rank -> (W, L, ...): every rank's ``t``, in rank
    order."""
    out = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(out, t.contiguous(), group=mesh.get_group())
    return torch.stack(out)


def is_writer(mesh) -> bool:
    """Rank 0 of the mesh writes checkpoints and logs; True without one."""
    return mesh is None or dist.get_rank() == 0

