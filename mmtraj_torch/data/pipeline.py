"""Feeding batches to the device (counterpart of ``mmtraj/data/pipeline.py``).

Two paths, both of fixed shape:

* ``DeviceDataset`` copies the whole padded window set to the device once;
  every batch is a gather on the device by an index vector drawn on the
  host.  ``epoch_indices`` is the JAX package's numpy permutation with its
  cyclic pad, so the port trains on the same batches in the same order for
  a seed.
* ``prefetch_to_device`` streams host batches (``train --stream``, for a
  window set that the device should not hold): a producer thread pins each
  batch and copies it on a side CUDA stream while the consumer trains on the
  one before, at most ``size`` batches in flight.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.parallel.mesh import shard_batch


class DeviceDataset:
    """Padded windows on ``device`` with a gather a batch."""

    def __init__(self, ds: WindowDataset, device):
        self.device = torch.device(device)
        self.xy = torch.as_tensor(ds.xy, device=self.device)
        self.mask = torch.as_tensor(ds.mask, device=self.device)
        self.n_windows = ds.n_windows

    def batch(self, idx: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        return self.xy[idx], self.mask[idx]

    def epoch_indices(self, batch_size: int, rng: np.random.Generator) -> Iterator[np.ndarray]:
        perm = rng.permutation(self.n_windows)
        if len(perm) == 0:
            return
        pad = (-len(perm)) % batch_size
        if pad:
            # np.resize repeats cyclically, so batch_size > n_windows still
            # gives a full fixed-shape batch.
            perm = np.concatenate([perm, np.resize(perm, pad)])
        for s in range(0, len(perm), batch_size):
            yield perm[s : s + batch_size]


def _to_device(item, device: torch.device, stream):
    """Each array of ``item`` (a tuple, list or dict of numpy arrays, or
    one) as a tensor on ``device``: on CUDA pinned and copied with
    ``non_blocking=True`` on ``stream``; on the CPU copied as it is."""
    if isinstance(item, dict):
        return {k: _to_device(v, device, stream) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_to_device(v, device, stream) for v in item)
    t = torch.as_tensor(np.asarray(item))
    if device.type != "cuda":
        return t.to(device, copy=True)
    with torch.cuda.stream(stream):
        return t.pin_memory().to(device, non_blocking=True)


def _record_stream(item, stream) -> None:
    """Mark every tensor of ``item`` as used on ``stream``, so the caching
    allocator does not hand its memory out again before that stream is done."""
    if isinstance(item, dict):
        item = list(item.values())
    for t in item if isinstance(item, (tuple, list)) else (item,):
        if isinstance(t, (tuple, list, dict)):
            _record_stream(t, stream)
        else:
            t.record_stream(stream)


def prefetch_to_device(iterator, size: int = 2, device="cuda", mesh=None):
    """Host batches -> the same batches on ``device``, copied ahead by a
    producer thread (the JAX package's ``prefetch_to_device``,
    ``mmtraj/data/pipeline.py:57-108``).

    ``iterator`` yields numpy arrays (or tuples, lists or dicts of them).
    On CUDA the producer pins each batch and copies it with
    ``non_blocking=True`` on a side stream, then records an event; the
    consumer makes its current stream wait on that event and marks the
    tensors as used there (``record_stream``).  On the CPU, which the caller
    names, it copies without pinning.  ``size`` bounds the batches in flight.
    With a ``mesh`` each array goes as this rank's rows of its leading axis
    (``parallel.shard_batch``; a 0-d one as it is).

    As in JAX: order and values are kept; an empty iterator yields nothing;
    a consumer that stops (a closed generator, a ``break``) stops the
    producer within 0.1 s and drops the queued batches; an exception of the
    producer is raised in the consumer.  Unlike JAX's, the close waits for
    the producer to end: a producer thread still inside a torch call when
    the interpreter exits is ended by ``pthread_exit`` in C++ code, and the
    process aborts ("terminate called without an active exception")."""
    device = torch.device(device)
    queue: collections.deque = collections.deque()
    done = object()
    ready = threading.Semaphore(0)
    space = threading.Semaphore(size)
    stop = threading.Event()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def producer():
        try:
            for item in iterator:
                # Polled, so that an abandoned consumer releases this thread
                # and its queued device batches.
                while not space.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                if mesh is not None:
                    item = shard_batch(item, mesh)
                batch = _to_device(item, device, side)
                event = None
                if side is not None:
                    event = torch.cuda.Event()
                    event.record(side)
                queue.append((batch, event))
                ready.release()
            queue.append(done)
        except BaseException as e:  # noqa: BLE001 -- raised again by the consumer
            queue.append(e)
        ready.release()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            ready.acquire()
            item = queue.popleft()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                _record_stream(batch, current)
            space.release()
            yield batch
    finally:
        # On exhaustion and on the generator's close alike.
        stop.set()
        thread.join()
        queue.clear()
