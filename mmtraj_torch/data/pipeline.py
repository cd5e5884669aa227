"""The training window set resident on the device (counterpart of
``mmtraj/data/pipeline.py``).

``DeviceDataset`` copies the whole padded window set to the device once;
every batch is a gather on the device by an index vector drawn on the host.
``epoch_indices`` is the JAX package's numpy permutation with its cyclic
pad, so the port trains on the same batches in the same order for a seed.
The JAX package's streaming prefetcher (``prefetch_to_device``,
``--stream``) is not ported.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from mmtraj_torch.data.collate import WindowDataset


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
