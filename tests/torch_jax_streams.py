"""Shared by the evaluator parity tests of the port (``test_torch_evaluate*.py``):
the small model size, random windows, and JAX's per-window random streams
handed to the port through its seam, ``mmtraj_torch.evaluate.window_stream``."""

import jax
import numpy as np
import torch

TO, TP = 4, 3
SMALL = dict(hidden_dim=16, embed_dim=16, num_heads=2)


def random_windows(rng, counts, seq_len=TO + TP):
    """One random-walk window (n, seq_len, 2) per agent count in ``counts``."""
    return [np.cumsum(rng.normal(size=(n, seq_len, 2)).astype(np.float32) * 0.3, axis=1)
            for n in counts]


def jax_window_stream(jax_model):
    """A stand-in for ``window_stream`` that draws JAX's ``_per_window_stream``
    for the key chain JAX's evaluate folds: PRNGKey(seed), then the ensemble
    member and the view (each skipped where the port's chain holds 0), then
    the window index."""

    def draw(model, chain, win_idx, k, n, sigma_scale=1.0, draw_n=None):
        seed, member, view = chain
        key = jax.random.PRNGKey(seed)
        if member:
            key = jax.random.fold_in(key, member - 1)
        if view:
            key = jax.random.fold_in(key, view)
        keys = jax.vmap(lambda w: jax.random.fold_in(key, w))(np.asarray(win_idx, np.int32))
        gumbel, normal = jax_model._per_window_stream(keys, k, n, sigma_scale, draw_n)
        return torch.from_numpy(np.array(gumbel)), torch.from_numpy(np.array(normal))

    return draw
