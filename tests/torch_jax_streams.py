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


def write_scenes(root, frames=16):
    """One annotation file a scene of ``mmtraj_torch.config.SCENES``: 3-6
    pedestrians walking through every frame (ids every 10 frames, 0.4 s), in
    the ETH/UCY row format.  -> the directory, as a string."""
    from mmtraj_torch.config import SCENES

    rng = np.random.default_rng(0)
    for s, scene in enumerate(SCENES):
        rows = []
        start = rng.uniform(0, 8, size=(3 + s % 4, 2))
        vel = rng.normal(scale=0.3, size=start.shape)
        for f in range(frames):
            for p, (x, y) in enumerate(start + vel * f + rng.normal(scale=0.05, size=start.shape)):
                rows.append(f"{10 * f}\t{p + 1}\t{x:.4f}\t{y:.4f}")
        (root / f"{scene}.txt").write_text("\n".join(rows) + "\n")
    return str(root)


def jax_step_draws(jax_model):
    """A stand-in for ``mmtraj_torch.train.step_draws`` that returns JAX's
    draws for the step, as ``mmtraj/train.py`` folds them from
    ``PRNGKey(seed ^ 0x5EED)`` and ``augment_windows`` and
    ``_dropout_masks`` draw them, in the port's ``StepDraws``."""
    import jax.numpy as jnp

    from mmtraj.models.forecaster import _dropout_masks
    from mmtraj_torch.train import StepDraws

    def draw(model, seed, step, B, N, rotate, flip, variety_n):
        step_key = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x5EED), step)
        if variety_n:
            k_aug, k_drop, vkey = jax.random.split(step_key, 3)
        else:
            k_aug, k_drop = jax.random.split(step_key)

        def t(a):
            return torch.from_numpy(np.array(a))

        theta = det = drop = stream = None
        if rotate or flip:
            kr, kf = jax.random.split(k_aug)
            theta = t(jax.random.uniform(kr, (B,), minval=0.0, maxval=2.0 * jnp.pi) if rotate
                      else jnp.zeros((B,), jnp.float32))
            det = t(jnp.where(jax.random.bernoulli(kf, 0.5, (B,)), -1.0, 1.0) if flip
                    else jnp.ones((B,), jnp.float32))
        if jax_model.cfg.dropout > 0:
            drop = tuple({k: t(v) for k, v in d.items()}
                         for d in _dropout_masks(k_drop, jax_model.cfg, B, N))
        if variety_n:
            stream = tuple(t(a) for a in jax_model._rollout_stream(vkey, variety_n * B, N))
        return StepDraws(theta, det, drop, stream)

    return draw


def grad_keeper():
    """An optax transformation whose state is the last gradient and whose
    update is zero, so ``mmtraj.train.make_train_step`` hands back JAX's
    gradients."""
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
