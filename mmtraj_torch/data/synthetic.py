"""Synthetic ETH/UCY-format scene generator (counterpart of
``mmtraj/data/synthetic.py``, numpy only, and byte for byte the same files).

Pedestrian scenes in the public txt format (``frame ped x y``, meters,
0.4 s a frame) that ``mmtraj_torch/data/parser.py`` reads; real data drops in
with no code change.  The walker model is a light social-forces sketch:
agents spawn on the boundary of a square area with a goal on the far side,
prefer about 1.3 m/s, feel mild pairwise repulsion and carry smooth heading
noise.  The presets follow the real datasets' densities (univ is the dense
crowd, 50+ agents a frame).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

FRAME_DT = 0.4  # seconds per annotation frame
FRAME_STEP = 10  # raw frame ids advance by 10, like the real dumps


@dataclass(frozen=True)
class ScenePreset:
    n_frames: int = 600
    area: float = 15.0  # square side, meters
    spawn_rate: float = 0.8  # expected new agents per frame
    max_agents: int = 40
    speed_mean: float = 1.3  # m/s
    speed_std: float = 0.3
    noise: float = 0.25  # heading OU noise
    repulsion: float = 1.0  # social repulsion gain


PRESETS = {
    "eth": ScenePreset(spawn_rate=0.35, max_agents=16),
    "hotel": ScenePreset(spawn_rate=0.30, max_agents=14),
    "univ": ScenePreset(spawn_rate=2.5, max_agents=70, area=20.0),
    "zara1": ScenePreset(spawn_rate=0.5, max_agents=20),
    "zara2": ScenePreset(spawn_rate=0.6, max_agents=22),
}


def generate_scene(seed: int, preset: ScenePreset) -> np.ndarray:
    """Simulate one scene -> rows (R, 4) [frame_id, ped_id, x, y]."""
    rng = np.random.default_rng(seed)
    a = preset.area
    pos = np.zeros((0, 2))
    vel = np.zeros((0, 2))
    goal = np.zeros((0, 2))
    speed = np.zeros((0,))
    ids = np.zeros((0,), dtype=np.int64)
    next_id = 1
    rows = []

    for f in range(preset.n_frames):
        # Spawn.
        n_new = rng.poisson(preset.spawn_rate)
        n_new = min(n_new, preset.max_agents - len(ids))
        for _ in range(max(n_new, 0)):
            side = rng.integers(4)
            u = rng.uniform(0.05 * a, 0.95 * a)
            p = np.array([[u, 0.0], [u, a], [0.0, u], [a, u]][side])
            g_side = (side + rng.integers(1, 4)) % 4
            gu = rng.uniform(0.05 * a, 0.95 * a)
            g = np.array([[gu, 0.0], [gu, a], [0.0, gu], [a, gu]][g_side])
            s = np.clip(rng.normal(preset.speed_mean, preset.speed_std), 0.4, 2.5)
            d = g - p
            v = d / (np.linalg.norm(d) + 1e-9) * s
            pos = np.vstack([pos, p[None]])
            vel = np.vstack([vel, v[None]])
            goal = np.vstack([goal, g[None]])
            speed = np.append(speed, s)
            ids = np.append(ids, next_id)
            next_id += 1

        n = len(ids)
        if n:
            # Goal attraction.
            d = goal - pos
            dist = np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
            desired = d / dist * speed[:, None]
            # Pairwise repulsion (vectorized O(n^2), fine at these n).
            diff = pos[:, None, :] - pos[None, :, :]
            r2 = (diff**2).sum(-1) + 1e-6
            np.fill_diagonal(r2, np.inf)
            rep = (diff / r2[..., None] * np.exp(-r2 / 4.0)[..., None]).sum(1)
            noise = rng.normal(0, preset.noise, (n, 2))
            vel = 0.7 * vel + 0.3 * desired + preset.repulsion * rep * FRAME_DT + noise * FRAME_DT
            # Cap speed.
            sp = np.linalg.norm(vel, axis=1, keepdims=True)
            vel = np.where(sp > 2.5, vel / sp * 2.5, vel)
            pos = pos + vel * FRAME_DT

            for i in range(n):
                rows.append((f * FRAME_STEP, ids[i], pos[i, 0], pos[i, 1]))

            # Despawn: reached goal or left area (with margin).
            done = (np.linalg.norm(goal - pos, axis=1) < 0.5) | (
                (pos < -1.0) | (pos > a + 1.0)
            ).any(axis=1)
            keep = ~done
            pos, vel, goal, speed, ids = pos[keep], vel[keep], goal[keep], speed[keep], ids[keep]

    return np.array(rows, dtype=np.float64).reshape(-1, 4)


def write_synthetic_dataset(data_dir: str, seed: int = 0, n_frames: int | None = None) -> None:
    """Write all five scenes as ``{data_dir}/{scene}.txt`` (deterministic)."""
    os.makedirs(data_dir, exist_ok=True)
    for i, (scene, preset) in enumerate(PRESETS.items()):
        if n_frames is not None:
            preset = ScenePreset(**{**preset.__dict__, "n_frames": n_frames})
        rows = generate_scene(seed * 1000 + i, preset)
        np.savetxt(os.path.join(data_dir, f"{scene}.txt"), rows, fmt="%.1f\t%.1f\t%.6f\t%.6f")
