"""Scene registry and the 5-scene leave-one-out split (counterpart of
``mmtraj/data/registry.py``).  A scene's files are ``{data_dir}/{scene}.txt``
and any ``{data_dir}/{scene}/*.txt``, read with the native parser
(``data/native.py``; the numpy parser where no C++ compiler is found)."""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from mmtraj_torch.config import SCENES
from mmtraj_torch.data.native import read_annotation_file_fast as read_annotation_file
from mmtraj_torch.data.windower import make_windows


def leave_one_out(test_scene: str) -> Tuple[List[str], List[str]]:
    if test_scene not in SCENES:
        raise KeyError(f"unknown scene {test_scene!r}; choose from {SCENES}")
    return [s for s in SCENES if s != test_scene], [test_scene]


def scene_files(data_dir: str, scene: str) -> List[str]:
    flat = os.path.join(data_dir, f"{scene}.txt")
    files = [flat] if os.path.exists(flat) else []
    files += sorted(glob.glob(os.path.join(data_dir, scene, "*.txt")))
    if not files:
        raise FileNotFoundError(
            f"no annotation files for scene {scene!r} under {data_dir!r} "
            f"(expected {scene}.txt or {scene}/*.txt)"
        )
    return files


def load_scene_windows(data_dir: str, scene: str, obs_len: int, pred_len: int, stride: int = 1,
                       min_agents: int = 1) -> List[np.ndarray]:
    windows: List[np.ndarray] = []
    for path in scene_files(data_dir, scene):
        windows += make_windows(read_annotation_file(path), obs_len, pred_len, stride,
                                min_agents)
    return windows


def load_split(data_dir: str, test_scene: str, obs_len: int, pred_len: int, stride: int = 1,
               min_agents: int = 1):
    """Leave-one-out split -> (train_windows, test_windows)."""
    train_scenes, test_scenes = leave_one_out(test_scene)
    train, test = [], []
    for s in train_scenes:
        train += load_scene_windows(data_dir, s, obs_len, pred_len, stride, min_agents)
    for s in test_scenes:
        test += load_scene_windows(data_dir, s, obs_len, pred_len, stride, min_agents)
    return train, test
