"""Configuration dataclasses and the presets 1-5 of the PyTorch port.

A copy of the JAX package's ``mmtraj/config.py`` with the same field names, so
that a checkpoint's ``meta/config_json`` reads unchanged.  The port keeps its
own copy and imports nothing of ``mmtraj``.

In the port, ``use_pallas=True`` selects the hand-written Hopper GAT kernel
(``ops/fused_gat.py``), ``attend_kernel="pallas"`` the Hopper attend kernel
(``ops/fused_attend.py``) and ``use_fused_decoder=True`` the Hopper rollout
kernel (``ops/fused_decoder.py``).  ``remat``, ``remat_policy`` and
``dropout`` are read only by training.  ``dtype="bfloat16"`` rounds the
operands of the model's products to bf16 and keeps their results float32
(``models/layers.py``).  ``data_parallel`` splits each batch over the ranks
of a ``torch.distributed`` group (``mmtraj_torch/parallel``), ``stream``
feeds batches through a pinned prefetch instead of the resident window set.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any

SCENES = ("eth", "hotel", "univ", "zara1", "zara2")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for the forecaster family."""

    cell: str = "gru"  # "gru" | "lstm"
    encoder: str = "rnn"  # "rnn" | "attn"
    attn_layers: int = 2
    social: bool = True
    num_heads: int = 4
    gat_layers: int = 1
    embed_dim: int = 64
    hidden_dim: int = 64
    head: str = "gmm"  # "gmm" | "deterministic"
    num_mixtures: int = 5
    # Proximity adjacency radius in meters; <= 0 means fully connected.
    adjacency_radius: float = 4.0
    sigma_min: float = 1e-3
    rho_max: float = 0.99
    dtype: str = "float32"
    use_pallas: bool = False  # the whole GAT layer through the Hopper kernel
    # Attend-chain backend: "auto" takes the kernel for a CUDA tensor at
    # N >= 128 on paths that are not differentiated; "xla" (the plain chain)
    # and "pallas" (the kernel) pin it.  The names are the JAX package's.
    attend_kernel: str = "auto"
    use_fused_decoder: bool = False  # the whole rollout in one Hopper kernel
    dropout: float = 0.0
    remat: bool = False
    remat_policy: str = "full"
    scan_unroll: int = 1


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = "data/synthetic"
    scene: str = "zara1"
    obs_len: int = 8
    pred_len: int = 12
    n_max: int = 32
    stride: int = 1
    min_agents: int = 1


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    steps: int = 2000
    loss: str = "nll"
    variety_n: int = 8
    variety_weight: float = 1.0
    variety_fde_weight: float = 0.0
    lr: float = 1e-3
    lr_schedule: str = "constant"
    warmup_steps: int = 100
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    ema_decay: float = 0.0
    augment_rotate: bool = False
    augment_flip: bool = False
    k_samples: int = 20
    eval_every: int = 500
    log_every: int = 100
    ckpt_every: int = 0
    seed: int = 0
    out_dir: str = "runs/default"
    data_parallel: bool = False
    stream: bool = False
    steps_per_dispatch: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def config1() -> Config:
    """ETH-hotel single scene: plain LSTM encoder-decoder, single-mode
    output, obs=8/pred=12, batch 8."""
    return Config(
        model=ModelConfig(cell="lstm", social=False, head="deterministic", num_heads=1),
        data=DataConfig(scene="hotel", n_max=24),
        train=TrainConfig(batch_size=8, k_samples=1),
    )


def config2() -> Config:
    """5-scene leave-one-out: social graph-attention encoder + GRU decoder,
    deterministic output."""
    return Config(
        model=ModelConfig(cell="gru", social=True, head="deterministic", num_heads=1,
                          remat=True),
        data=DataConfig(scene="zara1", n_max=32),
        train=TrainConfig(batch_size=32, k_samples=1),
    )


def config3() -> Config:
    """Multimodal K=20 bivariate-Gaussian-mixture decoder with best-of-K
    ADE/FDE eval, masked variable agent counts."""
    return Config(
        model=ModelConfig(cell="gru", social=True, head="gmm", num_heads=1, remat=True),
        data=DataConfig(scene="zara1", n_max=32),
        train=TrainConfig(batch_size=32, k_samples=20),
    )


def config4() -> Config:
    """Multi-head graph attention over dense crowds (UCY-univ, 50+ agents a
    frame) with padded fixed-shape graphs: N_max=64, 4 heads, GMM with M=5,
    K=20 samples."""
    return Config(
        model=ModelConfig(cell="gru", social=True, head="gmm", num_heads=4, remat=True),
        data=DataConfig(scene="univ", n_max=64),
        train=TrainConfig(batch_size=16, k_samples=20),
    )


def config5() -> Config:
    """Large-batch multi-scene training: config 4's model at batch 256,
    data-parallel over the ranks of a ``torch.distributed`` group, one card
    each (``train.fit``, ``cli train --config 5 --data-parallel``).  On a
    machine with one H100 the mesh has one rank: the step is config 4's at
    B = 256, its gradient ``all_reduce`` an identity."""
    return Config(
        model=ModelConfig(cell="gru", social=True, head="gmm", num_heads=4, remat=True),
        data=DataConfig(scene="univ", n_max=64),
        train=TrainConfig(batch_size=256, k_samples=20, data_parallel=True),
    )


PRESETS = {
    "1": config1,
    "2": config2,
    "3": config3,
    "4": config4,
    "5": config5,
    "config1": config1,
    "config2": config2,
    "config3": config3,
    "config4": config4,
    "config5": config5,
}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown config preset {name!r}; choose from 1..5")
    return PRESETS[name]()


def config_from_json(s: str) -> Config:
    d = json.loads(s)
    return Config(
        model=ModelConfig(**d["model"]),
        data=DataConfig(**d["data"]),
        train=TrainConfig(**d["train"]),
    )
