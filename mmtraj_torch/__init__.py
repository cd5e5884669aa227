"""mmtraj_torch: the PyTorch/CUDA port of mmtraj for NVIDIA Hopper.

Plain tensor code is PyTorch; the three kernels of the JAX package's
``mmtraj/ops`` are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``,
built with ``nvcc`` at first use (``ops/_build.py``).  Entry points run on
the card unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper runs its plain PyTorch version.

The configuration names import eagerly; ``Forecaster``, ``fit``,
``evaluate``, ``fit_population``, ``checkpoint`` and ``PredictServer``
load on first use, so ``import mmtraj_torch`` stays light (it imports no
torch and builds no kernel).
"""

__version__ = "0.1.0"

from mmtraj_torch.config import (  # noqa: F401
    PRESETS,
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
    get_config,
)


def __getattr__(name):
    if name == "Forecaster":
        from mmtraj_torch.models.forecaster import Forecaster

        return Forecaster
    if name == "fit":
        from mmtraj_torch.train import fit

        return fit
    if name == "evaluate":
        from mmtraj_torch.evaluate import evaluate

        return evaluate
    if name == "fit_population":
        from mmtraj_torch.population import fit_population

        return fit_population
    if name == "checkpoint":
        import mmtraj_torch.checkpoint as checkpoint

        return checkpoint
    if name == "PredictServer":
        from mmtraj_torch.serve import PredictServer

        return PredictServer
    raise AttributeError(f"module 'mmtraj_torch' has no attribute {name!r}")
