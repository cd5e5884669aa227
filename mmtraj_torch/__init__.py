"""mmtraj_torch: the PyTorch/CUDA port of mmtraj for NVIDIA Hopper.

Plain tensor code is PyTorch; the three kernels of the JAX package's
``mmtraj/ops`` are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``,
built with ``nvcc`` at first use (``ops/_build.py``).  Entry points run on
the card unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper runs its plain PyTorch version.
"""
