"""Kernel wrappers (CUDA C++ in ``csrc/``) beside their plain PyTorch versions."""
