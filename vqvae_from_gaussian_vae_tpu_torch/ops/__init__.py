"""Kernels and their plain PyTorch versions; ``_build`` compiles ``csrc/``."""
