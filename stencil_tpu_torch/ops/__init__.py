"""Kernels (hand-written CUDA, built by ``_native``) and their plain
PyTorch versions."""
