"""Kernels and quantized linears. Hand-written CUDA sources live in ``csrc/``."""
