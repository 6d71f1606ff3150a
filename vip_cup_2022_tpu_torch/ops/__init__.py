"""Operators of the port: resize, activations, norms, and the CUDA kernels."""
