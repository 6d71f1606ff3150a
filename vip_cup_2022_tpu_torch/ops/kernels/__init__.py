"""Hand-written CUDA kernels (``csrc/``), their builds and their PyTorch wrappers."""
