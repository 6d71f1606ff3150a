"""PyTorch + CUDA port of ``vip_cup_2022_tpu`` for one NVIDIA Hopper GPU.

Sub-packages mirror the JAX package's (``core``, ``data``, ``ops``,
``models``, ``utils``, ``weights``, ``infer``) so each module's counterpart is
found by name. The port imports neither JAX nor the JAX package. Hand-written
CUDA kernels live in ``csrc/`` and are built by ``ops/kernels/build.py`` at
first use.
"""
