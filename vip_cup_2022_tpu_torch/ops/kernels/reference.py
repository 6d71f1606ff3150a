"""The reference arm: every model kernel routed through its plain version.

:func:`plain_kernels` is for tools that build an f32 (or bf16) reference
of a model on the card, beside the kernel path: ``chip_smoke.py``'s
comparisons and ``tools/train_flip.py``'s f32 arm. Inside it, each wrapper
the models call (the ConvNeXt and GCViT block kernels, window attention,
LayerNorm, the depthwise kernel and the int8 PTQ site) is its module's
``<name>_plain`` function, the same math in PyTorch, with no launch
counted. The serving path (``main_torch.py``, the engine) never enters it,
and it is not a fallback: outside it the wrappers launch their kernels on
CUDA or raise.
"""
from __future__ import annotations

import contextlib

from . import convnext_block, depthwise, gcvit_block, int8_gemm, layernorm, window_attention

# (module, wrapper) pairs the models reach; each module has ``<wrapper>_plain``
MODEL_KERNELS = (
    [(convnext_block, n) for n in ("dwconv7x7_nhwc", "ln_fc1_gelu", "fc2_scale_residual")]
    + [(gcvit_block, n) for n in ("ln_qkv", "window_attention", "proj_scale_residual")]
    + [(window_attention, "window_attention"), (layernorm, "layer_norm"),
       (int8_gemm, "ptq_int8_conv"), (depthwise, "depthwise_conv_nhwc")])


@contextlib.contextmanager
def plain_kernels():
    """Route the models' kernels through their plain versions until exit."""
    saved = [(m, n, getattr(m, n)) for m, n in MODEL_KERNELS]
    for m, n in MODEL_KERNELS:
        setattr(m, n, getattr(m, n + "_plain"))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
