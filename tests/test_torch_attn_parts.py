"""The port's attention-parts kernel (K11) and its ``exp_attn_parts`` tool,
on the CPU.

The wrapper runs its plain PyTorch version for CPU tensors; each of the
tool's six variants is held to the JAX tool's ``build`` with ``pallas_call``
forced into interpret mode (``build`` takes no ``interpret`` argument), f32
inputs on both sides, within 1e-5 of max|ref|. The kernel rounds q and P to
bf16 whatever the input dtype (the TPU tool's ``mm_dtype``), so the inputs
are multiples of 1/16 in [-2, 2]: every score is then exact in f32 in any
summation order, and the two sides round the same values to bf16. The
kernel itself needs the card: ``test_torch_kernels_cuda.py`` holds it to the
plain version there.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.ops.kernels import attn_parts as A
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G
from vip_cup_2022_tpu_torch.tools import exp_attn_parts as T

B, NWIN, N, C, HEADS, GROUP = 2, 4, 49, 64, 2, 2
REL = 1e-5  # of max|ref|, f32 on both sides


@pytest.fixture
def jax_tool(monkeypatch):
    """The JAX ``tools/exp_attn_parts.py`` with every ``pallas_call`` in
    interpret mode and its compilation cache off."""
    monkeypatch.setenv("VIPTPU_NO_JIT_CACHE", "1")
    real = pl.pallas_call

    def interpreted(*args, **kwargs):
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    return importlib.import_module("tools.exp_attn_parts")


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [np.round(rng.uniform(-2, 2, (B, NWIN * N, C)) * 16).astype(np.float32) / 16
            for _ in range(3)]


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("variant", list(T.VARIANTS))
def test_attn_parts_plain_matches_pallas(jax_tool, variant):
    q, k, v = _inputs()
    parts = T.VARIANTS[variant]
    call = jax_tool.build(B, NWIN, N, C, HEADS, GROUP, parts or set(), copy=parts is None)
    want = call(*(jnp.asarray(a) for a in (q, k, v)))
    t = dict(q=torch.from_numpy(q), k=torch.from_numpy(k), v=torch.from_numpy(v),
             mb=torch.from_numpy(A.group_bias(HEADS, N, GROUP)))
    A.reset_launches()
    got = T.call(variant, t, HEADS, N, GROUP)()
    assert A.LAUNCHES == {"attn_parts": 0, "attn_parts_copy": 0}  # CPU tensors: no launch
    assert got.shape == (B, NWIN * N, C) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= REL


def test_full_is_window_attention_per_window():
    """With the block-diagonal bias, ``full`` is softmax attention within each
    window: the GCViT plain window attention with the per-window bias, within
    1e-2 of max|ref| (the kernel rounds q and P to bf16, the reference not)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1))
    mb = A.group_bias(HEADS, N, GROUP)
    got = A.attn_parts(q, k, v, torch.from_numpy(mb), heads=HEADS, n=N, g=GROUP,
                       parts=T.VARIANTS["full"])
    window_bias = torch.from_numpy(np.ascontiguousarray(mb[:, :N, :N]))
    want = G.window_attention_plain(q, k, v, window_bias, N, (C // HEADS) ** -0.5)
    assert _rel(got.numpy(), want.numpy()) <= 1e-2


def test_group_bias_is_the_tools(jax_tool):
    """The numpy copy of the tool's bias against the one ``build`` feeds its
    kernel (read back through the ``pallas_call`` arguments)."""
    seen = []
    real = pl.pallas_call

    def record(*args, **kwargs):
        call = real(*args, **kwargs)

        def run(*operands):
            seen.append(np.asarray(operands[3]))
            return call(*operands)

        return run

    pl.pallas_call = record
    try:
        q = jnp.zeros((1, 4 * N, C), jnp.float32)
        jax_tool.build(1, 4, N, C, HEADS, GROUP, {"bias"})(q, q, q)
    finally:
        pl.pallas_call = real
    np.testing.assert_array_equal(seen[0], A.group_bias(HEADS, N, GROUP))
    assert T.SHAPES == jax_tool.SHAPES


def test_unknown_parts_raise():
    q = torch.zeros((1, 2 * N, C))
    with pytest.raises(ValueError, match="unknown attention parts"):
        A.attn_parts(q, q, q, torch.zeros((HEADS, 2 * N, 2 * N)), heads=HEADS, n=N, g=2,
                     parts={"bias", "softmax"})


def test_tool_exits_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        T.main(["l1", "--iters", "1"])
