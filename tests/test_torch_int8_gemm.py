"""K13, the int8 GEMM spike, on the CPU: the plain versions of the port's
three spike bodies (``ops/kernels/int8_gemm.py``) against the Pallas kernel
``_call`` of ``tools/int8_pallas_spike.py`` run in interpret mode, and the
port tool's ``equiv`` against the JAX tool's hand math.

The JAX tool's ``_call`` takes ``interpret=True``. Shapes are ragged against
its row tile and the kernel's 128 x 128 x 64 tiles. The kernels themselves
need the card: ``test_torch_kernels_cuda.py`` holds them to these plain
versions there.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q
from vip_cup_2022_tpu_torch.tools import int8_pallas_spike as T


@pytest.fixture(scope="module")
def spike():
    return importlib.import_module("tools.int8_pallas_spike")


SHAPES = [(20, 48, 24, 8), (37, 64, 36, 16), (5, 128, 8, 8)]  # (M, K, N, m_tile)


def _ties(m, k, rng):
    """f32 x on a 1/32 grid, a third of it exactly on the half steps of the
    scale 1/16, so round-half-to-even decides those elements."""
    x = rng.randint(-64 * 32, 64 * 32, (m, k)).astype(np.float32) / 32.0
    halves = (rng.randint(-100, 100, (m, k)) + 0.5).astype(np.float32) / 16.0
    pick = rng.rand(m, k) < 1 / 3
    x[pick] = halves[pick]
    return x


@pytest.mark.parametrize("m,k,n,tile", SHAPES)
def test_direct_plain_equals_pallas(spike, m, k, n, tile):
    rng = np.random.RandomState(m)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    want = spike._call(spike._int8_direct_kernel, jnp.asarray(x), jnp.asarray(w), jnp.int32,
                       tile, interpret=True)
    Q.reset_launches()
    got = Q.int8_spike_direct(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and all(v == 0 for v in Q.LAUNCHES.values())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n,tile", SHAPES)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_int8_plain_equals_pallas_with_ties(spike, m, k, n, tile, x_dtype):
    """Within 1e-6 of max|ref|: both sides sum the same integers and scale
    by the same f32 ``sx``; the ties pin round half to even (``roundf``
    would differ on every tie)."""
    rng = np.random.RandomState(k)
    x = _ties(m, k, rng)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    sx = 1.0 / 16.0
    xj = jnp.asarray(x).astype(x_dtype)
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    kern = functools.partial(spike._int8_kernel, sx=sx)
    want = np.asarray(spike._call(kern, xj, jnp.asarray(w), jnp.float32, tile, interpret=True))
    got = Q.int8_spike_int8(xt, torch.from_numpy(w), sx, torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    q = Q.quantize(xt, Q.f32_reciprocal(sx)).numpy()
    ties = (x * 16.0) % 1.0 == 0.5
    assert ties.any()
    half_even = np.clip(np.round(x[ties] * 16.0), -127, 127)  # numpy rounds half to even
    np.testing.assert_array_equal(q[ties], half_even)


@pytest.mark.parametrize("m,k,n,tile", SHAPES)
def test_bf16_plain_equals_pallas(spike, m, k, n, tile):
    """Inputs on a 1/8 grid: every product and partial sum is exact in f32,
    so both sides round the same f32 sums to bf16 and agree exactly."""
    rng = np.random.RandomState(n)
    x = (rng.randint(-16, 17, (m, k)) / 8.0).astype(np.float32)
    w = (rng.randint(-16, 17, (k, n)) / 8.0).astype(np.float32)
    want = spike._call(spike._bf16_kernel, jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16), jnp.bfloat16, tile, interpret=True)
    got = Q.int8_spike_bf16(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_tool_equiv_matches_jax_hand_math():
    """The port tool's equiv on the CPU against the JAX tool's hand math
    (``equiv``: ``(qx * sx) @ w.astype(int8)``, qx by division), within the
    JAX tool's 1e-3. The JAX tool's int8 weights truncate to zeros, so the
    tool's second case, ``w * 16``, carries the check."""
    rng = np.random.RandomState(0)
    x = rng.randn(256, 384).astype(np.float32)
    w = (rng.randn(384, 1536) * 0.05).astype(np.float32)
    sx = float(np.abs(x).max()) / 127.0
    qx = np.clip(np.round(x / sx), -127, 127)
    xt = torch.from_numpy(x)
    for w8 in (w.astype(np.int8), np.clip(w * 16.0, -127, 127).astype(np.int8)):
        want = (qx * sx) @ w8.astype(np.float32)
        got = Q.int8_spike_int8(xt, torch.from_numpy(w8), sx, torch.float32).numpy()
        assert np.abs(got - want).max() < 1e-3 * max(1.0, np.abs(want).max())
    errs = T.equiv("cpu")
    assert set(errs) == {"jax_weights", "w_x16"} and max(errs.values()) < 1e-3


def test_tool_gemm_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        T.main(["gemm"])


def test_tool_equiv_needs_a_card(monkeypatch):
    """The entry point never checks the plain version in the kernel's place:
    without a card ``equiv`` exits (``equiv("cpu")`` is asked for by name)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        T.main(["equiv"])
