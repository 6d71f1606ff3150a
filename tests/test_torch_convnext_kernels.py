"""The port's ConvNeXt block kernels.

On the CPU the wrappers run their plain PyTorch versions, which are held to
the JAX package's Pallas block kernels run in interpret mode (exact-erf GELU,
f32, atol 1e-5). The kernels themselves need the card:
``test_torch_kernels_cuda.py`` holds them to the plain versions there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.ops.pallas.convnext_block import (
    fused_convnext_block,
    fused_convnext_block_batchlane,
)
from vip_cup_2022_tpu_torch.ops.kernels import build
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K

ATOL = 1e-5  # f32 on both sides; the two LN statistics forms differ by ~1e-7


def _params(c, rng):
    """dw (7,7,C), dw bias, LN gamma/beta, w1 (C,4C), b1, w2 (4C,C), b2 at the
    scale of the JAX package's own block tests, and layer scale ~ U(0.5, 1.5):
    the 1e-6 init would hide the MLP."""
    shapes = [(7, 7, c), (c,), (c,), (c,), (c, 4 * c), (4 * c,), (4 * c, c), (c,)]
    args = [rng.uniform(-0.2, 0.2, s).astype(np.float32) for s in shapes]
    args.append(rng.uniform(0.5, 1.5, (c,)).astype(np.float32))
    return args


def _port_block(x, args):
    dw, dwb, g, bt, w1, b1, w2, b2, ls = [torch.from_numpy(a) for a in args]
    out = K.convnext_block(torch.from_numpy(x), dw, dwb, g, bt, w1.T.contiguous(), b1,
                           w2.T.contiguous(), b2, ls, eps=1e-6)
    return out.numpy()


@pytest.mark.parametrize("c,shape,row_tile", [
    (32, (2, 9, 9), None),
    (256, (2, 9, 9), None),
    (32, (2, 13, 11), 5),   # ragged H and W, ragged last row tile
    (256, (1, 7, 5), 3),
])
def test_block_plain_matches_fused_convnext_block(c, shape, row_tile):
    rng = np.random.RandomState(c + shape[1])
    x = rng.uniform(-1, 1, (*shape, c)).astype(np.float32)
    args = _params(c, rng)
    ref = fused_convnext_block(jnp.asarray(x), *map(jnp.asarray, args), gelu="erf",
                               row_tile=row_tile, interpret=True)
    np.testing.assert_allclose(_port_block(x, args), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("c,shape", [(32, (3, 9, 11)), (96, (2, 9, 11)), (96, (3, 5, 7))])
def test_block_plain_matches_fused_convnext_block_batchlane(c, shape):
    rng = np.random.RandomState(c)
    x = rng.uniform(-1, 1, (*shape, c)).astype(np.float32)
    args = _params(c, rng)
    xt = jnp.transpose(jnp.asarray(x), (1, 2, 3, 0))
    ref = jnp.transpose(
        fused_convnext_block_batchlane(xt, *map(jnp.asarray, args), gelu="erf",
                                       interpret=True), (3, 0, 1, 2))
    np.testing.assert_allclose(_port_block(x, args), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("c", [32, 96])
def test_dwconv_plain_matches_jax_depthwise(c):
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 11, 9, c)).astype(np.float32)
    k = rng.uniform(-0.2, 0.2, (7, 7, c)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, (c,)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k)[:, :, None, :], (1, 1), [(3, 3), (3, 3)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c) + b
    out = K.dwconv7x7_nhwc(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("c", [32, 192])
def test_ln_fc1_gelu_and_fc2_plain_match_jax(c):
    rng = np.random.RandomState(6)
    m = 37  # not a multiple of any row tile
    x = rng.uniform(-1, 1, (m, c)).astype(np.float32)
    res = rng.uniform(-1, 1, (m, c)).astype(np.float32)
    _, _, g, bt, w1, b1, w2, b2, ls = _params(c, rng)
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    y = (jnp.asarray(x) - mean) * jax.lax.rsqrt(jnp.asarray(var) + 1e-6) * g + bt
    h_ref = jax.nn.gelu(y @ w1 + b1, approximate=False)
    o_ref = res + (h_ref @ w2 + b2) * ls
    t = torch.from_numpy
    h = K.ln_fc1_gelu(t(x), t(g), t(bt), t(w1.T.copy()), t(b1), 1e-6)
    o = K.fc2_scale_residual(h, t(w2.T.copy()), t(b2), t(ls), t(res))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    K.reset_launches()
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (1, 5, 5, 32)).astype(np.float32)
    _port_block(x, _params(32, rng))
    assert K.LAUNCHES == {"dwconv7x7_nhwc": 0, "ln_fc1_gelu": 0, "fc2_scale_residual": 0}


def test_library_path_tracks_source_and_flags(monkeypatch):
    p1 = build.library_path("convnext_block")
    assert p1.startswith(build.BUILD_DIR) and p1.endswith(".so")
    assert build.library_path("convnext_block") == p1
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("convnext_block") != p1


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
