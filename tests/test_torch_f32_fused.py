"""The fused blocks in f32 (``VIPTPU_DTYPE=float32``) against the JAX package.

The port's f32 ConvNeXt block through its three wrappers (``dwconv7x7_nhwc``,
``ln_fc1_gelu``, ``fc2_scale_residual``) and its f32 GCViT block through its
five (``ln_qkv``, ``window_attention``, ``proj_scale_residual`` and the two
MLP GEMMs), on the CPU their plain versions, against the JAX package's
fused entry points in f32 with their Pallas kernels in interpret mode and
exact-erf GELU (``VIPTPU_GELU=erf``): ``fused_convnext_block`` (C >= 256),
``fused_convnext_block_batchlane`` (C < 256) and
``fused_window_transformer_block`` with and without a global query, one
window (the JAX wrapper's batch fold) and several; within 1e-4. On the card
the same wrappers launch their ``_f32`` kernels, which
``test_torch_kernels_cuda.py`` holds to these plain versions (``-k f32``);
the narrow members on their fused f32 blocks against the JAX models are in
``test_torch_f32_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_convnext_kernels import _params as _convnext_params
from test_torch_convnext_kernels import _port_block as _port_convnext_block
from test_torch_gcvit_kernels import _block_params, _port_block as _port_gcvit_block, _u
from vip_cup_2022_tpu.ops.pallas.convnext_block import (
    fused_convnext_block,
    fused_convnext_block_batchlane,
)
from vip_cup_2022_tpu.ops.pallas.gcvit_block import fused_window_transformer_block
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G

ATOL = 1e-4  # f32 on both sides, sums over K up to 4C in another order


@pytest.fixture(autouse=True)
def erf_gelu(monkeypatch):
    monkeypatch.setenv("VIPTPU_GELU", "erf")
    K.reset_launches()
    G.reset_launches()
    yield
    assert not any(K.LAUNCHES.values()) and not any(G.LAUNCHES.values())  # CPU: no launch


@pytest.mark.parametrize("c,shape", [(256, (2, 9, 9)), (512, (1, 7, 5)), (768, (1, 5, 6))])
def test_f32_convnext_block_matches_fused_convnext_block(c, shape):
    rng = np.random.RandomState(c)
    x = rng.uniform(-1, 1, (*shape, c)).astype(np.float32)
    args = _convnext_params(c, rng)
    want = fused_convnext_block(jnp.asarray(x), *map(jnp.asarray, args), gelu="erf",
                                interpret=True)
    got = _port_convnext_block(x, args)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("c,shape", [(64, (3, 7, 7)), (96, (2, 9, 11)), (192, (2, 5, 7))])
def test_f32_convnext_block_matches_fused_convnext_block_batchlane(c, shape):
    rng = np.random.RandomState(c + 1)
    x = rng.uniform(-1, 1, (*shape, c)).astype(np.float32)
    args = _convnext_params(c, rng)
    xt = jnp.transpose(jnp.asarray(x), (1, 2, 3, 0))
    want = jnp.transpose(fused_convnext_block_batchlane(xt, *map(jnp.asarray, args), gelu="erf",
                                                        interpret=True), (3, 0, 1, 2))
    got = _port_convnext_block(x, args)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n,nwin,heads,global_query", [
    (49, 4, 2, False), (49, 4, 2, True), (49, 1, 4, False), (49, 1, 4, True), (9, 4, 1, True),
])
def test_f32_window_block_matches_fused_window_transformer_block(n, nwin, heads, global_query):
    """hd = 32 as at every GCViT level; ``nwin`` = 1 takes the JAX wrapper's
    fold of images into windows."""
    rng = np.random.RandomState(n + 3 * nwin + heads)
    b, c = 2, heads * 32
    p = _block_params(c, 2 if global_query else 3, heads, n, rng)
    x = _u(rng, (b, nwin * n, c))
    qg = _u(rng, (b, n, c)) if global_query else None
    want = fused_window_transformer_block(
        jnp.asarray(x), heads=heads, n=n, ln1_g=p["ln1_g"], ln1_b=p["ln1_b"], wqkv=p["wqkv"],
        bqkv=p["bqkv"], bias=p["bias"], wp=p["wp"], bp=p["bp"], ln2_g=p["ln2_g"],
        ln2_b=p["ln2_b"], w1=p["w1"], b1=p["b1"], w2=p["w2"], b2=p["b2"],
        gamma1=p["gamma1"], gamma2=p["gamma2"], scale=32 ** -0.5,
        q_global=None if qg is None else jnp.asarray(qg), eps=1e-5, interpret=True)
    got = _port_gcvit_block(x, qg, p, n)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_f32_block_wrappers_keep_f32_on_the_cpu():
    """The f32 block's intermediate outputs stay f32 through every wrapper
    (the hidden and q / k / v in the weights' dtype)."""
    rng = np.random.RandomState(0)
    c, m = 32, 18
    x = torch.from_numpy(_u(rng, (m, c)))
    w = torch.from_numpy(_u(rng, (3 * c, c)))
    b, g = torch.zeros(3 * c), torch.ones(c)
    q, k, v = G.ln_qkv(x, g, torch.zeros(c), w, b, 1e-5)
    a = G.window_attention(q.view(2, 9, c), k.view(2, 9, c), v.view(2, 9, c),
                           torch.zeros((1, 9, 9)), 9, 32 ** -0.5)
    r1 = G.proj_scale_residual(a.view(m, c), w[:c], b[:c], g, x)
    h = K.ln_fc1_gelu(r1, g, torch.zeros(c), w, b, 1e-5)
    out = K.fc2_scale_residual(h, w.T.contiguous(), b[:c], g, r1)
    assert {t.dtype for t in (q, k, v, a, r1, h, out)} == {torch.float32}
