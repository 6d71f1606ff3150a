"""The port's GCViT window-block kernels.

On the CPU the wrappers run their plain PyTorch versions, which are held to
the JAX package's Pallas GCViT kernels run in interpret mode (f32, exact-erf
GELU, atol 1e-5). The kernels themselves need the card:
``test_torch_kernels_cuda.py`` holds them to the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.ops.pallas.gcvit_block import (
    grouped_window_attention,
    ln_dense,
    mono_window_transformer_block,
    proj_res_ln_mlp,
)
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as CK
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G

ATOL = 1e-5  # f32 on both sides


def _u(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block_params(c, s, heads, n, rng):
    """Block parameters in the JAX layout (Dense kernels (in, out)); LN and
    layer scale off their 1 / 0 init so every leaf matters."""
    h = 3 * c
    return dict(
        ln1_g=_u(rng, (c,), 0.5, 1.5), ln1_b=_u(rng, (c,), -0.1, 0.1),
        wqkv=_u(rng, (c, s * c)) * c ** -0.5, bqkv=_u(rng, (s * c,), -0.1, 0.1),
        bias=_u(rng, (heads, n, n)),
        wp=_u(rng, (c, c)) * c ** -0.5, bp=_u(rng, (c,), -0.1, 0.1),
        ln2_g=_u(rng, (c,), 0.5, 1.5), ln2_b=_u(rng, (c,), -0.1, 0.1),
        w1=_u(rng, (c, h)) * c ** -0.5, b1=_u(rng, (h,), -0.1, 0.1),
        w2=_u(rng, (h, c)) * h ** -0.5, b2=_u(rng, (c,), -0.1, 0.1),
        gamma1=_u(rng, (c,), 0.5, 1.5), gamma2=_u(rng, (c,), 0.5, 1.5),
    )


@pytest.mark.parametrize("c,split,m", [(64, 3, 37), (64, 2, 37), (128, 3, 64), (32, 2, 5)])
def test_ln_qkv_plain_matches_ln_dense(c, split, m):
    rng = np.random.RandomState(c + split)
    x = _u(rng, (m, c))
    g, b = _u(rng, (c,), 0.5, 1.5), _u(rng, (c,), -0.1, 0.1)
    w, wb = _u(rng, (c, split * c)) * c ** -0.5, _u(rng, (split * c,), -0.1, 0.1)
    want = ln_dense(jnp.asarray(x), g, b, jnp.asarray(w), wb, eps=1e-5, split=split,
                    interpret=True)
    got = G.ln_qkv(_t(x), _t(g), _t(b), _t(w.T), _t(wb), 1e-5)
    assert len(got) == split
    for a, ref in zip(got, want):
        assert a.shape == (m, c) and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("n,nwin,heads,hd,q_is_global", [
    (49, 4, 2, 32, False), (49, 4, 2, 32, True), (9, 4, 2, 8, False), (9, 4, 2, 8, True),
    (49, 1, 4, 32, True),  # single-window level: the global query is the image's own q
])
def test_window_attention_plain_matches_grouped_window_attention(n, nwin, heads, hd, q_is_global):
    rng = np.random.RandomState(n + nwin + int(q_is_global))
    b, c = 2, heads * hd
    k, v = _u(rng, (b, nwin * n, c)), _u(rng, (b, nwin * n, c))
    q = _u(rng, (b, n, c) if q_is_global else (b, nwin * n, c))
    bias = _u(rng, (heads, n, n))
    scale = hd ** -0.5
    want = grouped_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, n,
                                    bias=jnp.asarray(bias), scale=scale, group=min(2, nwin),
                                    q_is_global=q_is_global, interpret=True)
    got = G.window_attention(_t(q), _t(k), _t(v), _t(bias), n, scale, q_is_global=q_is_global)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("c,m", [(64, 37), (128, 50)])
def test_proj_ln_mlp_plain_chain_matches_proj_res_ln_mlp(c, m):
    rng = np.random.RandomState(c)
    p = _block_params(c, 3, 2, 4, rng)
    a, x = _u(rng, (m, c)), _u(rng, (m, c))
    want = proj_res_ln_mlp(jnp.asarray(a), jnp.asarray(x), p["wp"], p["bp"], p["gamma1"],
                           p["ln2_g"], p["ln2_b"], p["w1"], p["b1"], p["w2"], p["b2"],
                           p["gamma2"], eps=1e-5, gelu="erf", interpret=True)
    r1 = G.proj_scale_residual(_t(a), _t(p["wp"].T), _t(p["bp"]), _t(p["gamma1"]), _t(x))
    assert r1.dtype == torch.float32
    h = CK.ln_fc1_gelu(r1, _t(p["ln2_g"]), _t(p["ln2_b"]), _t(p["w1"].T), _t(p["b1"]), 1e-5)
    got = CK.fc2_scale_residual(h, _t(p["w2"].T), _t(p["b2"]), _t(p["gamma2"]), r1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _port_block(x, qg, p, n):
    return G.window_transformer_block(
        _t(x), None if qg is None else _t(qg), n=n,
        ln1_weight=_t(p["ln1_g"]), ln1_bias=_t(p["ln1_b"]), wqkv=_t(p["wqkv"].T),
        bqkv=_t(p["bqkv"]), bias=_t(p["bias"]), wp=_t(p["wp"].T), bp=_t(p["bp"]),
        gamma1=_t(p["gamma1"]), ln2_weight=_t(p["ln2_g"]), ln2_bias=_t(p["ln2_b"]),
        w1=_t(p["w1"].T), b1=_t(p["b1"]), w2=_t(p["w2"].T), b2=_t(p["b2"]),
        gamma2=_t(p["gamma2"]), eps=1e-5).numpy()


@pytest.mark.parametrize("n,nwin,heads,global_query", [
    (49, 4, 2, False), (49, 4, 2, True), (9, 4, 1, False), (9, 4, 1, True), (49, 1, 4, True),
])
def test_window_transformer_block_plain_matches_mono_block(monkeypatch, n, nwin, heads,
                                                           global_query):
    """The five-launch composition against the TPU's whole-block kernel,
    with its exact-erf GELU; hd = 32 as at every GCViT level."""
    monkeypatch.setenv("VIPTPU_GELU", "erf")
    rng = np.random.RandomState(n + nwin + heads)
    b, c = 2, heads * 32
    p = _block_params(c, 2 if global_query else 3, heads, n, rng)
    x = _u(rng, (b, nwin * n, c))
    qg = _u(rng, (b, n, c)) if global_query else None
    want = mono_window_transformer_block(
        jnp.asarray(x), heads=heads, n=n, ln1_g=p["ln1_g"], ln1_b=p["ln1_b"], wqkv=p["wqkv"],
        bqkv=p["bqkv"], bias=p["bias"], wp=p["wp"], bp=p["bp"], ln2_g=p["ln2_g"],
        ln2_b=p["ln2_b"], w1=p["w1"], b1=p["b1"], w2=p["w2"], b2=p["b2"],
        gamma1=p["gamma1"], gamma2=p["gamma2"], scale=32 ** -0.5,
        q_global=None if qg is None else jnp.asarray(qg), group=min(2, nwin), eps=1e-5,
        interpret=True)
    np.testing.assert_allclose(_port_block(x, qg, p, n), np.asarray(want), atol=ATOL)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    G.reset_launches()
    CK.reset_launches()
    rng = np.random.RandomState(3)
    p = _block_params(32, 3, 1, 9, rng)
    out = _port_block(_u(rng, (1, 18, 32)), None, p, 9)
    assert out.shape == (1, 18, 32)
    assert G.LAUNCHES == {"ln_qkv": 0, "window_attention": 0, "proj_scale_residual": 0}
    assert CK.LAUNCHES == {"dwconv7x7_nhwc": 0, "ln_fc1_gelu": 0, "fc2_scale_residual": 0}


def test_fc2_plain_keeps_the_hidden_dtype_with_an_f32_residual():
    h = torch.ones((4, 96), dtype=torch.bfloat16)
    w2 = torch.full((32, 96), 0.01, dtype=torch.bfloat16)
    out = CK.fc2_scale_residual(h, w2, torch.zeros(32), torch.ones(32), torch.ones((4, 32)))
    assert out.dtype == torch.bfloat16
