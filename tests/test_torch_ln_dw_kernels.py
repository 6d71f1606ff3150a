"""The port's LayerNorm (K10), window-attention (K8) and depthwise (K9)
kernels, on the CPU.

The wrappers run their plain PyTorch versions for CPU tensors; those are held
to the JAX package's Pallas kernels run in interpret mode, as the JAX
package's own tests run them (f32 on both sides, atol 1e-5). The LN's
autograd backward is held to the JAX ``custom_vjp`` backward. The kernels
themselves need the card: ``test_torch_kernels_cuda.py`` holds them to the
plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.ops.norms import LayerNorm as JaxLayerNorm
from vip_cup_2022_tpu.ops.pallas.depthwise import depthwise_conv_nhwc as jax_depthwise
from vip_cup_2022_tpu.ops.pallas.norms import _bwd as jax_ln_bwd
from vip_cup_2022_tpu.ops.pallas.norms import _pallas_ln2
from vip_cup_2022_tpu.ops.pallas.window_attention import window_attention as jax_window_attention
from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D
from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L
from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA
from vip_cup_2022_tpu_torch.ops.norms import LayerNorm
from vip_cup_2022_tpu_torch.weights.from_jax import state_dict_from_flax

ATOL = 1e-5  # f32 on both sides


def _u(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K10: LayerNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,c,eps", [(37, 16, 1e-5), (1029, 64, 1e-5), (50, 96, 1e-6)])
def test_layer_norm_plain_matches_pallas_ln(m, c, eps):
    """Ragged M: no row count here is a multiple of the TPU kernel's row tile."""
    rng = np.random.RandomState(c)
    x = _u(rng, (m, c), -2, 3)
    g, b = _u(rng, (c,), 0.5, 1.5), _u(rng, (c,), -0.1, 0.1)
    want = _pallas_ln2(jnp.asarray(x), g, b, eps, interpret=True)
    got = L.layer_norm(_t(x), _t(g), _t(b), eps)
    assert got.shape == (m, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", [(3, 5, 7, 64), (4, 96)])
def test_layer_norm_backward_matches_the_jax_custom_vjp(shape):
    """The autograd function's gradients (x, weight, bias) against the JAX
    ``custom_vjp`` backward, which differentiates the reference LN."""
    rng = np.random.RandomState(len(shape))
    c = shape[-1]
    x, dy = _u(rng, shape, -2, 2), _u(rng, shape)
    g, b = _u(rng, (c,), 0.5, 1.5), _u(rng, (c,), -0.1, 0.1)
    want = jax_ln_bwd(1e-5, (jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)), jnp.asarray(dy))
    xt, gt, bt = (_t(a).requires_grad_() for a in (x, g, b))
    y = L.fused_layernorm(xt, gt, bt, 1e-5)
    np.testing.assert_allclose(y.detach().numpy(),
                               L.layer_norm_plain(_t(x), _t(g), _t(b), 1e-5).numpy(), atol=0)
    y.backward(_t(dy))
    for got, ref in zip((xt.grad, gt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_layer_norm_module_keeps_its_names_and_matches_the_flax_module():
    """``weight`` / ``bias`` still take the Flax ``gamma`` / ``beta`` through
    the weight bridge, and the module runs the LN function (f32)."""
    rng = np.random.RandomState(5)
    x = _u(rng, (2, 7, 9, 64), -2, 2)
    params = {"gamma": _u(rng, (64,), 0.5, 1.5), "beta": _u(rng, (64,), -0.1, 0.1)}
    want = JaxLayerNorm(epsilon=1e-6).apply({"params": params}, jnp.asarray(x))
    port = LayerNorm(64, eps=1e-6)
    assert set(port.state_dict()) == {"weight", "bias"}
    port.load_state_dict(state_dict_from_flax({"params": params}, port.state_dict(), True))
    np.testing.assert_array_equal(port.weight.detach().numpy(), params["gamma"])
    L.reset_launches()
    with torch.inference_mode():
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert L.LAUNCHES == {"layer_norm": 0}  # CPU tensors take the plain version


@pytest.mark.parametrize("c", [12, 26, 52, 13, 1])
def test_layer_norm_at_any_width_matches_the_flax_module(c):
    """EfficientNetV2T_GC's ``gc_ln`` widths (12, 26, 52) and odd ones, which
    the kernel takes on its scalar path: the wrapper's plain version (what it
    runs on the CPU) against the JAX package's f32 LayerNorm, eps 1e-5, on
    pooled (B, 1, 1, C) rows."""
    rng = np.random.RandomState(c)
    x = _u(rng, (33, 1, 1, c), -2, 3)
    params = {"gamma": _u(rng, (c,), 0.5, 1.5), "beta": _u(rng, (c,), -0.1, 0.1)}
    want = JaxLayerNorm(epsilon=1e-5).apply({"params": params}, jnp.asarray(x))
    got = L.layer_norm(_t(x), _t(params["gamma"]), _t(params["beta"]), 1e-5)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_layer_norm_keeps_the_input_dtype():
    x = torch.randn(4, 32, dtype=torch.bfloat16)
    out = L.layer_norm(x, torch.ones(32), torch.zeros(32), 1e-5)
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# K8: window attention on (B, H, N, D)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 2, 49, 32), (2, 8, 196, 32), (3, 1, 9, 8),
                                   (2, 4, 49, 32), (2, 8, 49, 32), (1, 16, 49, 32)])
def test_window_attention_plain_matches_pallas(shape):
    """GCViTTiny's windows: N = 49 at heads 2 / 4 / 8 / 16 (L1, L2, L4 and
    L3's head count), N = 196 at L3; f32 on both sides, as the f32 kernel
    ``window_attention_bhnd_f32`` is held to this plain version on the
    card."""
    b, heads, n, d = shape
    rng = np.random.RandomState(n)
    q, k, v = (_u(rng, shape) for _ in range(3))
    bias = _u(rng, (heads, n, n))
    scale = d ** -0.5
    want = jax_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias), scale, interpret=True)
    WA.reset_launches()
    got = WA.window_attention(_t(q), _t(k), _t(v), _t(bias), scale)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert set(WA.LAUNCHES.values()) == {0}


def test_window_attention_plain_casts_p_to_v_dtype():
    """P is rounded to v's dtype before P.V, as the TPU kernel rounds it."""
    rng = np.random.RandomState(1)
    q, k = _t(_u(rng, (1, 1, 9, 8), -3, 3)), _t(_u(rng, (1, 1, 9, 8), -3, 3))
    v = _t(_u(rng, (1, 1, 9, 8))).to(torch.bfloat16)
    bias = torch.zeros(1, 9, 9)
    got = WA.window_attention(q, k, v, bias, 1.0)
    p = torch.softmax(q @ k.transpose(-1, -2), -1).to(torch.bfloat16).float()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  (p @ v.float()).to(torch.bfloat16).float().numpy())


def test_window_attention_phase_cuts_are_cuda_only():
    """The phase cuts are CUDA kernels with no plain version: CPU tensors
    raise."""
    q = torch.zeros((1, 1, 9, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="only as CUDA kernels"):
        WA.window_attention_cut(q, q, q, torch.zeros(1, 9, 9), 0.2, 1)


def test_exp_window_attention_needs_a_card(monkeypatch):
    from vip_cup_2022_tpu_torch.tools import exp_window_attention

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_window_attention.main(["--iters", "1"])


# ---------------------------------------------------------------------------
# K9: depthwise conv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,padding,kern_rank,c", [
    pytest.param(3, ((1, 1), (1, 1)), 4, 24, id="3-padding0-4"),
    pytest.param(5, ((2, 1), (0, 2)), 4, 24, id="5-padding1-4"),
    pytest.param(7, ((3, 2), (1, 3)), 3, 24, id="7-padding2-3"),
    pytest.param(3, ((0, 2), (2, 0)), 3, 24, id="3-padding3-3"),
    pytest.param(5, ((2, 2), (2, 2)), 4, 336, id="5-padding4-4-c336"),
    pytest.param(3, ((1, 0), (0, 1)), 3, 336, id="3-padding5-3-c336"),
    pytest.param(7, ((0, 3), (3, 0)), 4, 6, id="7-padding6-4-c6"),
    # TF SAME at stride 1: ConvNeXt's 7 x 7 at C = 96, GCViT's 3 x 3 at 64,
    # V1B4's 5 x 5 at 40
    pytest.param(7, ((3, 3), (3, 3)), 3, 96, id="7-same-3-c96"),
    pytest.param(3, ((1, 1), (1, 1)), 3, 64, id="3-same-3-c64"),
    pytest.param(5, ((2, 2), (2, 2)), 4, 40, id="5-same-4-c40"),
])
def test_depthwise_plain_matches_pallas(k, padding, kern_rank, c):
    """Asymmetric paddings, taps in the Flax (k, k, 1, C) and the port's
    (k, k, C) layouts, widths that are no multiple of the CUDA kernel's
    32-channel slice (24, 6: a tail alone; 336: ten slices and a tail of 16)
    and TF SAME pairs at the models' widths, f32 on both sides (the f32
    kernel ``depthwise_conv_nhwc_f32`` is held to this plain version on the
    card), atol 1e-5."""
    rng = np.random.RandomState(k)
    x = _u(rng, (2, 11, 9, c))
    kern = _u(rng, (k, k, 1, c), -0.5, 0.5)
    want = jax_depthwise(jnp.asarray(x), jnp.asarray(kern), padding=padding, interpret=True)
    taps = kern if kern_rank == 4 else kern[:, :, 0, :]
    D.reset_launches()
    got = D.depthwise_conv_nhwc(_t(x), _t(taps), padding=padding)
    assert got.shape == np.asarray(want).shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert set(D.LAUNCHES.values()) == {0}


def test_exp_dw_times_the_jax_tools_shapes():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools.exp_dw import SHAPES as JAX_SHAPES
    from vip_cup_2022_tpu_torch.tools import exp_dw

    assert exp_dw.SHAPES == JAX_SHAPES
    if not torch.cuda.is_available():  # the tool refuses to time the CPU
        with pytest.raises(SystemExit):
            exp_dw.main(["--iters", "1"])
