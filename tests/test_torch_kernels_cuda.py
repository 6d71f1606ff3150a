"""The port's CUDA kernels on the card against their plain PyTorch versions.

Marked ``cuda``: they build the kernels with nvcc and launch them, so they skip
where there is no CUDA device. The file itself needs only torch and the port
(not flax, not the JAX package), so it runs on a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""
import pytest
import torch

from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 99, 99, 96), (2, 49, 49, 192), (3, 24, 24, 384),
                                   (2, 12, 12, 768), (1, 5, 7, 32)])
def test_kernels_match_plain_on_card(cuda_device, shape):
    """bf16 kernels vs the f32 plain versions on the same bf16-rounded inputs:
    max|d| / max|ref| <= 1e-2 (bf16 rounding of the LN output and hidden
    feeding sums over K = C ... 4C)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def u(s, lo, hi):
        return torch.rand(s, generator=g, device=cuda_device) * (hi - lo) + lo

    b, h, w, c = shape
    m = b * h * w
    x = u(shape, -1, 1).to(torch.bfloat16)
    dw, dwb = u((7, 7, c), -0.2, 0.2), u((c,), -0.1, 0.1)
    lg, lb = u((c,), 0.5, 1.5), u((c,), -0.1, 0.1)
    w1 = (u((4 * c, c), -1, 1) * c ** -0.5).to(torch.bfloat16)
    b1 = u((4 * c,), -0.1, 0.1)
    w2 = (u((c, 4 * c), -1, 1) * (4 * c) ** -0.5).to(torch.bfloat16)
    b2, ls = u((c,), -0.1, 0.1), u((c,), 0.5, 1.5)

    def rel(a, ref):
        return ((a.float() - ref).abs().max() / ref.abs().max()).item()

    d = K.dwconv7x7_nhwc(x, dw, dwb)
    hid = K.ln_fc1_gelu(d.view(m, c), lg, lb, w1, b1, 1e-6)
    out = K.fc2_scale_residual(hid, w2, b2, ls, x.view(m, c))
    torch.cuda.synchronize()
    assert rel(d, K.dwconv7x7_nhwc_plain(x.float(), dw, dwb)) <= 1e-5
    assert rel(hid, K.ln_fc1_gelu_plain(d.view(m, c), lg, lb, w1.float(), b1, 1e-6)) <= 1e-2
    ref = K.fc2_scale_residual_plain(hid.float(), w2.float(), b2, ls, x.view(m, c).float())
    assert rel(out, ref) <= 1e-2


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros((1, 5, 5, 48), dtype=torch.bfloat16, device=cuda_device)
    taps = torch.zeros((7, 7, 48), device=cuda_device)
    with pytest.raises(ValueError, match="not a multiple of 32"):
        K.dwconv7x7_nhwc(x, taps, torch.zeros(48, device=cuda_device))
    x = torch.zeros((1, 5, 5, 32), dtype=torch.float32, device=cuda_device)
    taps = torch.zeros((7, 7, 32), device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        K.dwconv7x7_nhwc(x, taps, torch.zeros(32, device=cuda_device))
    w1 = torch.zeros((128, 32), dtype=torch.bfloat16, device=cuda_device).t()
    with pytest.raises(ValueError):
        K.ln_fc1_gelu(torch.zeros((4, 32), device=cuda_device), torch.ones(32, device=cuda_device),
                      torch.zeros(32, device=cuda_device), w1, torch.zeros(128, device=cuda_device),
                      1e-6)


@pytest.mark.cuda
def test_each_wrapper_counts_its_launches(cuda_device):
    K.reset_launches()
    c, m = 32, 10
    dev = cuda_device
    d = K.dwconv7x7_nhwc(torch.zeros((1, 2, 5, c), dtype=torch.bfloat16, device=dev),
                         torch.zeros((7, 7, c), device=dev), torch.zeros(c, device=dev))
    h = K.ln_fc1_gelu(d.view(m, c), torch.ones(c, device=dev), torch.zeros(c, device=dev),
                      torch.zeros((4 * c, c), dtype=torch.bfloat16, device=dev),
                      torch.zeros(4 * c, device=dev), 1e-6)
    K.fc2_scale_residual(h, torch.zeros((c, 4 * c), dtype=torch.bfloat16, device=dev),
                         torch.zeros(c, device=dev), torch.ones(c, device=dev),
                         torch.zeros((m, c), dtype=torch.bfloat16, device=dev))
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"dwconv7x7_nhwc": 1, "ln_fc1_gelu": 1, "fc2_scale_residual": 1}


# ---------------------------------------------------------------------------
# GCViT window-block kernels
# ---------------------------------------------------------------------------
def _rel(a, ref):
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _gcvit_inputs(dev, b, nwin, n, c, heads, global_query, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(s, lo=-1.0, hi=1.0):
        return torch.rand(s, generator=g, device=dev) * (hi - lo) + lo

    s = 2 if global_query else 3
    bf = torch.bfloat16
    return dict(
        x=u((b, nwin * n, c)).to(bf), qg=u((b, n, c)).to(bf) if global_query else None,
        ln1_weight=u((c,), 0.5, 1.5), ln1_bias=u((c,), -0.1, 0.1),
        wqkv=(u((s * c, c)) * c ** -0.5).to(bf), bqkv=u((s * c,), -0.1, 0.1),
        bias=u((heads, n, n)), wp=(u((c, c)) * c ** -0.5).to(bf), bp=u((c,), -0.1, 0.1),
        gamma1=u((c,), 0.5, 1.5), ln2_weight=u((c,), 0.5, 1.5), ln2_bias=u((c,), -0.1, 0.1),
        w1=(u((3 * c, c)) * c ** -0.5).to(bf), b1=u((3 * c,), -0.1, 0.1),
        w2=(u((c, 3 * c)) * (3 * c) ** -0.5).to(bf), b2=u((c,), -0.1, 0.1),
        gamma2=u((c,), 0.5, 1.5),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("b,nwin,n,c,heads", [
    (2, 64, 49, 64, 2), (3, 16, 49, 128, 4), (2, 1, 196, 256, 8), (5, 1, 49, 512, 16),
    (1, 4, 9, 32, 1),
])
@pytest.mark.parametrize("global_query", [False, True])
def test_gcvit_kernels_match_plain_on_card(cuda_device, b, nwin, n, c, heads, global_query):
    """Each GCViT kernel against its f32 plain version on the same bf16 inputs
    at the GCViTTiny level shapes (and a 3 x 3 window): max|d| / max|ref|
    <= 1e-2 (bf16 rounding of the LN output, q, P and the hidden)."""
    p = _gcvit_inputs(cuda_device, b, nwin, n, c, heads, global_query)
    m, f = b * nwin * n, lambda t: t.float()
    x2 = p["x"].view(m, c)
    parts = G.ln_qkv(x2, p["ln1_weight"], p["ln1_bias"], p["wqkv"], p["bqkv"], 1e-5)
    refs = G.ln_qkv_plain(x2, p["ln1_weight"], p["ln1_bias"], f(p["wqkv"]), p["bqkv"], 1e-5)
    for got, ref in zip(parts, refs):
        assert _rel(got, ref) <= 1e-2
    q = p["qg"] if global_query else parts[0].view(b, -1, c)
    k, v = (t.view(b, -1, c) for t in parts[-2:])
    scale = 32 ** -0.5
    attn = G.window_attention(q, k, v, p["bias"], n, scale, q_is_global=global_query)
    ref = G.window_attention_plain(f(q), f(k), f(v), p["bias"], n, scale, global_query)
    assert _rel(attn, ref) <= 1e-2
    r1 = G.proj_scale_residual(attn.view(m, c), p["wp"], p["bp"], p["gamma1"], x2)
    ref = G.proj_scale_residual_plain(f(attn.view(m, c)), f(p["wp"]), p["bp"], p["gamma1"], f(x2))
    assert r1.dtype == torch.float32 and _rel(r1, ref) <= 1e-2
    h = K.ln_fc1_gelu(r1, p["ln2_weight"], p["ln2_bias"], p["w1"], p["b1"], 1e-5)
    ref = K.ln_fc1_gelu_plain(r1, p["ln2_weight"], p["ln2_bias"], f(p["w1"]), p["b1"], 1e-5)
    assert _rel(h, ref) <= 1e-2
    out = K.fc2_scale_residual(h, p["w2"], p["b2"], p["gamma2"], r1)
    ref = K.fc2_scale_residual_plain(f(h), f(p["w2"]), p["b2"], p["gamma2"], r1)
    assert out.dtype == torch.bfloat16 and _rel(out, ref) <= 1e-2
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_gcvit_block_counts_its_launches(cuda_device):
    G.reset_launches()
    K.reset_launches()
    p = _gcvit_inputs(cuda_device, 1, 4, 49, 64, 2, True)
    x, qg = p.pop("x"), p.pop("qg")
    out = G.window_transformer_block(x, qg, n=49, **p)
    torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert G.LAUNCHES == {"ln_qkv": 1, "window_attention": 1, "proj_scale_residual": 1}
    assert K.LAUNCHES == {"dwconv7x7_nhwc": 0, "ln_fc1_gelu": 1, "fc2_scale_residual": 1}


@pytest.mark.cuda
def test_gcvit_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    dev = cuda_device
    t = torch.zeros((1, 49, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="heads"):  # head width 16, not 32
        G.window_attention(t, t, t, torch.zeros((4, 49, 49), device=dev), 49, 0.25)
    with pytest.raises(TypeError, match="bfloat16"):
        G.window_attention(t.float(), t, t, torch.zeros((2, 49, 49), device=dev), 49, 0.2)
    with pytest.raises(ValueError, match="2C or 3C"):
        G.ln_qkv(t.view(49, 64), torch.ones(64, device=dev), torch.zeros(64, device=dev),
                 torch.zeros((64, 64), dtype=torch.bfloat16, device=dev),
                 torch.zeros(64, device=dev), 1e-5)


# ---------------------------------------------------------------------------
# LayerNorm (K10), window attention on (B, H, N, D) (K8), depthwise conv (K9)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 96, 128, 192, 256, 384, 512, 768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_matches_plain_on_card(cuda_device, c, dtype):
    """A ragged row count (1001 rows: no tile divides it) at every LN width
    of both members; the plain version in f32 on the same inputs. bf16:
    max|d| / max|ref| <= 1e-2 (the output's rounding); f32 <= 1e-5."""
    from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L

    g = torch.Generator(device=cuda_device).manual_seed(c)
    x = (torch.rand((1001, c), generator=g, device=cuda_device) * 4 - 2).to(dtype)
    w = torch.rand((c,), generator=g, device=cuda_device) + 0.5
    b = torch.rand((c,), generator=g, device=cuda_device) * 0.2 - 0.1
    L.reset_launches()
    got = L.layer_norm(x, w, b, 1e-6)
    torch.cuda.synchronize()
    assert got.dtype == dtype and L.LAUNCHES == {"layer_norm": 1}
    assert _rel(got, L.layer_norm_plain(x.float(), w, b, 1e-6)) <= (
        1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
def test_layer_norm_function_backward_on_card(cuda_device):
    """Forward through the kernel, backward the plain LN's gradient."""
    from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L

    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((3, 7, 64), generator=g, device=cuda_device).requires_grad_()
    w = (torch.rand((64,), generator=g, device=cuda_device) + 0.5).requires_grad_()
    b = torch.zeros((64,), device=cuda_device, requires_grad=True)
    dy = torch.randn((3, 7, 64), generator=g, device=cuda_device)
    L.fused_layernorm(x, w, b, 1e-5).backward(dy)
    refs = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    L.layer_norm_plain(*refs, 1e-5).backward(dy)
    for got, ref in zip((x, w, b), refs):
        assert torch.allclose(got.grad, ref.grad, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,n", [(6, 2, 49), (5, 4, 49), (3, 8, 196), (4, 16, 49),
                                       (2, 1, 9)])
def test_window_attention_bhnd_matches_plain_on_card(cuda_device, b, heads, n):
    """bf16 q/k/v (B, H, N, 32) against the f32 plain version on the same
    inputs: max|d| / max|ref| <= 1e-2 (bf16 P and output)."""
    from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA

    g = torch.Generator(device=cuda_device).manual_seed(n + heads)
    q, k, v = (torch.rand((b, heads, n, 32), generator=g, device=cuda_device) * 2 - 1
               for _ in range(3))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    bias = torch.rand((heads, n, n), generator=g, device=cuda_device) * 2 - 1
    WA.reset_launches()
    got = WA.window_attention(q, k, v, bias, 32 ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert WA.LAUNCHES == {"window_attention_bhnd": 1}
    ref = WA.window_attention_plain(q.float(), k.float(), v.float(), bias, 32 ** -0.5)
    assert _rel(got, ref) <= 1e-2
    with pytest.raises(ValueError, match="head width"):
        WA.window_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                            v[..., :16].contiguous(), bias, 0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("k,padding,c", [
    (3, ((1, 1), (1, 1)), 192), (5, ((2, 1), (0, 2)), 96), (7, ((3, 2), (1, 3)), 24),
    (5, ((2, 2), (2, 2)), 1632),
])
def test_depthwise_matches_plain_on_card(cuda_device, k, padding, c):
    """Asymmetric paddings, ragged column tiles (W = 13) and the widest
    EfficientNet width: max|d| / max|ref| <= 1e-2 (the bf16 output)."""
    from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D

    g = torch.Generator(device=cuda_device).manual_seed(k)
    x = torch.rand((3, 11, 13, c), generator=g, device=cuda_device).to(torch.bfloat16)
    kern = torch.rand((k, k, 1, c), generator=g, device=cuda_device) - 0.5
    D.reset_launches()
    got = D.depthwise_conv_nhwc(x, kern, padding=padding)
    torch.cuda.synchronize()
    assert D.LAUNCHES == {"depthwise_conv_nhwc": 1}
    ref = D.depthwise_conv_nhwc_plain(x.float(), kern, padding=padding)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _rel(got, ref) <= 1e-2


@pytest.mark.cuda
def test_exp_dw_tool_runs_on_card(cuda_device):
    from vip_cup_2022_tpu_torch.tools import exp_dw

    (result,) = exp_dw.main(["--iters", "1", "--shapes", "s5_7x1632_k5"])
    assert result["max_abs_err"] <= 1e-2 * result["max_abs_ref"]
    assert result["ms"] > 0 and result["cudnn_ms"] > 0


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_to_cut_the_graph(cuda_device):
    from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D
    from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA

    q = torch.zeros((2, 1, 9, 32), dtype=torch.bfloat16, device=cuda_device)
    bias = torch.zeros((1, 9, 9), device=cuda_device)
    with pytest.raises(NotImplementedError, match="no backward"):
        WA.window_attention(q.clone().requires_grad_(), q, q, bias, 0.2)
    x = torch.zeros((1, 5, 5, 8), dtype=torch.bfloat16, device=cuda_device)
    kern = torch.zeros((3, 3, 8), device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        D.depthwise_conv_nhwc(x, kern, padding=((1, 1), (1, 1)))
    with torch.no_grad():
        WA.window_attention(q.clone().requires_grad_(), q, q, bias, 0.2)
        D.depthwise_conv_nhwc(x, kern, padding=((1, 1), (1, 1)))
    torch.cuda.synchronize()
