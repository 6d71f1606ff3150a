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


# ---------------------------------------------------------------------------
# The tool kernels: LN-MLP in three layouts (K3, K12) and attention parts (K11)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 5, 7, 32), (3, 7, 5, 96), (2, 5, 3, 384), (3, 3, 5, 768)])
@pytest.mark.parametrize("name", ["fused_ln_mlp_residual", "lnmlp_batchlane", "lnmlp_chanfirst"])
def test_ln_mlp_matches_plain_on_card(cuda_device, shape, name):
    """Ragged row tiles (35 to 105 rows; batch 3 crosses a position inside a
    tile of the batch-lane layout) against the f32 plain version on the same
    bf16 inputs: max|d| / max|ref| <= 1e-2 (bf16 LN output, hidden and out)."""
    from vip_cup_2022_tpu_torch.ops.kernels import ln_mlp as LM

    g = torch.Generator(device=cuda_device).manual_seed(shape[-1])

    def u(s, lo=-1.0, hi=1.0):
        return torch.rand(s, generator=g, device=cuda_device) * (hi - lo) + lo

    perm = LM.LAYOUTS[name]
    c, n = shape[-1], 4 * shape[-1]
    x, r = (u(shape).to(torch.bfloat16).permute(*perm).contiguous() for _ in range(2))
    prm = (u((c,), 0.5, 1.5), u((c,), -0.1, 0.1), (u((n, c)) * c ** -0.5).to(torch.bfloat16),
           u((n,), -0.1, 0.1), (u((c, n)) * n ** -0.5).to(torch.bfloat16), u((c,), -0.1, 0.1),
           u((c,), 0.5, 1.5))
    LM.reset_launches()
    got = getattr(LM, name)(x, r, *prm)
    torch.cuda.synchronize()
    assert LM.LAUNCHES[name] == 1 and sum(LM.LAUNCHES.values()) == 1
    ref = getattr(LM, name + "_plain")(x.float(), r.float(), *(t.float() for t in prm))
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert _rel(got, ref) <= 1e-2


@pytest.mark.cuda
def test_ln_mlp_rejects_what_the_kernel_does_not_take(cuda_device):
    from vip_cup_2022_tpu_torch.ops.kernels import ln_mlp as LM

    dev = cuda_device

    def args(c, n):
        return (torch.ones(c, device=dev), torch.zeros(c, device=dev),
                torch.zeros((n, c), dtype=torch.bfloat16, device=dev), torch.zeros(n, device=dev),
                torch.zeros((c, n), dtype=torch.bfloat16, device=dev), torch.zeros(c, device=dev),
                torch.ones(c, device=dev))

    x = torch.zeros((1, 2, 3, 48), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="no kernel instantiation"):
        LM.fused_ln_mlp_residual(x, x, *args(48, 192))
    x = torch.zeros((1, 2, 3, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 128"):
        LM.fused_ln_mlp_residual(x, x, *args(32, 96))
    with pytest.raises(TypeError, match="bfloat16"):
        LM.fused_ln_mlp_residual(x.float(), x, *args(32, 128))
    with pytest.raises(NotImplementedError, match="no backward"):
        LM.fused_ln_mlp_residual(x, x, *(t.requires_grad_() if t.dtype == torch.float32 else t
                                          for t in args(32, 128)))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "no_max", "no_bias", "no_exp", "gemm_only", "empty"])
@pytest.mark.parametrize("b,nwin,n,c,heads,g", [(3, 4, 49, 64, 2, 2), (2, 16, 49, 128, 4, 8),
                                                (2, 6, 9, 32, 1, 3)])
def test_attn_parts_match_plain_on_card(cuda_device, variant, b, nwin, n, c, heads, g):
    """Each variant against the f32 plain version on the same bf16 inputs:
    max|d| / max|ref| <= 1e-2 (bf16 q, P and output; for no_exp, P holds
    bf16-rounded -1e9 entries, held relative to max|ref| all the same)."""
    from vip_cup_2022_tpu_torch.ops.kernels import attn_parts as A
    from vip_cup_2022_tpu_torch.tools import exp_attn_parts as T

    gen = torch.Generator(device=cuda_device).manual_seed(b * nwin)
    q, k, v = (torch.randn((b, nwin * n, c), generator=gen, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    t = dict(q=q, k=k, v=v, mb=torch.from_numpy(A.group_bias(heads, n, g)).to(cuda_device))
    t32 = dict(t, q=q.float(), k=k.float(), v=v.float())
    A.reset_launches()
    got = T.call(variant, t, heads, n, g)()
    torch.cuda.synchronize()
    assert sum(A.LAUNCHES.values()) == 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _rel(got, T.call(variant, t32, heads, n, g, plain=True)()) <= 1e-2


@pytest.mark.cuda
def test_tools_run_on_card(cuda_device):
    """One short run of each tool: every kernel variant within its bound and
    timed, and each tool kernel launched."""
    from vip_cup_2022_tpu_torch.ops.kernels import attn_parts as A
    from vip_cup_2022_tpu_torch.ops.kernels import ln_mlp as LM
    from vip_cup_2022_tpu_torch.tools import exp_attn_parts, exp_convnext_s12

    LM.reset_launches()
    A.reset_launches()
    (res,) = exp_convnext_s12.main(["s4", "--iters", "1", "--batch", "8"])
    assert set(res["ms"]) == set(exp_convnext_s12.VARIANTS)
    assert all(e <= 1e-2 for e in res["equiv"].values())
    parts = exp_attn_parts.main(["l2", "--iters", "1", "--batch", "4"])
    assert set(parts) == set(exp_attn_parts.VARIANTS)
    assert all(LM.LAUNCHES.values()) and all(A.LAUNCHES.values())


# ---------------------------------------------------------------------------
# K13: the int8 / bf16 GEMM template (spike bodies and the PTQ site)
# ---------------------------------------------------------------------------
def _spike_inputs(dev, m, k, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) * 0.05
    w8 = torch.clamp(w * 16.0, -127, 127).to(torch.int8)
    x8 = torch.clamp(x * 16.0, -127, 127).to(torch.int8)
    return x, w, w8, x8


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(625, 384, 1536), (1352, 768, 3072), (37, 64, 96),
                                   (130, 100, 132)])
def test_int8_spike_matches_plain_on_card(cuda_device, m, k, n):
    """The three spike bodies against their plain versions on the same
    inputs: direct exactly, int8 within 1e-6 of max|ref| (the same integer
    sums, one f32 scale), bf16 within 1e-2 (f32 sums in another order,
    rounded to bf16). Ragged M, K and N against the 128 x 128 x 64 tiles."""
    from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

    x, w, w8, x8 = _spike_inputs(cuda_device, m, k, n)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    sx = x.abs().max().item() / 127.0
    got = Q.int8_spike_direct(x8, w8)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, Q.int8_spike_direct_plain(x8, w8))
    for xi in (x, xb):
        for out_dtype in (torch.float32, torch.bfloat16):
            got = Q.int8_spike_int8(xi, w8, sx, out_dtype)
            ref = Q.int8_spike_int8_plain(xi, w8, sx, out_dtype)
            assert got.dtype == out_dtype and _rel(got, ref) <= 1e-6
    for out_dtype in (torch.bfloat16, torch.float32):
        got = Q.int8_spike_bf16(xb, wb, out_dtype)
        assert got.dtype == out_dtype
        assert _rel(got, Q.int8_spike_bf16_plain(xb, wb, torch.float32)) <= 1e-2


def _site(dev, b, h, w, c, n, kernel, seed=0):
    from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=g, device=dev)
    qw = torch.randint(-127, 128, (kernel * kernel * c, n), generator=g, device=dev)
    colscale = torch.rand((n,), generator=g, device=dev) * 1e-3
    bias = torch.randn((n,), generator=g, device=dev)
    inv = Q.f32_reciprocal(x.abs().max().item() / 127.0)
    return x, Q.pack_weight(qw.to(torch.int8)), colscale, bias, inv


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 256])
@pytest.mark.parametrize("h,c,n,kernel,stride,padding", [
    (50, 64, 64, 3, 1, 1),     # c2 conv_2
    (50, 128, 128, 3, 2, 1),   # c3 block 0 conv_2: 3 x 3 at stride 2
    (13, 512, 512, 3, 2, 1),   # c5 block 0 conv_2, odd input
    (25, 512, 128, 1, 1, 0),   # c3 conv_1: rows
    (7, 1024, 2048, 1, 1, 0),  # c5 projection: rows, ragged M at batch 8
])
def test_ptq_int8_conv_matches_plain_on_card(cuda_device, b, h, c, n, kernel, stride, padding):
    """ptq_int8_conv against its plain version at ResNetRS50's site shapes,
    f32 and bf16 x and outputs, with and without bias: within 1e-6 of
    max|ref| (the same integer sums and the same f32 epilogue)."""
    from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

    x, qw, cs, bias, inv = _site(cuda_device, b, h, h, c, n, kernel)
    kw = dict(kernel=kernel, stride=stride, padding=padding)
    for xi in (x, x.to(torch.bfloat16)):
        for out_dtype, bi in ((None, None), (torch.float32, bias), (torch.bfloat16, bias)):
            got = Q.ptq_int8_conv(xi, qw, cs, bi, inv, out_dtype=out_dtype, **kw)
            ref = Q.ptq_int8_conv_plain(xi, qw, cs, bi, inv, out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            assert got.shape == ref.shape and got.dtype == ref.dtype
            assert _rel(got, ref) <= 1e-6


@pytest.mark.cuda
def test_ptq_int8_conv_dense_rows_on_card(cuda_device):
    """A Dense site: x (B, T, K) rows, bias, f32 out."""
    from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

    x, qw, cs, bias, inv = _site(cuda_device, 3, 7, 5, 96, 40, 1)
    x = x.view(3, 35, 96)
    got = Q.ptq_int8_conv(x, qw, cs, bias, inv, kernel=None)
    ref = Q.ptq_int8_conv_plain(x, qw, cs, bias, inv, kernel=None)
    torch.cuda.synchronize()
    assert got.shape == (3, 35, 40) and _rel(got, ref) <= 1e-6


@pytest.mark.cuda
def test_int8_wrappers_count_and_reject(cuda_device):
    from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

    Q.reset_launches()
    x, w, w8, x8 = _spike_inputs(cuda_device, 16, 32, 64)
    Q.int8_spike_bf16(x.to(torch.bfloat16), w.to(torch.bfloat16))
    Q.int8_spike_int8(x, w8, 0.01)
    Q.int8_spike_direct(x8, w8)
    xs, qw, cs, _, inv = _site(cuda_device, 2, 5, 5, 32, 64, 3)
    Q.ptq_int8_conv(xs, qw, cs, None, inv, kernel=3, stride=2, padding=1)
    torch.cuda.synchronize()
    assert Q.LAUNCHES == {"int8_spike_bf16": 1, "int8_spike_int8": 1, "int8_spike_direct": 1,
                          "ptq_int8_conv": 1}
    with pytest.raises(TypeError, match="int8"):
        Q.int8_spike_direct(x, w8)
    with pytest.raises(ValueError, match="multiples of 4"):
        Q.int8_spike_direct(x8[:, :30].contiguous(), w8[:30])
    with pytest.raises(ValueError, match="multiple of 4"):
        Q.ptq_int8_conv(xs[..., :30].contiguous(), qw, cs, None, inv, kernel=3, stride=2,
                        padding=1)
    with pytest.raises(ValueError, match="not packed"):
        Q.ptq_int8_conv(xs, qw[:, :32].contiguous(), cs, None, inv, kernel=3)
