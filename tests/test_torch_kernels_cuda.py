"""The port's CUDA kernels on the card against their plain PyTorch versions.

Marked ``cuda``: they build the kernels with nvcc and launch them, so they skip
where there is no CUDA device. The file itself needs only torch and the port
(not flax, not the JAX package), so it runs on a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
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
@pytest.mark.parametrize("c", [64, 96, 128, 192, 256, 384, 512, 768])
@pytest.mark.parametrize("ratio", [3, 4])
@pytest.mark.parametrize("rows", ["one", "tile-1", "tile+1", "ragged"])
@pytest.mark.parametrize("res_dtype", [torch.bfloat16, torch.float32], ids=["bf16res", "f32res"])
def test_mlp_kernels_match_plain_on_card(cuda_device, c, ratio, rows, res_dtype):
    """``ln_fc1_gelu`` and ``fc2_scale_residual`` at every block width of
    both members with N = 3C (GCViT) and 4C (ConvNeXt), against the f32
    plain versions on the same bf16-rounded inputs: max|d| / max|ref| <=
    1e-2 (bf16 LN output and hidden). Row counts at the edges of the plan's
    row tile (1, one short of and one past a tile) and one that gives the
    persistent CTAs more than a round of tiles with a ragged last one; both
    residual types."""
    g = torch.Generator(device=cuda_device).manual_seed(c * ratio)

    def u(s, lo=-1.0, hi=1.0):
        return torch.rand(s, generator=g, device=cuda_device) * (hi - lo) + lo

    n = ratio * c
    bm = K.mlp_gemm_plan("ln", c, n)["bm"]
    m = {"one": 1, "tile-1": bm - 1, "tile+1": bm + 1, "ragged": 2 * 132 * 128 + 77}[rows]
    x, lg, lb = u((m, c)), u((c,), 0.5, 1.5), u((c,), -0.1, 0.1)
    w1, b1 = (u((n, c)) * c ** -0.5).to(torch.bfloat16), u((n,), -0.1, 0.1)
    w2, b2, gamma = (u((c, n)) * n ** -0.5).to(torch.bfloat16), u((c,), -0.1, 0.1), u((c,), 0.5, 1.5)
    res = u((m, c)).to(res_dtype)
    K.reset_launches()
    hid = K.ln_fc1_gelu(x, lg, lb, w1, b1, 1e-6)
    out = K.fc2_scale_residual(hid, w2, b2, gamma, res)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"dwconv7x7_nhwc": 0, "ln_fc1_gelu": 1, "fc2_scale_residual": 1}
    assert hid.shape == (m, n) and out.shape == (m, c) and out.dtype == torch.bfloat16
    assert _rel(hid, K.ln_fc1_gelu_plain(x, lg, lb, w1.float(), b1, 1e-6)) <= 1e-2
    ref = K.fc2_scale_residual_plain(hid.float(), w2.float(), b2, gamma, res.float())
    assert _rel(out, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 96, 192, 384, 768])
@pytest.mark.parametrize("grid", ["tiny", "ragged", "one", "rounds"])
def test_dwconv_matches_plain_on_card(cuda_device, c, grid):
    """The tiled depthwise kernel against its f32 plain version on the same
    bf16 input, within 1e-5 of max|ref| (f32 sums of 49 products in another
    order): H and W below 7 (the halo is mostly padding), ragged tiles (13 x
    11 against 16 x 16 tiles), batch 1, and a batch whose tiles outnumber
    one round of the persistent CTAs."""
    b, h, w = {"tiny": (2, 5, 6), "ragged": (3, 13, 11), "one": (1, 24, 24),
               "rounds": (24 * 96 // c + 40, 24, 24)}[grid]
    g = torch.Generator(device=cuda_device).manual_seed(c + h)

    def u(s, lo, hi):
        return torch.rand(s, generator=g, device=cuda_device) * (hi - lo) + lo

    x = u((b, h, w, c), -1, 1).to(torch.bfloat16)
    dw, dwb = u((7, 7, c), -0.2, 0.2), u((c,), -0.1, 0.1)
    K.reset_launches()
    got = K.dwconv7x7_nhwc(x, dw, dwb)
    torch.cuda.synchronize()
    assert K.LAUNCHES["dwconv7x7_nhwc"] == 1
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, K.dwconv7x7_nhwc_plain(x.float(), dw, dwb)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("rows", ["one", "tile-1", "tile+1", "ragged"])
def test_ln_qkv_matches_plain_on_card(cuda_device, c, s, rows):
    """``ln_qkv`` on the wgmma + TMA engine at every GCViT width, local (q,
    k, v) and global (k, v), against the f32 plain version on the same bf16
    inputs: max|d| / max|ref| <= 1e-2 (the bf16 LN output and outputs). Row
    counts at the edges of the plan's row tile and one that gives the
    persistent CTAs more than a round of tiles with a ragged last one."""
    g = torch.Generator(device=cuda_device).manual_seed(c * s)

    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=cuda_device) * (hi - lo) + lo

    bm = K.mlp_gemm_plan("qkv", c, s * c)["bm"]
    m = {"one": 1, "tile-1": bm - 1, "tile+1": bm + 1, "ragged": 2 * 132 * 128 + 77}[rows]
    x, lg, lb = u((m, c)).to(torch.bfloat16), u((c,), 0.5, 1.5), u((c,), -0.1, 0.1)
    w, b = (u((s * c, c)) * c ** -0.5).to(torch.bfloat16), u((s * c,), -0.1, 0.1)
    G.reset_launches()
    got = G.ln_qkv(x, lg, lb, w, b, 1e-5)
    torch.cuda.synchronize()
    assert G.LAUNCHES["ln_qkv"] == 1 and len(got) == s
    for o, ref in zip(got, G.ln_qkv_plain(x, lg, lb, w.float(), b, 1e-5)):
        assert o.shape == (m, c) and o.dtype == torch.bfloat16
        assert _rel(o, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("rows", ["one", "tile-1", "tile+1", "ragged"])
def test_proj_scale_residual_matches_plain_on_card(cuda_device, c, rows):
    """``proj_scale_residual`` on the wgmma + TMA engine (K = C, f32 output,
    W_p held in shared memory at C <= 256) at every GCViT width, against the
    f32 plain version on the same bf16 inputs: max|d| / max|ref| <= 1e-2.
    Row counts at the edges of the 128-row tile and one that gives the
    persistent CTAs more than a round of tiles with a ragged last one."""
    g = torch.Generator(device=cuda_device).manual_seed(c + 7)

    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=cuda_device) * (hi - lo) + lo

    bm = K.mlp_gemm_plan("proj", c, c)["bm"]
    m = {"one": 1, "tile-1": bm - 1, "tile+1": bm + 1, "ragged": 2 * 132 * 128 + 77}[rows]
    a, x = u((m, c)).to(torch.bfloat16), u((m, c)).to(torch.bfloat16)
    wp, bp = (u((c, c)) * c ** -0.5).to(torch.bfloat16), u((c,), -0.1, 0.1)
    gamma = u((c,), 0.5, 1.5)
    G.reset_launches()
    got = G.proj_scale_residual(a, wp, bp, gamma, x)
    torch.cuda.synchronize()
    assert G.LAUNCHES["proj_scale_residual"] == 1
    assert got.shape == (m, c) and got.dtype == torch.float32
    ref = G.proj_scale_residual_plain(a.float(), wp.float(), bp, gamma, x.float())
    assert _rel(got, ref) <= 1e-2


@pytest.mark.cuda
def test_exp_dwconv_tool_runs_on_card(cuda_device):
    """The depthwise phase-cut tool at s1 and s4: every cut and cuDNN timed,
    the whole kernel within 1e-5 of its plain version."""
    from vip_cup_2022_tpu_torch.tools import exp_dwconv

    for r in exp_dwconv.main(["--iters", "1", "--batch", "2", "--shapes", "s1", "s4"]):
        assert r["rel_err"] <= 1e-5
        assert set(r["ms"]) == set(exp_dwconv.CUTS) | {"cudnn"}
        assert all(t > 0 for t in r["ms"].values())


@pytest.mark.cuda
def test_mlp_gemm_cuts_run_on_card(cuda_device):
    """The phase-cut tool at s1 and L4 (a resident and a streamed plan):
    every cut launches and is timed (at L4 also ``ln_qkv``'s), and the whole
    kernels agree with their plain versions."""
    from vip_cup_2022_tpu_torch.tools import exp_mlp_gemm

    for r in exp_mlp_gemm.main(["--iters", "1", "--batch", "2", "--shapes", "s1", "L4"]):
        assert all(e <= 1e-2 for e in r["rel_err"])
        assert set(r["ln_fc1_gelu"]) == set(exp_mlp_gemm.LN_CUTS) | {"cublas"}
        assert set(r["fc2_scale_residual"]) == set(exp_mlp_gemm.FC2_CUTS) | {"cublas"}
        assert all(t > 0 for t in r["ln_fc1_gelu"].values())
        if r["name"] == "L4":  # ln_qkv's and proj's cuts on the same engine
            assert set(r["ln_qkv"]) == set(exp_mlp_gemm.QKV_CUTS) | {"cublas"}
            assert set(r["proj_scale_residual"]) == set(exp_mlp_gemm.PROJ_CUTS) | {"cublas"}


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
@pytest.mark.parametrize("b,nwin,n,heads", [
    (1, 1, 1, 2), (2, 3, 16, 3), (1, 7, 49, 3), (2, 2, 64, 2), (3, 2, 100, 4), (1, 1, 196, 8),
    (1, 1, 224, 2), (2, 2, 224, 1),
    (13, 64, 49, 2),  # 1664 (window, head) items: more than one round of persistent CTAs
    (37, 1, 196, 8),  # 296 items at N = 196, not a multiple of the grid
])
@pytest.mark.parametrize("global_query", [False, True])
def test_gcvit_window_attention_shapes_on_card(cuda_device, b, nwin, n, heads, global_query):
    """K5 at the key-tile edges (N = 1 ... 224 over the 64 / 208 / 224
    tiles), batch 1, one and several windows with a global query, and item
    counts that leave the last round of the persistent CTAs ragged, against
    the f32 plain version on the same bf16 inputs: max|d| / max|ref| <= 1e-2
    (bf16 q, P and output)."""
    g = torch.Generator(device=cuda_device).manual_seed(n * 7 + heads)
    c = heads * 32

    def u(s):
        return torch.rand(s, generator=g, device=cuda_device) * 2 - 1

    k, v = (u((b, nwin * n, c)).to(torch.bfloat16) for _ in range(2))
    q = u((b, n, c) if global_query else (b, nwin * n, c)).to(torch.bfloat16)
    bias = u((heads, n, n))
    G.reset_launches()
    got = G.window_attention(q, k, v, bias, n, 32 ** -0.5, q_is_global=global_query)
    torch.cuda.synchronize()
    assert got.shape == k.shape and got.dtype == torch.bfloat16
    assert G.LAUNCHES["window_attention"] == 1
    ref = G.window_attention_plain(q.float(), k.float(), v.float(), bias, n, 32 ** -0.5,
                                   global_query)
    assert _rel(got, ref) <= 1e-2


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
@pytest.mark.parametrize("b,heads,n", [
    (6, 2, 49), (5, 4, 49), (3, 8, 196), (4, 16, 49), (2, 1, 9),
    (1, 1, 1), (3, 2, 16), (7, 3, 64), (5, 2, 100), (1, 3, 113), (1, 8, 196), (1, 2, 224),
    (3, 5, 224),
    (829, 2, 49),  # 1658 (window, head) items: more than one round of persistent CTAs
    (37, 8, 196),  # 296 items at N = 196, not a multiple of the grid
])
def test_window_attention_bhnd_matches_plain_on_card(cuda_device, b, heads, n):
    """bf16 q/k/v (B, H, N, 32) against the f32 plain version on the same
    inputs: max|d| / max|ref| <= 1e-2 (bf16 P and output). N = 1 ... 224
    covers the 64 / 208 / 224 key tiles and their ragged edges; batch
    1; item counts that leave the persistent CTAs' last round ragged."""
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
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("c,padding", [
    (336, ((2, 2), (2, 2))), (24, ((2, 0), (1, 3))), (8, ((0, 2), (3, 1))),
    (12, ((1, 1), (1, 1))), (6, ((3, 0), (0, 0))),
])
def test_depthwise_tail_slices_on_card(cuda_device, k, c, padding):
    """C not a multiple of the template's 32-channel slice: a tail slice
    (C = 336: 10 slices and 16 channels; 24, 12, 8, 6: the tail alone), its
    halo copied 16 (C % 8 = 0), 8 (C = 12) or 4 bytes (C = 6) at a time,
    with asymmetric paddings up to the kernel's size: max|d| / max|ref| <=
    1e-2 (the bf16 output)."""
    from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D

    g = torch.Generator(device=cuda_device).manual_seed(c + k)
    x = torch.rand((2, 9, 13, c), generator=g, device=cuda_device).to(torch.bfloat16)
    kern = torch.rand((k, k, c), generator=g, device=cuda_device) - 0.5
    D.reset_launches()
    got = D.depthwise_conv_nhwc(x, kern, padding=padding)
    torch.cuda.synchronize()
    assert D.LAUNCHES == {"depthwise_conv_nhwc": 1}
    ref = D.depthwise_conv_nhwc_plain(x.float(), kern, padding=padding)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _rel(got, ref) <= 1e-2
    plan = D.depthwise_plan(ref.shape[1], ref.shape[2], c)
    assert plan["slices"] == -(-c // 32)
    assert plan["copy_bytes"] == (16 if c % 8 == 0 else 8 if c % 4 == 0 else 4)


@pytest.mark.cuda
def test_depthwise_conv_module_launches_k9_at_stride_1_only(cuda_device):
    """EfficientNet's depthwise module: at stride 1 it launches K9, at
    stride 2 it runs cuDNN and launches nothing; K9 at a V1B4 shape (56 x 56
    x 192, k = 5) with the (1, 2) padding TF ``SAME`` gives a stride-2 k = 5
    conv at 56 (55 x 55 out at stride 1), within 1e-2 of max|ref| of its
    plain version; a width K9 does not take raises instead of falling
    back."""
    from vip_cup_2022_tpu_torch.ops.conv import DepthwiseConv
    from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D

    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.rand((4, 56, 56, 192), generator=g, device=cuda_device).to(torch.bfloat16)
    for stride, launches in ((1, 1), (2, 0)):
        conv = DepthwiseConv(192, 5, "same", torch.bfloat16, stride).to(cuda_device)
        with torch.no_grad():
            conv.weight.copy_(torch.rand((5, 5, 192), generator=g, device=cuda_device) - 0.5)
        D.reset_launches()
        with torch.inference_mode():
            out = conv(x)
        torch.cuda.synchronize()
        assert D.LAUNCHES == {"depthwise_conv_nhwc": launches}
        assert out.shape == (4, 56 // stride, 56 // stride, 192)
    pad = ((1, 2), (1, 2))
    kern = torch.rand((5, 5, 192), generator=g, device=cuda_device).to(torch.bfloat16) - 0.5
    got = D.depthwise_conv_nhwc(x, kern, padding=pad)
    torch.cuda.synchronize()
    ref = D.depthwise_conv_nhwc_plain(x.float(), kern, padding=pad)
    assert got.shape == ref.shape == (4, 55, 55, 192)
    assert _rel(got, ref) <= 1e-2
    odd = DepthwiseConv(7, 3, 1, torch.bfloat16).to(cuda_device)
    with torch.inference_mode(), pytest.raises(ValueError, match="not even"):
        odd(x[..., :7].contiguous())


@pytest.mark.cuda
def test_exp_dw_tool_runs_on_card(cuda_device):
    from vip_cup_2022_tpu_torch.tools import exp_dw

    (result,) = exp_dw.main(["--iters", "1", "--shapes", "s5_7x1632_k5"])
    assert result["max_abs_err"] <= 1e-2 * result["max_abs_ref"]
    assert result["ms"] > 0 and result["cudnn_ms"] > 0


@pytest.mark.cuda
def test_exp_window_attention_tool_runs_on_card(cuda_device):
    """The phase-cut tool at every level: the whole kernel within 1e-2 of
    its plain version, each cut and SDPA timed."""
    from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA
    from vip_cup_2022_tpu_torch.tools import exp_window_attention

    results = exp_window_attention.main(["--iters", "1", "--batch", "2"])
    assert len(results) == len(exp_window_attention.LEVELS)
    for r in results:
        assert r["rel_err"] <= 1e-2
        assert set(r["ms"]) == {"loads", "scores", "softmax", "whole", "sdpa"}
        assert all(t > 0 for t in r["ms"].values())
    q = torch.zeros((2, 1, 9, 32), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(RuntimeError, match="cut 4"):
        WA.window_attention_cut(q, q, q, torch.zeros((1, 9, 9), device=cuda_device), 0.2, 4)


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
@pytest.mark.parametrize("shape", [(2, 99, 99, 96), (2, 13, 13, 768), (1, 7, 9, 192),
                                   (2, 5, 7, 512)], ids=["s1", "s4", "c192", "c512"])
@pytest.mark.parametrize("name", ["fused_ln_mlp_residual", "lnmlp_batchlane", "lnmlp_chanfirst"])
def test_ln_mlp_stage_rows_on_card(cuda_device, shape, name):
    """The exp_convnext_s12 widths at s1's rows (19602: two row groups of
    64, the last item's second group past M) and s4's (338: C split in two
    halves that each compute fc1), and two more widths, each layout against
    the f32 plain version on the same bf16 inputs: max|d| / max|ref| <= 1e-2."""
    from vip_cup_2022_tpu_torch.ops.kernels import ln_mlp as LM

    g = torch.Generator(device=cuda_device).manual_seed(shape[-1] + 1)

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
    assert LM.LAUNCHES[name] == 1
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
@pytest.mark.parametrize("b,nwin,n,c,heads,g", [
    (3, 4, 49, 64, 2, 2),     # gN 98: one stripe of seven tiles
    (2, 16, 49, 128, 4, 8),   # gN 392: five full stripes
    (2, 6, 9, 32, 1, 3),      # gN 27
    (2, 4, 49, 64, 2, 1),     # g = 1, gN 49
    (2, 6, 49, 64, 2, 6),     # gN 294: three stripes of 7 tiles, the last partial
    (1, 16, 49, 128, 4, 8),   # batch 1 at the tool's l2 shape
    (1, 16, 49, 32, 1, 16),   # gN 784: one K and V stage beside the bias
])
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
@pytest.mark.parametrize("mask", range(16))
@pytest.mark.parametrize("g", [2, 8], ids=["gN98", "gN392"])
def test_attn_parts_every_mask_on_card(cuda_device, mask, g):
    """Every subset of the four parts (the kernel's 16 instantiations) at a
    small batch, in one stripe with one warp a tile (gN 98) and in five
    stripes with two (gN 392), against the f32 plain version within 1e-2 of
    max|ref|."""
    from vip_cup_2022_tpu_torch.ops.kernels import attn_parts as A

    b, nwin, n, c, heads = 2, 8, 49, 64, 2
    gen = torch.Generator(device=cuda_device).manual_seed(mask)
    q, k, v = (torch.randn((b, nwin * n, c), generator=gen, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    mb = torch.from_numpy(A.group_bias(heads, n, g)).to(cuda_device)
    parts = {name for i, name in enumerate(A.PARTS) if mask >> i & 1}
    got = A.attn_parts(q, k, v, mb, heads=heads, n=n, g=g, parts=parts)
    torch.cuda.synchronize()
    ref = A.attn_parts_plain(q.float(), k.float(), v.float(), mb, heads=heads, n=n, g=g,
                             parts=parts)
    assert _rel(got, ref) <= 1e-2


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


@pytest.mark.cuda
def test_exp_lnmlp_dw_tool_runs_on_card(cuda_device):
    """The device-time tool at batch 2: the three LN-MLP layouts, the phase
    cuts and both yardsticks at s1-s4, and the depthwise kernel beside cuDNN
    at the exp_dw shapes, all timed."""
    from vip_cup_2022_tpu_torch.tools import exp_lnmlp_dw

    res = exp_lnmlp_dw.main(["--iters", "1", "--batch", "2", "--cuts", "--yardsticks"])
    assert set(res["lnmlp"]) == {"s1", "s2", "s3", "s4"} and len(res["dw"]) == 6
    for row in res["lnmlp"].values():
        assert {"fused_ln_mlp_residual", "pair", "cublas", "cut_loads", "cut_gelu"} <= set(row)
        assert all(t["device"] > 0 and t["events"] > 0 for t in row.values())
    assert all(set(row) == {"kernel", "cudnn"} for row in res["dw"].values())


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
@pytest.mark.parametrize("m,k,n", [(625, 384, 1536), (1352, 768, 3072), (4096, 768, 3072),
                                   (37, 64, 96), (130, 100, 132), (100, 200, 100),
                                   (129, 776, 260), (130, 104, 136)])
@pytest.mark.parametrize("packed", [False, True], ids=["w", "w_packed"])
def test_int8_spike_matches_plain_on_card(cuda_device, m, k, n, packed):
    """The three spike bodies against their plain versions on the same
    inputs: direct and int8 exactly (the same integer sums, one f32 scale,
    one rounding), bf16 within 1e-2 (f32 sums in another order, rounded to
    bf16). The spike's three shapes, and ragged M (< 128, one past a tile),
    K (not a multiple of 128, 16 or 8) and N (not a multiple of 8) against
    the GEMM's tiles; f32 and bf16 x (bf16 x with a bf16 output quantized in
    the GEMM where N spans two column tiles); w packed by the wrapper or
    beforehand (``w_packed``)."""
    from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

    x, w, w8, x8 = _spike_inputs(cuda_device, m, k, n)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    p8 = dict(w_packed=Q.pack_weight(w8)) if packed else {}
    p16 = dict(w_packed=Q.pack_weight(wb)) if packed else {}
    sx = x.abs().max().item() / 127.0
    got = Q.int8_spike_direct(x8, w8, **p8)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, Q.int8_spike_direct_plain(x8, w8))
    for xi in (x, xb):
        for out_dtype in (torch.float32, torch.bfloat16):
            got = Q.int8_spike_int8(xi, w8, sx, out_dtype, **p8)
            ref = Q.int8_spike_int8_plain(xi, w8, sx, out_dtype)
            assert got.dtype == out_dtype and torch.equal(got, ref)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = Q.int8_spike_bf16(xb, wb, out_dtype, **p16)
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
    # int8_spike_int8 on f32 x: the quantize pass (counted as ptq_int8_quantize), then its GEMM
    assert Q.LAUNCHES == {"int8_spike_bf16": 1, "int8_spike_int8": 1, "int8_spike_direct": 1,
                          "ptq_int8_quantize": 2, "ptq_int8_conv": 1}
    with pytest.raises(TypeError, match="int8"):
        Q.int8_spike_direct(x, w8)
    with pytest.raises(ValueError, match="multiples of 4"):
        Q.int8_spike_direct(x8[:, :30].contiguous(), w8[:30])
    with pytest.raises(ValueError, match="w_packed"):
        Q.int8_spike_direct(x8, w8, w_packed=Q.pack_weight(w8)[:32].contiguous())
    with pytest.raises(ValueError, match="multiple of 4"):
        Q.ptq_int8_conv(xs[..., :30].contiguous(), qw, cs, None, inv, kernel=3, stride=2,
                        padding=1)
    with pytest.raises(ValueError, match="not packed"):
        Q.ptq_int8_conv(xs, qw[:, :32].contiguous(), cs, None, inv, kernel=3)


# ResNetRS50's 22 int8 site shapes at 200 px: (H = W, C, N, kernel, stride)
RESNETRS50_SITES = [
    (50, 64, 256, 1, 1), (50, 64, 64, 1, 1), (50, 64, 64, 3, 1), (50, 256, 64, 1, 1),
    (25, 256, 512, 1, 1), (50, 256, 128, 1, 1), (50, 128, 128, 3, 2), (25, 128, 512, 1, 1),
    (25, 512, 128, 1, 1), (25, 128, 128, 3, 1), (13, 512, 1024, 1, 1), (25, 512, 256, 1, 1),
    (25, 256, 256, 3, 2), (13, 256, 1024, 1, 1), (13, 1024, 256, 1, 1), (13, 256, 256, 3, 1),
    (7, 1024, 2048, 1, 1), (13, 1024, 512, 1, 1), (13, 512, 512, 3, 2), (7, 512, 2048, 1, 1),
    (7, 2048, 512, 1, 1), (7, 512, 512, 3, 1),
]


def _ptq_check(dev, b, h, w, c, n, kernel, stride, x_dtype, out_dtype, with_bias, seed=0):
    from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

    x, qw, cs, bias, inv = _site(dev, b, h, w, c, n, kernel, seed)
    kw = dict(kernel=kernel, stride=stride, padding=kernel // 2)
    xi, bi = x.to(x_dtype), bias if with_bias else None
    Q.reset_launches()
    got = Q.ptq_int8_conv(xi, qw, cs, bi, inv, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    in_gemm = Q.quantizes_in_gemm(x_dtype, out_dtype, k=kernel * kernel * c, n=n, **kw)
    assert Q.LAUNCHES["ptq_int8_quantize"] == (0 if in_gemm else 1)
    assert Q.LAUNCHES["ptq_int8_conv"] == 1
    ref = Q.ptq_int8_conv_plain(xi, qw, cs, bi, inv, out_dtype=out_dtype, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert _rel(got, ref) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("h,c,n,kernel,stride", RESNETRS50_SITES)
def test_ptq_int8_conv_every_resnetrs50_site_on_card(cuda_device, h, c, n, kernel, stride):
    """The wgmma + TMA int8 site at each of ResNetRS50's 22 site shapes at
    batch 8, bf16 x and output as on the path, against the plain version
    within 1e-6 of max|ref| (the same integer sums, the same f32 epilogue)."""
    _ptq_check(cuda_device, 8, h, h, c, n, kernel, stride, torch.bfloat16, torch.bfloat16, False)


# ResNest50's 22 int8 site shapes at 200 px (68 sites), every one at stride 1:
# (H = W, C, N, kernel); the 3 x 3 ones are the split attention's channel
# halves (C = 32: K = 288)
RESNEST50_SITES = [
    (50, 64, 256, 1), (50, 64, 64, 1), (50, 32, 64, 3), (50, 256, 64, 1), (25, 256, 512, 1),
    (50, 256, 128, 1), (50, 64, 128, 3), (25, 128, 512, 1), (25, 512, 128, 1), (25, 64, 128, 3),
    (13, 512, 1024, 1), (25, 512, 256, 1), (25, 128, 256, 3), (13, 256, 1024, 1),
    (13, 1024, 256, 1), (13, 128, 256, 3), (7, 1024, 2048, 1), (13, 1024, 512, 1),
    (13, 256, 512, 3), (7, 512, 2048, 1), (7, 2048, 512, 1), (7, 256, 512, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,c,n,kernel", RESNEST50_SITES)
def test_ptq_int8_conv_every_resnest50_site_on_card(cuda_device, h, c, n, kernel):
    """The int8 site at each of ResNest50's 22 site shapes at batch 8, bf16
    x and output as on the path, within 1e-6 of max|ref| of the plain
    version."""
    _ptq_check(cuda_device, 8, h, h, c, n, kernel, 1, torch.bfloat16, torch.bfloat16, False)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,n,kernel,stride", [
    (2, 9, 7, 64, 64, 1, 1),      # N = 64, K = 64: one resident 64-wide tile, ragged M
    (3, 11, 13, 64, 64, 3, 1),    # gathered N = 64, ragged last M tile
    (1, 13, 13, 96, 128, 3, 2),   # stride 2 on an odd input
    (2, 15, 9, 32, 96, 3, 2),     # stride 2, N not a multiple of the tile
    (5, 5, 5, 36, 40, 3, 1),      # C not a multiple of 16 (4-byte gather), N = 40
    (4, 6, 6, 40, 36, 1, 1),      # rows with K not a multiple of 16, N not of 8
    (2, 17, 17, 256, 192, 1, 1),  # rows with two column tiles, the second ragged
    (3, 11, 9, 520, 64, 1, 1),    # rows with K = 520: a last K tile of 8 columns
    (1, 21, 21, 64, 384, 1, 1),   # bf16 rows too wide to quantize in the GEMM
])
@pytest.mark.parametrize("types", ["bf16-bf16", "f32-f32", "f32-bf16"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_ptq_int8_conv_edges_on_card(cuda_device, b, h, w, c, n, kernel, stride, types,
                                     with_bias):
    """Ragged M and N, stride 2 on odd inputs, K and C that take the 4-byte
    gather, rows quantized in the GEMM (bf16 x and output) and after the
    pass, f32 and bf16 x and outputs, with and without bias: within 1e-6."""
    x_dtype, out_dtype = {"bf16-bf16": (torch.bfloat16, torch.bfloat16),
                          "f32-f32": (torch.float32, torch.float32),
                          "f32-bf16": (torch.float32, torch.bfloat16)}[types]
    _ptq_check(cuda_device, b, h, w, c, n, kernel, stride, x_dtype, out_dtype, with_bias,
               seed=h * w + c)


@pytest.mark.cuda
def test_ptq_int8_conv_rejects_kernels_past_its_tap_mask(cuda_device):
    """A gathered row's taps are a 64-bit mask: an 8 x 8 conv runs, a 9 x 9
    one is refused before any launch."""
    from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

    x, qw, cs, _, inv = _site(cuda_device, 1, 11, 11, 16, 32, 8)
    kw = dict(kernel=8, stride=1, padding=3)
    got = Q.ptq_int8_conv(x, qw, cs, None, inv, **kw)
    torch.cuda.synchronize()
    assert _rel(got, Q.ptq_int8_conv_plain(x, qw, cs, None, inv, **kw)) <= 1e-6
    x, qw, cs, _, inv = _site(cuda_device, 1, 11, 11, 16, 32, 9)
    with pytest.raises(ValueError, match="taps"):
        Q.ptq_int8_conv(x, qw, cs, None, inv, kernel=9, stride=1, padding=4)


@pytest.mark.cuda
def test_exp_ptq_int8_tool_runs_on_card(cuda_device):
    """The PTQ phase-cut tool at one 1 x 1 and one 3 x 3 site at batch 2:
    every cut timed, the whole site within 1e-6 of its plain version."""
    from vip_cup_2022_tpu_torch.tools import exp_ptq_int8

    results = exp_ptq_int8.main(["--iters", "1", "--batch", "2", "--sites", "c2_1x1", "c2_3x3"])
    assert len(results) == 2 and results[0]["in_gemm"] and not results[1]["in_gemm"]
    for r in results:
        assert r["rel_err"] <= 1e-6
        assert set(r["ms"]) == set(exp_ptq_int8.CUTS) | {"cudnn"}
        assert all(t > 0 for t in r["ms"].values())


# ---------------------------------------------------------------------------
# K8, K9 and K10 under autograd, at GCViTTiny's training shapes (batch 64)
# ---------------------------------------------------------------------------
TRAIN_BATCH = 64
# GCViTTiny@224's 11 stride-1 3 x 3 depthwise sites: the stem's ReduceSize,
# each level's FeatExtracts and downsample ReduceSize (H, W, C)
GCVIT_DW_SITES = ((112, 112, 64), (56, 56, 64), (28, 28, 64), (14, 14, 64), (56, 56, 64),
                  (28, 28, 128), (14, 14, 128), (28, 28, 128), (14, 14, 256), (14, 14, 256),
                  (7, 7, 512))


def _grads(out, dout, inputs):
    return torch.autograd.grad(out, inputs, dout)


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(4))
def test_window_attention_function_backward_on_card(cuda_device, level):
    """The kernel forward within 1e-2 of the plain version, and its
    backward (the plain version's gradient recomputed from the saved
    inputs) equal to the plain version's own autograd on the same bf16
    q, k, v and f32 bias, at each level's (B * windows, heads, N, 32)."""
    from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA
    from vip_cup_2022_tpu_torch.tools.exp_window_attention import LEVELS

    grid, _, heads, ws, *_ = LEVELS[level]
    n, nwin = ws * ws, (grid // ws) ** 2
    g = torch.Generator(device=cuda_device).manual_seed(level)
    shape = (TRAIN_BATCH * nwin, heads, n, 32)
    q, k, v = ((torch.rand(shape, generator=g, device=cuda_device) * 2 - 1).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    bias = (torch.rand((heads, n, n), generator=g, device=cuda_device) * 2 - 1).requires_grad_()
    dout = (torch.rand(shape, generator=g, device=cuda_device) * 2 - 1).to(torch.bfloat16)
    inputs = (q, k, v, bias)
    before = WA.LAUNCHES["window_attention_bhnd"]
    out = WA.window_attention_fn(q, k, v, bias, 32 ** -0.5)
    got = _grads(out, dout, inputs)
    ref_out = WA.window_attention_plain(q, k, v, bias, 32 ** -0.5)
    want = _grads(ref_out, dout, inputs)
    torch.cuda.synchronize()
    assert WA.LAUNCHES["window_attention_bhnd"] == before + 1
    assert _rel(out, ref_out.float()) <= 1e-2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _rel(a, b.float()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("site", range(len(GCVIT_DW_SITES)))
def test_depthwise_function_backward_on_card(cuda_device, site):
    """dx and the taps' gradient of the closed form, on bf16 x and bf16 taps
    (the model casts its f32 taps to the compute dtype), against the plain
    version's autograd in f32 on the same values: within 1e-2 of max|ref|
    (the closed form sums in f32 and rounds once to bf16; the plain
    version's autograd in bf16 would round each tap's share of dx to bf16
    and add them in bf16, 9 roundings); the forward within 1e-2 too."""
    from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D

    h, w, c = GCVIT_DW_SITES[site]
    g = torch.Generator(device=cuda_device).manual_seed(site)
    x = (torch.rand((TRAIN_BATCH, h, w, c), generator=g, device=cuda_device) * 2 - 1).to(
        torch.bfloat16).requires_grad_()
    kern = ((torch.rand((3, 3, c), generator=g, device=cuda_device) * 2 - 1) / 3).to(
        torch.bfloat16).requires_grad_()
    dy = (torch.rand((TRAIN_BATCH, h, w, c), generator=g, device=cuda_device) * 2 - 1).to(
        torch.bfloat16)
    pad = ((1, 1), (1, 1))
    out = D.depthwise_conv_fn(x, kern, padding=pad)
    got = _grads(out, dy, (x, kern))
    x32, kern32 = (t.detach().float().requires_grad_() for t in (x, kern))
    ref_out = D.depthwise_conv_nhwc_plain(x32, kern32, padding=pad)
    want = _grads(ref_out, dy.float(), (x32, kern32))
    torch.cuda.synchronize()
    assert _rel(out, ref_out) <= 1e-2
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert _rel(a, b) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(112, 64), (56, 64), (28, 128), (14, 256), (7, 512)])
def test_layer_norm_function_backward_on_card(cuda_device, h, c):
    """The LN function on bf16 activations at each level's width: the kernel
    forward within 1e-2 of the plain version, the backward (the plain LN's
    gradient recomputed) equal to the plain LN's own autograd."""
    from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L

    g = torch.Generator(device=cuda_device).manual_seed(c)
    x = (torch.rand((TRAIN_BATCH, h, h, c), generator=g, device=cuda_device) * 4 - 2).to(
        torch.bfloat16).requires_grad_()
    weight = (torch.rand(c, generator=g, device=cuda_device) + 0.5).requires_grad_()
    bias = (torch.rand(c, generator=g, device=cuda_device) * 0.2 - 0.1).requires_grad_()
    dy = (torch.rand(x.shape, generator=g, device=cuda_device) * 2 - 1).to(torch.bfloat16)
    out = L.fused_layernorm(x, weight, bias, 1e-5)
    got = _grads(out, dy, (x, weight, bias))
    ref_out = L.layer_norm_plain(x, weight, bias, 1e-5)
    want = _grads(ref_out, dy, (x, weight, bias))
    torch.cuda.synchronize()
    assert _rel(out, ref_out.float()) <= 1e-2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _rel(a, b.float()) <= 1e-6
