"""On the card: GCViT's f32-product window attention (``window_attention_f32``
and ``_mmf32``, ``csrc/tf32_attention.cuh``: 3xTF32 mma.sync) at its tile
edges, and ``ln_qkv_mmbf16`` (``csrc/hopper_gemm.cuh::ln_qkv_tma_kernel``,
f32 outputs stored by TMA, at C = 32 and 64; the LN kernel elsewhere) at
every width, S = 2 and 3 and ragged row counts, and its phase cuts; against
the plain versions.

Marked ``cuda``: they build the kernels with nvcc and launch them, so they
skip where there is no CUDA device. The file needs only torch and the port:

    python -m pytest tests/test_torch_tf32_attention_cuda.py -m cuda -q
"""
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G

F32_BOUND = 1e-5  # of max|ref|: f32 outputs of f32 products, sums in another order
MIXED_BOUND = 1e-2  # bf16 outputs, and any output of bf16 products
# N at the edges of the attention's 16-row query tiles and 8-key tiles, and of
# its three instantiations (64, 200 and 224 keys held)
ATTN_EDGES = [1, 8, 9, 15, 16, 17, 56, 57, 63, 64, 65, 192, 193, 200, 201, 208, 209, 224]
# row counts at the edges of ln_qkv_mmbf16's 128-row tiles (64 at C = 768) and past a wave
QKV_ROWS = {"one": 1, "63": 63, "tile-1": 127, "tile+1": 129, "ragged": 2 * 132 * 128 + 77}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, ref):
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _gen(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda shape, lo=-1.0, hi=1.0: torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo


@pytest.mark.cuda
@pytest.mark.parametrize("n", ATTN_EDGES)
@pytest.mark.parametrize("global_query", [False, True])
@pytest.mark.parametrize("mode", ["f32", "mmf32"])
def test_tf32_window_attention_tile_edges_on_card(cuda_device, n, global_query, mode):
    """Three windows of two images, three heads (one CTA keeps one head: a
    grid not a multiple of it would mix them), at N around the query and key
    tiles: ``window_attention_f32`` within 1e-5 of max|ref| of the plain
    version in f32, ``window_attention_mmf32`` (a bf16 global query, bf16
    output) within the mixed modes' 1e-2."""
    u = _gen(cuda_device, 31 * n + 2 * global_query + (mode == "mmf32"))
    b, nwin, heads = 2, 3, 3
    c = heads * 32
    out_dt = torch.float32 if mode == "f32" else torch.bfloat16
    k, v = u((b, nwin * n, c)), u((b, nwin * n, c))
    q = u((b, n, c)).to(out_dt) if global_query else u((b, nwin * n, c))
    bias = u((heads, n, n))
    G.reset_launches()
    got = G.window_attention(q, k, v, bias, n, 32 ** -0.5, global_query,
                             mm_dtype=torch.float32, out_dtype=out_dt)
    torch.cuda.synchronize()
    assert {s: v for s, v in G.LAUNCHES.items() if v} == {f"window_attention_{mode}": 1}
    assert got.shape == k.shape and got.dtype == out_dt
    ref = G.window_attention_plain(q, k, v, bias, n, 32 ** -0.5, global_query, torch.float32,
                                   out_dt)
    assert _rel(got, ref) <= (F32_BOUND if mode == "f32" else MIXED_BOUND)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 96, 128, 192, 256, 384, 512, 768])
@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("rows", sorted(QKV_ROWS))
def test_ln_qkv_mmbf16_widths_and_rows_on_card(cuda_device, c, s, rows):
    """``ln_qkv_mmbf16`` (f32 x, bf16 W_qkv, f32 q, k, v) at every width its
    plan takes (the TMA kernel at C = 32 and 64; the LN kernel elsewhere,
    split by columns at C = 768), local (S = 3)
    and global-query (S = 2) blocks, row counts at the tiles' edges and past
    a wave, against the plain version: max|d| / max|ref| <= 1e-2 (the bf16
    LN output). Rows differ (random x), so an output row or column stored in
    the wrong place shows."""
    u = _gen(cuda_device, 7 * c + s)
    m = QKV_ROWS[rows]
    x, lg, lb = u((m, c)) * 2, u((c,), 0.5, 1.5), u((c,), -0.1, 0.1)
    w, bq = (u((s * c, c)) * c ** -0.5).to(torch.bfloat16), u((s * c,), -0.1, 0.1)
    G.reset_launches()
    got = G.ln_qkv(x, lg, lb, w, bq, 1e-5, mm_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert {k: v for k, v in G.LAUNCHES.items() if v} == {"ln_qkv_mmbf16": 1}
    refs = G.ln_qkv_plain(x, lg, lb, w, bq, 1e-5, torch.bfloat16)
    assert len(got) == s
    for o, ref in zip(got, refs):
        assert o.shape == (m, c) and o.dtype == torch.float32
        assert _rel(o, ref) <= MIXED_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("s", [2, 3])
def test_ln_qkv_mmbf16_phase_cuts_launch_on_card(cuda_device, c, s):
    """Every cut of ``ln_qkv_mmbf16`` launches at GCViTTiny's widths (its
    TMA kernel at L1, the LN kernel at L2-L4), counts no launch, and cut 3
    is the kernel itself; an unknown cut raises."""
    u = _gen(cuda_device, c + s)
    m = 3 * 128 + 5
    x, lg, lb = u((m, c)), u((c,), 0.5, 1.5), u((c,), -0.1, 0.1)
    w, bq = (u((s * c, c)) * c ** -0.5).to(torch.bfloat16), u((s * c,), -0.1, 0.1)
    G.reset_launches()
    for cut in (0, 1, 2, 5):
        outs = G.ln_qkv_mmbf16_cut(x, lg, lb, w, bq, 1e-5, cut)
        assert len(outs) == s and all(o.shape == (m, c) and o.dtype == torch.float32
                                      for o in outs)
    torch.cuda.synchronize()
    assert G.LAUNCHES["ln_qkv_mmbf16"] == 0
    whole = G.ln_qkv_mmbf16_cut(x, lg, lb, w, bq, 1e-5, 3)
    assert G.LAUNCHES["ln_qkv_mmbf16"] == 1
    for o, ref in zip(whole, G.ln_qkv(x, lg, lb, w, bq, 1e-5, mm_dtype=torch.bfloat16)):
        assert torch.equal(o, ref)
    with pytest.raises(RuntimeError, match="cut 4"):
        G.ln_qkv_mmbf16_cut(x, lg, lb, w, bq, 1e-5, 4)


@pytest.mark.cuda
def test_exp_tools_time_the_new_kernels_on_card(cuda_device):
    """``exp_window_attention --kernels f32`` and ``exp_mlp_gemm --kernels
    mixed`` at a small batch: every kernel within its bound of its plain
    version, each reading timed, per-forward sums over the four levels."""
    from vip_cup_2022_tpu_torch.tools import exp_mlp_gemm, exp_window_attention

    f32 = exp_window_attention.main(["--iters", "1", "--batch", "2", "--kernels", "f32"])[-1]
    assert f32["kernels"] == "f32"
    for name, r in ((name, r) for level in f32["levels"].values() for name, r in level.items()):
        assert r["rel_err"] <= (F32_BOUND if name.startswith("window_attention_f32")
                                else MIXED_BOUND), name
        assert r["ms"]["whole"] > 0 and r["ms"]["sdpa"] > 0
    assert set(f32["forward"]) == set(exp_window_attention.F32_MODES)
    mixed = exp_mlp_gemm.main(["--iters", "1", "--batch", "2", "--kernels", "mixed"])
    for level in mixed:
        for name, r in level["mixed"].items():
            assert r["rel_err"] <= MIXED_BOUND, name
            if name.startswith("ln_qkv_mmbf16"):
                assert set(r["ms"]) == {"whole", "cublas", "loads", "ln", "products", "no_stores"}
