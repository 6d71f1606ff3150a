"""The block kernels' last modes against the JAX package, on the CPU.

``VIPTPU_GCVIT_MM=f32|bf16`` sets the GEMM dtype of GCViT's fused blocks
against the compute dtype, which the activations keep (the JAX kernels'
``force_mm_dtype``); ``VIPTPU_INT8_KERNELS=1`` composes with it and with f32
compute. On the CPU the port's wrappers run their plain versions, which
compute what the card's mixed-mode kernels compute (the operands rounded to
the GEMM dtype, exact products, f32 sums; the attention's P rounded and
divided after P.V by the sum of its rounded values). They are held here,
with ``VIPTPU_GELU=erf``, to:

- the GCViT block through its five wrappers, against
  ``fused_window_transformer_block(..., force_mm_dtype=...)`` in interpret
  mode, with and without a global query, on both JAX routes pinned by
  ``VIPTPU_GCVIT_MONO`` (with bf16 activations and f32 GEMMs the routes
  differ: the three-kernel pipeline rounds q, k, v to bf16, the monoblock,
  which the JAX package takes at every GCViTTiny level, keeps them f32, as
  the port does): 1e-2 (one bf16 step) of max|ref| where the block writes
  bf16; where it writes f32, 1e-4 in all rows but those (at most
  ``TIE_ROWS`` of them) where an f32 value rounded to a bf16 GEMM operand
  sits on a rounding tie that the two packages' last-ulp differences cross,
  which one bf16 step bounds;
- the int8 block in both mixed modes against JAX's int8 monoblock, the
  rows with a code on a .5 tie aside as ``test_torch_int8_kernels_mode.py``
  sets them aside (whose cases hold the int8 blocks on f32 activations);
- a narrow GCViT on its fused blocks in each mixed mode, against the JAX
  model forced fused, and a narrow f32 int8 ConvNeXt, which the knob leaves
  as it is;
- ``main_torch.py``'s CSV under each combination, byte for byte equal to
  ``main.py``'s on the same two-member manifest, both on the fused blocks.

The card's side (each mode's kernel launched, no plain version run) is in
``test_torch_f32_cuda.py`` on meta tensors and in ``test_torch_kernels_cuda.py``
(``-k a15c``) on the card.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_gcvit import _jax_gcvit
from test_torch_gcvit import assert_two_member_csvs_equal
from test_torch_gcvit_kernels import _block_params, _u
from test_torch_int8_kernels_mode import TIE_BOUND, _Quantized, _w8
from test_torch_slice import NARROW as NARROW_CONVNEXT, _jax_variables as _jax_convnext
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.ops.pallas import gcvit_block as jgb
from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.models import gcvit as port_gcvit
from vip_cup_2022_tpu_torch.ops.kernels import block_int8 as B
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G
from vip_cup_2022_tpu_torch.quant import dyn_int8
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch

F32, BF16 = torch.float32, torch.bfloat16
JAX_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}
# mode -> (the activations' dtype, the GEMMs')
MODES = {"mmf32": (BF16, F32), "mmbf16": (F32, BF16)}
F32_BOUND, BF16_BOUND = 1e-4, 1e-2  # of max|ref|: f32 outputs; bf16 outputs (one bf16 step)
# rows of an f32 output of bf16 GEMMs that may pass F32_BOUND: an LN output, q, the attention
# output or the hidden rounded to bf16 on the other side of a tie (an ulp apart in f32) moves
# its row, or its window, by one bf16 step of one operand
TIE_ROWS = 0.05
# a narrow GCViTTiny: hd = 32 at every level, C >= 128 (int8 under the knob) at L3 and L4, a
# global-query block at L1 (the block tests take one at every shape)
NARROW_GCVIT = dict(dim=32, num_heads=(1, 2, 4, 8), depths=(2, 1, 1, 1))
KNOBS = ("VIPTPU_GCVIT_MM", "VIPTPU_INT8_KERNELS", "VIPTPU_GCVIT_INT8_MIN_C", "VIPTPU_DTYPE",
         "VIPTPU_INT8", "VIPTPU_GCVIT_MONO", "VIPTPU_NO_FUSED_BLOCK", "VIPTPU_BATCHLANE_FOLD",
         "VIPTPU_CONVNEXT_FUSED_MIN_C")


@pytest.fixture(autouse=True)
def erf_gelu(monkeypatch):
    monkeypatch.setenv("VIPTPU_GELU", "erf")
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for module in (K, G, B):
        module.reset_launches()
    yield
    assert not any(v for m in (K, G, B) for v in m.LAUNCHES.values())  # CPU: no launch


def _t(a, dtype=F32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the block through its five wrappers
# ---------------------------------------------------------------------------
def _jax_block(x, qg, p, n, heads, **kw):
    return jgb.fused_window_transformer_block(
        x, heads=heads, n=n, ln1_g=p["ln1_g"], ln1_b=p["ln1_b"], wqkv=p["wqkv"],
        bqkv=p["bqkv"], bias=p["bias"], wp=p["wp"], bp=p["bp"], ln2_g=p["ln2_g"],
        ln2_b=p["ln2_b"], w1=p["w1"], b1=p["b1"], w2=p["w2"], b2=p["b2"],
        gamma1=p["gamma1"], gamma2=p["gamma2"], scale=32 ** -0.5, q_global=qg, eps=1e-5,
        interpret=True, **kw)


@pytest.mark.parametrize("route", ["mono", "pipeline"])
@pytest.mark.parametrize("global_query", [False, True], ids=["local", "global"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_window_block_matches_fused_window_transformer_block(monkeypatch, mode,
                                                                   global_query, route):
    """The block in the activations' dtype with its GEMMs in the other one
    (the weights in the GEMM dtype, from the same f32 values JAX casts),
    hd = 32 as at every GCViT level; its output keeps x's dtype."""
    x_dt, mm = MODES[mode]
    monkeypatch.setenv("VIPTPU_GCVIT_MONO", "1" if route == "mono" else "0")
    rng = np.random.RandomState(7 + global_query)
    n, nwin, heads, b = 49, 4, 2, 2
    c = heads * 32
    p = _block_params(c, 2 if global_query else 3, heads, n, rng)
    x = _u(rng, (b, nwin * n, c))
    qg = _u(rng, (b, n, c)) if global_query else None
    jdt = JAX_DTYPE[x_dt]
    want = _jax_block(jnp.asarray(x, jdt), None if qg is None else jnp.asarray(qg, jdt), p, n,
                      heads, force_mm_dtype=JAX_DTYPE[mm])
    got = G.window_transformer_block(
        _t(x, x_dt), None if qg is None else _t(qg, x_dt), n=n,
        ln1_weight=_t(p["ln1_g"]), ln1_bias=_t(p["ln1_b"]), wqkv=_t(p["wqkv"].T, mm),
        bqkv=_t(p["bqkv"]), bias=_t(p["bias"]), wp=_t(p["wp"].T, mm), bp=_t(p["bp"]),
        gamma1=_t(p["gamma1"]), ln2_weight=_t(p["ln2_g"]), ln2_bias=_t(p["ln2_b"]),
        w1=_t(p["w1"].T, mm), b1=_t(p["b1"]), w2=_t(p["w2"].T, mm), b2=_t(p["b2"]),
        gamma2=_t(p["gamma2"]), eps=1e-5, mm_dtype=mm)
    assert got.dtype == x_dt and want.dtype == jdt
    _assert_rows_close(got, want, x_dt, mm)


def _assert_rows_close(got, want, x_dt, mm):
    """bf16 outputs within ``BF16_BOUND`` of max|ref|; f32 outputs of f32
    GEMMs within ``F32_BOUND``; f32 outputs of bf16 GEMMs within it in all
    but ``TIE_ROWS`` of the rows, and within ``BF16_BOUND`` in those."""
    got = got.float().numpy().reshape(-1, got.shape[-1])
    want = np.asarray(want, np.float32).reshape(got.shape)
    err = np.abs(got - want).max(-1) / np.abs(want).max()
    if x_dt == BF16:
        assert err.max() <= BF16_BOUND, err.max()
        return
    if mm == F32:
        assert err.max() <= F32_BOUND, err.max()
        return
    assert err.max() <= BF16_BOUND and (err > F32_BOUND).mean() <= TIE_ROWS, (
        err.max(), (err > F32_BOUND).mean())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_wrappers_keep_the_monoblocks_dtypes(mode):
    """Between the wrappers: q, k, v in f32 (the monoblock's), the
    attention output in x's dtype, r1 in f32, the hidden in the GEMM dtype,
    the block's output in x's dtype."""
    x_dt, mm = MODES[mode]
    rng = np.random.RandomState(1)
    c, m = 32, 18
    x = _t(_u(rng, (m, c)), x_dt)
    w = _t(_u(rng, (3 * c, c)), mm)
    bias, g, z = torch.zeros(3 * c), torch.ones(c), torch.zeros(c)
    q, k, v = G.ln_qkv(x, g, z, w, bias, 1e-5, mm_dtype=mm)
    a = G.window_attention(q.view(2, 9, c), k.view(2, 9, c), v.view(2, 9, c),
                           torch.zeros((1, 9, 9)), 9, 32 ** -0.5, mm_dtype=mm, out_dtype=x_dt)
    r1 = G.proj_scale_residual(a.view(m, c), w[:c], bias[:c], g, x, mm_dtype=mm)
    h = K.ln_fc1_gelu(r1, g, z, w, bias, 1e-5, mm_dtype=mm)
    out = K.fc2_scale_residual(h, w.T.contiguous(), bias[:c], g, r1, out_dtype=x_dt)
    assert {t.dtype for t in (q, k, v, r1)} == {F32}
    assert (a.dtype, h.dtype, out.dtype) == (x_dt, mm, x_dt)


@pytest.mark.parametrize("global_query", [False, True], ids=["local", "global"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_int8_window_block_matches_the_int8_monoblock(monkeypatch, mode, global_query):
    """``VIPTPU_INT8_KERNELS=1`` with ``VIPTPU_GCVIT_MM``: the qkv, proj and
    MLP GEMMs int8, the attention in the GEMM dtype, against JAX's int8
    monoblock (K7) forced to that dtype; rows with a code on a .5 tie aside
    (held to one code step)."""
    x_dt, mm = MODES[mode]
    monkeypatch.setenv("VIPTPU_INT8_KERNELS", "1")
    rng = np.random.RandomState(11 + global_query)
    n, nwin, heads, b = 49, 2, 4, 2
    c = heads * 32
    p = _block_params(c, 2 if global_query else 3, heads, n, rng)
    x = _u(rng, (b, nwin * n, c))
    qg = _u(rng, (b, n, c)) if global_query else None
    jdt = JAX_DTYPE[x_dt]
    want = jgb.mono_window_transformer_block(
        jnp.asarray(x, jdt), heads=heads, n=n, ln1_g=p["ln1_g"], ln1_b=p["ln1_b"],
        wqkv=p["wqkv"], bqkv=p["bqkv"], bias=p["bias"], wp=p["wp"], bp=p["bp"],
        ln2_g=p["ln2_g"], ln2_b=p["ln2_b"], w1=p["w1"], b1=p["b1"], w2=p["w2"], b2=p["b2"],
        gamma1=p["gamma1"], gamma2=p["gamma2"], scale=32 ** -0.5,
        q_global=None if qg is None else jnp.asarray(qg, jdt), group=nwin, eps=1e-5,
        force_mm_dtype=JAX_DTYPE[mm], int8=True, interpret=True)
    seen = _Quantized(monkeypatch)
    got = B.window_transformer_block_int8(
        _t(x, x_dt), None if qg is None else _t(qg, x_dt), n=n, ln1_weight=_t(p["ln1_g"]),
        ln1_bias=_t(p["ln1_b"]), qkv=_w8(p["wqkv"]), bqkv=_t(p["bqkv"]), bias=_t(p["bias"]),
        proj=_w8(p["wp"]), bp=_t(p["bp"]), gamma1=_t(p["gamma1"]), ln2_weight=_t(p["ln2_g"]),
        ln2_bias=_t(p["ln2_b"]), fc1=_w8(p["w1"]), b1=_t(p["b1"]), fc2=_w8(p["w2"]),
        b2=_t(p["b2"]), gamma2=_t(p["gamma2"]), eps=1e-5, mm_dtype=mm)
    assert got.dtype == x_dt
    near = seen.near_tie_rows(window=n)
    got = got.float().numpy().reshape(near.shape[0], -1)
    want = np.asarray(want, np.float32).reshape(near.shape[0], -1)
    err = np.abs(got - want).max(-1) / np.abs(want).max()
    bound = F32_BOUND if x_dt == F32 else BF16_BOUND
    assert (err[~near] <= bound).all(), err[~near].max()
    assert (err <= TIE_BOUND).all() and (err > bound).mean() <= 0.25, err.max()


# ---------------------------------------------------------------------------
# narrow members on their fused blocks
# ---------------------------------------------------------------------------
BF16_MODEL_BOUND = 0.03  # bf16 members: JAX's bf16 LN statistics, bf16 convs
# f32 members with bf16 GEMMs: a bf16 operand rounded across a tie (TIE_ROWS) moves a token by
# one bf16 step, which the head's pooled LN and Linear carry to the logits in part
MIXED_MODEL_BOUND = 2e-3


@pytest.fixture(scope="module")
def gcvit_tree():
    kw = dict(input_size=(224, 224), nb_classes=3, **NARROW_GCVIT)
    _, tree = _jax_gcvit(seed=21, **kw)
    x = np.random.RandomState(21).uniform(0, 1, (1, 224, 224, 3)).astype(np.float32)
    return kw, tree, x


@pytest.mark.parametrize("mode", sorted(MODES))
def test_narrow_gcvit_under_the_knobs_matches_jax_fused_model(monkeypatch, gcvit_tree, mode):
    """A narrow GCViTTiny on the fused blocks in both packages, the port's
    f32 GEMMs of a bf16 model on the checkpoint's f32 values: within
    ``BF16_MODEL_BOUND`` of max|ref| in bf16, ``MIXED_MODEL_BOUND`` in f32
    with bf16 GEMMs; apart from the run with the compute dtype's GEMMs
    (the mode ran). (With ``VIPTPU_INT8_KERNELS=1`` beside the knob: the
    int8 block above and the CLI below.)"""
    kw, tree, x = gcvit_tree
    dt, mm = MODES[mode]
    monkeypatch.setenv("VIPTPU_GCVIT_MM", "f32" if mm == F32 else "bf16")
    jax_module, _, _ = jax_create_model("GCViTTiny", init=False, fused_block=True,
                                        dtype=JAX_DTYPE[dt], **kw)
    want = np.asarray(jax.jit(jax_module.apply)(tree, jnp.asarray(x)), np.float32)
    port, _ = create_model("GCViTTiny", dtype=dt, fused_block=True, **kw)
    transfer_weights(tree, port, strict=True)
    dyn_int8.attach(port, flax_to_torch(tree), f32=True)
    port.eval()
    with torch.no_grad():
        got = port(_t(x)).float().numpy()
        monkeypatch.delenv("VIPTPU_GCVIT_MM")
        other = port(_t(x)).float().numpy()
    bound = BF16_MODEL_BOUND if dt == BF16 else MIXED_MODEL_BOUND
    assert _rel(got, want) <= bound and _rel(got, other) > 0


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_narrow_convnext_f32_int8_ignores_gcvit_mm(monkeypatch, mm):
    """The knob is GCViT's: an f32 ConvNeXt under ``VIPTPU_INT8_KERNELS=1``
    (its MLP on the int8 kernels' f32 modes) serves the same logits with
    ``VIPTPU_GCVIT_MM`` set as without it."""
    kw = dict(input_size=(64, 64), nb_classes=3, **NARROW_CONVNEXT)
    _, tree = _jax_convnext(seed=4, **kw)
    port, _ = create_model("convnext_tiny_in22k", fused_block=True, **kw)
    transfer_weights(tree, port, strict=True)
    x = _t(np.random.RandomState(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    monkeypatch.setenv("VIPTPU_INT8_KERNELS", "1")
    with torch.no_grad():
        want = port.eval()(x)
        monkeypatch.setenv("VIPTPU_GCVIT_MM", mm)
        assert torch.equal(port(x), want)


# ---------------------------------------------------------------------------
# the CLI: main_torch.py's CSV equals main.py's under each combination
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fused_workspace(tmp_path_factory):
    """Six 200x200 JPEGs and a manifest of a narrow ConvNeXt at 200 and a
    narrow GCViT at 224, both pinned to their fused blocks by their
    config.json (``fused_block``), as main.py runs them on a TPU."""
    root = tmp_path_factory.mktemp("mixed_modes_e2e")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(13)
    names = [f"m_{i:02d}.jpg" for i in range(6)]
    for name in names:
        Image.fromarray(rng.randint(0, 255, (200, 200, 3), dtype=np.uint8)).save(
            img_dir / name, quality=92)
    input_csv = img_dir / "input.csv"
    input_csv.write_text("filename\n" + "".join(f"{n}\n" for n in names))
    head = dict(nb_classes=1, classifier_activation="sigmoid", fused_block=True)
    narrow_convnext = dict(head, **NARROW_CONVNEXT)
    narrow_gcvit = dict(head, **NARROW_GCVIT)
    del narrow_convnext["fused_block"], narrow_gcvit["fused_block"]
    members = {
        "convnext_tiny_in22k-200x200": (
            (200, 200), dict(head, **NARROW_CONVNEXT),
            _jax_convnext(seed=8, input_size=(64, 64), **narrow_convnext)[1]),
        "GCViTTiny-224x224": (
            (224, 224), dict(head, **NARROW_GCVIT),
            _jax_gcvit(seed=9, input_size=(224, 224), **narrow_gcvit)[1]),
    }
    manifest = []
    for base, (dim, overrides, tree) in members.items():
        ckpt_dir = root / "ckpts" / base / "ckpt"
        ckpt_dir.mkdir(parents=True)
        with open(ckpt_dir / "config.json", "w") as fh:
            json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in overrides.items()}, fh)
        save_variables(str(ckpt_dir / "fold0.msgpack"), tree)
        manifest.append([base, list(dim), 0])
    with open(root / "ckpts" / "ckpts.json", "w") as fh:
        json.dump(manifest, fh)
    return root, input_csv, names, members


# (VIPTPU_DTYPE, VIPTPU_GCVIT_MM, VIPTPU_INT8_KERNELS, VIPTPU_INT8)
CLI_COMBOS = [("bfloat16", "f32", "", ""), ("float32", "bf16", "", ""),
              ("float32", "", "1", ""), ("bfloat16", "f32", "1", ""),
              ("float32", "bf16", "1", "all")]


@pytest.mark.parametrize("knobs", CLI_COMBOS, ids=lambda k: "-".join(v or "unset" for v in k))
def test_cli_csv_under_the_knobs_equals_jax_byte_for_byte(fused_workspace, monkeypatch, knobs):
    """Both CLIs on the fused-block manifest under the knobs, the threshold
    put between the images by the port's own probabilities: the CSVs are
    byte for byte equal, and the port's GCViT member ran its fused blocks
    in the knobs' GEMM dtype."""
    dtype, mm, int8_kernels, int8 = knobs
    for knob, value in (("VIPTPU_DTYPE", dtype), ("VIPTPU_GCVIT_MM", mm),
                        ("VIPTPU_INT8_KERNELS", int8_kernels), ("VIPTPU_INT8", int8)):
        if value:
            monkeypatch.setenv(knob, value)
    seen = []
    real = port_gcvit.GCViTBlock.forward

    def record(self, x, q_global, fused=True, mm_dtype=None):
        seen.append((fused, mm_dtype, x.dtype))
        return real(self, x, q_global, fused, mm_dtype)

    monkeypatch.setattr(port_gcvit.GCViTBlock, "forward", record)
    assert_two_member_csvs_equal(fused_workspace, monkeypatch)
    want_mm = {"f32": F32, "bf16": BF16}.get(mm, F32 if dtype == "float32" else BF16)
    compute = F32 if dtype == "float32" else BF16
    assert seen and set(seen) == {(True, want_mm, compute)}
