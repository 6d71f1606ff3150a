"""f32 compute on CUDA (``VIPTPU_DTYPE=float32``), checked on the CPU.

On CUDA the f32 path runs GCViT and ConvNeXt on their fused blocks, as
``main.py`` does on a TPU, whose kernels there are the f32 modes of the
block kernels (``dwconv7x7_nhwc_f32``, ``ln_fc1_gelu_f32``,
``fc2_scale_residual_f32``, ``ln_qkv_f32``, ``window_attention_f32``,
``proj_scale_residual_f32``), and the unfused blocks (training, or
``VIPTPU_NO_FUSED_BLOCK``) on the f32 modes of window attention (K8, the
symbol ``window_attention_bhnd_f32``), the depthwise conv (K9,
``depthwise_conv_nhwc_f32``) and the LN (K10, ``layer_norm_f32``). The
kernels need the card (``test_torch_kernels_cuda.py`` holds them to their
plain versions there); here:

- each wrapper's choice of symbol by dtype, with the library replaced by a
  recorder and the tensors on the meta device (not the CPU, so the wrapper
  takes its kernel path; nothing is computed), the fused-block wrappers
  running no plain version;
- the models' rule that an f32 GCViT or ConvNeXt takes its fused block on
  CUDA as bf16 does (``_use_fused_block``), a narrow f32 member off the CPU
  reaching the f32 symbols, and the engine's f32 members, built on the CPU
  and run on their fused blocks, narrow, against the JAX package's f32
  models forced fused (its Pallas kernels in interpret mode, exact-erf
  GELU) within 1e-4;
- the last modes, once refused under the name A15c (the test names keep
  it): the int8 block wrappers given f32 off the CPU launch their f32
  instantiations (their plain versions never run), ``VIPTPU_INT8_KERNELS=1``
  with f32 on CUDA reaches them from a narrow ConvNeXt, and
  ``VIPTPU_GCVIT_MM`` against the compute dtype runs a narrow GCViT's fused
  blocks on the mixed-mode symbols (``_mmf32`` / ``_mmbf16``);
- the TF32 scope (``utils/precision.py::f32_scope``) that the engine's
  forwards and the trainer's steps and evaluations take: both flags off
  inside, restored after.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_gcvit import NARROW as NARROW_GCVIT, _jax_gcvit
from test_torch_slice import NARROW as NARROW_CONVNEXT, _jax_variables as _jax_convnext
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu_torch.infer import engine as E
from vip_cup_2022_tpu_torch.models import convnext as convnext_model
from vip_cup_2022_tpu_torch.models import create_model, gcvit as gcvit_model, transfer_weights
from vip_cup_2022_tpu_torch.ops.kernels import block_int8 as B8
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G
from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L
from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA
from vip_cup_2022_tpu_torch.quant import dyn_int8
from vip_cup_2022_tpu_torch.quant.dyn_int8 import Int8Weight
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer
from vip_cup_2022_tpu_torch.utils.precision import f32_scope

ATOL = 1e-4  # a narrow member in f32 against the JAX package's, as test_torch_unfused.py
META = torch.device("meta")
F32, BF16 = torch.float32, torch.bfloat16
CUDA = torch.device("cuda")
# each member's model module and the fused block it calls on the fused path
FUSED = {"GCViTTiny": (gcvit_model, "window_transformer_block"),
         "convnext_tiny_in22k": (convnext_model, "convnext_block")}


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# the symbol each dtype launches
# ---------------------------------------------------------------------------
class _Recorder:
    """A stand-in for a kernel library: records the symbol called."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        return lambda *args: self.called.append(name) or 0


def _launch(monkeypatch, module, call):
    lib = _Recorder()
    monkeypatch.setattr(module, "_lib", lambda: lib)
    monkeypatch.setattr(module, "_stream", lambda device: None)
    module.reset_launches()
    out = call()
    return lib.called, dict(module.LAUNCHES), out


@pytest.mark.parametrize("dtype,symbol", [(BF16, "window_attention_bhnd"),
                                          (F32, "window_attention_bhnd_f32")])
@pytest.mark.parametrize("n,heads", [(49, 2), (196, 8)])
def test_window_attention_launches_the_symbol_of_its_dtype(monkeypatch, dtype, symbol, n, heads):
    q = _meta(3, heads, n, 32, dtype=dtype)
    called, launches, out = _launch(monkeypatch, WA, lambda: WA.window_attention(
        q, q, q, _meta(heads, n, n), 32 ** -0.5))
    assert called == [symbol] and launches == {**{s: 0 for s in WA.SYMBOL.values()}, symbol: 1}
    assert out.dtype == dtype and out.shape == q.shape


@pytest.mark.parametrize("dtype,symbol", [(BF16, "depthwise_conv_nhwc"),
                                          (F32, "depthwise_conv_nhwc_f32")])
@pytest.mark.parametrize("k,c", [(3, 64), (5, 24), (7, 96), (3, 6)])
def test_depthwise_launches_the_symbol_of_its_dtype(monkeypatch, dtype, symbol, k, c):
    x = _meta(2, 13, 11, c, dtype=dtype)
    pad = ((k // 2, k // 2), (k // 2, k // 2))
    called, launches, out = _launch(monkeypatch, D, lambda: D.depthwise_conv_nhwc(
        x, _meta(k, k, 1, c), padding=pad))
    assert called == [symbol] and launches == {**{s: 0 for s in D.SYMBOL.values()}, symbol: 1}
    assert out.dtype == dtype and out.shape == x.shape


def test_depthwise_f32_takes_odd_widths_bf16_does_not(monkeypatch):
    """An f32 pixel of any width is whole 4-byte copies; a bf16 one only at
    even widths."""
    pad = ((1, 1), (1, 1))
    called, _, _ = _launch(monkeypatch, D, lambda: D.depthwise_conv_nhwc(
        _meta(1, 5, 5, 5), _meta(3, 3, 5), padding=pad))
    assert called == ["depthwise_conv_nhwc_f32"]
    with pytest.raises(ValueError, match="not even"):
        D.depthwise_conv_nhwc(_meta(1, 5, 5, 5, dtype=BF16), _meta(3, 3, 5), padding=pad)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        D.depthwise_conv_nhwc(_meta(1, 5, 5, 6, dtype=torch.float16), _meta(3, 3, 6),
                              padding=pad)


@pytest.mark.parametrize("dtype,symbol", [(BF16, "layer_norm_bf16"), (F32, "layer_norm_f32")])
@pytest.mark.parametrize("c", [64, 512, 768])
def test_layer_norm_launches_the_symbol_of_its_dtype(monkeypatch, dtype, symbol, c):
    """Every LN of the f32 path is at most ``MAX_WIDTH[f32]`` wide: GCViT's
    64 ... 512 and ConvNeXt's 768. One counter counts both dtypes."""
    assert c <= L.MAX_WIDTH[F32]
    called, launches, out = _launch(monkeypatch, L, lambda: L.layer_norm(
        _meta(5, c, dtype=dtype), _meta(c), _meta(c), 1e-6))
    assert called == [symbol] and launches == {"layer_norm": 1}
    assert out.dtype == dtype


# ---------------------------------------------------------------------------
# the fused blocks' wrappers launch their f32 symbols, and so do the int8 ones
# ---------------------------------------------------------------------------
def _i8(n, c):
    return Int8Weight(_meta(n, c, dtype=torch.int8), _meta(n))


def _fused_call(name, dt):
    """The call of fused-block wrapper ``name`` on meta tensors of a bf16 or
    an f32 (``dt``) block: the LN GEMM's x and every bias, scale and LN
    parameter f32 either way."""
    return {
        "dwconv7x7_nhwc": lambda: K.dwconv7x7_nhwc(_meta(2, 9, 9, 64, dtype=dt), _meta(7, 7, 64),
                                                   _meta(64)),
        "ln_fc1_gelu": lambda: K.ln_fc1_gelu(_meta(8, 64), _meta(64), _meta(64),
                                             _meta(256, 64, dtype=dt), _meta(256), 1e-6),
        "fc2_scale_residual": lambda: K.fc2_scale_residual(
            _meta(8, 256, dtype=dt), _meta(64, 256, dtype=dt), _meta(64), _meta(64),
            _meta(8, 64, dtype=dt)),
        "ln_qkv": lambda: G.ln_qkv(_meta(98, 64, dtype=dt), _meta(64), _meta(64),
                                   _meta(192, 64, dtype=dt), _meta(192), 1e-5),
        "window_attention": lambda: G.window_attention(
            *[_meta(2, 98, 64, dtype=dt)] * 3, _meta(2, 49, 49), 49, 32 ** -0.5),
        "proj_scale_residual": lambda: G.proj_scale_residual(
            _meta(98, 64, dtype=dt), _meta(64, 64, dtype=dt), _meta(64), _meta(64),
            _meta(98, 64, dtype=dt)),
    }[name]


INT8_F32_CALLS = {
    "ln_qkv_int8": lambda: B8.ln_qkv_int8(_meta(98, 128), _meta(128), _meta(128),
                                          *_i8(384, 128), _meta(384), 1e-5),
    "mlp_int8_scale_residual": lambda: B8.mlp_int8_scale_residual(
        _meta(8, 128, dtype=torch.int8), _meta(8), _meta(8), *_i8(512, 128), _meta(512),
        *_i8(128, 512), _meta(128), _meta(128), _meta(8, 128), F32),
    "fc2_scale_residual_int8": lambda: B8.fc2_scale_residual_int8(
        _meta(8, 512, dtype=torch.int8), _meta(8), *_i8(128, 512), _meta(128), _meta(128),
        _meta(8, 128), F32),
    "proj_scale_residual_int8": lambda: B8.proj_scale_residual_int8(
        _meta(8, 128, dtype=torch.int8), _meta(8), *_i8(128, 128), _meta(128), _meta(128),
        _meta(8, 128)),
}
# each fused-block wrapper's module and output dtype in a bf16 block (the depthwise sum
# and GCViT's r1 stay f32)
FUSED_WRAPPERS = {"dwconv7x7_nhwc": (K, F32), "ln_fc1_gelu": (K, BF16),
                  "fc2_scale_residual": (K, BF16),
                  "ln_qkv": (G, BF16), "window_attention": (G, BF16),
                  "proj_scale_residual": (G, F32)}


def _no_plain(monkeypatch, module, name):
    def no_plain(*args, **kwargs):
        raise AssertionError(f"{name} ran its plain version")

    monkeypatch.setattr(module, f"{name}_plain", no_plain)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(FUSED_WRAPPERS))
def test_fused_wrappers_launch_the_symbol_of_their_dtype(monkeypatch, name, dtype):
    """Off the CPU a fused-block wrapper given an f32 block's tensors
    launches its ``_f32`` symbol, a bf16 block's its bf16 one, counts that
    launch, and runs no plain version; an f32 block's outputs are f32."""
    module, bf16_out = FUSED_WRAPPERS[name]
    _no_plain(monkeypatch, module, name)
    symbol = name + "_f32" if dtype == F32 else name
    called, launches, out = _launch(monkeypatch, module, _fused_call(name, dtype))
    assert called == [symbol]
    assert launches == {**{k: 0 for k in module.LAUNCHES}, symbol: 1}
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.dtype == (F32 if dtype == F32 else bf16_out) for o in outs)


# each int8 wrapper's entry point in csrc/block_int8.cu and the counter of its f32 mode
INT8_F32_SYMBOLS = {"ln_qkv_int8": ("ln_qkv_int8", "ln_qkv_int8_f32"),
                    "mlp_int8_scale_residual": ("mlp_int8_scale_residual",
                                                "mlp_int8_scale_residual_f32"),
                    "fc2_scale_residual_int8": ("res_gemm_int8", "fc2_scale_residual_int8_f32"),
                    "proj_scale_residual_int8": ("res_gemm_int8", "proj_scale_residual_int8_f32")}


@pytest.mark.parametrize("name", sorted(INT8_F32_CALLS))
def test_int8_wrappers_refuse_f32_naming_a15c(monkeypatch, name):
    """Off the CPU an int8 block wrapper (``VIPTPU_INT8_KERNELS=1``) given
    an f32 block's activations (once refused as A15c) launches its kernel's
    f32 instantiation, counted under the mode's own name, runs no plain
    version, and writes f32, as the JAX kernels write ``x2.dtype``."""
    _no_plain(monkeypatch, B8, name)
    entry, counter = INT8_F32_SYMBOLS[name]
    called, launches, out = _launch(monkeypatch, B8, INT8_F32_CALLS[name])
    assert called == [entry]
    assert launches == {**{k: 0 for k in B8.LAUNCHES}, counter: 1}
    outs = out if isinstance(out, tuple) else (out,)
    assert outs and all(o.dtype == F32 for o in outs)


# the launches of one narrow forward's blocks on the f32 symbols
NARROW_F32_LAUNCHES = {
    "GCViTTiny": (G, {"ln_qkv_f32": 8, "window_attention_f32": 8,
                      "proj_scale_residual_f32": 8}, {"ln_fc1_gelu_f32": 8,
                                                      "fc2_scale_residual_f32": 8}),
    "convnext_tiny_in22k": (K, {}, {"dwconv7x7_nhwc_f32": 4, "ln_fc1_gelu_f32": 4,
                                    "fc2_scale_residual_f32": 4}),
}


@pytest.mark.parametrize("name,size,narrow", [("GCViTTiny", 224, NARROW_GCVIT),
                                              ("convnext_tiny_in22k", 64, NARROW_CONVNEXT)])
def test_f32_member_off_the_cpu_takes_its_fused_block_and_reaches_the_f32_symbols(
        monkeypatch, name, size, narrow):
    """A narrow f32 member whose config leaves the block path to the default,
    off the CPU (on the meta device, the block kernels' libraries replaced
    by recorders and the unfused kernels' plain versions standing in for the
    LN and depthwise kernels, which compute shapes only there), runs every
    block on the f32 symbols and no bf16 one."""
    monkeypatch.delenv("VIPTPU_NO_FUSED_BLOCK", raising=False)
    monkeypatch.setattr(L, "layer_norm", L.layer_norm_plain)
    monkeypatch.setattr(D, "depthwise_conv_nhwc", D.depthwise_conv_nhwc_plain)
    libs = {}
    for module in (K, G):
        libs[module] = _Recorder()
        monkeypatch.setattr(module, "_lib", lambda lib=libs[module]: lib)
        monkeypatch.setattr(module, "_stream", lambda device: None)
        module.reset_launches()
    model, _ = create_model(name, input_size=(size, size), nb_classes=1, dtype=F32, **narrow)
    assert model.cfg.fused_block is None
    model = model.to(META).eval()
    with torch.no_grad():
        out = model(_meta(1, size, size, 3))
    assert out.shape == (1, 1) and out.dtype == F32
    _, want_g, want_k = NARROW_F32_LAUNCHES[name]
    assert K.LAUNCHES == {**{k: 0 for k in K.LAUNCHES}, **want_k}
    assert G.LAUNCHES == {**{k: 0 for k in G.LAUNCHES}, **want_g}
    assert sorted(set(libs[K].called + libs[G].called)) == sorted({**want_k, **want_g})


def _off_the_cpu(monkeypatch, modules):
    """The block kernels' libraries of ``modules`` replaced by recorders, the
    LN and depthwise kernels by their plain versions (which compute shapes
    only on the meta device); the recorders."""
    monkeypatch.delenv("VIPTPU_NO_FUSED_BLOCK", raising=False)
    monkeypatch.setattr(L, "layer_norm", L.layer_norm_plain)
    monkeypatch.setattr(D, "depthwise_conv_nhwc", D.depthwise_conv_nhwc_plain)
    libs = {}
    for module in modules:
        libs[module] = _Recorder()
        monkeypatch.setattr(module, "_lib", lambda lib=libs[module]: lib)
        monkeypatch.setattr(module, "_stream", lambda device: None)
        module.reset_launches()
    return libs


def test_int8_kernels_with_f32_on_cuda_raise_a15c(monkeypatch):
    """``VIPTPU_INT8_KERNELS=1`` with f32 compute on CUDA (once refused as
    A15c) is on in every compute dtype, and a narrow f32 ConvNeXt off the
    CPU runs its MLP on the int8 kernels' f32 instantiations only: pass 1
    on its f32 x, pass 2 writing f32 beside the f32 residual."""
    monkeypatch.setenv("VIPTPU_INT8_KERNELS", "1")
    for device, dtype in (("cuda", F32), ("cuda", BF16), ("cpu", F32)):
        eng = E.EnsembleEngine(device=device, compute_dtype=dtype, verbose=0)
        assert eng._int8_kernels()
        eng.close()
    libs = _off_the_cpu(monkeypatch, (K, B8))
    # the member's own widths (the int8 MLP pair's plans start at C = 64), one block a stage
    model, _ = create_model("convnext_tiny_in22k", input_size=(64, 64), nb_classes=1, dtype=F32,
                            nb_blocks=(1, 1, 1, 1))
    model = model.to(META).eval()
    with torch.no_grad():
        out = model(_meta(1, 64, 64, 3))
    assert out.shape == (1, 1) and out.dtype == F32
    blocks = 4
    assert K.LAUNCHES == {**{k: 0 for k in K.LAUNCHES}, "dwconv7x7_nhwc_f32": blocks}
    assert B8.LAUNCHES == {**{k: 0 for k in B8.LAUNCHES}, "ln_fc1_rowmax_int8": blocks,
                           "mlp_int8_scale_residual_f32": blocks}
    assert sorted(set(libs[B8].called)) == ["ln_fc1_rowmax_int8", "mlp_int8_scale_residual"]
    monkeypatch.setenv("VIPTPU_INT8_KERNELS", "0")
    f32_cuda = E.EnsembleEngine(device="cuda", compute_dtype=F32, verbose=0)
    assert not f32_cuda._int8_kernels()
    f32_cuda.close()


# ---------------------------------------------------------------------------
# the engine's f32 members, built on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_members():
    """name -> (size, create_model kwargs, JAX tree, input, JAX f32 logits)
    of a narrow GCViT at 224 and a narrow ConvNeXt at 64, the JAX models
    forced onto their fused blocks (the Pallas kernels in interpret mode,
    ``VIPTPU_GELU=erf``)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIPTPU_GELU", "erf")
        for name, size, kw, make in (
                ("GCViTTiny", 224, NARROW_GCVIT, _jax_gcvit),
                ("convnext_tiny_in22k", 64, NARROW_CONVNEXT, _jax_convnext)):
            kw = dict(nb_classes=1, classifier_activation=None, **kw)
            tree = make(seed=3, input_size=(size, size), **kw)[1]
            fused, _, _ = jax_create_model(name, init=False, fused_block=True,
                                           input_size=(size, size), **kw)
            x = np.random.RandomState(5).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
            out[name] = (size, kw, tree, x,
                         np.asarray(jax.jit(fused.apply)(tree, jnp.asarray(x))))
    return out


def _as_on_cuda(monkeypatch, name):
    """Make ``name``'s model take, on the CPU, the block path its rule gives
    on CUDA, and count its fused block's calls; returns the count."""
    module, fused = FUSED[name]
    real, real_fused, calls = module._use_fused_block, getattr(module, fused), []

    def on_cuda(cfg, training, device=None):
        return real(cfg, training, CUDA)

    def counted(*args, **kwargs):
        calls.append(1)
        return real_fused(*args, **kwargs)

    monkeypatch.setattr(module, "_use_fused_block", on_cuda)
    monkeypatch.setattr(module, fused, counted)
    return calls


@pytest.mark.parametrize("forced", [False, True], ids=["auto", "fused_block"])
@pytest.mark.parametrize("name", ["GCViTTiny", "convnext_tiny_in22k"])
def test_engine_builds_f32_members_on_their_fused_blocks(jax_members, monkeypatch, name, forced):
    """``VIPTPU_DTYPE=float32`` on CUDA: the engine builds the member in f32
    with the block path left to the model, which on CUDA takes the fused
    block (or the model is built with ``fused_block=True``); run on the CPU
    on that path (the block wrappers' plain versions), the model equals the
    JAX package's f32 model on its fused Pallas blocks within 1e-4."""
    size, kw, tree, x, want = jax_members[name]
    monkeypatch.delenv("VIPTPU_NO_FUSED_BLOCK", raising=False)
    if forced:
        model, _ = create_model(name, input_size=(size, size), dtype=F32, fused_block=True, **kw)
    else:
        eng = E.EnsembleEngine(device="cuda", compute_dtype=F32, verbose=0)
        model, _ = eng._create_member(name, (size, size), dict(kw))
        eng.close()
        assert model.cfg.fused_block is None
    assert model.cfg.dtype == F32
    transfer_weights(tree, model, strict=True)
    calls = _as_on_cuda(monkeypatch, name)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    assert len(calls) == sum(model.cfg.depths if name == "GCViTTiny" else model.cfg.nb_blocks)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name,narrow", [("GCViTTiny", NARROW_GCVIT),
                                         ("convnext_tiny_in22k", NARROW_CONVNEXT)])
def test_f32_on_cuda_takes_the_fused_block_as_bf16_does(monkeypatch, name, narrow):
    """The models' rule: a model whose config leaves the block path to the
    default takes the fused block in f32 and in bf16, on CUDA and on the
    CPU, unless ``VIPTPU_NO_FUSED_BLOCK`` is set; a forced path stays
    forced; training is unfused always."""
    module, _ = FUSED[name]
    cfg = create_model(name, input_size=(224, 224), nb_classes=1, dtype=F32, **narrow)[1]
    monkeypatch.delenv("VIPTPU_NO_FUSED_BLOCK", raising=False)
    assert cfg.fused_block is None
    for c in (cfg, cfg.replace(dtype=BF16)):
        assert module._use_fused_block(c, False, CUDA)
        assert module._use_fused_block(c, False, torch.device("cpu"))
        assert module._use_fused_block(c, False)
        assert not module._use_fused_block(c, True, CUDA)
        assert not module._use_fused_block(c.replace(fused_block=False), False, CUDA)
    assert module._use_fused_block(cfg.replace(fused_block=True), False, CUDA)
    monkeypatch.setenv("VIPTPU_NO_FUSED_BLOCK", "1")
    assert not module._use_fused_block(cfg, False, CUDA)
    assert module._use_fused_block(cfg.replace(fused_block=True), False, CUDA)


def test_trainer_evaluates_f32_on_cuda_on_the_fused_block(monkeypatch):
    """The trainer leaves the model's config as it is: an f32 GCViT whose
    config leaves the block path to the default evaluates on CUDA on its
    fused block by the model's rule, inside the TF32 scope. Built on the
    CPU, the trainer is pointed at the card after its construction, its
    tensors kept on the CPU, the model run on the path it takes on CUDA."""
    monkeypatch.delenv("VIPTPU_NO_FUSED_BLOCK", raising=False)
    model, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1, **NARROW_GCVIT)
    tr = Trainer(model, TrainConfig(), device="cpu")
    assert tr.model.cfg.fused_block is None and tr.compute_dtype == F32
    tr.device = CUDA
    monkeypatch.setattr(tr, "_tensor", lambda a: torch.as_tensor(np.asarray(a)))
    calls = _as_on_cuda(monkeypatch, "GCViTTiny")
    forward, seen = tr.model.forward, []

    def recorded(x):
        seen.append(_flags())
        return forward(x)

    monkeypatch.setattr(tr.model, "forward", recorded)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = np.random.RandomState(2).randint(0, 255, (2, 224, 224, 3), dtype=np.uint8)
    loss, _ = tr.eval_step(x, np.ones((2, 1), np.float32))
    assert torch.isfinite(loss) and seen == [(False, False)] and _flags() == (True, True)
    assert len(calls) == sum(NARROW_GCVIT["depths"])


# ---------------------------------------------------------------------------
# VIPTPU_GCVIT_MM: GCViT's fused GEMM dtype in main.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value,dtype", [("f32", F32), ("bf16", BF16), ("", F32), ("fp8", BF16)])
def test_gcvit_mm_equal_to_the_compute_dtype_changes_nothing(monkeypatch, value, dtype):
    """The compute dtype's own value, an empty one and one the JAX model
    does not read pass; a narrow f32 GCViT serves the same logits with the
    knob at ``f32`` as without it."""
    monkeypatch.setenv("VIPTPU_GCVIT_MM", value)
    assert gcvit_model.gcvit_mm_dtype(dtype) == dtype
    if value == "f32":
        model, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1, seed=0,
                                **NARROW_GCVIT)
        x = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (1, 224, 224, 3))
                             .astype(np.float32))
        with torch.inference_mode():
            got = model.eval()(x)
            monkeypatch.delenv("VIPTPU_GCVIT_MM")
            assert torch.equal(got, model(x))


@pytest.mark.parametrize("value,dtype", [("bf16", F32), ("f32", BF16)])
def test_gcvit_mm_against_the_compute_dtype_raises_a15c(monkeypatch, value, dtype):
    """The other dtype than the compute dtype (once refused as A15c) sets
    GCViT's fused GEMM dtype, as JAX's model reads the knob: a narrow GCViT
    off the CPU runs every fused block on the mixed-mode symbols alone (an
    f32 GEMM of a bf16 model on the f32 values its weights were cast from),
    its output in the compute dtype; the unfused path, which the JAX model
    runs without reading the knob, serves on the CPU."""
    monkeypatch.setenv("VIPTPU_GCVIT_MM", value)
    mm = gcvit_model.GCVIT_MM[value]
    assert gcvit_model.gcvit_mm_dtype(dtype) == mm != dtype
    f32_model, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1, seed=0,
                                **NARROW_GCVIT)
    weights = f32_model.state_dict()
    model, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1, dtype=dtype,
                            **NARROW_GCVIT)
    model.load_state_dict(weights)
    libs = _off_the_cpu(monkeypatch, (K, G))
    model = model.to(META).eval()
    dyn_int8.attach(model, weights, f32=True)
    with torch.no_grad():
        out = model(_meta(1, 224, 224, 3, dtype=dtype))
    assert out.shape == (1, 1)
    tag = "_mmf32" if mm == F32 else "_mmbf16"
    blocks = sum(NARROW_GCVIT["depths"])
    want_g = {f"{n}{tag}": blocks for n in ("ln_qkv", "window_attention", "proj_scale_residual")}
    want_k = {"ln_fc1_gelu_f32" if mm == F32 else "ln_fc1_gelu": blocks,
              f"fc2_scale_residual{tag}": blocks}
    assert G.LAUNCHES == {**{k: 0 for k in G.LAUNCHES}, **want_g}
    assert K.LAUNCHES == {**{k: 0 for k in K.LAUNCHES}, **want_k}
    assert sorted(set(libs[G].called + libs[K].called)) == sorted({**want_g, **want_k})
    x = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (1, 224, 224, 3))
                         .astype(np.float32))
    unfused, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1, dtype=dtype,
                              seed=0, fused_block=False, **NARROW_GCVIT)
    with torch.inference_mode():
        assert torch.isfinite(unfused.eval()(x).float()).all()


# ---------------------------------------------------------------------------
# TF32 off in the f32 forwards and steps
# ---------------------------------------------------------------------------
def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def test_tf32_scope_sets_and_restores_both_flags(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    eng = E.EnsembleEngine(device="cuda", compute_dtype=F32, verbose=0)
    with eng._precision():
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    with pytest.raises(ValueError, match="inside"):
        with f32_scope("cuda", F32):
            assert _flags() == (False, False)
            raise ValueError("inside")
    assert _flags() == (True, True)
    eng.close()
    for device, dtype in (("cuda", BF16), ("cpu", F32)):
        with f32_scope(device, dtype):
            assert _flags() == (True, True)


@pytest.mark.parametrize("dtype,inside", [(F32, (False, False)), (BF16, (True, True))])
def test_trainer_steps_in_the_tf32_scope(monkeypatch, dtype, inside):
    """``Trainer.train_step`` of an f32 model pointed at the card runs its
    step with both TF32 flags off and restores them; a bf16 model's step
    leaves them as they are. (The trainer is built on the CPU and pointed at
    the card after; the step itself is recorded, not run.)"""
    model, _ = create_model("convnext_tiny_in22k", input_size=(64, 64), nb_classes=1,
                            dtype=dtype, **NARROW_CONVNEXT)
    tr = Trainer(model, TrainConfig(), device="cpu")
    tr.device = CUDA
    seen = []
    monkeypatch.setattr(tr, "_train_step", lambda *args: seen.append(_flags()) or args[2])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert tr.train_step(None, None, 0.5) == 0.5
    assert seen == [inside] and _flags() == (True, True)
