"""f32 compute on CUDA (``VIPTPU_DTYPE=float32``), checked on the CPU.

On CUDA the f32 path runs GCViT and ConvNeXt on their unfused blocks, whose
kernels are the f32 modes of window attention (K8, the symbol
``window_attention_bhnd_f32``), the depthwise conv (K9,
``depthwise_conv_nhwc_f32``) and the LN (K10, ``layer_norm_f32``); the
fused block kernels, whose f32 mode is ROADMAP item A15b, refuse f32. The
kernels need the card (``test_torch_kernels_cuda.py`` holds them to their
plain versions there); here:

- each wrapper's choice of symbol by dtype, with the library replaced by a
  recorder and the tensors on the meta device (not the CPU, so the wrapper
  takes its kernel path; nothing is computed);
- the models' rule that an f32 GCViT or ConvNeXt on CUDA takes its
  unfused block unless its config forces a path (``_use_fused_block``),
  and the engine's f32 members, built on the CPU and run on the path that
  rule gives on CUDA, narrow, against the JAX package's f32 models (its
  unfused path off the TPU) within 1e-4;
- the refusals naming A15b: every fused-block wrapper given f32 on a
  non-CPU device (its plain version never runs), a narrow member forced
  onto its fused block, ``VIPTPU_INT8_KERNELS=1``;
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
from vip_cup_2022_tpu_torch.infer import engine as E
from vip_cup_2022_tpu_torch.models import convnext as convnext_model
from vip_cup_2022_tpu_torch.models import create_model, gcvit as gcvit_model, transfer_weights
from vip_cup_2022_tpu_torch.ops.kernels import block_int8 as B8
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G
from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L
from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA
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
# the fused blocks refuse f32 (A15b)
# ---------------------------------------------------------------------------
def _i8(n, c):
    return Int8Weight(_meta(n, c, dtype=torch.int8), _meta(n))


FUSED_F32_CALLS = {
    "dwconv7x7_nhwc": lambda: K.dwconv7x7_nhwc(_meta(2, 9, 9, 64), _meta(7, 7, 64), _meta(64)),
    "ln_fc1_gelu": lambda: K.ln_fc1_gelu(_meta(8, 64), _meta(64), _meta(64), _meta(256, 64),
                                         _meta(256), 1e-6),
    "fc2_scale_residual": lambda: K.fc2_scale_residual(_meta(8, 256), _meta(64, 256), _meta(64),
                                                       _meta(64), _meta(8, 64)),
    "ln_qkv": lambda: G.ln_qkv(_meta(98, 64), _meta(64), _meta(64), _meta(192, 64), _meta(192),
                               1e-5),
    "window_attention": lambda: G.window_attention(*[_meta(2, 98, 64)] * 3, _meta(2, 49, 49),
                                                   49, 32 ** -0.5),
    "proj_scale_residual": lambda: G.proj_scale_residual(_meta(98, 64), _meta(64, 64), _meta(64),
                                                         _meta(64), _meta(98, 64)),
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
PLAIN = {"dwconv7x7_nhwc": K, "ln_fc1_gelu": K, "fc2_scale_residual": K, "ln_qkv": G,
         "window_attention": G, "proj_scale_residual": G, "ln_qkv_int8": B8,
         "mlp_int8_scale_residual": B8, "fc2_scale_residual_int8": B8,
         "proj_scale_residual_int8": B8}


@pytest.mark.parametrize("name", sorted(FUSED_F32_CALLS))
def test_fused_wrappers_refuse_f32_naming_a15b(monkeypatch, name):
    """Off the CPU a fused-block wrapper given f32 activations raises
    ``NotImplementedError`` naming A15b, before its dtype checks, and runs
    no plain version in its place."""
    def no_plain(*args, **kwargs):
        raise AssertionError(f"{name} ran its plain version")

    monkeypatch.setattr(PLAIN[name], f"{name}_plain", no_plain)
    with pytest.raises(NotImplementedError, match="A15b"):
        FUSED_F32_CALLS[name]()


@pytest.mark.parametrize("name,size,narrow", [("GCViTTiny", 224, NARROW_GCVIT),
                                              ("convnext_tiny_in22k", 64, NARROW_CONVNEXT)])
def test_member_forced_onto_its_fused_block_in_f32_raises_a15b(monkeypatch, name, size, narrow):
    """A narrow f32 member with ``fused_block=True`` off the CPU (on the
    meta device, the unfused kernels' plain versions standing in for the
    LN and depthwise kernels, which compute shapes only there) reaches its
    first fused block and raises."""
    monkeypatch.setattr(L, "layer_norm", L.layer_norm_plain)
    monkeypatch.setattr(D, "depthwise_conv_nhwc", D.depthwise_conv_nhwc_plain)
    model, _ = create_model(name, input_size=(size, size), nb_classes=1, fused_block=True,
                            **narrow)
    model = model.to(META).eval()
    with pytest.raises(NotImplementedError, match="A15b"), torch.no_grad():
        model(_meta(1, size, size, 3))


def test_int8_kernels_with_f32_on_cuda_raise_a15b(monkeypatch):
    monkeypatch.setenv("VIPTPU_INT8_KERNELS", "1")
    f32_cuda = E.EnsembleEngine(device="cuda", compute_dtype=F32, verbose=0)
    with pytest.raises(NotImplementedError, match="A15b"):
        f32_cuda._int8_kernels()
    f32_cuda.close()
    for device, dtype in (("cuda", BF16), ("cpu", F32)):
        eng = E.EnsembleEngine(device=device, compute_dtype=dtype, verbose=0)
        assert eng._int8_kernels()
        eng.close()
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
    of a narrow GCViT at 224 and a narrow ConvNeXt at 64."""
    out = {}
    for name, size, kw, make in (
            ("GCViTTiny", 224, NARROW_GCVIT, _jax_gcvit),
            ("convnext_tiny_in22k", 64, NARROW_CONVNEXT, _jax_convnext)):
        kw = dict(nb_classes=1, classifier_activation=None, **kw)
        module, tree = make(seed=3, input_size=(size, size), **kw)[:2]
        x = np.random.RandomState(5).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
        out[name] = (size, kw, tree, x, np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x))))
    return out


def _as_on_cuda(monkeypatch, name):
    """Make ``name``'s model take, on the CPU, the block path its rule gives
    on CUDA, and make its fused block raise if it is called."""
    module, fused = FUSED[name]
    real = module._use_fused_block

    def on_cuda(cfg, training, device=None):
        return real(cfg, training, CUDA)

    def no_fused(*args, **kwargs):
        raise AssertionError(f"{name} took its fused block")

    monkeypatch.setattr(module, "_use_fused_block", on_cuda)
    monkeypatch.setattr(module, fused, no_fused)


@pytest.mark.parametrize("name", ["GCViTTiny", "convnext_tiny_in22k"])
def test_engine_builds_f32_members_on_their_unfused_blocks(jax_members, monkeypatch, name):
    """``VIPTPU_DTYPE=float32`` on CUDA: the engine builds the member in f32
    with the block path left to the model, which on CUDA takes the unfused
    block; run on the CPU on that path, the model equals the JAX package's
    f32 model within 1e-4."""
    size, kw, tree, x, want = jax_members[name]
    eng = E.EnsembleEngine(device="cuda", compute_dtype=F32, verbose=0)
    model, _ = eng._create_member(name, (size, size), dict(kw))
    eng.close()
    assert model.cfg.fused_block is None and model.cfg.dtype == F32
    transfer_weights(tree, model, strict=True)
    _as_on_cuda(monkeypatch, name)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name,narrow", [("GCViTTiny", NARROW_GCVIT),
                                         ("convnext_tiny_in22k", NARROW_CONVNEXT)])
def test_f32_on_cuda_takes_the_unfused_block_unless_forced(monkeypatch, name, narrow):
    """The models' rule: an f32 model on CUDA whose config leaves the block
    path to the default takes the unfused block (only it has f32 kernels
    there; the fused blocks' f32 mode is A15b); bf16 on CUDA and f32 on the
    CPU keep the fused default, a forced path stays forced (a forced fused
    block then raises A15b in its kernels), training is unfused always."""
    module, _ = FUSED[name]
    cfg = create_model(name, input_size=(224, 224), nb_classes=1, dtype=F32, **narrow)[1]
    monkeypatch.delenv("VIPTPU_NO_FUSED_BLOCK", raising=False)
    assert cfg.fused_block is None
    assert not module._use_fused_block(cfg, False, CUDA)
    assert module._use_fused_block(cfg, False, torch.device("cpu"))
    assert module._use_fused_block(cfg, False)
    assert module._use_fused_block(cfg.replace(dtype=BF16), False, CUDA)
    assert module._use_fused_block(cfg.replace(fused_block=True), False, CUDA)
    assert not module._use_fused_block(cfg.replace(fused_block=False), False, torch.device("cpu"))
    assert not module._use_fused_block(cfg, True, CUDA)


def test_trainer_evaluates_f32_on_cuda_on_the_unfused_block(monkeypatch):
    """The trainer leaves the model's config as it is: an f32 GCViT whose
    config leaves the block path to the default evaluates on CUDA on its
    unfused block by the model's rule, inside the TF32 scope. Built on the
    CPU, the trainer is pointed at the card after its construction, its
    tensors kept on the CPU, the model run on the path it takes on CUDA."""
    model, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1, **NARROW_GCVIT)
    tr = Trainer(model, TrainConfig(), device="cpu")
    assert tr.model.cfg.fused_block is None and tr.compute_dtype == F32
    tr.device = CUDA
    monkeypatch.setattr(tr, "_tensor", lambda a: torch.as_tensor(np.asarray(a)))
    _as_on_cuda(monkeypatch, "GCViTTiny")
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
