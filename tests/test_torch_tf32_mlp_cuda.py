"""The 3xTF32 f32 MLP kernels on the card against their plain versions.

``ln_fc1_gelu_f32``, ``fc2_scale_residual_f32`` and
``fc2_scale_residual_mmf32`` (``csrc/tf32_gemm.cuh``) at every main-path
shape (ConvNeXt's s1-s4, GCViTTiny's L1-L4) and batch 8, 256 and the fold
mode's 512, against the plain versions in f32 with TF32 off; the weight
pair given by the caller or made by the wrapper; the blocks' split cache on
the model path; the phase cuts and ``tools/exp_f32_mlp.py``. Marked ``cuda``: they build the kernels with nvcc
and launch them, so they skip where there is no CUDA device. The file needs
only torch and the port (not the JAX package), so it runs on a machine with
the card:

    python -m pytest tests/test_torch_tf32_mlp_cuda.py -m cuda -q
"""
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.models import create_model
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels.tf32 import tf32_weight
from vip_cup_2022_tpu_torch.quant import dyn_int8

F32_BOUND = 1e-5  # of max|ref|: f32 products kept to about 22 bits, sums in another order
BF16_BOUND = 2.0 ** -8  # of max|ref|: the mmf32 output rounded once to bf16
# name: tokens a side, C, N / C, LN eps (ConvNeXt at 200 px, GCViTTiny at 224)
SHAPES = {"s1": (99, 96, 4, 1e-6), "s2": (49, 192, 4, 1e-6), "s3": (24, 384, 4, 1e-6),
          "s4": (12, 768, 4, 1e-6), "L1": (56, 64, 3, 1e-5), "L2": (28, 128, 3, 1e-5),
          "L3": (14, 256, 3, 1e-5), "L4": (7, 512, 3, 1e-5)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, ref):
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _inputs(dev, m, c, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(s, lo=-1.0, hi=1.0):
        return torch.rand(s, generator=g, device=dev) * (hi - lo) + lo

    return dict(x=u((m, c)), lg=u((c,), 0.5, 1.5), lb=u((c,), -0.1, 0.1),
                w1=u((n, c)) * c ** -0.5, b1=u((n,), -0.1, 0.1), w2=u((c, n)) * n ** -0.5,
                b2=u((c,), -0.1, 0.1), gamma=u((c,), 0.5, 1.5), res=u((m, c)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("batch", [8, 256, 512])
def test_tf32_mlp_kernels_match_plain_on_card(cuda_device, shape, batch):
    grid, c, ratio, eps = SHAPES[shape]
    m, n = batch * grid * grid, ratio * c
    p = _inputs(cuda_device, m, c, n, seed=batch + c)
    s1, s2 = tf32_weight(p["w1"]), tf32_weight(p["w2"])
    K.reset_launches()
    hid = K.ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], eps, w_split=s1)
    out = K.fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"], w_split=s2)
    mm = K.fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"],
                              out_dtype=torch.bfloat16, w_split=s2)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ln_fc1_gelu_f32"] == 1 and K.LAUNCHES["fc2_scale_residual_f32"] == 1
    assert K.LAUNCHES["fc2_scale_residual_mmf32"] == 1
    assert hid.dtype == out.dtype == torch.float32 and mm.dtype == torch.bfloat16
    assert _rel(hid, K.ln_fc1_gelu_plain(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], eps)) \
        <= F32_BOUND
    ref = K.fc2_scale_residual_plain(hid, p["w2"], p["b2"], p["gamma"], p["res"])
    assert _rel(out, ref) <= F32_BOUND
    assert _rel(mm, ref) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("c,ratio,m", [(32, 4, 77), (96, 4, 1), (64, 3, 129), (768, 4, 300)])
def test_tf32_split_given_or_made_gives_the_same_bits(cuda_device, c, ratio, m):
    """The wrapper's own split (a caller passing only w) runs the same kernel
    on the same pair as the blocks' cache: equal outputs."""
    n = ratio * c
    p = _inputs(cuda_device, m, c, n, seed=c)
    hid = K.ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6)
    assert torch.equal(hid, K.ln_fc1_gelu(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6,
                                          w_split=tf32_weight(p["w1"])))
    out = K.fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"])
    assert torch.equal(out, K.fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"],
                                                 w_split=tf32_weight(p["w2"])))
    with pytest.raises(ValueError, match="shape"):
        K.fc2_scale_residual(hid, p["w2"], p["b2"], p["gamma"], p["res"],
                             w_split=tf32_weight(p["w1"]))


@pytest.mark.cuda
def test_f32_blocks_split_their_weights_once(cuda_device, monkeypatch):
    """A narrow f32 ConvNeXt on the card: its fused blocks pass their cached
    pairs (two splits a block, on the first forward only; a weight written
    in place is split again), and its output holds to the plain forward."""
    made = []
    real = dyn_int8.tf32_weight
    monkeypatch.setattr(dyn_int8, "tf32_weight", lambda w: made.append(w.shape) or real(w))
    model, _ = create_model("convnext_tiny_in22k", input_size=(64, 64), nb_classes=1,
                            classifier_activation=None, dtype=torch.float32, seed=0,
                            embed_dim=(32, 64, 96, 128), nb_blocks=(1, 1, 2, 1))
    model = model.to(cuda_device).eval()
    x = torch.rand((3, 64, 64, 3), device=cuda_device)
    K.reset_launches()
    with torch.inference_mode():
        first = model(x)
        second = model(x)
    assert len(made) == 2 * 5 and torch.equal(first, second)
    assert K.LAUNCHES["ln_fc1_gelu_f32"] == K.LAUNCHES["fc2_scale_residual_f32"] == 10
    with torch.no_grad():
        model.stages_2_blocks_1.mlp_fc2.weight.mul_(0.5)
    with torch.inference_mode():
        model(x)
    assert len(made) == 11


@pytest.mark.cuda
def test_f32_mlp_yardsticks_cuts_and_tool_run_on_card(cuda_device):
    """Every phase cut launches; the tool runs end to end at a small batch
    (its own checks against the plain versions included). Its yardstick is
    cuBLAS's f32 product (the FFMA kernels it once held beside the 3xTF32
    ones are gone with csrc/f32_gemm.cuh)."""
    from vip_cup_2022_tpu_torch.tools import exp_f32_mlp

    p = _inputs(cuda_device, 200, 96, 384, seed=5)
    ref = K.ln_fc1_gelu_plain(p["x"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6)
    s1, s2 = tf32_weight(p["w1"]), tf32_weight(p["w2"])
    for cut in K.TF32_CUTS:
        K.tf32_mlp_cut("gelu", cut, p["x"], s1, p["b1"], ln_weight=p["lg"], ln_bias=p["lb"],
                       eps=1e-6)
        K.tf32_mlp_cut("res", cut, ref, s2, p["b2"], gamma=p["gamma"], residual=p["res"])
    torch.cuda.synchronize()
    results = exp_f32_mlp.run(batch=2, check_batches=(1,), cuts=True)
    assert set(results["shapes"]) == set(exp_f32_mlp.SHAPES)
    assert all(t > 0 for r in results["shapes"].values() for t in r["ms"].values())
