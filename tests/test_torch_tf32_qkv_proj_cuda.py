"""GCViT's 3xTF32 qkv and proj kernels on the card against their plain versions.

``ln_qkv_f32``, ``ln_qkv_mmf32``, ``proj_scale_residual_f32`` and
``proj_scale_residual_mmf32`` (``csrc/tf32_gemm.cuh``, kinds kQkv and
kResidual) at GCViTTiny's L1-L4, local and global query, batch 8 (ragged row
tiles), 256 and the fold mode's 512, against the plain versions in f32 with
TF32 off; the weight pair given by the caller or made by the wrapper; a
narrow f32 GCViT's blocks splitting their four weights once; the phase cuts
of the f32 kinds. Marked ``cuda``: they build the kernels with nvcc and
launch them, so they skip where there is no CUDA device. The file needs only
torch and the port (not the JAX package):

    python -m pytest tests/test_torch_tf32_qkv_proj_cuda.py -m cuda -q
"""
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.models import create_model
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G
from vip_cup_2022_tpu_torch.ops.kernels.tf32 import tf32_weight
from vip_cup_2022_tpu_torch.quant import dyn_int8

F32_BOUND = 1e-5  # of max|ref|: f32 products kept to about 22 bits, sums in another order
LEVELS = {"L1": (56, 64), "L2": (28, 128), "L3": (14, 256), "L4": (7, 512)}  # side, C at 224
MODES = {"f32": torch.float32, "mmf32": torch.bfloat16}  # mode -> the activations' dtype


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, ref):
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _inputs(dev, m, c, act, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(s, lo=-1.0, hi=1.0):
        return torch.rand(s, generator=g, device=dev) * (hi - lo) + lo

    return dict(x=u((m, c)).to(act), lg=u((c,), 0.5, 1.5), lb=u((c,), -0.1, 0.1),
                w=u((3 * c, c)) * c ** -0.5, b=u((3 * c,), -0.1, 0.1), a=u((m, c)).to(act),
                wp=u((c, c)) * c ** -0.5, bp=u((c,), -0.1, 0.1), gamma=u((c,), 0.5, 1.5))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("level", list(LEVELS))
@pytest.mark.parametrize("batch", [8, 256, 512])
def test_qkv_and_proj_kernels_match_plain_on_card(cuda_device, mode, level, batch):
    grid, c = LEVELS[level]
    act, f32 = MODES[mode], torch.float32
    m = batch * grid * grid
    p = _inputs(cuda_device, m, c, act, seed=batch + c)
    G.reset_launches()
    local = G.ln_qkv(p["x"], p["lg"], p["lb"], p["w"], p["b"], 1e-5, mm_dtype=f32,
                     w_split=tf32_weight(p["w"]))
    glob = G.ln_qkv(p["x"], p["lg"], p["lb"], p["w"][c:], p["b"][c:], 1e-5, mm_dtype=f32,
                    w_split=tf32_weight(p["w"][c:]))
    r1 = G.proj_scale_residual(p["a"], p["wp"], p["bp"], p["gamma"], p["x"], mm_dtype=f32,
                               w_split=tf32_weight(p["wp"]))
    torch.cuda.synchronize()
    sfx = "_f32" if mode == "f32" else "_mmf32"
    assert G.LAUNCHES["ln_qkv" + sfx] == 2 and G.LAUNCHES["proj_scale_residual" + sfx] == 1
    assert sum(G.LAUNCHES.values()) == 3
    for got, w, b in ((local, p["w"], p["b"]), (glob, p["w"][c:], p["b"][c:])):
        ref = G.ln_qkv_plain(p["x"], p["lg"], p["lb"], w, b, 1e-5, mm_dtype=f32)
        assert len(got) == len(ref) and all(t.dtype == f32 for t in got)
        assert _rel(torch.cat(got, 1), torch.cat(ref, 1)) <= F32_BOUND
        del ref
    ref = G.proj_scale_residual_plain(p["a"], p["wp"], p["bp"], p["gamma"], p["x"], f32)
    assert r1.dtype == f32 and _rel(r1, ref) <= F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("c,m", [(32, 77), (96, 1), (64, 129), (512, 300)])
def test_qkv_and_proj_split_given_or_made_gives_the_same_bits(cuda_device, mode, c, m):
    """The wrapper's own split (a caller passing only w) runs the same kernel
    on the same pair as the blocks' cache: equal outputs; a pair of another
    shape is refused."""
    p = _inputs(cuda_device, m, c, MODES[mode], seed=c)
    f32 = torch.float32
    made = G.ln_qkv(p["x"], p["lg"], p["lb"], p["w"], p["b"], 1e-5, mm_dtype=f32)
    given = G.ln_qkv(p["x"], p["lg"], p["lb"], p["w"], p["b"], 1e-5, mm_dtype=f32,
                     w_split=tf32_weight(p["w"]))
    assert all(torch.equal(a, b) for a, b in zip(made, given))
    r1 = G.proj_scale_residual(p["a"], p["wp"], p["bp"], p["gamma"], p["x"], mm_dtype=f32)
    assert torch.equal(r1, G.proj_scale_residual(p["a"], p["wp"], p["bp"], p["gamma"], p["x"],
                                                 mm_dtype=f32, w_split=tf32_weight(p["wp"])))
    with pytest.raises(ValueError, match="shape"):
        G.proj_scale_residual(p["a"], p["wp"], p["bp"], p["gamma"], p["x"], mm_dtype=f32,
                              w_split=tf32_weight(p["w"]))


@pytest.mark.cuda
def test_f32_gcvit_blocks_split_their_four_weights_once(cuda_device, monkeypatch):
    """A narrow f32 GCViT on the card: its fused blocks pass their cached
    pairs (four splits a block, on the first forward only), and its output
    is the same on the second forward."""
    made = []
    real = dyn_int8.tf32_weight
    monkeypatch.setattr(dyn_int8, "tf32_weight", lambda w: made.append(w.shape) or real(w))
    model, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1,
                            classifier_activation=None, dtype=torch.float32, seed=0, dim=32,
                            num_heads=(1, 2, 4, 8), depths=(2, 1, 1, 1))
    model = model.to(cuda_device).eval()
    x = torch.rand((2, 224, 224, 3), device=cuda_device)
    G.reset_launches()
    with torch.inference_mode():
        first = model(x)
        second = model(x)
    assert len(made) == 4 * 5 and torch.equal(first, second)
    assert G.LAUNCHES["ln_qkv_f32"] == G.LAUNCHES["proj_scale_residual_f32"] == 10


@pytest.mark.cuda
@pytest.mark.parametrize("level", list(LEVELS))
def test_qkv_and_proj_phase_cuts_launch(cuda_device, level):
    grid, c = LEVELS[level]
    p = _inputs(cuda_device, 4 * grid * grid, c, torch.float32, seed=c)
    sq, sp = tf32_weight(p["w"]), tf32_weight(p["wp"])
    for cut in K.TF32_CUTS:
        K.tf32_mlp_cut("qkv", cut, p["x"], sq, p["b"], ln_weight=p["lg"], ln_bias=p["lb"],
                       eps=1e-5)
        K.tf32_mlp_cut("proj", cut, p["a"], sp, p["bp"], gamma=p["gamma"], residual=p["x"])
    torch.cuda.synchronize()
