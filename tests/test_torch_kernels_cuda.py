"""The port's CUDA kernels on the card against their plain PyTorch versions.

Marked ``cuda``: they build the kernels with nvcc and launch them, so they skip
where there is no CUDA device. The file itself needs only torch and the port
(not flax, not the JAX package), so it runs on a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""
import pytest
import torch

from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K


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
