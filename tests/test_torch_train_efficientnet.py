"""EfficientNetV2T's and EfficientNetV1B4's training forms in the port
against the JAX package, on the CPU: ``test_torch_train_members.py``'s
tests of a member (the narrow ``test_torch_efficientnet.NARROW``, V2T at
64 px with a second block in stage 3 and drop-connect 0.2, V1B4 at 57 px
with the registry's 0.2 / 0.4), and the training forward's K9 calls: every
stride-1 depthwise conv reaches the depthwise wrapper with its padding
resolved at the call's size, the strided ones do not."""
import os
import sys

import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu_torch.models import create_model
from vip_cup_2022_tpu_torch.ops.conv import DepthwiseConv
from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_train_members import MemberTraining, _kw  # noqa: E402


class TestEfficientNetV2T(MemberTraining):
    NAME = "EfficientNetV2T"


class TestEfficientNetV1B4(MemberTraining):
    NAME = "EfficientNetV1B4"


def test_training_runs_k9_at_each_stride_1_depthwise_conv(monkeypatch):
    """V1B4 at 57 px (TF ``SAME``, odd sides): the training forward calls
    the depthwise wrapper once per stride-1 ``DepthwiseConv`` with its
    k x k taps and the symmetric k // 2 padding, under autograd; the
    backward reaches it no more."""
    calls = []

    def dw(x, kern, *, padding):
        calls.append((kern.shape[0], padding, x.requires_grad))
        return D.depthwise_conv_nhwc_plain(x, kern, padding=padding)

    monkeypatch.setattr(D, "depthwise_conv_nhwc", dw)
    model, _ = create_model("EfficientNetV1B4", **_kw("EfficientNetV1B4"))
    sites = [m for m in model.modules() if isinstance(m, DepthwiseConv) and m.stride == 1]
    model.train()(torch.rand(2, 57, 57, 3)).sum().backward()
    assert len(calls) == len(sites) > 0
    assert calls == [(m.weight.shape[0], ((m.weight.shape[0] // 2,) * 2,) * 2, True)
                     for m in sites]
