"""The port's LN-MLP kernels (K3 ``fused_ln_mlp_residual``, K12
``lnmlp_batchlane`` / ``lnmlp_chanfirst``) and its ``exp_convnext_s12``
tool, on the CPU.

The wrappers run their plain PyTorch versions for CPU tensors; those are held
to the Pallas kernels run in interpret mode, f32 on both sides, atol 1e-5.
K3 takes ``interpret=True``; the JAX tool's K12 functions take no such
argument, so ``pallas_call`` is wrapped to force it for the test. Shapes are
ragged against the TPU tiles: position counts that are not multiples of
``tp`` = 8, row counts below ``row_tile`` and ``lane_tile``, batch 3. The
kernels themselves need the card: ``test_torch_kernels_cuda.py`` holds them
to the plain versions there.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.ops.pallas.convnext_block import fused_ln_mlp_residual as jax_lnmlp
from vip_cup_2022_tpu_torch.ops.kernels import ln_mlp as LM
from vip_cup_2022_tpu_torch.tools import exp_convnext_s12 as T

ATOL = 1e-5  # f32 on both sides


@pytest.fixture
def jax_tool(monkeypatch):
    """The JAX ``tools/exp_convnext_s12.py`` with every ``pallas_call`` in
    interpret mode and its compilation cache off."""
    monkeypatch.setenv("VIPTPU_NO_JIT_CACHE", "1")
    real = pl.pallas_call

    def interpreted(*args, **kwargs):
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    return importlib.import_module("tools.exp_convnext_s12")


def _params(c, rng):
    """The JAX tool's parameters (its convention) and the port's in f32."""
    p = T.make_params(c, 4 * c, rng)
    return p, T.torch_params(p, torch.float32, "cpu")


def _mlp(P):
    return (P["g"], P["b"], P["w1"], P["b1"], P["w2"], P["b2"], P["ls"])


def _jmlp(p):
    return tuple(jnp.asarray(p[k]) for k in ("g", "b", "w1", "b1", "w2", "b2", "ls"))


@pytest.mark.parametrize("shape", [(3, 5, 7, 32), (3, 2, 5, 96)])
def test_fused_ln_mlp_residual_plain_matches_pallas(shape):
    rng = np.random.RandomState(shape[-1])
    p, P = _params(shape[-1], rng)
    x, r = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    want = jax_lnmlp(jnp.asarray(x), jnp.asarray(r), *_jmlp(p), gelu="erf", interpret=True)
    LM.reset_launches()
    got = LM.fused_ln_mlp_residual(torch.from_numpy(x), torch.from_numpy(r), *_mlp(P))
    assert got.shape == shape and got.dtype == torch.float32
    assert LM.LAUNCHES == {"fused_ln_mlp_residual": 0, "lnmlp_batchlane": 0, "lnmlp_chanfirst": 0}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", [(3, 5, 32, 3), (2, 5, 96, 3)])  # (H, W, C, B); 15, 10 positions
def test_lnmlp_batchlane_plain_matches_pallas(jax_tool, shape):
    rng = np.random.RandomState(shape[2])
    p, P = _params(shape[2], rng)
    x, r = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    want = jax_tool.lnmlp_batchlane(jnp.asarray(x), jnp.asarray(r), *_jmlp(p))
    got = LM.lnmlp_batchlane(torch.from_numpy(x), torch.from_numpy(r), *_mlp(P))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", [(32, 3, 5, 3), (96, 2, 5, 3)])  # (C, H, W, B)
def test_lnmlp_chanfirst_plain_matches_pallas(jax_tool, shape):
    rng = np.random.RandomState(shape[0] + 1)
    p, P = _params(shape[0], rng)
    x, r = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    want = jax_tool.lnmlp_chanfirst(jnp.asarray(x), jnp.asarray(r), *_jmlp(p))
    got = LM.lnmlp_chanfirst(torch.from_numpy(x), torch.from_numpy(r), *_mlp(P))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_the_three_layouts_compute_one_function():
    """The same rows through the three wrappers: the outputs are the same
    tensor up to the layout permutation."""
    rng = np.random.RandomState(7)
    _, P = _params(32, rng)
    x = torch.from_numpy(rng.randn(3, 5, 7, 32).astype(np.float32))
    rows = LM.fused_ln_mlp_residual(x, x, *_mlp(P))
    xt = x.permute(*LM.LAYOUTS["lnmlp_batchlane"]).contiguous()
    xc = x.permute(*LM.LAYOUTS["lnmlp_chanfirst"]).contiguous()
    torch.testing.assert_close(LM.lnmlp_batchlane(xt, xt, *_mlp(P)).permute(3, 0, 1, 2), rows,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(LM.lnmlp_chanfirst(xc, xc, *_mlp(P)).permute(3, 1, 2, 0), rows,
                               rtol=0, atol=1e-6)


def test_make_params_is_the_jax_tools(jax_tool):
    ours = T.make_params(96, 384, np.random.RandomState(0))
    theirs = jax_tool.make_params(96, 384, np.random.RandomState(0))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))
    assert {k: v[:3] for k, v in T.SHAPES.items()} == {
        "s1": (99, 99, 96), "s2": (49, 49, 192), "s3": (25, 25, 384), "s4": (13, 13, 768)}


@pytest.mark.parametrize("variant,jax_variant", [
    ("eager", "xla"), ("lnmlp", "lnmlp"), ("hyb_nhwc", "hyb_nhwc"), ("hyb_hwcn", "hyb_hwcn"),
    ("hyb_chwn", "hyb_chwn"),
])
def test_tool_variants_match_the_jax_tools(jax_tool, monkeypatch, variant, jax_variant):
    """The port's tool variants on the CPU (plain versions behind the
    wrappers, a true depthwise conv) against the JAX tool's (block-diagonal
    conv, Pallas kernels in interpret mode), f32. VIPTPU_GELU=erf: the JAX
    K3 otherwise takes its polynomial erf; K12's kernels use the A&S erf."""
    monkeypatch.setenv("VIPTPU_GELU", "erf")
    c = 32
    rng = np.random.RandomState(0)
    p = T.make_params(c, 4 * c, rng)
    P = T.torch_params(p, torch.float32, "cpu")
    x = rng.randn(3, 9, 11, c).astype(np.float32)
    v, vt, vc = jax_tool.build_variants({k: jnp.asarray(a) for k, a in p.items()}, c,
                                        {jax_variant})
    fn = {**v, **vt, **vc}[jax_variant]
    perm = T.LAYOUTS.get(variant, (0, 1, 2, 3))
    want = np.asarray(fn(jnp.transpose(jnp.asarray(x), perm)))
    xin = T.to_layout(torch.from_numpy(x), variant)
    got = T.build_variants(P)[variant](xin)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_tool_exits_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        T.main(["s1", "--iters", "1"])
