"""The port's training pieces below the trainer, on the CPU, against the JAX
package: the autograd functions of K8 (window attention), K9 (depthwise)
and K10 (LN) against ``jax.vjp`` of the JAX functions the JAX model trains
through; DropPath and Dropout fed the same uniforms; BatchNorm's training
form; mixup and cutmix fed JAX's draws; the losses; the lr schedules; the
unfused GCViT modules' dropouts and in-graph rel-pos bias. f32 on both
sides unless a test says otherwise; each tolerance is stated where it is
used."""
import importlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.ops.drop import DropPath as JaxDropPath
from vip_cup_2022_tpu.ops.norms import BatchNorm as JaxBatchNorm
from vip_cup_2022_tpu.ops.pallas.norms import _bwd as jax_ln_bwd
from vip_cup_2022_tpu.ops.pallas.window_attention import window_attention as jax_window_attention
from vip_cup_2022_tpu.train import losses as jax_losses
from vip_cup_2022_tpu.train import schedules as jax_schedules
from vip_cup_2022_tpu_torch.ops import drop
from vip_cup_2022_tpu_torch.ops.attention import WindowAttention
from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D
from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L
from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA
from vip_cup_2022_tpu_torch.ops.norms import BatchNorm
from vip_cup_2022_tpu_torch.train import losses, schedules

# the packages re-export the function ``mixup`` under the module's name
jax_mixup = importlib.import_module("vip_cup_2022_tpu.train.mixup")
mixup = importlib.import_module("vip_cup_2022_tpu_torch.train.mixup")

ATOL = 1e-5  # f32 on both sides, sums of a few hundred terms in other orders


def _u(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


# ---------------------------------------------------------------------------
# K8, K9, K10 under autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,heads,n", [(3, 2, 49), (2, 4, 196)])
def test_window_attention_function_gradients_match_jax_vjp(b, heads, n):
    """d(q, k, v, bias) of the port's function (the plain version's
    gradient, recomputed) against ``jax.vjp`` of the JAX ``window_attention``
    on its XLA path, the one the JAX model trains through; GCViT's head
    width 32 and windows 7 and 14."""
    rng = np.random.RandomState(n)
    q, k, v = (_u(rng, (b, heads, n, 32)) for _ in range(3))
    bias, dout = _u(rng, (heads, n, n)), _u(rng, (b, heads, n, 32))
    scale = 32 ** -0.5
    out, vjp = jax.vjp(lambda *a: jax_window_attention(*a, scale), *map(jnp.asarray,
                                                                          (q, k, v, bias)))
    want = vjp(jnp.asarray(dout))
    ts = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    got = WA.window_attention_fn(*ts, scale)
    _close(got.detach(), out)
    got.backward(_t(dout))
    for t, ref in zip(ts, want):
        _close(t.grad, ref)


def test_window_attention_bare_wrapper_still_refuses_autograd_on_the_card():
    """The bare wrapper keeps its guard (it is the Function's forward, which
    runs with grad off); on the CPU it is the plain version either way."""
    q = torch.zeros((1, 1, 4, 32), requires_grad=True)
    bias = torch.zeros((1, 4, 4))
    out = WA.window_attention_fn(q, q.detach(), q.detach(), bias, 0.1)
    assert out.requires_grad and out.grad_fn.name().endswith("WindowAttentionFunctionBackward")


@pytest.mark.parametrize("k,padding,c", [
    (3, ((1, 1), (1, 1)), 24),   # GCViT's branch conv
    (5, ((2, 2), (2, 2)), 16),
    (3, ((0, 2), (1, 0)), 6),    # asymmetric, as TF-SAME pads
])
def test_depthwise_function_gradients_match_jax_vjp(k, padding, c):
    """dx and d(taps) of the port's function (the closed form) against
    ``jax.vjp`` of XLA's grouped conv, the depthwise the JAX model trains
    through, and against the plain version's own autograd."""
    rng = np.random.RandomState(k * c)
    x, kern = _u(rng, (2, 9, 11, c)), _u(rng, (k, k, 1, c))
    y, vjp = jax.vjp(lambda x_, k_: jax.lax.conv_general_dilated(
        x_, k_, (1, 1), padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c), jnp.asarray(x), jnp.asarray(kern))
    dy = _u(rng, y.shape)
    dx_ref, dk_ref = vjp(jnp.asarray(dy))
    xt, kt = _t(x).requires_grad_(), _t(kern).requires_grad_()
    out = D.depthwise_conv_fn(xt, kt, padding=padding)
    _close(out.detach(), y)
    out.backward(_t(dy))
    _close(xt.grad, dx_ref)
    _close(kt.grad, dk_ref)
    assert kt.grad.shape == kt.shape
    xp, kp = _t(x).requires_grad_(), _t(kern).requires_grad_()
    D.depthwise_conv_nhwc_plain(xp, kp, padding=padding).backward(_t(dy))
    _close(xt.grad, xp.grad, 1e-6)
    _close(kt.grad, kp.grad, 1e-6)


def test_depthwise_closed_form_gradient_keeps_the_dtypes():
    """bf16 x and taps in, bf16 dx and taps' gradient out, summed in f32."""
    rng = np.random.RandomState(0)
    x = _t(_u(rng, (2, 6, 6, 8))).bfloat16()
    kern = _t(_u(rng, (3, 3, 8))).bfloat16()
    dy = _t(_u(rng, (2, 6, 6, 8))).bfloat16()
    dx, dk = D.depthwise_conv_nhwc_plain_grad(x, kern, dy, padding=((1, 1), (1, 1)))
    assert dx.dtype == dk.dtype == torch.bfloat16 and dk.shape == kern.shape
    fx, fk = D.depthwise_conv_nhwc_plain_grad(x.float(), kern.float(), dy.float(),
                                              padding=((1, 1), (1, 1)))
    _close(dx.float(), fx, 2e-2)  # one bf16 rounding of each sum
    _close(dk.float(), fk, 2e-2 * float(fk.abs().max()))


@pytest.mark.parametrize("c", [64, 128])
def test_layer_norm_function_trains_in_bf16_like_the_jax_custom_vjp(c):
    """bf16 activations under training: the gradients of the port's LN
    function against the JAX ``custom_vjp`` backward on the same bf16 x
    (dx in bf16 on both sides: within 1e-2 of max|ref|, two bf16 roundings;
    dgamma and dbeta in f32: 1e-3 of max|ref|, sums over the rows of
    products of a bf16 dy)."""
    rng = np.random.RandomState(c)
    x = _t(_u(rng, (4, 7, c), -2, 2)).bfloat16()
    dy = _t(_u(rng, (4, 7, c))).bfloat16()
    g, b = _u(rng, (c,), 0.5, 1.5), _u(rng, (c,), -0.1, 0.1)
    to_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    want = jax_ln_bwd(1e-5, (to_jax(x), jnp.asarray(g), jnp.asarray(b)), to_jax(dy))
    xt, gt, bt = x.clone().requires_grad_(), _t(g).requires_grad_(), _t(b).requires_grad_()
    y = L.fused_layernorm(xt, gt, bt, 1e-5)
    assert y.dtype == torch.bfloat16
    y.backward(dy)
    assert xt.grad.dtype == torch.bfloat16
    for got, ref, rel in ((xt.grad, want[0], 1e-2), (gt.grad, want[1], 1e-3),
                          (bt.grad, want[2], 1e-3)):
        ref = np.asarray(ref, np.float32)
        _close(got.float(), ref, rel * np.abs(ref).max())


# ---------------------------------------------------------------------------
# DropPath, Dropout, BatchNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rate", [0.0, 0.2, 0.5])
def test_drop_path_matches_jax_given_its_uniforms(rate):
    """The JAX module draws ``uniform(rng, (B, 1, 1, 1))``; the same numbers
    as the port's ``noise`` give the same output. Eval mode and rate 0 are
    the identity."""
    rng = np.random.RandomState(1)
    x = _u(rng, (6, 3, 4, 5))
    key = jax.random.PRNGKey(7)
    want = JaxDropPath(rate).apply({}, jnp.asarray(x), training=True, rngs={"dropout": key})
    u = np.asarray(nn.initializers.uniform(scale=1.0)(_flax_key(key), (6, 1, 1, 1),
                                                      jnp.float32))
    module = drop.DropPath(rate).train()
    got = module(_t(x), noise=_t(u))
    _close(got, want, 1e-6)
    assert torch.equal(module.eval()(_t(x)), _t(x))


def _flax_key(key, path=()):
    """The key ``make_rng("dropout")`` hands the first call of a Flax module
    at ``path`` (submodule names) under a top-level module applied with
    ``rngs={"dropout": key}``."""
    captured = {}

    class Leaf(nn.Module):
        @nn.compact
        def __call__(self):
            captured["key"] = self.make_rng("dropout")
            return jnp.zeros(())

    class Node(nn.Module):
        names: tuple

        @nn.compact
        def __call__(self):
            if len(self.names) == 1:
                return Leaf(name=self.names[0])()
            return Node(self.names[1:], name=self.names[0])()

    (Node(tuple(path)) if path else Leaf()).apply({}, rngs={"dropout": key})
    return captured["key"]


@pytest.mark.parametrize("rate", [0.1, 0.5, 1.0])
def test_dropout_matches_flax_given_its_uniforms(rate):
    """Flax keeps an element where ``bernoulli(keep)``, i.e. its uniform is
    below ``keep``, scaled by 1 / keep; all zeros at rate 1."""
    rng = np.random.RandomState(2)
    x = _u(rng, (4, 9))
    key = jax.random.PRNGKey(3)
    want = nn.Dropout(rate, deterministic=False).apply({}, jnp.asarray(x), rngs={"dropout": key})
    u = np.asarray(jax.random.uniform(_flax_key(key), (4, 9)))
    got = drop.Dropout(rate).train()(_t(x), noise=_t(u))
    _close(got, want, 1e-6)


def test_drop_modules_draw_from_their_generator():
    x = torch.ones(64, 8)
    a, b = drop.Dropout(0.5).train(), drop.Dropout(0.5).train()
    drop.set_generator(a, torch.Generator().manual_seed(0))
    drop.set_generator(b, torch.Generator().manual_seed(0))
    assert torch.equal(a(x), b(x))
    kept = (a(x) != 0).float().mean().item()
    assert 0.3 < kept < 0.7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_training_matches_jax_over_two_updates(dtype):
    """Output and running statistics after two training calls against the
    JAX BN with ``mutable=["batch_stats"]``: f32 batch mean and population
    variance over N, H, W, running = 0.9 running + 0.1 batch; then the eval
    form on the updated statistics. bf16 input: the same bf16 values on
    both sides, outputs within one bf16 rounding."""
    rng = np.random.RandomState(4)
    c = 12
    xs = [_u(rng, (3, 5, 4, c), -2, 3) for _ in range(2)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    module = JaxBatchNorm(epsilon=1e-3)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, c)))
    params = {"gamma": jnp.asarray(_u(rng, (c,), 0.5, 1.5)),
              "beta": jnp.asarray(_u(rng, (c,), -0.2, 0.2))}
    stats = variables["batch_stats"]
    port = BatchNorm(c, eps=1e-3)
    with torch.no_grad():
        port.weight.copy_(_t(np.asarray(params["gamma"])))
        port.bias.copy_(_t(np.asarray(params["beta"])))
    port.train()
    atol = 1.6e-2 * 4 if dtype == torch.bfloat16 else ATOL
    for x in xs:
        xj = jnp.asarray(x).astype(jdt)
        want, mut = module.apply({"params": params, "batch_stats": stats}, xj, training=True,
                                 mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = port(_t(np.asarray(xj.astype(jnp.float32))).to(dtype))
        assert got.dtype == dtype
        _close(got.float(), np.asarray(want, np.float32), atol)
        _close(port.running_mean, stats["moving_mean"], 1e-6)
        _close(port.running_var, stats["moving_variance"], 1e-6)
    want = module.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[0]))
    _close(port.eval()(_t(xs[0])), want)


def test_batchnorm_training_has_gradients_through_its_statistics():
    port = BatchNorm(4).train()
    x = torch.randn(2, 3, 3, 4, requires_grad=True)
    port(x).pow(2).sum().backward()
    assert x.grad is not None and port.weight.grad is not None


# ---------------------------------------------------------------------------
# mixup and cutmix, fed JAX's draws
# ---------------------------------------------------------------------------
def _jax_mixup_draws(key, b, alpha):
    k_w, k_s = jax.random.split(key)
    return dict(w=np.asarray(jax_mixup.sample_beta(k_w, (b,), alpha, alpha)),
                perm=np.asarray(jax.random.permutation(k_s, b)))


def _jax_cutmix_draws(key, b, hh, ww, alpha):
    k_w, k_y, k_x, k_s = jax.random.split(key, 4)
    return dict(w0=float(jax_mixup.sample_beta(k_w, (), alpha, alpha)),
                cy=int(jax.random.randint(k_y, (), 0, hh)),
                cx=int(jax.random.randint(k_x, (), 0, ww)),
                perm=np.asarray(jax.random.permutation(k_s, b)))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("min_mix_weight", [0.0, 0.3])
def test_mixup_matches_jax_given_its_draws(seed, min_mix_weight):
    rng = np.random.RandomState(seed)
    x, y = _u(rng, (8, 6, 7, 3), 0, 1), np.eye(4, dtype=np.float32)[rng.randint(0, 4, 8)]
    key = jax.random.PRNGKey(seed)
    wx, wy = jax_mixup.mixup(key, jnp.asarray(x), jnp.asarray(y), 0.4, min_mix_weight)
    gx, gy = mixup.mixup(_t(x), _t(y), 0.4, min_mix_weight, **_jax_mixup_draws(key, 8, 0.4))
    _close(gx, wx, 1e-6)
    _close(gy, wy, 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("min_mix_weight", [0.0, 0.4])
def test_cutmix_matches_jax_given_its_draws(seed, min_mix_weight):
    """The box (clipped at the borders), the area weight and the skip rule."""
    rng = np.random.RandomState(seed)
    x, y = _u(rng, (6, 16, 12, 3), 0, 1), np.eye(3, dtype=np.float32)[rng.randint(0, 3, 6)]
    key = jax.random.PRNGKey(seed)
    wx, wy = jax_mixup.cutmix(key, jnp.asarray(x), jnp.asarray(y), 0.5, min_mix_weight)
    gx, gy = mixup.cutmix(_t(x), _t(y), 0.5, min_mix_weight,
                          **_jax_cutmix_draws(key, 6, 16, 12, 0.5))
    _close(gx, wx, 0)
    _close(gy, wy, 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mixup_cutmix_switch_matches_jax(seed):
    """Both alphas set: JAX draws the switch's uniform from one half of the
    key and both ops' draws from the other."""
    rng = np.random.RandomState(seed)
    x, y = _u(rng, (4, 8, 8, 3), 0, 1), np.eye(2, dtype=np.float32)[rng.randint(0, 2, 4)]
    key = jax.random.PRNGKey(seed)
    wx, wy = jax_mixup.mixup_cutmix(key, jnp.asarray(x), jnp.asarray(y), 0.2, 0.8)
    k_switch, k_op = jax.random.split(key)
    gx, gy = mixup.mixup_cutmix(_t(x), _t(y), 0.2, 0.8, u=float(jax.random.uniform(k_switch)),
                                mixup_draws=_jax_mixup_draws(k_op, 4, 0.2),
                                cutmix_draws=_jax_cutmix_draws(k_op, 4, 8, 8, 0.8))
    _close(gx, wx, 1e-6)
    _close(gy, wy, 1e-6)


def test_mixup_draws_from_a_generator_by_default():
    x, y = torch.rand(8, 4, 4, 3), torch.eye(4)[torch.arange(8) % 4]
    a = mixup.mixup_cutmix(x, y, 0.4, 0.0, generator=torch.Generator().manual_seed(1))
    b = mixup.mixup_cutmix(x, y, 0.4, 0.0, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.allclose(a[1].sum(-1), torch.ones(8))
    xc, _ = mixup.cutmix(x, y, 0.5, generator=torch.Generator().manual_seed(2))
    assert xc.shape == x.shape


# ---------------------------------------------------------------------------
# losses and schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(target_threshold=0.2), dict(label_smoothing=0.1),
    dict(from_logits=False), dict(target_threshold=0.3, label_smoothing=0.2, from_logits=False),
])
def test_bce_timm_matches_jax(kw):
    rng = np.random.RandomState(6)
    y_true = _u(rng, (8, 5), 0, 1)
    logits = kw.get("from_logits", True)
    y_pred = _u(rng, (8, 5), -4, 4) if logits else _u(rng, (8, 5), 0.01, 0.99)
    want = jax_losses.binary_cross_entropy_timm(jnp.asarray(y_true), jnp.asarray(y_pred), **kw)
    _close(losses.binary_cross_entropy_timm(_t(y_true), _t(y_pred), **kw), want, 1e-6)


@pytest.mark.parametrize("name,args", [
    ("categorical_cross_entropy", dict(label_smoothing=0.0)),
    ("categorical_cross_entropy", dict(label_smoothing=0.1)),
    ("distill_kl_divergence", dict(temperature=10.0)),
    ("distill_kl_divergence", dict(temperature=2.0)),
    ("binary_accuracy", dict(threshold=0.5)),
    ("balanced_accuracy", dict(threshold=0.4)),
])
def test_losses_and_accuracies_match_jax(name, args):
    rng = np.random.RandomState(7)
    a, b = _u(rng, (16, 6), -3, 3), _u(rng, (16, 6), -3, 3)
    if name == "categorical_cross_entropy":
        a = np.eye(6, dtype=np.float32)[rng.randint(0, 6, 16)]
    elif name.endswith("accuracy"):
        a, b = (a > 0).astype(np.float32), _u(rng, (16, 6), 0, 1)
    want = getattr(jax_losses, name)(jnp.asarray(a), jnp.asarray(b), *args.values())
    _close(getattr(losses, name)(_t(a), _t(b), *args.values()), want, 1e-6)


@pytest.mark.parametrize("kw", [
    dict(lr_base=0.01, first_restart_step=4, steps_per_epoch=10, lr_min=1e-5),
    dict(lr_base=0.01, first_restart_step=3, steps_per_epoch=7, lr_min=1e-6, warmup_steps=1,
         cooldown_steps=1),
    dict(lr_base=0.1, first_restart_step=2, steps_per_epoch=5, lr_min=0.05),  # no restart
    dict(lr_base=0.1, first_restart_step=2, steps_per_epoch=5, lr_min=1e-4, t_mul=1.0),
    dict(lr_base=0.1, first_restart_step=2, steps_per_epoch=4, lr_min=1e-4, lr_warmup=1e-3,
         warmup_steps=2, m_mul=0.8),
])
def test_cosine_lr_scheduler_matches_jax(kw):
    """Every step of several cycles, within 1e-6 relative (the cosine in f32
    on both sides, by other libraries)."""
    ours, theirs = schedules.CosineLrScheduler(**kw), jax_schedules.CosineLrScheduler(**kw)
    for step in range(0, 300, 2):
        want = theirs(step)
        assert abs(ours(step) - want) <= 1e-6 * abs(want), step


@pytest.mark.parametrize("name,args", [
    ("cosine_decay", (0.1, 40, 0.01)),
    ("constant_scheduler", (0.1, (3, 6), 0.5, 2)),
    ("exp_scheduler", (0.1, 2, 0.8, 1e-3, 1)),
    ("multistep_schedule", (0.1, (2, 5), 0.1, 1)),
])
def test_schedules_match_jax(name, args):
    for step in range(0, 60, 3):
        want = float(getattr(jax_schedules, name)(step, *args))
        got = getattr(schedules, name)(step, *args)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), (step, got, want)


# ---------------------------------------------------------------------------
# the unfused GCViT modules in training
# ---------------------------------------------------------------------------
def test_window_attention_gathers_its_bias_in_the_graph_and_regathers_on_eval():
    """Training: the table gets a gradient through the gather; the buffer is
    not read. Back in eval mode, the buffer holds the moved table's bias."""
    torch.manual_seed(0)
    attn = WindowAttention(64, 2, 7, False, torch.float32)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_()
        for lin in (attn.qkv, attn.proj):
            lin.weight.normal_(std=0.1)
    attn.train()
    attn(torch.randn(3, 49, 64)).pow(2).sum().backward()
    grad = attn.relative_position_bias_table.grad
    assert grad is not None and grad.abs().sum() > 0
    with torch.no_grad():
        attn.relative_position_bias_table.add_(1.0)
    attn.eval()
    want = attn.relative_position_bias_table[
        torch.from_numpy(WA_index(7)).long()].reshape(49, 49, 2).permute(2, 0, 1)
    assert torch.equal(attn.bias_dense, want)


def WA_index(ws):
    from vip_cup_2022_tpu_torch.ops.attention import relative_position_index

    return relative_position_index(ws, ws).reshape(-1)


def test_window_attention_dropout_takes_the_plain_path_like_jax():
    """attn_drop > 0 in training: the JAX module's einsum path (q scaled in
    the compute dtype) with its dropout; with the dropout's uniforms all
    kept (noise 0) it equals the Flax module in training."""
    from vip_cup_2022_tpu.ops.attention import WindowAttention as JaxWindowAttention
    from vip_cup_2022_tpu_torch.weights.from_jax import state_dict_from_flax

    rng = np.random.RandomState(8)
    x = _u(rng, (2, 49, 64))
    jmod = JaxWindowAttention(window_size=7, num_heads=2, attn_drop=0.3)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["relative_position_bias_table"] = _u(rng, params["relative_position_bias_table"].shape)
    key = jax.random.PRNGKey(1)
    want = jmod.apply({"params": params}, jnp.asarray(x), training=True, rngs={"dropout": key})
    port = WindowAttention(64, 2, 7, False, torch.float32, attn_drop=0.3)
    port.load_state_dict(state_dict_from_flax({"params": params}, port.state_dict()), strict=True)
    port.train()
    mask_u = np.asarray(jax.random.uniform(_flax_key(key, ("Dropout_0",)), (2, 2, 49, 49)))
    original = port.attn_drop.forward
    port.attn_drop.forward = lambda t: original(t, noise=_t(mask_u))
    _close(port(_t(x)).detach(), want, 1e-5)
