"""A narrow ConvNeXt's unfused block path and training step in the port
against the JAX package, on the CPU.

The narrow ConvNeXt (widths 32 / 64 / 128 / 256, one block a stage) at
32 px, f32, batch 2, one output, every leaf perturbed as
``test_torch_slice._perturb`` does (layer scale ~ U(0.5, 1.5)): the unfused
forward against the JAX forward and against the port's fused path within
1e-4; the block path's choice; the training step's K9 and K10 calls; the
loss and every gradient at the start against ``jax.value_and_grad`` of the
JAX loss, DropPath at the registry's 0.1 with JAX's masks fed to the port;
two AdamW steps against the JAX trainer's jitted step (its masks fed
likewise); and a checkpoint the port's trainer writes, read by the JAX
package, against the port's eval logits. The tolerances and the Adam
rounding-noise rule are ``test_torch_train_step.py``'s. The JAX side runs
once, in a module-scoped fixture."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.parallel.mesh import get_mesh, replicated
from vip_cup_2022_tpu.train import TrainConfig as JaxTrainConfig
from vip_cup_2022_tpu.train import Trainer as JaxTrainer
from vip_cup_2022_tpu.train.losses import binary_cross_entropy_timm as jax_bce
from vip_cup_2022_tpu.utils.checkpoint import load_variables as jax_load_variables
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.models.convnext import ConvNeXtConfig, _use_fused_block
from vip_cup_2022_tpu_torch.ops.drop import DropPath, Dropout
from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D
from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer
from vip_cup_2022_tpu_torch.train.sam import value_and_grad
from vip_cup_2022_tpu_torch.weights.to_flax import torch_to_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_slice import _perturb  # noqa: E402
from test_torch_train_ops import _flax_key  # noqa: E402
from test_torch_train_step import LR, REL, _assert_trees_close, _cfg, _flat  # noqa: E402

NAME = "convnext_tiny_in22k"
NARROW = dict(nb_blocks=(1, 1, 1, 1), embed_dim=(32, 64, 128, 256))
SIZE = 32
KW = dict(input_size=(SIZE, SIZE), nb_classes=1, classifier_activation=None, **NARROW)
ATOL = 1e-4  # the bar the port's models are held to against the JAX package
CKPT_ATOL = 1e-5


def drop_uniforms(port: torch.nn.Module, key, batch: int) -> dict:
    """For each DropPath of ``port`` at a rate above 0 (by module name),
    the (B, 1, 1, 1) uniforms the JAX DropPath at the same Flax path (the
    port's name split at the dots) draws under ``rngs={"dropout": key}``."""
    out = {}
    for name, m in port.named_modules():
        if isinstance(m, DropPath) and m.rate > 0:
            out[name] = np.asarray(jax.random.uniform(
                _flax_key(key, tuple(name.split("."))), (batch, 1, 1, 1)))
    return out


def _feed(module: torch.nn.Module, cls, noise) -> None:
    """``module``'s calls take ``noise(x)`` through the seam of ``cls``."""
    module.forward = lambda x: cls.forward(module, x, noise=torch.tensor(noise(x)))


def feed_uniforms(port: torch.nn.Module, uniforms: dict, dropout_paths: dict = None,
                  key=None) -> None:
    """Hand each DropPath in ``uniforms`` its uniforms, and each Dropout in
    ``dropout_paths`` (port name -> Flax path; Flax names its dropouts
    ``Dropout_<i>``) the uniforms of x's shape the JAX one draws under
    ``rngs={"dropout": key}``, for their next calls."""
    for name, m in port.named_modules():
        if name in uniforms:
            _feed(m, DropPath, lambda x, u=uniforms[name]: u)
        elif dropout_paths and name in dropout_paths:
            _feed(m, Dropout, lambda x, p=dropout_paths[name]: np.asarray(
                jax.random.uniform(_flax_key(key, p), tuple(x.shape))))


def _tree(seed, **kw):
    port, _ = create_model(NAME, seed=seed, **dict(KW, **kw))
    tree = torch_to_flax(port)
    _perturb(tree["params"], np.random.RandomState(seed))
    return tree


def _port(tree, **kw):
    port, _ = create_model(NAME, **dict(KW, **kw))
    return transfer_weights(tree, port, strict=True)


@pytest.fixture(scope="module")
def jax_run():
    module, _, _ = jax_create_model(NAME, init=False, **KW)
    tree = _tree(3)
    rng = np.random.RandomState(4)
    x = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    y = np.array([[1.0], [0.0]], np.float32)
    key0 = jax.random.PRNGKey(11)

    def loss_fn(p):
        out = module.apply({"params": p}, jnp.asarray(x), training=True,
                           rngs={"dropout": key0})
        return jnp.mean(jax_bce(jnp.asarray(y), out.astype(jnp.float32)))

    loss0, grads = jax.jit(jax.value_and_grad(loss_fn))(tree["params"])
    eval_out = np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x)))
    mesh = get_mesh(devices=jax.devices()[:1])
    tr = JaxTrainer(module, tree, _cfg(JaxTrainConfig), mesh=mesh)
    step = tr._build_step()
    params, stats, opt = jax.device_put((tr.params, tr.batch_stats, tr.opt_state),
                                        replicated(mesh))
    losses = []
    for i in range(2):
        params, stats, opt, loss = step(params, stats, opt, jnp.float32(LR), x, y,
                                        jax.random.PRNGKey(i))
        losses.append(float(loss))
    return dict(module=module, tree=tree, x=x, y=y, key0=key0, loss0=float(loss0),
                grads=jax.tree_util.tree_map(np.asarray, grads), losses=losses,
                eval_out=eval_out, params=jax.tree_util.tree_map(np.asarray, params))


def _step_key(i):
    """The dropout key the JAX trainer's step derives from its rng."""
    return jax.random.split(jax.random.PRNGKey(i))[1]


def test_unfused_forward_matches_jax_and_the_fused_path(jax_run):
    x = torch.from_numpy(jax_run["x"])
    unfused, fused = _port(jax_run["tree"], fused_block=False), _port(jax_run["tree"])
    with torch.inference_mode():
        a, b = unfused(x).numpy(), fused(x).numpy()
    np.testing.assert_allclose(a, jax_run["eval_out"], atol=ATOL)
    np.testing.assert_allclose(a, b, atol=ATOL)


def test_block_path_follows_the_field_the_environment_training_and_dropout(monkeypatch):
    monkeypatch.delenv("VIPTPU_NO_FUSED_BLOCK", raising=False)
    cfg = ConvNeXtConfig(name=NAME)
    assert _use_fused_block(cfg, training=False)  # the port's auto: fused on every device
    assert not _use_fused_block(cfg, training=True)
    assert not _use_fused_block(cfg.replace(fused_block=False), training=False)
    assert not _use_fused_block(cfg.replace(fused_block=True, drop_rate=0.1), training=False)
    monkeypatch.setenv("VIPTPU_NO_FUSED_BLOCK", "1")
    assert not _use_fused_block(cfg, training=False)
    assert _use_fused_block(cfg.replace(fused_block=True), training=False)


def test_training_runs_k9_at_each_block_and_k10_at_each_ln(monkeypatch):
    """The unfused training forward reaches the depthwise wrapper (K9 on
    the card) at every block with k = 7, padding 3, and the LN wrapper (K10)
    at every LN: the stem's, three downsamples', each block's and the
    head's; the backward reaches neither."""
    calls = {"dw": [], "ln": 0}

    def dw(x, kern, *, padding):
        calls["dw"].append((tuple(kern.shape[:2]), padding))
        return D.depthwise_conv_nhwc_plain(x, kern, padding=padding)

    def ln(x, weight, bias, eps):
        calls["ln"] += 1
        return L.layer_norm_plain(x, weight, bias, eps)

    monkeypatch.setattr(D, "depthwise_conv_nhwc", dw)
    monkeypatch.setattr(L, "layer_norm", ln)
    model, _ = create_model(NAME, **KW)
    model.train()(torch.rand(2, SIZE, SIZE, 3)).sum().backward()
    assert calls["dw"] == [((7, 7), ((3, 3), (3, 3)))] * 4
    assert calls["ln"] == 5 + 4


def test_gradients_at_the_start_match_jax(jax_run):
    """DropPath at linspace(0, 0.1, 4) in block order, JAX's masks fed in."""
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig), device="cpu")
    x, y = torch.from_numpy(jax_run["x"]), torch.from_numpy(jax_run["y"])
    port.train()
    uniforms = drop_uniforms(port, jax_run["key0"], 2)
    assert sorted(uniforms) == [f"stages_{j}_blocks_0.drop_path" for j in (1, 2, 3)]
    feed_uniforms(port, uniforms)
    loss, grads = value_and_grad(lambda: tr._loss(y, port(x).float()), tr.params)
    assert abs(loss.item() - jax_run["loss0"]) <= REL * abs(jax_run["loss0"])
    _assert_trees_close(torch_to_flax(port, values=grads)["params"], jax_run["grads"])


def test_two_adamw_steps_match_the_jax_trainer_step(jax_run):
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig), device="cpu")
    losses = []
    for i in range(2):
        feed_uniforms(port, drop_uniforms(port, _step_key(i), 2))
        losses.append(tr.train_step(jax_run["x"], jax_run["y"], LR).item())
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=REL)
    grads = jax_run["grads"]
    floor = 1e-6 * max(np.abs(g).max() for g in _flat(grads).values())
    noise = jax.tree_util.tree_map(lambda g: np.abs(g) < floor, grads)
    _assert_trees_close(torch_to_flax(port)["params"], jax_run["params"], noise)


def test_a_port_checkpoint_gives_jax_its_logits(jax_run, tmp_path):
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig, ckpt_dir=str(tmp_path), basic_save_name="c"),
                 device="cpu")
    feed_uniforms(port, drop_uniforms(port, _step_key(0), 2))
    tr.train_step(jax_run["x"], jax_run["y"], LR)
    state = jax_load_variables(tr.save_latest())
    assert state["batch_stats"] == {}
    want = np.asarray(jax.jit(jax_run["module"].apply)({"params": state["params"]},
                                                       jnp.asarray(jax_run["x"])))
    port.eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(jax_run["x"])).numpy()
    np.testing.assert_allclose(got, want, atol=CKPT_ATOL)
