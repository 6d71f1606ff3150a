"""ResNet-RS's training form in the port against the JAX package, on the
CPU, and the BN momentum a member's BNs move their statistics by.

A narrow ResNet-RS: the ResNetRS50 block (widths 64 ... 2048, SE, the
ResNet-D stem and projections) with one bottleneck a stage, registered in
both packages' ``BLOCK_ARGS`` as depth 14 for this module; 64 px, f32,
batch 2, one output, BN scales, shifts, biases and moving statistics
perturbed, the scale of each residual branch's last BN ~ U(0.1, 0.3) (the
damping ``chip_smoke.py`` gives ResNetRS50: with every branch at full
scale a BN network in training amplifies rounding, and XLA's and torch's
f32 sums then differ by up to 3.5e-4 of the largest gradient; damped, by
8.7e-7).

Its BNs move by the config's ``bn_momentum`` (0.0, as in the JAX package),
so after a training step the moving statistics are that step's batch
statistics, JAX's within 1e-6 at the stem and 5e-6 deeper; the loss and
every gradient at the start against ``jax.value_and_grad`` of the JAX loss,
the head's dropout (0.25) fed the JAX module's uniforms; two AdamW steps
against the JAX trainer's jitted step (its masks fed likewise); a
checkpoint the port's trainer writes, read by the JAX package, against the
port's eval logits; and a 0.9 member, a narrow ResNest50, whose statistics
after a step match the JAX BN's at 0.9. The other tolerances and the Adam
rounding-noise rule are ``test_torch_train_step.py``'s. The JAX side runs
once, in module-scoped fixtures."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.models import resnet_rs as jax_resnet_rs
from vip_cup_2022_tpu.parallel.mesh import get_mesh, replicated
from vip_cup_2022_tpu.train import TrainConfig as JaxTrainConfig
from vip_cup_2022_tpu.train import Trainer as JaxTrainer
from vip_cup_2022_tpu.train.losses import binary_cross_entropy_timm as jax_bce
from vip_cup_2022_tpu.utils.checkpoint import load_variables as jax_load_variables
from vip_cup_2022_tpu_torch.models import create_model, resnet_rs, transfer_weights
from vip_cup_2022_tpu_torch.ops.drop import DropPath
from vip_cup_2022_tpu_torch.ops.norms import BatchNorm
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer
from vip_cup_2022_tpu_torch.train.sam import value_and_grad
from vip_cup_2022_tpu_torch.weights.to_flax import torch_to_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_resnest import NARROW as NARROW_RESNEST  # noqa: E402
from test_torch_slice import _perturb  # noqa: E402
from test_torch_train_convnext import CKPT_ATOL, _step_key, feed_uniforms  # noqa: E402
from test_torch_train_step import LR, REL, _assert_trees_close, _cfg, _flat  # noqa: E402

NAME, DEPTH, SIZE = "ResNetRS50", 14, 64
KW = dict(input_size=(SIZE, SIZE), nb_classes=1, classifier_activation=None, depth=DEPTH)
HEAD_DROPOUT = {"drop": ("Dropout_0",)}  # the port's head dropout and its Flax path
# each moving statistic, relative and absolute: the stem's inputs are one
# conv from the image and agree within 1e-6; deeper BNs' inputs carry both
# frameworks' f32 rounding through the blocks (3.7e-6 at c4)
STATS_TOL = 5e-6
# Adam moves every entry by up to lr whatever its gradient's size, so an
# entry whose two gradients nearly cancel takes an ill-conditioned second
# update: a few of them (32 of 8.4e6 here, with gradients 2e-5 .. 1e-3 of
# the largest) differ by up to 0.7 lr between the frameworks
ADAM_OUTLIERS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_block_a_stage():
    """Depth 14 in both packages' block tables: ResNetRS50's stages, one
    bottleneck each."""
    table = [{"input_filters": f, "num_repeats": 1} for f in (64, 128, 256, 512)]
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_resnet_rs, resnet_rs):
            mp.setitem(module.BLOCK_ARGS, DEPTH, table)
        yield


def _stats_tree(tree, rng):
    """The moving statistics off their 0 / 1 init, so that a momentum
    other than the config's would show."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _stats_tree(v, rng)
        elif k == "moving_mean":
            tree[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        elif k == "moving_variance":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)


def _tree(name, seed, **kw):
    port, _ = create_model(name, seed=seed, **kw)
    tree = torch_to_flax(port)
    rng = np.random.RandomState(seed)
    _perturb(tree["params"], rng)
    _stats_tree(tree["batch_stats"], rng)
    for block in tree["params"].values():  # damp each residual branch's last BN
        if "batch_norm_3" in block:
            bn = block["batch_norm_3"]
            bn["gamma"] = rng.uniform(0.1, 0.3, bn["gamma"].shape).astype(np.float32)
    return tree


def _port(tree, name=NAME, **kw):
    port, _ = create_model(name, **(kw or KW))
    return transfer_weights(tree, port, strict=True)


def _assert_stats_close(got, want):
    """Each moving statistic within ``STATS_TOL`` (relative and absolute),
    the stem's within 1e-6."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys() and got
    for k, w in want.items():
        tol = 1e-6 if k.startswith("stem_") else STATS_TOL
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def jax_run(one_block_a_stage):
    """The JAX module, the perturbed tree and the batch."""
    module, _, _ = jax_create_model(NAME, init=False, **KW)
    rng = np.random.RandomState(6)
    return dict(module=module, tree=_tree(NAME, 5, **KW),
                x=rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
                y=np.array([[1.0], [0.0]], np.float32), key0=jax.random.PRNGKey(12))


@pytest.fixture(scope="module")
def jax_grads(jax_run):
    """The JAX loss and gradients at the start, the head's dropout drawn
    from ``key0`` (a fixture of its own, so that no one test pays for both
    JAX compiles)."""
    module, tree, x, y = (jax_run[k] for k in ("module", "tree", "x", "y"))

    def loss_fn(p):
        out, _ = module.apply({"params": p, "batch_stats": tree["batch_stats"]},
                              jnp.asarray(x), training=True, mutable=["batch_stats"],
                              rngs={"dropout": jax_run["key0"]})
        return jnp.mean(jax_bce(jnp.asarray(y), out.astype(jnp.float32)))

    loss0, grads = jax.jit(jax.value_and_grad(loss_fn))(tree["params"])
    return dict(loss0=float(loss0), grads=jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def jax_steps(jax_run):
    """Two steps of the JAX trainer's jitted step: the losses, the
    parameters after both and the statistics after each."""
    mesh = get_mesh(devices=jax.devices()[:1])
    tr = JaxTrainer(jax_run["module"], jax_run["tree"], _cfg(JaxTrainConfig), mesh=mesh)
    step = tr._build_step()
    params, stats, opt = jax.device_put((tr.params, tr.batch_stats, tr.opt_state),
                                        replicated(mesh))
    losses, step_stats = [], []
    for i in range(2):
        params, stats, opt, loss = step(params, stats, opt, jnp.float32(LR), jax_run["x"],
                                        jax_run["y"], jax.random.PRNGKey(i))
        losses.append(float(loss))
        step_stats.append(jax.tree_util.tree_map(np.asarray, stats))
    return dict(losses=losses, params=jax.tree_util.tree_map(np.asarray, params),
                stats=step_stats)


def _step(tr, port, jax_run, i):
    feed_uniforms(port, {}, HEAD_DROPOUT, _step_key(i))
    return tr.train_step(jax_run["x"], jax_run["y"], LR)


def test_every_bn_moves_by_the_config_momentum_and_resnest_keeps_0_9():
    port, cfg = create_model(NAME, **KW)
    bns = [m for m in port.modules() if isinstance(m, BatchNorm)]
    assert cfg.bn_momentum == 0.0 and len(bns) == 4 + 4 * 4
    assert all(m.momentum == 0.0 for m in bns)
    other, _ = create_model("ResNest50", input_size=(SIZE, SIZE), **NARROW_RESNEST)
    assert {m.momentum for m in other.modules() if isinstance(m, BatchNorm)} == {0.9}


def test_drop_path_rates_follow_the_jax_schedule():
    """``drop_path_rate * (stage + 2) / 5`` for every block of a stage, as
    the JAX module's ``survival_probability``; 0 in the registry."""
    port, _ = create_model(NAME, drop_path_rate=0.2, **KW)
    rates = [m.rate for name, m in port.named_modules()
             if isinstance(m, DropPath) and name.endswith(".drop")]
    assert rates == pytest.approx([0.2 * (i + 2) / 5 for i in range(4)])


def test_one_step_leaves_the_batch_statistics_as_jax_does(jax_run, jax_steps):
    """Momentum 0.0: after one training step the moving statistics are the
    batch's, JAX's ``batch_stats`` within 1e-6."""
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig), device="cpu")
    _step(tr, port, jax_run, 0)
    _assert_stats_close(torch_to_flax(port)["batch_stats"], jax_steps["stats"][0])


def test_a_0_9_member_moves_its_statistics_as_jax_does():
    """ResNest50 (narrow) builds its BNs at the JAX package's 0.9: after one
    training step its moving statistics equal the JAX BN's update."""
    kw = dict(input_size=(SIZE, SIZE), nb_classes=1, classifier_activation=None,
              **NARROW_RESNEST)
    module, _, _ = jax_create_model("ResNest50", init=False, **kw)
    tree = _tree("ResNest50", 7, **kw)
    x = np.random.RandomState(8).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    _, mut = jax.jit(lambda v, a: module.apply(v, a, training=True, mutable=["batch_stats"]))(
        tree, jnp.asarray(x))
    port = _port(tree, "ResNest50", **kw)
    Trainer(port, _cfg(TrainConfig), device="cpu").train_step(x, np.ones((2, 1), np.float32), LR)
    _assert_stats_close(torch_to_flax(port)["batch_stats"],
                        jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))


def test_gradients_at_the_start_match_jax(jax_run, jax_grads):
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig), device="cpu")
    x, y = torch.from_numpy(jax_run["x"]), torch.from_numpy(jax_run["y"])
    port.train()
    feed_uniforms(port, {}, HEAD_DROPOUT, jax_run["key0"])
    loss, grads = value_and_grad(lambda: tr._loss(y, port(x).float()), tr.params)
    assert abs(loss.item() - jax_grads["loss0"]) <= REL * abs(jax_grads["loss0"])
    _assert_trees_close(torch_to_flax(port, values=grads)["params"], jax_grads["grads"])


def test_two_adamw_steps_match_the_jax_trainer_step(jax_run, jax_grads, jax_steps):
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig), device="cpu")
    losses = [_step(tr, port, jax_run, i).item() for i in range(2)]
    np.testing.assert_allclose(losses, jax_steps["losses"], rtol=REL)
    grads = jax_grads["grads"]
    floor = 1e-6 * max(np.abs(g).max() for g in _flat(grads).values())
    noise = _flat(jax.tree_util.tree_map(lambda g: np.abs(g) < floor, grads))
    variables = torch_to_flax(port)
    got, want = _flat(variables["params"]), _flat(jax_steps["params"])
    scale = max(np.abs(w).max() for w in want.values())
    off = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= (4 if noise[k].any() else 1) * LR, k
        off += int((d[~noise[k]] > REL * scale).sum())
    assert off <= ADAM_OUTLIERS * sum(w.size for w in want.values()), off


def test_a_port_checkpoint_gives_jax_its_logits(jax_run, jax_steps, tmp_path):
    """The trainer's checkpoint after a step carries the moved statistics;
    the JAX model on it gives the port's eval logits."""
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig, ckpt_dir=str(tmp_path), basic_save_name="r"),
                 device="cpu")
    _step(tr, port, jax_run, 0)
    state = jax_load_variables(tr.save_latest())
    _assert_stats_close(state["batch_stats"], jax_steps["stats"][0])
    want = np.asarray(jax.jit(jax_run["module"].apply)(
        {"params": state["params"], "batch_stats": state["batch_stats"]},
        jnp.asarray(jax_run["x"])))
    port.eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(jax_run["x"])).numpy()
    np.testing.assert_allclose(got, want, atol=CKPT_ATOL)
