"""A narrow GCViT's training step in the port against the JAX trainer's,
on the CPU, and the port's checkpoints read by the JAX package.

The narrow GCViT of ``test_torch_gcvit.py`` (every leaf perturbed, rel-pos
tables ~ U(-1, 1)), f32, batch 2, drop rates 0, one output, ``bce_timm``,
AdamW with weight decay 0.05 at lr 1e-3: the loss and every gradient at
the start against ``jax.value_and_grad`` of the JAX trainer's loss, then
the losses of two steps and the parameters after them against the JAX
trainer's jitted ``_build_step``, each within 1e-4 of the leaf's max|ref|
(the bar the port's GCViT forward is held to) of the tree's max|ref|. One
exception: entries whose gradient is rounding noise (below 1e-6 of the
tree's max|gradient|: the key bias, to which the softmax over keys is
invariant, and a few SE weights) get Adam updates of up to lr either way in
either framework, as Adam normalises whatever it is given; they are held to
4 lr after the two steps. The JAX side runs once, in a module-scoped
fixture."""
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
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer
from vip_cup_2022_tpu_torch.train.sam import value_and_grad
from vip_cup_2022_tpu_torch.weights.to_flax import torch_to_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_gcvit import MODEL_ATOL, NARROW  # noqa: E402
from test_torch_slice import _perturb  # noqa: E402

KW = dict(input_size=(224, 224), nb_classes=1, classifier_activation=None, drop_path_rate=0.0,
          **NARROW)
LR, DECAY = 1e-3, 0.05
REL = 1e-4


def _cfg(cls, **kw):
    return cls(optimizer="adamw", weight_decay=DECAY, lr_schedule="constant", lr_base=LR,
               loss="bce_timm", **kw)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _assert_trees_close(got, want, noise=None):
    """Every leaf within ``REL`` of the tree's max|ref|; entries in ``noise``
    (a tree of bool masks) within 4 lr instead."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    scale = max(np.abs(w).max() for w in want.values())
    noise = _flat(noise) if noise is not None else {}
    for k, w in want.items():
        d = np.abs(got[k] - w)
        if k in noise:
            assert d[noise[k]].max(initial=0) <= 4 * LR, k
            d = d[~noise[k]]
        assert d.max(initial=0) <= REL * scale, (k, d.max(), scale)


def _tree(seed):
    """The narrow GCViT's Flax tree (drawn by the port, read through the
    inverse bridge, so no JAX init is compiled) with every leaf perturbed as
    ``test_torch_gcvit._jax_gcvit`` perturbs it."""
    port, _ = create_model("GCViTTiny", seed=seed, **KW)
    tree = torch_to_flax(port)
    rng = np.random.RandomState(seed)
    _perturb(tree["params"], rng)

    def tables(t):
        for k, v in t.items():
            if isinstance(v, dict):
                tables(v)
            elif k == "relative_position_bias_table":
                t[k] = rng.uniform(-1, 1, v.shape).astype(np.float32)
    tables(tree["params"])
    return tree


@pytest.fixture(scope="module")
def jax_run():
    module, _, _ = jax_create_model("GCViTTiny", init=False, **KW)
    tree = _tree(5)
    rng = np.random.RandomState(6)
    x = rng.uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    y = np.array([[1.0], [0.0]], np.float32)

    def loss_fn(p):
        out = module.apply({"params": p}, jnp.asarray(x), training=True)
        return jnp.mean(jax_bce(jnp.asarray(y), out.astype(jnp.float32)))

    loss0, grads = jax.jit(jax.value_and_grad(loss_fn))(tree["params"])
    mesh = get_mesh(devices=jax.devices()[:1])
    tr = JaxTrainer(module, tree, _cfg(JaxTrainConfig), mesh=mesh)
    step = tr._build_step()
    # committed like the step's outputs, so the second step reuses the first's program
    params, stats, opt = jax.device_put((tr.params, tr.batch_stats, tr.opt_state),
                                        replicated(mesh))
    losses = []
    for i in range(2):
        params, stats, opt, loss = step(params, stats, opt, jnp.float32(LR), x, y,
                                        jax.random.PRNGKey(i))
        losses.append(float(loss))
    return dict(module=module, tree=tree, x=x, y=y, loss0=float(loss0),
                grads=jax.tree_util.tree_map(np.asarray, grads), losses=losses,
                params=jax.tree_util.tree_map(np.asarray, params))


def _port(tree):
    port, _ = create_model("GCViTTiny", **KW)
    transfer_weights(tree, port, strict=True)
    return port


def test_gradients_at_the_start_match_jax(jax_run):
    """Every leaf's gradient, mapped to the Flax layout; the rel-pos tables'
    among them are non-zero (the gather is in the graph)."""
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig), device="cpu")
    x, y = torch.from_numpy(jax_run["x"]), torch.from_numpy(jax_run["y"])
    port.train()
    loss, grads = value_and_grad(lambda: tr._loss(y, port(x).float()), tr.params)
    assert abs(loss.item() - jax_run["loss0"]) <= REL * abs(jax_run["loss0"])
    got = torch_to_flax(port, values=grads)["params"]
    _assert_trees_close(got, jax_run["grads"])
    tables = [g for k, g in grads.items() if k.endswith("relative_position_bias_table")]
    assert len(tables) == 8 and all(t.abs().max() > 0 for t in tables)


def test_two_adamw_steps_match_the_jax_trainer_step(jax_run):
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig), device="cpu")
    losses = [tr.train_step(jax_run["x"], jax_run["y"], LR).item() for _ in range(2)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=REL)
    grads = jax_run["grads"]
    floor = 1e-6 * max(np.abs(g).max() for g in _flat(grads).values())
    noise = jax.tree_util.tree_map(lambda g: np.abs(g) < floor, grads)
    _assert_trees_close(torch_to_flax(port)["params"], jax_run["params"], noise)
    assert int(tr.opt_state["count"]) == 2


def test_a_port_checkpoint_gives_jax_its_logits(jax_run, tmp_path):
    """After a step, the trainer's latest checkpoint loads in the JAX
    package (md5 sidecar checked) and the JAX model on its params gives the
    port's eval logits within the model bar; its optimizer state and meta
    are there too."""
    port = _port(jax_run["tree"])
    tr = Trainer(port, _cfg(TrainConfig, ckpt_dir=str(tmp_path), basic_save_name="g"),
                 device="cpu")
    tr.train_step(jax_run["x"], jax_run["y"], LR)
    tr.global_step = 1
    path = tr.save_latest()
    assert os.path.isfile(path + ".md5")
    state = jax_load_variables(path)
    assert set(state) == {"params", "batch_stats", "opt_state", "meta"}
    assert int(state["meta"]["global_step"]) == 1 and state["batch_stats"] == {}
    assert set(state["opt_state"]) == {"count", "mu", "nu"}
    want = np.asarray(jax.jit(jax_run["module"].apply)({"params": state["params"]},
                                                       jnp.asarray(jax_run["x"])))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(jax_run["x"])).numpy()
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)
