"""ECA_NFNetL0's training form in the port against the JAX package, on the
CPU: ``test_torch_train_members.py``'s tests of a member (the narrow
``test_torch_nfnet.NARROW`` at 64 px, stochastic depth 0.2 where the
registry has 0), and the standardized convs in training. Under the
``Trainer`` every ``ScaledStdConv``'s ``weight`` and ``gain`` gets a
non-zero gradient equal to JAX's (its standardized weight computed in the
graph, not cached outside it); its eval logits are bit for bit the same
after a ``train()`` / ``eval()`` round trip (the cache is dropped on every
mode change)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.train.losses import binary_cross_entropy_timm as jax_bce
from vip_cup_2022_tpu_torch.ops.conv import ScaledStdConv
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer
from vip_cup_2022_tpu_torch.weights.to_flax import torch_to_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_train_members import MemberTraining, _kw, _port, _tree  # noqa: E402
from test_torch_train_step import LR, REL, _cfg, _flat  # noqa: E402


class TestECA_NFNetL0(MemberTraining):
    NAME = "ECA_NFNetL0"


def test_every_standardized_conv_gets_its_gradient_under_the_trainer():
    """ECA_NFNetL0 (narrow) through the ``Trainer``'s step: every
    ``ScaledStdConv``'s ``weight`` and ``gain`` gets a non-zero gradient,
    JAX's within the step tests' tolerance (1e-4 of the tree's max|ref|),
    and the step moves them."""
    name = "ECA_NFNetL0"
    kw = _kw(name, drop_connect_rate=0.0, drop_rate=0.0)
    module, _, _ = jax_create_model(name, init=False, **kw)
    tree = _tree(name, 9, **kw)
    x = np.random.RandomState(10).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    y = np.array([[0.0], [1.0]], np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.mean(jax_bce(
        jnp.asarray(y), module.apply({"params": p}, jnp.asarray(x), training=True)))))(
        tree["params"])
    want = _flat(jax.tree_util.tree_map(np.asarray, want))
    port = _port(name, tree, **kw)
    tr = Trainer(port, _cfg(TrainConfig), device="cpu")
    captured = {}
    real = tr.tx.update

    def update(grads, state, params):
        captured.update(grads)
        return real(grads, state, params)

    tr.tx.update = update
    before = {k: p.detach().clone() for k, p in tr.params.items()}
    tr.train_step(x, y, LR)
    got = _flat(torch_to_flax(port, values=captured)["params"])
    scale = max(np.abs(w).max() for w in want.values())
    convs = [n for n, m in port.named_modules() if isinstance(m, ScaledStdConv)]
    assert len(convs) == 4 + 5 * 4 + 4 + 1  # stem, blocks, shortcuts, post
    for n in convs:
        for leaf, key in (("kernel", "weight"), ("gain", "gain")):
            g = got[f"{n}/{leaf}"]
            assert np.abs(g).max() > 0, (n, leaf)
            np.testing.assert_allclose(g, want[f"{n}/{leaf}"], rtol=0, atol=REL * scale,
                                       err_msg=f"{n}/{leaf}")
            assert not torch.equal(tr.params[f"{n}.{key}"], before[f"{n}.{key}"]), (n, key)


def test_nfnet_eval_logits_survive_a_train_eval_round_trip():
    """The cached standardized weights are dropped on every mode change:
    ECA_NFNetL0's eval logits bit for bit the same before and after
    ``train()`` / ``eval()`` (and a training forward between)."""
    name = "ECA_NFNetL0"
    port = _port(name, _tree(name, 11, **_kw(name)))
    x = torch.from_numpy(np.random.RandomState(12).uniform(0, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        before = port(x)
    port.train()
    port(x).sum().backward()
    port.eval()
    with torch.inference_mode():
        after = port(x)
    assert torch.equal(before, after)
