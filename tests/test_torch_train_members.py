"""The training forms of ResNest50, EfficientNetV2T, EfficientNetV1B4 and
ECA_NFNetL0 in the port against the JAX package, on the CPU: the tests of
one member (:class:`MemberTraining`), run here for ResNest50 and in
``test_torch_train_efficientnet.py`` / ``test_torch_train_nfnet.py`` for
the others.

Each member narrow (the serving tests' ``NARROW``; V2T with a second block
in stage 3, so that an MBConv block with a K9 site takes the shortcut),
f32, one output, at 64 px (V1B4 at 57: TF ``SAME`` padding at odd sides),
a batch of 2 noise images a shade apart (ResNest50: 4, :func:`_batch`),
its leaves perturbed as its serving test perturbs them (BN scales, shifts
and moving statistics, biases, gains), the scale of the last BN of each
residual branch ~ U(0.1, 0.3) (``chip_smoke.py``'s damped draw: at full
branch scale a BN network in training amplifies rounding). Per member:

- each DropPath's and the head dropout's rate against the JAX module's,
  read off the JAX modules as they are called (full width);
- the training-mode forward at drop rates 0 against JAX's
  ``training=True`` within 1e-4, the BNs at momentum 0.9 and the moving
  statistics the forward leaves;
- the loss and every gradient at the start against ``jax.value_and_grad``,
  DropPath and dropout fed the JAX module's uniforms (stochastic depth 0.2
  where the registry has 0, so that it runs; ResNest50's head dropout
  0.25);
- after one step of the port's ``Trainer``, every BN's moving statistics
  against the JAX trainer's;
- two AdamW steps against the JAX trainer's jitted step;
- a checkpoint the port's trainer writes, read by the JAX package, against
  the port's eval logits.

The tolerances are ``test_torch_train_step.py``'s and
``test_torch_train_resnet_rs.py``'s; the Adam rounding-noise rule is
:func:`_sign_free`.
"""
import os
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.ops.drop import DropPath as JaxDropPath
from vip_cup_2022_tpu.parallel.mesh import get_mesh, replicated
from vip_cup_2022_tpu.train import TrainConfig as JaxTrainConfig
from vip_cup_2022_tpu.train import Trainer as JaxTrainer
from vip_cup_2022_tpu.train.losses import binary_cross_entropy_timm as jax_bce
from vip_cup_2022_tpu.utils.checkpoint import load_variables as jax_load_variables
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.ops.drop import DropPath, Dropout
from vip_cup_2022_tpu_torch.ops.norms import BatchNorm
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer
from vip_cup_2022_tpu_torch.train.sam import value_and_grad
from vip_cup_2022_tpu_torch.weights.to_flax import torch_to_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_efficientnet as eff_tests  # noqa: E402
import test_torch_nfnet as nf_tests  # noqa: E402
from test_torch_resnest import NARROW as NARROW_RESNEST  # noqa: E402
from test_torch_train_convnext import (ATOL, CKPT_ATOL, _step_key, drop_uniforms,  # noqa: E402
                                       feed_uniforms)
from test_torch_train_resnet_rs import ADAM_OUTLIERS, _assert_stats_close  # noqa: E402
from test_torch_train_step import LR, REL, _assert_trees_close, _cfg, _flat  # noqa: E402

HEAD_DROPOUT = {"drop": ("Dropout_0",)}  # the port's head dropout and its Flax path
# name: (side, narrow widths, the drop rates the gradient and step tests run at)
MEMBERS = {
    "ResNest50": (64, NARROW_RESNEST, dict(drop_connect_rate=0.2, drop_rate=0.25)),
    "EfficientNetV2T": (64, dict(eff_tests.NARROW["EfficientNetV2T"], depthes=(1, 1, 1, 2, 1, 1)),
                        dict(drop_connect_rate=0.2)),
    "EfficientNetV1B4": (57, eff_tests.NARROW["EfficientNetV1B4"], {}),
    "EfficientNetV2T_GC": (64, dict(eff_tests.NARROW["EfficientNetV2T"], depthes=(1, 1, 1, 2, 1, 1)),
                           dict(drop_connect_rate=0.2)),
    "ECA_NFNetL0": (64, nf_tests.NARROW, dict(drop_connect_rate=0.2)),
}
BN_MEMBERS = [n for n in MEMBERS if n != "ECA_NFNetL0"]
BATCH = {"ResNest50": 4}  # the others at 2


def _kw(name, **over):
    size, narrow, rates = MEMBERS[name]
    return dict(input_size=(size, size), nb_classes=1, classifier_activation=None,
                **{**narrow, **rates, **over})


def _tree(name, seed, **kw):
    """The member's Flax tree (drawn by the port, read through the inverse
    bridge, so no JAX init is compiled), perturbed as its serving test
    perturbs it, each residual branch's last BN scale ~ U(0.1, 0.3)
    (``chip_smoke.branch_end_bns``)."""
    from chip_smoke import branch_end_bns

    port, _ = create_model(name, seed=seed, **kw)
    tree = torch_to_flax(port)
    rng = np.random.RandomState(seed)
    perturb = nf_tests._perturb if name == "ECA_NFNetL0" else eff_tests._perturb
    perturb(tree, rng)
    for bn in branch_end_bns(port):
        gamma = tree["params"][bn]["gamma"]
        tree["params"][bn]["gamma"] = rng.uniform(0.1, 0.3, gamma.shape).astype(np.float32)
    return tree


def _port(name, tree, **kw):
    port, _ = create_model(name, **(kw or _kw(name)))
    return transfer_weights(tree, port, strict=True)


def _batch(name, seed):
    """The member's batch of noise images, each a shade brighter than the
    one before (U(0, 0.6) + linspace(0, 0.4)), and its labels 1, 0, 1, ...
    ResNest's ``sa_2_bn`` normalises pooled (B, 1, 1, C) features over the
    batch: at B = 2 its output is +-1 whatever its input, so the gradient
    through it is rounding, and images of one shade pool to nearly one
    vector, whose spread it would divide their rounding by."""
    size, b = MEMBERS[name][0], BATCH.get(name, 2)
    u = np.random.RandomState(seed).uniform(0, 0.6, (b, size, size, 3))
    x = (u + np.linspace(0, 0.4, b).reshape(b, 1, 1, 1)).astype(np.float32)
    return x, (np.arange(b) % 2 == 0).astype(np.float32).reshape(b, 1)


def _feed(port, key, batch):
    """JAX's uniforms under ``rngs={"dropout": key}`` for the port's next
    forward: every DropPath above rate 0 and the head dropout."""
    feed_uniforms(port, drop_uniforms(port, key, batch), HEAD_DROPOUT, key)


def _step(tr, port, run, i):
    _feed(port, _step_key(i), len(run["x"]))
    return tr.train_step(run["x"], run["y"], LR)


def _jax_drop_rates(name, kw) -> dict:
    """{Flax module name: rate} of every DropPath and dropout the JAX module
    calls in a training forward (traced, not run)."""
    module, _, _ = jax_create_model(name, init=False, **kw)
    x = jax.ShapeDtypeStruct((2, *kw["input_size"], 3), jnp.float32)
    variables = jax.eval_shape(lambda a: module.init(jax.random.PRNGKey(0), a), x)
    rates = {}

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, (JaxDropPath, nn.Dropout)):
            rates[context.module.name] = context.module.rate
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jax.eval_shape(lambda v, a: module.apply(
            v, a, training=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)}), variables, x)
    return rates


def _sign_free(g1, g2) -> dict:
    """{leaf: mask} of the entries whose Adam direction is not determined
    over the two steps: the first step's gradient, the second's, or the
    second step's bias-corrected first moment ``(0.09 g1 + 0.1 g2) / 0.19``
    within ``REL`` of the larger step's max|gradient|. The gradient tests
    hold the port to that bound, and the moment's error is at most the
    gradients', so such an entry's sign may differ between the frameworks,
    and Adam, which moves every entry by about lr whatever its size, may
    move it either way; elsewhere the second update's error is at most
    ``floor / |moment|`` of lr."""
    g1, g2 = _flat(g1), _flat(g2)
    floor = REL * max(np.abs(g).max() for g in list(g1.values()) + list(g2.values()))
    return {k: (np.abs(g1[k]) <= floor) | (np.abs(g2[k]) <= floor)
            | (np.abs(0.09 * g1[k] + 0.1 * g2[k]) <= 0.19 * floor) for k in g1}


class MemberTraining:
    """The training tests of one member, ``NAME``; a ``Test...`` subclass
    per member runs them (here and in ``test_torch_train_efficientnet.py``
    and ``test_torch_train_nfnet.py``, so that xdist's file groups share
    the JAX compiles out). The JAX side runs once per class."""

    NAME: str

    @pytest.fixture(scope="class")
    def jax_run(self):
        """The JAX module at the test drop rates, the perturbed tree and
        the batch."""
        name = self.NAME
        module, _, _ = jax_create_model(name, init=False, **_kw(name))
        x, y = _batch(name, 6)
        return dict(module=module, tree=_tree(name, 5, **_kw(name)), x=x, y=y,
                    key0=jax.random.PRNGKey(12))

    @pytest.fixture(scope="class")
    def jax_forward(self, jax_run):
        """JAX's training-mode forward at drop rates 0: the logits and the
        moving statistics it leaves."""
        module, _, _ = jax_create_model(self.NAME, init=False,
                                        **_kw(self.NAME, drop_connect_rate=0.0, drop_rate=0.0))
        out, mut = jax.jit(lambda v, x: module.apply(v, x, training=True,
                                                     mutable=["batch_stats"]))(
            jax_run["tree"], jnp.asarray(jax_run["x"]))
        return dict(out=np.asarray(out),
                    stats=jax.tree_util.tree_map(np.asarray, mut.get("batch_stats", {})))

    @pytest.fixture(scope="class")
    def jax_grads(self, jax_run):
        """The JAX loss and gradients at the start, the drops drawn from
        ``key0``, and the jitted ``(params, key) -> (loss, gradients)`` (in
        training mode the BNs normalise with the batch's statistics, so the
        gradient does not depend on the moving ones)."""
        module, tree, x, y = (jax_run[k] for k in ("module", "tree", "x", "y"))

        def loss_fn(p, key):
            out, _ = module.apply({"params": p, "batch_stats": tree["batch_stats"]},
                                  jnp.asarray(x), training=True, mutable=["batch_stats"],
                                  rngs={"dropout": key})
            return jnp.mean(jax_bce(jnp.asarray(y), out.astype(jnp.float32)))

        fn = jax.jit(jax.value_and_grad(loss_fn))
        loss0, grads = fn(tree["params"], jax_run["key0"])
        return dict(loss0=float(loss0), grads=jax.tree_util.tree_map(np.asarray, grads), fn=fn)

    @pytest.fixture(scope="class")
    def jax_steps(self, jax_run, jax_grads):
        """Two steps of the JAX trainer's jitted step: the losses, the
        parameters after both, the statistics after each, and each step's
        gradient (the step's dropout key at the step's parameters)."""
        mesh = get_mesh(devices=jax.devices()[:1])
        tr = JaxTrainer(jax_run["module"], jax_run["tree"], _cfg(JaxTrainConfig), mesh=mesh)
        step = tr._build_step()
        params, stats, opt = jax.device_put((tr.params, tr.batch_stats, tr.opt_state),
                                            replicated(mesh))
        losses, step_stats, step_grads = [], [], []
        for i in range(2):
            _, grads = jax_grads["fn"](params, _step_key(i))
            step_grads.append(jax.tree_util.tree_map(np.asarray, grads))
            params, stats, opt, loss = step(params, stats, opt, jnp.float32(LR), jax_run["x"],
                                            jax_run["y"], jax.random.PRNGKey(i))
            losses.append(float(loss))
            step_stats.append(jax.tree_util.tree_map(np.asarray, stats))
        return dict(losses=losses, params=jax.tree_util.tree_map(np.asarray, params),
                    stats=step_stats, grads=step_grads)

    def _stats_close(self, got, want):
        if self.NAME in BN_MEMBERS:
            _assert_stats_close(got, want)
        else:
            assert got == want == {}

    def _trainer(self, run, **kw):
        port = _port(self.NAME, run["tree"])
        return port, Trainer(port, _cfg(TrainConfig, **kw), device="cpu")

    def test_drop_rates_follow_the_jax_schedule(self):
        """Full width at 64 px: the registry's rates, stochastic depth at
        0.2 where the registry has 0 (so that the schedule shows); every
        DropPath of the port at its JAX module's rate, under its Flax name,
        and the head dropout at ``Dropout_0``'s. The JAX module builds no
        DropPath where the port builds none (EfficientNet's blocks without
        the shortcut)."""
        kw = dict(input_size=(64, 64), nb_classes=1, classifier_activation=None)
        if self.NAME != "EfficientNetV1B4":
            kw["drop_connect_rate"] = 0.2
        want = _jax_drop_rates(self.NAME, kw)
        port, cfg = create_model(self.NAME, **kw)
        got = {("Dropout_0" if n == "drop" else n): m.rate for n, m in port.named_modules()
               if isinstance(m, (DropPath, Dropout))}
        assert got.keys() == want.keys()
        assert got == pytest.approx(want, abs=1e-12)
        assert got["Dropout_0"] == cfg.drop_rate and max(got.values()) > 0
        if self.NAME == "EfficientNetV1B4":  # the registry's drop-connect and dropout
            assert cfg.drop_connect_rate == 0.2 and cfg.drop_rate == 0.4

    def test_training_forward_matches_jax(self, jax_run, jax_forward):
        """Drop rates 0: the training-mode logits within 1e-4 and, after
        the forward, each moving statistic within the ResNet-RS test's
        bound (0.9 of the old value plus 0.1 of the batch's)."""
        port = _port(self.NAME, jax_run["tree"],
                     **_kw(self.NAME, drop_connect_rate=0.0, drop_rate=0.0))
        port.train()
        with torch.no_grad():
            out = port(torch.from_numpy(jax_run["x"])).numpy()
        np.testing.assert_allclose(out, jax_forward["out"], atol=ATOL)
        bns = {m.momentum for m in port.modules() if isinstance(m, BatchNorm)}
        assert bns == ({0.9} if self.NAME in BN_MEMBERS else set())
        self._stats_close(torch_to_flax(port)["batch_stats"], jax_forward["stats"])

    def test_gradients_at_the_start_match_jax(self, jax_run, jax_grads):
        port, tr = self._trainer(jax_run)
        x, y = torch.from_numpy(jax_run["x"]), torch.from_numpy(jax_run["y"])
        port.train()
        _feed(port, jax_run["key0"], len(x))
        loss, grads = value_and_grad(lambda: tr._loss(y, port(x).float()), tr.params)
        assert abs(loss.item() - jax_grads["loss0"]) <= REL * abs(jax_grads["loss0"])
        _assert_trees_close(torch_to_flax(port, values=grads)["params"], jax_grads["grads"])

    def test_one_step_moves_the_bn_statistics_as_jax_does(self, jax_run, jax_steps):
        """After one trainer step each moving statistic is 0.9 x its old
        value + 0.1 x the batch's, JAX's within 5e-6 (none for an NFNet)."""
        port, tr = self._trainer(jax_run)
        _step(tr, port, jax_run, 0)
        self._stats_close(torch_to_flax(port)["batch_stats"], jax_steps["stats"][0])

    def test_two_adamw_steps_match_the_jax_trainer_step(self, jax_run, jax_steps):
        """The losses within 1e-4; each parameter within lr of JAX's, or 4
        lr where its Adam direction is sign-free (:func:`_sign_free`); and
        no more than ``ADAM_OUTLIERS`` of the other entries off by more
        than 1e-4 of the tree's max|ref|."""
        port, tr = self._trainer(jax_run)
        losses = [_step(tr, port, jax_run, i).item() for i in range(2)]
        np.testing.assert_allclose(losses, jax_steps["losses"], rtol=REL)
        free = _sign_free(*jax_steps["grads"])
        got, want = _flat(torch_to_flax(port)["params"]), _flat(jax_steps["params"])
        assert got.keys() == want.keys()
        scale = max(np.abs(w).max() for w in want.values())
        off = 0
        for k, w in want.items():
            d, noise = np.abs(got[k] - w), free[k]
            assert d[noise].max(initial=0) <= 4 * LR and d[~noise].max(initial=0) <= LR, k
            off += int((d[~noise] > REL * scale).sum())
        assert off <= ADAM_OUTLIERS * sum(w.size for w in want.values()), off

    def test_a_port_checkpoint_gives_jax_its_logits(self, jax_run, jax_steps, tmp_path):
        """The trainer's checkpoint after a step, read by the JAX package:
        the moved statistics, and the JAX model on it gives the port's eval
        logits."""
        port, tr = self._trainer(jax_run, ckpt_dir=str(tmp_path), basic_save_name="m")
        _step(tr, port, jax_run, 0)
        state = jax_load_variables(tr.save_latest())
        self._stats_close(state["batch_stats"], jax_steps["stats"][0])
        want = np.asarray(jax.jit(jax_run["module"].apply)(
            {"params": state["params"], "batch_stats": state["batch_stats"]},
            jnp.asarray(jax_run["x"])))
        port.eval()
        with torch.inference_mode():
            got = port(torch.from_numpy(jax_run["x"])).numpy()
        np.testing.assert_allclose(got, want, atol=CKPT_ATOL)


class TestResNest50(MemberTraining):
    NAME = "ResNest50"
