"""``Trainer.fit`` of the port against the JAX trainer, on the CPU, on the
counterpart of ``tests/test_train.py``'s tiny model (a strided conv, BN,
ReLU, a mean, dropout, a dense head): the same weights and batches give the
same history (lr, loss, val_loss, val_acc within 1e-5 relative: f32 on
both sides, a few hundred sums in another order), with dropout at rate 0
(JAX's PRNG cannot be reproduced in torch; a run at 0.1 checks the port's
own draws). The conv has no bias: a bias before a BN has a zero gradient,
which the Adam family turns into updates of +-lr from rounding noise, in
either framework. Then the behaviours of the JAX trainer: checkpoints (latest,
best with pruning, per-epoch snapshots, retention by an injected clock),
resume, the NaN stop, distillation, SAM, uint8 batches, the eval accuracy
rules, the metric log, and where the trainer runs."""
import json
import os
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.ops import BatchNorm as JaxBatchNorm
from vip_cup_2022_tpu.parallel.mesh import get_mesh
from vip_cup_2022_tpu.train import TrainConfig as JaxTrainConfig
from vip_cup_2022_tpu.train import Trainer as JaxTrainer
from vip_cup_2022_tpu.utils.checkpoint import load_variables as jax_load_variables
from vip_cup_2022_tpu_torch.ops.conv import Conv, Linear
from vip_cup_2022_tpu_torch.ops.drop import Dropout
from vip_cup_2022_tpu_torch.ops.norms import BatchNorm
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer
from vip_cup_2022_tpu_torch.weights.from_jax import state_dict_from_flax

RTOL = 1e-5


class JaxTiny(fnn.Module):
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, training: bool = False):
        x = fnn.Conv(8, (3, 3), strides=(2, 2), use_bias=False)(x)
        x = JaxBatchNorm(name="bn")(x, training=training)
        x = fnn.relu(x)
        x = jnp.mean(x, axis=(1, 2))
        x = fnn.Dropout(self.rate, deterministic=not training)(x)
        return fnn.Dense(3)(x)


class Tiny(nn.Module):
    """The port's counterpart, under the Flax module names."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.Conv_0 = Conv(3, 8, 3, stride=2, padding="same", bias=False)
        self.bn = BatchNorm(8)
        self.drop = Dropout(rate)
        self.Dense_0 = Linear(8, 3, torch.float32)

    def forward(self, x):
        x = F.relu(self.bn(self.Conv_0(x)))
        return self.Dense_0(self.drop(x.mean(dim=(1, 2))))


@pytest.fixture(scope="module")
def variables():
    v = JaxTiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return jax.tree_util.tree_map(np.asarray, fnn.FrozenDict(v).unfreeze())


def _port(variables, rate=0.0):
    model = Tiny(rate)
    model.load_state_dict(state_dict_from_flax(variables, model.state_dict(), strict=True),
                          strict=True)
    return model


def _batches(seed, n=2, int_labels=False, u8=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8) if u8
             else rng.uniform(size=(8, 32, 32, 3)).astype(np.float32))
        labels = rng.randint(0, 3, size=8)
        y = labels.astype(np.int32) if int_labels else np.eye(3, dtype=np.float32)[labels]
        out.append((x, y))
    return lambda: iter(out)


def _jax_trainer(variables, cfg, rate=0.0):
    return JaxTrainer(JaxTiny(rate), variables, cfg, mesh=get_mesh(devices=jax.devices()[:1]))


def _assert_history(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("kw,int_labels,u8", [
    (dict(optimizer="adamw", loss="categorical"), False, False),  # cosine with warmup
    (dict(optimizer="sgdw", loss="categorical", lr_schedule="multistep", lr_decay_steps=(1,),
          warmup_epochs=0, weight_decay=0.01), True, True),
    (dict(optimizer="rmsprop", loss="bce_timm", lr_schedule="exp", lr_decay_steps=(1,),
          lr_decay_rate=0.5, warmup_epochs=0, label_smoothing=0.1), False, False),
    (dict(optimizer="lamb", loss="categorical", lr_schedule="constant", use_sam=True,
          grad_clip_norm=0.5), False, False),
])
def test_fit_history_matches_jax(variables, tmp_path, kw, int_labels, u8):
    """Three epochs of two steps and a validation pass each: the history,
    and the parameters and BN statistics at the end."""
    data = _batches(1, int_labels=int_labels, u8=u8)
    common = dict(epochs=3, steps_per_epoch=2, lr_base=1e-2, monitor="loss",
                  basic_save_name="t", **kw)
    jtr = _jax_trainer(variables, JaxTrainConfig(ckpt_dir=str(tmp_path / "jax"), **common))
    want = jtr.fit(data, val_iter_fn=data, verbose=0)
    tr = Trainer(_port(variables), TrainConfig(ckpt_dir=str(tmp_path / "port"), **common),
                 device="cpu")
    got = tr.fit(data, val_iter_fn=data, verbose=0)
    _assert_history(got, want)
    final = state_dict_from_flax({"params": jtr.params, "batch_stats": jtr.batch_stats},
                                 tr.model.state_dict(), strict=True)
    for key, value in tr.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), final[key].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_checkpoints_snapshots_and_resume(variables, tmp_path):
    """latest, best (the previous pruned, .md5 with it), keep_n_checkpoints
    snapshots and the history JSON; the JAX package reads the latest; a
    fresh trainer resumes to the same weights, optimizer state, step and
    epoch, and trains on."""
    data = _batches(2)
    cfg = TrainConfig(epochs=3, steps_per_epoch=2, lr_base=1e-2, loss="categorical",
                      monitor="loss", ckpt_dir=str(tmp_path), basic_save_name="ms",
                      keep_n_checkpoints=2)
    tr = Trainer(_port(variables), cfg, device="cpu")
    hist = tr.fit(data, val_iter_fn=data, verbose=0)
    files = sorted(os.listdir(tmp_path))
    snaps = [f for f in files if re.fullmatch(r"ms_epoch\d{3}\.msgpack", f)]
    assert snaps == ["ms_epoch002.msgpack", "ms_epoch003.msgpack"]
    best = [f for f in files if re.fullmatch(r"ms_epoch\d_loss.*\.msgpack", f)]
    assert len(best) == 1 and best[0] + ".md5" in files
    assert {"ms_latest.msgpack", "ms_latest.msgpack.md5", "ms_hist.json"} <= set(files)
    assert json.load(open(tmp_path / "ms_hist.json")) == hist
    state = jax_load_variables(str(tmp_path / "ms_latest.msgpack"))
    assert int(state["meta"]["global_step"]) == 6 and int(state["meta"]["epoch"]) == 3
    assert set(state["batch_stats"]["bn"]) == {"moving_mean", "moving_variance"}

    tr2 = Trainer(_port(variables), cfg, device="cpu")
    assert tr2.restore_latest()
    assert (tr2.global_step, tr2.initial_epoch) == (6, 3)
    for key, value in tr.model.state_dict().items():
        assert torch.equal(tr2.model.state_dict()[key], value), key
    for slot in ("mu", "nu"):
        for key, value in tr.opt_state[slot].items():
            assert torch.equal(tr2.opt_state[slot][key], value)
    assert int(tr2.opt_state["count"]) == 6
    tr2.cfg.epochs = 4
    assert len(tr2.fit(data, verbose=0)["loss"]) == 1
    assert not Trainer(_port(variables), TrainConfig(ckpt_dir=str(tmp_path / "none")),
                       device="cpu").restore_latest()


def test_keep_checkpoint_every_n_hours(variables, tmp_path):
    """A snapshot due for pruning is kept for good when 12 h separate its
    save from the last one kept (the JAX test's clock and expectations)."""
    cfg = TrainConfig(ckpt_dir=str(tmp_path), basic_save_name="ret", monitor="loss",
                      keep_n_checkpoints=1, keep_checkpoint_every_n_hours=12.0)
    tr = Trainer(_port(variables), cfg, device="cpu")
    now = {"t": 0.0}
    tr._clock = lambda: now["t"]
    tr._last_preserved_ts = 0.0
    for epoch in range(1, 6):
        now["t"] = (epoch - 1) * 5 * 3600.0
        tr._save_epoch_snapshot(epoch)
    snaps = sorted(p for p in os.listdir(tmp_path) if re.fullmatch(r"ret_epoch\d{3}\.msgpack", p))
    assert snaps == ["ret_epoch004.msgpack", "ret_epoch005.msgpack"]
    assert tr._preserved_ckpts == [str(tmp_path / "ret_epoch004.msgpack")]


@pytest.mark.parametrize("check_every", [1, 0])
def test_nan_loss_stops_training(variables, tmp_path, check_every):
    """NaN images: with a check every step the first step stops the run; with
    none, the epoch's end does; the history is written either way."""
    x = np.full((8, 32, 32, 3), np.nan, np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
    cfg = TrainConfig(epochs=3, steps_per_epoch=2, loss="categorical", ckpt_dir=str(tmp_path),
                      nan_check_every=check_every)
    tr = Trainer(_port(variables), cfg, device="cpu")
    hist = tr.fit(lambda: iter([(x, y)] * 2), verbose=0)
    assert hist["loss"] == [] and tr.global_step == (1 if check_every else 2)
    assert os.path.isfile(tmp_path / "model_hist.json")


def test_distillation_matches_jax(variables, tmp_path):
    """loss + weight * KL(teacher || student) at the temperature; the teacher
    is the starting model in eval mode."""
    data = _batches(3)
    common = dict(epochs=1, steps_per_epoch=2, lr_base=1e-2, loss="categorical",
                  monitor="loss")
    jtr = _jax_trainer(variables, JaxTrainConfig(ckpt_dir=str(tmp_path / "j"), **common))
    jtr.set_teacher(JaxTiny(), variables, temperature=5.0, weight=0.5)
    tr = Trainer(_port(variables), TrainConfig(ckpt_dir=str(tmp_path / "p"), **common),
                 device="cpu")
    tr.set_teacher(_port(variables), temperature=5.0, weight=0.5)
    _assert_history(tr.fit(data, verbose=0), jtr.fit(data, verbose=0))


def test_uint8_batches_are_rescaled(variables):
    x8 = np.random.RandomState(1).randint(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)
    y = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
    losses = {}
    for key, batch in (("u8", x8), ("f32", x8.astype(np.float32) / 255.0)):
        tr = Trainer(_port(variables), TrainConfig(loss="categorical"), device="cpu")
        losses[key + "_eval"] = float(tr.eval_step(batch, y)[0])
        losses[key] = float(tr.train_step(batch, y, 1e-3))
    assert losses["u8"] == pytest.approx(losses["f32"], abs=1e-6)
    assert losses["u8_eval"] == pytest.approx(losses["f32_eval"], abs=1e-6)


class _Fixed(nn.Module):
    """Outputs the first ``width`` pixels of the first row."""

    def __init__(self, width):
        super().__init__()
        self.width = width
        self.w = nn.Parameter(torch.ones(()))

    def forward(self, x):
        return x[:, 0, 0, :self.width] * self.w


@pytest.mark.parametrize("width,labels,want", [
    (1, np.array([[1.0], [0.0], [0.0], [0.0]], np.float32), 0.75),  # one logit: > 0.5
    (3, np.eye(3, dtype=np.float32)[[0, 2, 1, 1]], 0.75),            # one-hot: argmax
    (3, np.array([0, 2, 1, 1], np.int64), 0.75),                    # class ids
    (3, np.ones((4, 2), np.float32), float("nan")),                 # no rule: NaN
])
def test_eval_accuracy_rules(width, labels, want):
    x = np.zeros((4, 1, 1, 3), np.float32)
    x[:, 0, 0, :] = [[0.9, 0.1, 0.0], [0.2, 0.1, 0.3], [0.7, 0.0, 0.1], [0.1, 0.9, 0.0]]
    tr = Trainer(_Fixed(width), TrainConfig(loss="bce_timm" if width == 1 else "categorical"),
                 device="cpu")
    if labels.shape[-1] == 2:  # no loss takes these labels; only the accuracy matters here
        tr._loss = lambda y, out: out.sum()
    acc = float(tr.eval_step(x, labels)[1])
    assert (np.isnan(want) and np.isnan(acc)) or acc == pytest.approx(want)


def test_metric_log_and_dropout_draws(variables, tmp_path):
    """One JSONL row an epoch after the config; dropout at 0.1 draws from the
    trainer's seeded generator: the same seed, the same history."""
    data = _batches(4)
    cfg = dict(epochs=2, steps_per_epoch=2, loss="categorical", monitor="loss", seed=7,
               log_dir=str(tmp_path / "logs"))
    runs = [Trainer(_port(variables, 0.1), TrainConfig(ckpt_dir=str(tmp_path / str(i)), **cfg),
                    device="cpu").fit(data, verbose=0) for i in range(2)]
    np.testing.assert_equal(runs[0], runs[1])  # NaN validation entries: no val set
    assert all(np.isfinite(runs[0]["loss"]))
    rows = [json.loads(line) for line in open(tmp_path / "logs" / "model.jsonl")]
    assert rows[0]["_config"]["seed"] == 7 and sum("loss" in r for r in rows) == 4


def test_mixup_and_cutmix_in_the_step(variables):
    tr = Trainer(_port(variables), TrainConfig(loss="categorical", mixup_alpha=0.4,
                                               cutmix_alpha=0.8), device="cpu")
    x, y = next(_batches(5)())
    assert np.isfinite(float(tr.train_step(x, y, 1e-3)))


def test_where_the_trainer_runs(variables, monkeypatch):
    """On the card unless the CPU is asked for; no CUDA is an error. f32
    compute on CUDA is taken (ROADMAP A15): the steps run with TF32 off."""
    monkeypatch.delenv("VIPTPU_PLATFORM", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(_port(variables), TrainConfig())
        # f32 on CUDA is not refused: the trainer gets as far as moving the
        # model to the card, which this build cannot do
        with pytest.raises((AssertionError, RuntimeError)) as err:
            Trainer(_port(variables), TrainConfig(), device="cuda")
        assert not isinstance(err.value, NotImplementedError)
    else:
        tr = Trainer(_port(variables), TrainConfig(), device="cuda")
        assert tr.device.type == "cuda" and tr.compute_dtype == torch.float32
    monkeypatch.setenv("VIPTPU_PLATFORM", "cpu")
    assert Trainer(_port(variables), TrainConfig()).device.type == "cpu"
    with pytest.raises(ValueError, match="lr_schedule"):
        Trainer(_port(variables), TrainConfig(lr_schedule="nope"), device="cpu")


def test_train_steps_tool_runs_on_the_cpu(monkeypatch, capsys):
    """The tool behind PERF.md's loss trajectories, at batch 1 for two steps
    from both inits (f32 on the CPU; narrowed here, full width on the card)."""
    from test_torch_gcvit import NARROW
    from vip_cup_2022_tpu_torch.tools import train_steps

    full = train_steps.create_model
    monkeypatch.setattr(train_steps, "create_model",
                        lambda name, **kw: full(name, **NARROW, **kw))
    monkeypatch.setenv("VIPTPU_PLATFORM", "cpu")
    results = train_steps.main(["--init", "registry", "perturbed", "--batch", "1",
                                "--steps", "2"])
    assert [r["init"] for r in results] == ["registry", "perturbed"]
    assert all(len(r["losses"]) == 2 and np.isfinite(r["losses"]).all() for r in results)
    assert results[0]["losses"][0] != results[1]["losses"][0]
    assert capsys.readouterr().out.count("[train_steps]") == 2
