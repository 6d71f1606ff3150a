"""The port's ``eval`` package and its train tools on the CPU.

``eval.metrics`` and ``eval.harness`` against the JAX package's functions on
the same arrays and CSVs (every ``pred_format``, ``parity_diff`` on arrays
and on CSVs); ``evaluation`` (top-1 / top-5 over an image list) against the
JAX function on ``tests/test_torch_train_fit.py``'s tiny model with carried
weights: the same accuracies, probabilities within 1e-4; the trainer's
on-device balanced accuracy against ``eval.metrics``; and
``tools/train_flip.py --cpu`` and
``tools/train_bench.py --cpu`` at a narrowed size, whose JSON carries the
JAX tools' keys."""
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_train_fit import JaxTiny, _port
from vip_cup_2022_tpu.data.train_pipeline import EvalLoader as JaxEvalLoader
from vip_cup_2022_tpu.eval import harness as jax_harness
from vip_cup_2022_tpu.eval import metrics as jax_metrics
from vip_cup_2022_tpu_torch.eval import harness, metrics
from vip_cup_2022_tpu_torch.train.losses import balanced_accuracy


@pytest.mark.parametrize("seed,classes", [(0, 2), (1, 2), (2, 5)])
def test_metrics_equal_jax(seed, classes):
    rng = np.random.RandomState(seed)
    y_true = rng.randint(0, classes, 50)
    y_pred = np.where(rng.rand(50) < 0.7, y_true, rng.randint(0, classes, 50))
    probs = rng.rand(50, max(classes, 6))
    assert (metrics.balanced_accuracy_score(y_true, y_pred)
            == jax_metrics.balanced_accuracy_score(y_true, y_pred))
    for k in (1, 3, 5):
        assert metrics.top_k_accuracy(y_true, probs, k) == jax_metrics.top_k_accuracy(
            y_true, probs, k)
    assert metrics.competition_score(0.9, 0.7) == jax_metrics.competition_score(0.9, 0.7)


def test_the_trainers_balanced_accuracy_agrees_with_eval_metrics():
    """``train.losses.balanced_accuracy`` (on the device, thresholded) is the
    competition metric of ``eval.metrics`` on the same decisions."""
    rng = np.random.RandomState(3)
    for _ in range(5):
        y = (rng.rand(40, 1) < 0.4).astype(np.float32)
        p = rng.rand(40, 1).astype(np.float32)
        got = balanced_accuracy(torch.from_numpy(y), torch.from_numpy(p), threshold=0.487)
        want = metrics.balanced_accuracy_score(y[:, 0], (p[:, 0] > 0.487).astype(int))
        assert got.item() == pytest.approx(want, abs=1e-6)


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """A labeled input CSV and three prediction CSVs (out of order, one
    name missing): 0 / 1 decisions, raw probabilities, and raw
    probabilities that take two values."""
    root = tmp_path_factory.mktemp("eval_csvs")
    rng = np.random.RandomState(4)
    names = [f"im_{i:02d}.jpg" for i in range(30)]
    labels = rng.randint(0, 2, 30)
    (root / "input.csv").write_text(
        "filename,label\n" + "".join(f"{n},{y}\n" for n, y in zip(names, labels)))
    raw = rng.rand(29)
    order = rng.permutation(29)
    preds = {"binary": (raw > 0.487).astype(float), "raw": raw,
             "two": np.where(raw > 0.5, 0.9, 0.3)}
    for tag, values in preds.items():
        (root / f"{tag}.csv").write_text("filename,logit\n" + "".join(
            f"{names[i]},{float(values[i])!r}\n" for i in order))
    return root


@pytest.mark.parametrize("pred,fmt", [("binary", "binary"), ("binary", "auto"), ("raw", "raw"),
                                      ("raw", "auto"), ("two", "raw"), ("two", "auto")])
def test_evaluate_csv_equals_jax(csvs, pred, fmt):
    kw = dict(pred_csv=str(csvs / f"{pred}.csv"), pred_format=fmt)
    assert (harness.evaluate_csv(str(csvs / "input.csv"), **kw)
            == jax_harness.evaluate_csv(str(csvs / "input.csv"), **kw))


def test_evaluate_csv_rejects_an_unknown_format(csvs):
    with pytest.raises(ValueError, match="binary\\|raw\\|auto"):
        harness.evaluate_csv(str(csvs / "input.csv"), pred_csv=str(csvs / "raw.csv"),
                             pred_format="logits")


def test_parity_diff_equals_jax(csvs):
    a, b = str(csvs / "raw.csv"), str(csvs / "two.csv")
    assert harness.parity_diff(a, b) == jax_harness.parity_diff(a, b)
    x = np.random.RandomState(5).rand(20)
    y = x + np.random.RandomState(6).normal(0, 1e-4, 20)
    assert harness.parity_diff(x, y, atol=5e-5) == jax_harness.parity_diff(x, y, atol=5e-5)


def test_evaluation_matches_jax(tmp_path):
    """Seven JPEGs of three classes at batch 3 (a short last batch), the
    central crop at 0.9: top-1, top-5 and n as JAX's, and the logits the
    model gave within 1e-4 of JAX's forward on JAX's loader."""
    rng = np.random.RandomState(7)
    paths, labels = [], []
    for i in range(7):
        h, w = rng.randint(36, 60, 2)
        paths.append(str(tmp_path / f"e{i}.jpg"))
        cv2.imwrite(paths[-1], rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        labels.append(int(rng.randint(0, 3)))
    module = JaxTiny()
    variables = jax.tree_util.tree_map(
        np.asarray, dict(module.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))))
    kw = dict(batch_size=3, target_shape=(32, 32), central_crop=0.9)
    want = jax_harness.evaluation(module, variables, paths, labels, 3, **kw)
    model = _port(variables)
    outputs = []
    model.register_forward_hook(lambda m, i, o: outputs.append(o.detach().numpy()))
    got = harness.evaluation(model, paths, labels, 3, **kw)
    assert got == want and got["n"] == 7 and 0 < got["top1"] < 1
    fwd = jax.jit(lambda v, x: module.apply(v, x.astype(jnp.float32) / 255.0))
    loader = JaxEvalLoader(paths, labels, 3, 3, (32, 32), central_crop=0.9)
    ref = np.concatenate([np.asarray(fwd(variables, x)) for x, _ in loader])
    np.testing.assert_allclose(np.concatenate(outputs), ref, rtol=0, atol=1e-4)


# the last line of the JAX tools' output
FLIP_KEYS = {"n", "members", "task_balanced_acc_f32", "frac_within_0.01_of_thr_f32", "bf16",
             "int8"}
FLIP_ARM_KEYS = {"flip_rate", "balanced_acc_vs_f32_decisions", "task_balanced_acc",
                 "mean_abs_dp", "max_abs_dp"}
BENCH_KEYS = {"metric", "member", "batch", "dim", "per_step_ms", "img_per_sec",
              "compile_plus_first_step_s", "loss_first"}


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_train_flip_runs_on_the_cpu(tmp_path, capsys):
    """Three narrowed members trained a step each, then the three arms on
    four held-out images: the JAX tool's JSON, with finite numbers, and
    the trained weights on disk."""
    from vip_cup_2022_tpu_torch.tools import train_flip

    out = train_flip.main(["--cpu", "--epochs", "1", "--steps", "1", "--batch", "2",
                           "--n-eval", "4", "--eval-batch", "4", "--ckpt-dir", str(tmp_path)])
    assert _last_json(capsys.readouterr().out) == out
    assert set(out) == FLIP_KEYS and out["n"] == 4 and out["members"] == 3
    for arm in ("bf16", "int8"):
        assert set(out[arm]) == FLIP_ARM_KEYS and all(np.isfinite(list(out[arm].values())))
    assert sorted(p.name for p in tmp_path.glob("*.msgpack")) == [
        "GCViTTiny.msgpack", "ResNetRS50.msgpack", "convnext_tiny_in22k.msgpack"]


def test_train_bench_runs_on_the_cpu(capsys):
    """One timed step of ResNetRS50 at 64 px: the JAX tool's keys, the
    counted training FLOPs, and the MFU null off the card with its peak
    named."""
    from vip_cup_2022_tpu_torch.tools import train_bench

    out = train_bench.main(["--cpu", "--dim", "64", "--batch", "2", "--reps", "1"])
    assert _last_json(capsys.readouterr().out) == out
    assert BENCH_KEYS <= set(out) and out["member"] == "ResNetRS50" and out["batch"] == 2
    assert out["per_step_ms"] > 0 and np.isfinite(out["loss_first"])
    assert out["train_gflops_per_img"] > 0 and out["mfu"] is None
    assert "989 TFLOP/s" in out["mfu_peak"]
