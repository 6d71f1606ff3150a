"""The SavedModel route (and the Keras h5 reader on files Keras itself
wrote), with TensorFlow: a ``tf_keras`` model saved as ``.h5`` both ways
(``save_weights`` and ``model.save``) and as a SavedModel reads the same
flat weights through the port's readers and the JAX package's; a narrow
ConvNeXt's variables in a SavedModel under their Keras names convert in the
port as in the JAX package, load through ``load_weights`` from the
directory and from ``saved_model.pb``, and serve in the engine exactly as
the same weights from ``.msgpack``."""
import json

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_keras_h5 import assert_trees_equal
from test_torch_slice import NARROW, _cfg, _jax_variables
from test_torch_weight_members import WRITERS
from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu.weights import keras_h5 as jax_h5
from vip_cup_2022_tpu.weights import savedmodel as jax_sm
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.models import create_model, load_weights
from vip_cup_2022_tpu_torch.weights import keras_h5, savedmodel

tf = pytest.importorskip("tensorflow")

NAME = "convnext_tiny_in22k"


def _dedupe(flat):
    return {keras_h5._dedupe_layer_prefix(k): v for k, v in flat.items()}


def test_keras_saved_files_read_as_in_jax(tmp_path):
    """Keras's own files, each layout: the port's readers equal the JAX
    package's bit for bit, and the SavedModel's variables are the h5's."""
    keras = tf.keras
    model = keras.Sequential([
        keras.layers.Input((16, 16, 3)),
        keras.layers.Conv2D(4, 3, name="stem_conv"),
        keras.layers.BatchNormalization(name="stem_bn"),
        keras.layers.DepthwiseConv2D(3, name="stack_0_MB_dw_"),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(2, name="predictions"),
    ], name="tiny")
    weights_h5, model_h5, sm_dir = (str(tmp_path / "w.h5"), str(tmp_path / "m.h5"),
                                    str(tmp_path / "sm"))
    model.save_weights(weights_h5)
    model.save(model_h5)
    model.save(sm_dir, save_format="tf")

    flats = []
    for path in (weights_h5, model_h5):
        got = keras_h5.read_keras_h5(path)
        assert_trees_equal(got, jax_h5.read_keras_h5(path))
        flats.append(_dedupe(got))
    sm = savedmodel.read_savedmodel(sm_dir)
    assert_trees_equal(sm, jax_sm.read_savedmodel(sm_dir))
    for flat in flats + [_dedupe(sm)]:
        assert sorted(flat) == sorted(flats[0])
        for k, v in flat.items():
            assert v.tobytes() == flats[0][k].tobytes(), k
    assert flats[0]["stack_0_MB_dw_/depthwise_kernel"].shape == (3, 3, 4, 1)
    assert_trees_equal(savedmodel.convert_savedmodel(sm_dir, "EfficientNetTiny"),
                       jax_sm.convert_savedmodel(sm_dir, "EfficientNetTiny"))


def _write_savedmodel(sm_dir, weights):
    """A SavedModel whose variables carry the Keras weight names."""
    holder = tf.train.Checkpoint()
    holder.variables = [tf.Variable(v, name=k) for k, v in weights.items()]
    tf.saved_model.save(holder, sm_dir)


@pytest.fixture(scope="module")
def convnext_savedmodel(tmp_path_factory):
    root = tmp_path_factory.mktemp("convnext_sm")
    kw = dict(nb_classes=1, classifier_activation="sigmoid", **NARROW)
    tree = _jax_variables(seed=5, input_size=(64, 64), **kw)[1]
    ckpt = root / "ckpts" / "convnext_tiny_in22k-200x200" / "ckpt"
    ckpt.mkdir(parents=True)
    _write_savedmodel(str(ckpt), WRITERS["convnext"](tree, NAME))
    (ckpt / "config.json").write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}))
    (root / "ckpts" / "ckpts.json").write_text(json.dumps(
        [["convnext_tiny_in22k-200x200", [64, 64], 0]]))
    return root, tree, kw


def test_savedmodel_conversion_equals_jax(convnext_savedmodel):
    root, tree, kw = convnext_savedmodel
    sm_dir = str(root / "ckpts" / "convnext_tiny_in22k-200x200" / "ckpt")
    got = savedmodel.convert_savedmodel(sm_dir, NAME)
    assert_trees_equal(got, jax_sm.convert_savedmodel(sm_dir, NAME))
    assert_trees_equal(got, tree, ordered=False)
    for path in (sm_dir, sm_dir + "/saved_model.pb"):
        assert_trees_equal(load_weights(path, NAME), got)
    port, _ = create_model(NAME, model_path=sm_dir, input_size=(64, 64), **kw)
    assert port.state_dict()["stem_conv.weight"].shape == (32, 3, 4, 4)


def test_savedmodel_manifest_serves_as_msgpack(convnext_savedmodel, tmp_path):
    """The engine resolves the member's ``saved_model.pb`` and serves it;
    the raw probabilities equal those of the same weights as ``.msgpack``."""
    from PIL import Image

    root, tree, kw = convnext_savedmodel
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(3)
    names = [f"s_{i}.jpg" for i in range(4)]
    for n in names:
        Image.fromarray(rng.randint(0, 255, (200, 200, 3), dtype=np.uint8)).save(img_dir / n)
    input_csv = img_dir / "input.csv"
    input_csv.write_text("filename\n" + "".join(f"{n}\n" for n in names))
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    cfg = _cfg(root, input_csv, "sm.csv")
    assert cfg.ckpt_cfg[0][1][0].endswith("saved_model.pb")
    from_sm = eng.predict_soln_fused(cfg)["raw"]
    msgpack_root = tmp_path / "msgpack"
    ckpt = msgpack_root / "ckpts" / "convnext_tiny_in22k-200x200" / "ckpt"
    ckpt.mkdir(parents=True)
    save_variables(str(ckpt / "fold0.msgpack"), tree)
    (ckpt / "config.json").write_text(
        (root / "ckpts" / "convnext_tiny_in22k-200x200" / "ckpt" / "config.json").read_text())
    (msgpack_root / "ckpts" / "ckpts.json").write_text((root / "ckpts" / "ckpts.json").read_text())
    from_msgpack = eng.predict_soln_fused(_cfg(msgpack_root, input_csv, "m.csv"))["raw"]
    eng.close()
    assert from_sm.shape == (4,) and np.array_equal(from_sm, from_msgpack)
