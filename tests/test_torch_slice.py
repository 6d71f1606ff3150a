"""The port's one-member ConvNeXt CSV -> CSV slice against the JAX package:
host layer, resize, the model forward in f32 on the CPU (max|d| <= 1e-4, the
bar the JAX package held against Keras) and the CLI's CSV, byte for byte."""
import copy
import json
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.data.decode import decode_image as jax_decode_image
from vip_cup_2022_tpu.data.pipeline import _host_resize_uint8 as jax_host_resize
from vip_cup_2022_tpu.infer import engine as jax_engine
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.ops.resize import resize as jax_resize
from vip_cup_2022_tpu.ops.resize import resize_matrix as jax_resize_matrix
from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu_torch.core.config import Config
from vip_cup_2022_tpu_torch.data.decode import decode_image
from vip_cup_2022_tpu_torch.data.pipeline import _host_resize_uint8
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.ops.resize import resize, resize_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NARROW = dict(nb_blocks=(1, 1, 1, 1), embed_dim=(32, 64, 256, 512))
MODEL_ATOL = 1e-4


def _perturb(tree, rng):
    """Layer scale ~ U(0.5, 1.5) (the 1e-6 init would hide every block's MLP),
    LN params and biases off their 1 / 0 init, so every leaf matters."""
    for k, val in tree.items():
        if isinstance(val, dict):
            if "beta" in val:
                val["gamma"] = rng.uniform(0.5, 1.5, val["gamma"].shape).astype(np.float32)
                val["beta"] = rng.uniform(-0.1, 0.1, val["beta"].shape).astype(np.float32)
            else:
                _perturb(val, rng)
        elif k == "gamma":
            tree[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        elif k == "bias":
            tree[k] = rng.uniform(-0.1, 0.1, val.shape).astype(np.float32)
    return tree


def _jax_variables(seed=0, **kw):
    module, variables, _ = jax_create_model("convnext_tiny_in22k", rng=jax.random.PRNGKey(seed), **kw)
    tree = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))
    _perturb(tree["params"], np.random.RandomState(seed))
    return module, tree


# ---------------------------------------------------------------------------
# host layer and resize
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_in,n_out,method", [
    (200, 224, "bicubic"), (200, 64, "bicubic"), (256, 200, "bicubic"), (144, 200, "bicubic"),
    (7, 12, "bilinear"), (20, 9, "nearest"),
])
def test_resize_matrix_equals_jax(n_in, n_out, method):
    np.testing.assert_array_equal(resize_matrix(n_in, n_out, method),
                                  jax_resize_matrix(n_in, n_out, method))


@pytest.mark.parametrize("size", [(224, 224), (64, 64), (200, 200)])
def test_resize_matches_jax(size):
    x = np.random.RandomState(1).uniform(0, 1, (2, 200, 200, 3)).astype(np.float32)
    got = resize(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_resize(jnp.asarray(x), size)), atol=1e-5)


@pytest.mark.parametrize("shape", [(256, 144), (200, 200), (199, 201)])
def test_host_resize_uint8_equals_jax(shape):
    img = np.random.RandomState(2).randint(0, 256, (*shape, 3)).astype(np.uint8)
    np.testing.assert_array_equal(_host_resize_uint8(img, (200, 200)),
                                  jax_host_resize(img, (200, 200)))


def test_decode_equals_jax(tmp_path):
    arr = np.random.RandomState(3).randint(0, 255, (40, 30, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.jpg", quality=90)
    Image.fromarray(arr).save(tmp_path / "b.png")
    for name in ("a.jpg", "b.png"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(decode_image(path), jax_decode_image(path))


def test_manifest_and_tables_equal_jax(tmp_path):
    for base, files in (("convnext_tiny_in22k-200x200", ["fold1.msgpack", "fold0.msgpack"]),
                        ("ResNetRS50-200x200", ["m.h5"]), ("GCViTTiny-224x224", [])):
        d = tmp_path / base / "ckpt"
        d.mkdir(parents=True)
        for f in files:
            (d / f).write_bytes(b"")
    manifest = [["convnext_tiny_in22k-200x200", [200, 200], 0], ["ResNetRS50-200x200", [200, 200], 0],
                ["GCViTTiny-224x224", [224, 224], 0]]
    path = tmp_path / "ckpts.json"
    path.write_text(json.dumps(manifest))
    assert (engine.load_manifest(str(tmp_path), str(path), allow_missing=True)
            == jax_engine.load_manifest(str(tmp_path), str(path), allow_missing=True))
    with pytest.raises(ValueError, match="no model found for : GCViTTiny-224x224"):
        engine.load_manifest(str(tmp_path), str(path))
    assert engine.registry_name("GCViTTiny-224x224") == jax_engine.registry_name("GCViTTiny-224x224")
    assert engine.NAME2BS == jax_engine.NAME2BS
    assert engine.NATIVE_SIZE == jax_engine.NATIVE_SIZE


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Ten 200x200 JPEGs and one odd-sized one, an input CSV, and a narrow
    ConvNeXt fold checkpoint behind a one-member manifest whose config.json
    carries the narrow widths (both engines read it)."""
    root = tmp_path_factory.mktemp("torch_e2e")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(7)
    names = []
    for i in range(10):
        arr = rng.randint(0, 255, size=(200, 200, 3), dtype=np.uint8)
        names.append(f"img_{9 - i:03d}.jpg")  # listed out of order: the CSV sorts
        Image.fromarray(arr).save(img_dir / names[-1], quality=92)
    arr = rng.randint(0, 255, size=(256, 144, 3), dtype=np.uint8)
    Image.fromarray(arr).save(img_dir / "odd.jpg", quality=92)
    names.append("odd.jpg")
    input_csv = img_dir / "input.csv"
    input_csv.write_text("filename\n" + "".join(f"{n}\n" for n in names))

    overrides = dict(nb_classes=1, classifier_activation="sigmoid", **NARROW)
    _, tree = _jax_variables(seed=5, input_size=(64, 64), **overrides)
    ckpt_dir = root / "ckpts" / "convnext_tiny_in22k-200x200" / "ckpt"
    ckpt_dir.mkdir(parents=True)
    with open(ckpt_dir / "config.json", "w") as fh:
        json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in overrides.items()}, fh)
    with open(root / "ckpts" / "ckpts.json", "w") as fh:
        json.dump([["convnext_tiny_in22k-200x200", [64, 64], 0]], fh)
    save_variables(str(ckpt_dir / "fold0.msgpack"), tree)
    return root, input_csv, names, ckpt_dir, tree


def _cfg(root, input_csv, out_name):
    cfg = Config({})
    cfg.test_csv = str(input_csv)
    cfg.infer_path = str(input_csv.parent)
    cfg.output_csv_path = str(root / out_name)
    cfg.debug, cfg.verbose, cfg.tta, cfg.agg, cfg.seed, cfg.thr = 0, 0, 1, "mean", 42, 0.487
    cfg.ckpt_cfg = engine.load_manifest(str(root / "ckpts"), str(root / "ckpts" / "ckpts.json"))
    return cfg


def test_decode_stream_equals_jax(workspace):
    root, input_csv, names, _, _ = workspace
    paths = [str(input_csv.parent / n) for n in names]
    ours = engine.EnsembleEngine(device="cpu", verbose=0)
    theirs = jax_engine.EnsembleEngine(verbose=0)
    got, want = list(ours._decode_stream(paths, 4)), list(theirs._decode_stream(paths, 4))
    assert [nv for _, nv in got] == [nv for _, nv in want] == [4, 4, 3]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ours.close()


# ---------------------------------------------------------------------------
# the model forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size,activation,nb_classes", [
    ((32, 32), None, 3), ((32, 32), "softmax", 3), ((40, 36), None, 5), ((64, 64), "sigmoid", 1),
])
def test_narrow_convnext_matches_jax(size, activation, nb_classes):
    kw = dict(input_size=size, nb_classes=nb_classes, classifier_activation=activation, **NARROW)
    module, tree = _jax_variables(seed=1, **kw)
    x = np.random.RandomState(4).uniform(0, 1, (2, *size, 3)).astype(np.float32)
    want = np.asarray(module.apply(tree, jnp.asarray(x)))
    port, _ = create_model("convnext_tiny_in22k", **kw)
    transfer_weights(tree, port)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)


@pytest.mark.slow
def test_full_width_convnext_tiny_matches_jax():
    kw = dict(input_size=(200, 200))
    module, tree = _jax_variables(seed=2, **kw)
    x = np.random.RandomState(5).uniform(0, 1, (2, 200, 200, 3)).astype(np.float32)
    port, _ = create_model("convnext_tiny_in22k", classifier_activation=None, **kw)
    jax_logits_module, _, _ = jax_create_model("convnext_tiny_in22k", classifier_activation=None,
                                               init=False, **kw)
    want = np.asarray(jax_logits_module.apply(tree, jnp.asarray(x)))
    transfer_weights(tree, port)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 21841)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_csv_equals_jax_byte_for_byte(workspace, monkeypatch):
    root, input_csv, names, ckpt_dir, tree = workspace
    ckpt = str(ckpt_dir / "fold0.msgpack")
    # place the 0.487 threshold in the widest gap between the images' logits,
    # so the CSV holds both decisions and neither sits near the threshold
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    calib = engine.EnsembleEngine(device="cpu", verbose=0)
    raw = calib.predict_soln_fused(_cfg(root, input_csv, "calib.csv"))["raw"]
    calib.close()
    z = np.sort(np.log(raw / (1 - raw)))
    gap = int(np.argmax(np.diff(z)))
    assert z[gap + 1] - z[gap] > 1e-3
    tree = copy.deepcopy(tree)
    tree["params"]["head_fc"]["bias"] = (tree["params"]["head_fc"]["bias"] + np.log(0.487 / 0.513)
                                         - (z[gap] + z[gap + 1]) / 2).astype(np.float32)
    save_variables(ckpt, tree)

    monkeypatch.setenv("VIPTPU_CKPT_DIR", str(root / "ckpts"))
    monkeypatch.setenv("VIPTPU_VERBOSE", "0")
    monkeypatch.setenv("VIPTPU_NO_JIT_CACHE", "1")
    import main as jax_cli
    import main_torch

    jax_out, torch_out = root / "jax.csv", root / "torch.csv"
    jax_cli.main(["main.py", str(input_csv), str(jax_out)])
    monkeypatch.setenv("VIPTPU_PLATFORM", "cpu")
    main_torch.main(["main_torch.py", str(input_csv), str(torch_out)])

    assert torch_out.read_bytes() == jax_out.read_bytes()
    lines = torch_out.read_text().splitlines()
    assert lines[0] == "filename,logit"
    assert [ln.split(",")[0] for ln in lines[1:]] == sorted(names)
    assert {ln.split(",")[1] for ln in lines[1:]} == {"0.0", "1.0"}


@pytest.mark.parametrize("env,match", [
    ({"VIPTPU_INT8": "all"}, "A12"),
    ({"VIPTPU_INT8": "EfficientNetV2T", "VIPTPU_CKPTS_JSON": "efficientnet.json"}, "A8b"),
])
def test_cli_unported_knobs_raise(workspace, monkeypatch, env, match):
    """Each knob whose path is not ported raises before any CSV is written;
    a ``VIPTPU_CKPTS_JSON`` case runs a random-init EfficientNetV2T manifest
    (``VIPTPU_INT8`` reaches only the members a manifest holds)."""
    root, input_csv, *_ = workspace
    monkeypatch.setenv("VIPTPU_PLATFORM", "cpu")
    monkeypatch.setenv("VIPTPU_CKPT_DIR", str(root / "ckpts"))
    env = dict(env)
    if "VIPTPU_CKPTS_JSON" in env:
        manifest = root / "ckpts" / env["VIPTPU_CKPTS_JSON"]
        manifest.write_text(json.dumps([["EfficientNetV2T-200x200", [64, 64], 0]]))
        env.update(VIPTPU_CKPTS_JSON=str(manifest), VIPTPU_ALLOW_RANDOM_INIT="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    import main_torch

    with pytest.raises(NotImplementedError, match=match):
        main_torch.main(["main_torch.py", str(input_csv), str(root / "never.csv")])
    assert not (root / "never.csv").exists()


@pytest.mark.parametrize("env", [
    {"VIPTPU_TTA": "2"},
    {"VIPTPU_TTA": "2", "VIPTPU_TTA_MODE": "fold"},
    {"VIPTPU_FUSED": "0"},
    {"VIPTPU_FUSED": "0", "VIPTPU_TTA": "2"},
    {"VIPTPU_FUSE_BN": "1"},
])
def test_cli_serving_knobs_write_the_csv(workspace, monkeypatch, env):
    """The serving options of ``main.py`` (TTA in both modes, the sequential
    path, the conv-BN fold) each write the sorted ``filename,logit`` CSV."""
    root, input_csv, names, *_ = workspace
    for k, v in dict(env, VIPTPU_PLATFORM="cpu", VIPTPU_CKPT_DIR=str(root / "ckpts"),
                     VIPTPU_MAX_BATCH="8", VIPTPU_VERBOSE="0").items():
        monkeypatch.setenv(k, v)
    import main_torch

    out = root / "knobs.csv"
    result = main_torch.main(["main_torch.py", str(input_csv), str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "filename,logit"
    assert [ln.split(",")[0] for ln in lines[1:]] == sorted(names) == list(result["filename"])
    assert {ln.split(",")[1] for ln in lines[1:]} <= {"0.0", "1.0"}
    assert np.isfinite(result["raw"]).all()


def test_unported_member_raises(workspace):
    root, input_csv, *_ = workspace
    cfg = _cfg(root, input_csv, "never.csv")
    cfg.ckpt_cfg = [("ResNet50D-200x200", [], (200, 200), 0)]
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    with pytest.raises(NotImplementedError,
                       match="only ConvNeXt, GCViT, ResNet-RS, EfficientNet, ResNest and NFNet "
                             "are ported; the other model families .* ROADMAP item A14"):
        eng.predict_soln_fused(cfg)
    eng.close()


def _tree_of(tree_module):
    """A member's tree maker: the JAX init drawn off its init by
    ``tree_module._tree``."""
    def make(name, size, overrides, seed):
        _, variables, _ = jax_create_model(name, rng=jax.random.PRNGKey(seed),
                                           input_size=(size, size), **overrides)
        return tree_module._tree(variables, 20 + seed)
    return make


def _member_workspace(root, prefix, seed, members):
    """Ten 200x200 JPEGs named ``prefix...`` and one odd-sized one, an input
    CSV, and a manifest of ``members`` ((name, manifest base, size, narrow
    overrides, tree maker, head)), each with a fold checkpoint written by the
    JAX package (its tree from ``make(name, size, overrides, i)``) and a
    config.json carrying its narrow widths; each head is then rescaled so
    that its logits over these images spread."""
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(seed)
    names = []
    for i in range(10):
        names.append(f"{prefix}{9 - i:03d}.jpg")
        Image.fromarray(rng.randint(0, 255, (200, 200, 3), dtype=np.uint8)).save(
            img_dir / names[-1], quality=92)
    Image.fromarray(rng.randint(0, 255, (144, 256, 3), dtype=np.uint8)).save(
        img_dir / "odd.jpg", quality=92)
    names.append("odd.jpg")
    input_csv = img_dir / "input.csv"
    input_csv.write_text("filename\n" + "".join(f"{n}\n" for n in names))
    trees, manifest = {}, []
    for i, (name, base, size, narrow, make, head) in enumerate(members):
        overrides = dict(nb_classes=1, classifier_activation="sigmoid", **narrow)
        tree = make(name, size, overrides, i)
        ckpt_dir = root / "ckpts" / base / "ckpt"
        ckpt_dir.mkdir(parents=True)
        with open(ckpt_dir / "config.json", "w") as fh:
            json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in overrides.items()}, fh)
        save_variables(str(ckpt_dir / "fold0.msgpack"), tree)
        trees[base] = ((size, size), overrides, tree)
        manifest.append([base, [size, size], 0])
    with open(root / "ckpts" / "ckpts.json", "w") as fh:
        json.dump(manifest, fh)
    # random weights pool noise images to nearly one feature vector: rescale
    # each head so that its logits z = f.K + b over these images become
    # 2 (z - mean z) / std z, and every member moves the ensemble mean
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    all_entries = _cfg(root, input_csv, "probe.csv").ckpt_cfg
    for i, ((base, (_, _, tree)), member) in enumerate(zip(trees.items(), members)):
        cfg = _cfg(root, input_csv, f"probe{i}.csv")
        cfg.ckpt_cfg = [all_entries[i]]
        p = eng.predict_soln_fused(cfg)["raw"]
        z = np.log(p / (1 - p))
        head = tree["params"][member[-1]]
        scale = 2.0 / z.std()
        head["bias"] = (-scale * (z.mean() - head["bias"])).astype(np.float32)
        head["kernel"] = (head["kernel"] * scale).astype(np.float32)
        save_variables(str(root / "ckpts" / base / "ckpt" / "fold0.msgpack"), tree)
    eng.close()
    return root, input_csv, names, trees


@pytest.fixture(scope="module")
def efficientnet_workspace(tmp_path_factory):
    """A narrow EfficientNetV2T at 64 and a narrow EfficientNetV1B4 at 72
    (the engine's resize to both)."""
    import test_torch_efficientnet as eff_tests

    make, narrow = _tree_of(eff_tests), eff_tests.NARROW
    return _member_workspace(
        tmp_path_factory.mktemp("torch_efficientnet_e2e"), "e_", 12,
        [("EfficientNetV2T", "EfficientNetV2T-200x200", 64, narrow["EfficientNetV2T"], make,
          "predictions"),
         ("EfficientNetV1B4", "EfficientNetV1B4-224x224", 72, narrow["EfficientNetV1B4"], make,
          "predictions")])


def test_efficientnet_cli_csv_equals_jax_byte_for_byte(efficientnet_workspace, monkeypatch):
    """Both EfficientNet members, TF-SAME (V1B4) and torch-mode (V2T)
    padding, through both CLIs: the CSVs equal byte for byte."""
    from test_torch_gcvit import assert_two_member_csvs_equal

    assert_two_member_csvs_equal(efficientnet_workspace, monkeypatch, head="predictions")


@pytest.fixture(scope="module")
def resnest_nfnet_workspace(tmp_path_factory):
    """A narrow ResNest50 at 64 and a narrow ECA_NFNetL0 at 72, under their
    manifest names."""
    import test_torch_efficientnet as eff_tests
    import test_torch_nfnet as nf_tests
    from test_torch_resnest import NARROW as NARROW_RESNEST

    return _member_workspace(
        tmp_path_factory.mktemp("torch_resnest_nfnet_e2e"), "r_", 13,
        [("ResNest50", "ResNest50-200x200", 64, NARROW_RESNEST, _tree_of(eff_tests),
          "predictions"),
         ("ECA_NFNetL0", "ECA_NFNetL0-200x200", 72, nf_tests.NARROW, _tree_of(nf_tests),
          "predictions")])


def test_resnest_nfnet_cli_csv_equals_jax_byte_for_byte(resnest_nfnet_workspace, monkeypatch):
    """ResNest50 (split attention, zero-counting and SAME average pools) and
    ECA_NFNetL0 (grouped standardized convs, ECA) through both CLIs: the
    CSVs equal byte for byte."""
    from test_torch_gcvit import assert_two_member_csvs_equal

    assert_two_member_csvs_equal(resnest_nfnet_workspace, monkeypatch, head="predictions")


def test_random_init_member_runs(workspace):
    """The allow-missing route: a member without checkpoints gets seeded random
    weights and the CSV is still written (the route the on-card smoke takes)."""
    root, input_csv, names, *_ = workspace
    cfg = _cfg(root, input_csv, "random.csv")
    cfg.ckpt_cfg = [("convnext_tiny_in22k-200x200", [], (32, 32), 0)]
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    out = eng.predict_soln_fused(cfg)
    eng.close()
    assert list(out["filename"]) == sorted(names)
    assert np.isfinite(out["raw"]).all()
    assert set(out["logit"]) <= {0.0, 1.0}


def test_device_and_dtype_selection(monkeypatch):
    monkeypatch.delenv("VIPTPU_DTYPE", raising=False)
    monkeypatch.setenv("VIPTPU_PLATFORM", "cpu")
    assert engine.default_device() == torch.device("cpu")
    assert engine.default_compute_dtype(torch.device("cpu")) == torch.float32
    assert engine.default_compute_dtype(torch.device("cuda")) == torch.bfloat16
    monkeypatch.setenv("VIPTPU_DTYPE", "bf16")
    assert engine.default_compute_dtype(torch.device("cpu")) == torch.bfloat16
    monkeypatch.setenv("VIPTPU_DTYPE", "half")
    with pytest.raises(ValueError, match="not recognized"):
        engine.default_compute_dtype(torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="A15"):
        engine.EnsembleEngine(device="cuda", compute_dtype=torch.float32)
    monkeypatch.setenv("VIPTPU_PLATFORM", "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.default_device()


def test_port_imports_no_jax():
    code = ("import sys; import vip_cup_2022_tpu_torch, vip_cup_2022_tpu_torch.infer.engine, "
            "vip_cup_2022_tpu_torch.ops.kernels.build, vip_cup_2022_tpu_torch.models.gcvit, "
            "vip_cup_2022_tpu_torch.ops.kernels.gcvit_block, vip_cup_2022_tpu_torch.ops.window, "
            "vip_cup_2022_tpu_torch.ops.attention, vip_cup_2022_tpu_torch.ops.conv, main_torch, "
            "vip_cup_2022_tpu_torch.models.resnet_rs, vip_cup_2022_tpu_torch.quant, "
            "vip_cup_2022_tpu_torch.models.efficientnet, vip_cup_2022_tpu_torch.models.aotnet, "
            "vip_cup_2022_tpu_torch.models.nfnets, vip_cup_2022_tpu_torch.ops.pool, "
            "vip_cup_2022_tpu_torch.ops.kernels.int8_gemm, "
            "vip_cup_2022_tpu_torch.tools.int8_pallas_spike, "
            "vip_cup_2022_tpu_torch.data.augment, vip_cup_2022_tpu_torch.utils.surgery, "
            "vip_cup_2022_tpu_torch.eval, vip_cup_2022_tpu_torch.tools.train_flip, "
            "vip_cup_2022_tpu_torch.tools.train_bench, "
            "vip_cup_2022_tpu_torch.ops.kernels.reference, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'vip_cup_2022_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_no_port_file_imports_jax():
    """No module of the port, nor ``main_torch.py`` or ``chip_smoke.py``,
    has an import statement naming jax, jaxlib, flax or the JAX package
    (``vip_cup_2022_tpu``, not ``vip_cup_2022_tpu_torch``), at any depth of
    the file: the check above sees only what importing runs."""
    import glob
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|vip_cup_2022_tpu)(?![\w])",
                         re.MULTILINE)
    files = glob.glob(os.path.join(REPO, "vip_cup_2022_tpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(REPO, f) for f in ("main_torch.py", "chip_smoke.py")]
    assert len(files) > 60
    bad = {f: pattern.findall(open(f).read()) for f in files}
    assert not {f: m for f, m in bad.items() if m}
