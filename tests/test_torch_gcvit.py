"""The port's GCViT member against the JAX package: window and bias helpers,
the model forward in f32 on the CPU (max|d| <= 1e-4, the bar the JAX package
held against Keras), the weight bridge on the full GCViTTiny tree, and a
two-member (ConvNeXt + GCViT) CLI run whose CSV must equal the JAX CLI's byte
for byte."""
import json
import os
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _jax_init import jax_model
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.ops.attention import relative_position_index as jax_rel_index
from vip_cup_2022_tpu.ops.window import window_partition as jax_partition
from vip_cup_2022_tpu.ops.window import window_reverse as jax_reverse
from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu_torch.core.config import Config
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.ops.attention import (dense_relative_position_bias,
                                                   relative_position_index)
from vip_cup_2022_tpu_torch.ops.window import (crop_from_window, fit_window_pad,
                                                window_partition, window_reverse)
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from test_torch_slice import NARROW as NARROW_CONVNEXT  # noqa: E402
from test_torch_slice import _jax_variables as _jax_convnext_variables  # noqa: E402
from test_torch_slice import _perturb  # noqa: E402

# hd = 32 at every level, as in every GCViT variant; a local and a global
# block at every level
NARROW = dict(dim=32, num_heads=(1, 2, 4, 8), depths=(2, 2, 2, 2))
MODEL_ATOL = 1e-4


def _jax_gcvit(seed=0, name="GCViTTiny", **kw):
    """A JAX GCViT with its variables perturbed so every leaf matters: LN
    params and biases off their 1 / 0 init (as ``_perturb`` does) and the
    rel-pos tables ~ U(-1, 1), far above their 0.02 init."""
    module, variables, _ = jax_model(name, rng=jax.random.PRNGKey(seed), **kw)
    tree = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))
    rng = np.random.RandomState(seed)
    _perturb(tree["params"], rng)

    def tables(t):
        for k, v in t.items():
            if isinstance(v, dict):
                tables(v)
            elif k == "relative_position_bias_table":
                t[k] = rng.uniform(-1, 1, v.shape).astype(np.float32)
    tables(tree["params"])
    return module, tree


# ---------------------------------------------------------------------------
# window and bias helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,ws", [((2, 14, 21, 3), 7), ((1, 14, 14, 5), 14)])
def test_window_partition_and_reverse_equal_jax(shape, ws):
    x = np.random.RandomState(0).uniform(-1, 1, shape).astype(np.float32)
    win = window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jax_partition(jnp.asarray(x), ws)))
    back = window_reverse(win, ws, shape[1], shape[2])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_reverse(jnp.asarray(win.numpy()), ws, shape[1], shape[2])))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("h,w,ws", [(50, 50, 7), (25, 25, 7), (13, 13, 14), (56, 56, 7)])
def test_fit_window_pad_is_centred_and_crop_takes_the_top_left(h, w, ws):
    x = torch.arange(h * w, dtype=torch.float32).reshape(1, h, w, 1) + 1
    padded, h0, w0 = fit_window_pad(x, ws)
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    assert padded.shape == (1, h + ph, w + pw, 1) and (h0, w0) == (h, w)
    want = jnp.pad(jnp.asarray(x.numpy()), ((0, 0), (ph // 2, ph - ph // 2),
                                              (pw // 2, pw - pw // 2), (0, 0)))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(want))
    np.testing.assert_array_equal(crop_from_window(padded, h, w).numpy(),
                                  np.asarray(want)[:, :h, :w])


@pytest.mark.parametrize("ws", [3, 7, 14])
def test_relative_position_bias_equals_jax_gather(ws):
    np.testing.assert_array_equal(relative_position_index(ws, ws), jax_rel_index(ws, ws))
    table = np.random.RandomState(ws).randn((2 * ws - 1) ** 2, 3).astype(np.float32)
    idx = jax_rel_index(ws, ws).reshape(-1)
    want = jnp.transpose(jnp.asarray(table)[idx].reshape(ws * ws, ws * ws, 3), (2, 0, 1))
    got = dense_relative_position_bias(torch.from_numpy(table), ws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the model forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size,activation,nb_classes", [
    ((224, 224), None, 3), ((200, 200), "sigmoid", 1),
])
def test_narrow_gcvit_matches_jax(size, activation, nb_classes):
    """Every level runs a local and a global-query block; at 200 the stem grid
    of 50 is FitWindow-padded to 56 (25 to 28, 13 to 14) and cropped back."""
    kw = dict(input_size=size, nb_classes=nb_classes, classifier_activation=activation, **NARROW)
    module, tree = _jax_gcvit(seed=1, **kw)
    x = np.random.RandomState(4).uniform(0, 1, (2, *size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x)))
    port, _ = create_model("GCViTTiny", **kw)
    transfer_weights(tree, port, strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, nb_classes)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)


def test_full_gcvit_tiny_tree_bridges_strictly():
    """Every leaf of the full-width GCViTTiny Flax tree (shapes from an
    abstract init, values drawn here) lands in the port's state dict, in the
    torch layout, and nothing is left over on either side."""
    module, _, _ = jax_create_model("GCViTTiny", input_size=(224, 224), init=False)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), flax.core.unfreeze(shapes))
    port, _ = create_model("GCViTTiny", input_size=(224, 224))
    transfer_weights(tree, port, strict=True)
    src = flax_to_torch(tree)
    state = port.state_dict()
    assert set(src) == set(state)
    # 31 blocks x 13 leaves, 7 FeatExtracts x 4, 4 ReduceSizes x 9, stem conv 2, LN 2, head 2
    assert len(state) == 473
    for key, value in src.items():
        np.testing.assert_array_equal(state[key].numpy(), value)
    # the dense bias was gathered from the loaded tables
    blk = port.levels_2.blocks_1.attn
    np.testing.assert_array_equal(
        blk.bias_dense.numpy(),
        dense_relative_position_bias(blk.relative_position_bias_table.detach(), 14).numpy())
    assert blk.bias_dense.shape == (8, 196, 196)


def test_depthwise_branch_conv_takes_the_flax_kernel():
    """The branch's 3x3 depthwise conv: Flax (3, 3, 1, C) becomes (3, 3, C)."""
    module, tree = _jax_gcvit(seed=2, input_size=(224, 224), nb_classes=1, **NARROW)
    port, _ = create_model("GCViTTiny", input_size=(224, 224), nb_classes=1, **NARROW)
    transfer_weights(tree, port, strict=True)
    flax_k = tree["params"]["patch_embed"]["conv_down"]["conv_0"]["kernel"]
    assert flax_k.shape == (3, 3, 1, 32)
    np.testing.assert_array_equal(port.patch_embed.conv_down.conv_0.weight.detach().numpy(),
                                  flax_k[:, :, 0, :])


@pytest.mark.slow
def test_full_width_gcvit_tiny_matches_jax():
    kw = dict(input_size=(224, 224), nb_classes=1000, classifier_activation=None)
    module, tree = _jax_gcvit(seed=3, **kw)
    x = np.random.RandomState(5).uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(module.apply(tree, jnp.asarray(x)))
    port, _ = create_model("GCViTTiny", **kw)
    transfer_weights(tree, port, strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)


def test_registry_has_the_jax_gcvit_variants():
    from vip_cup_2022_tpu.models import list_models
    from vip_cup_2022_tpu_torch.models.registry import is_model

    names = list_models("gcvit*") + list_models("GCViT*")
    assert len(names) == 7
    assert all(is_model(n) for n in names)


# ---------------------------------------------------------------------------
# the CLI with two members
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def two_member_workspace(tmp_path_factory):
    """Ten 200x200 JPEGs and one odd-sized one, an input CSV, and a manifest
    of a narrow ConvNeXt at 200 and a narrow GCViT at 224 (the engine's
    200 -> 224 TF-bicubic resize), each with a fold checkpoint and a
    config.json carrying its narrow widths."""
    root = tmp_path_factory.mktemp("torch_gcvit_e2e")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(11)
    names = []
    for i in range(10):
        names.append(f"g_{9 - i:03d}.jpg")
        Image.fromarray(rng.randint(0, 255, (200, 200, 3), dtype=np.uint8)).save(
            img_dir / names[-1], quality=92)
    Image.fromarray(rng.randint(0, 255, (144, 256, 3), dtype=np.uint8)).save(
        img_dir / "odd.jpg", quality=92)
    names.append("odd.jpg")
    input_csv = img_dir / "input.csv"
    input_csv.write_text("filename\n" + "".join(f"{n}\n" for n in names))

    head = dict(nb_classes=1, classifier_activation="sigmoid")
    members = {
        "convnext_tiny_in22k-200x200": (
            (200, 200), dict(head, **NARROW_CONVNEXT),
            _jax_convnext_variables(seed=6, input_size=(64, 64), **head, **NARROW_CONVNEXT)[1]),
        "GCViTTiny-224x224": (
            (224, 224), dict(head, **NARROW),
            _jax_gcvit(seed=7, input_size=(224, 224), **head, **NARROW)[1]),
    }
    manifest = []
    for base, (dim, overrides, tree) in members.items():
        ckpt_dir = root / "ckpts" / base / "ckpt"
        ckpt_dir.mkdir(parents=True)
        with open(ckpt_dir / "config.json", "w") as fh:
            json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in overrides.items()}, fh)
        save_variables(str(ckpt_dir / "fold0.msgpack"), tree)
        manifest.append([base, list(dim), 0])
    with open(root / "ckpts" / "ckpts.json", "w") as fh:
        json.dump(manifest, fh)
    return root, input_csv, names, members


def _cfg(root, input_csv, out_name, entries=None):
    cfg = Config({})
    cfg.test_csv = str(input_csv)
    cfg.infer_path = str(input_csv.parent)
    cfg.output_csv_path = str(root / out_name)
    cfg.debug, cfg.verbose, cfg.tta, cfg.agg, cfg.seed, cfg.thr = 0, 0, 1, "mean", 42, 0.487
    cfg.ckpt_cfg = engine.load_manifest(str(root / "ckpts"), str(root / "ckpts" / "ckpts.json"))
    if entries is not None:
        cfg.ckpt_cfg = [cfg.ckpt_cfg[i] for i in entries]
    return cfg


def test_two_member_cli_csv_equals_jax_byte_for_byte(two_member_workspace, monkeypatch):
    assert_two_member_csvs_equal(two_member_workspace, monkeypatch)


def assert_two_member_csvs_equal(workspace, monkeypatch, head="head_fc"):
    """Put the threshold between the images, then run both CLIs on the
    workspace and compare their CSVs byte for byte. ``head`` is the Flax
    name of the first member's classifier, whose bias moves."""
    root, input_csv, names, members = workspace
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    # each member's probabilities from the port, then a shift of the first
    # member's head bias that puts the 0.487 threshold on the ensemble mean
    # as far from every image as it can while both decisions occur
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    p1, p2 = (eng.predict_soln_fused(_cfg(root, input_csv, f"m{i}.csv", [i]))["raw"]
              for i in range(2))
    eng.close()
    assert np.ptp(p2) > 1e-3  # the second member moves the ensemble mean
    z1 = np.log(p1 / (1 - p1))
    best, shift = 0.0, None
    for d in np.linspace(-8, 8, 3201):
        r = (1 / (1 + np.exp(-(z1 + d))) + p2) / 2 - 0.487
        if (r > 0).any() and (r < 0).any() and np.abs(r).min() > best:
            best, shift = np.abs(r).min(), d
    assert shift is not None and best > 1e-4
    first = next(iter(members))
    tree = members[first][2]
    tree["params"][head]["bias"] = (tree["params"][head]["bias"] + shift).astype(np.float32)
    save_variables(str(root / "ckpts" / first / "ckpt" / "fold0.msgpack"), tree)

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
