"""The port's ResNetRS50 member against the JAX package, on the CPU in f32:
BatchNorm, SE and the bottleneck block, the full-width model at 100 x 100
(its stages at 25 / 13 / 7 / 4, so both odd average pools run), the weight
bridge's ``batch_stats``, the model under int8 post-training quantization,
and the int8 CLI against the JAX CLI.

Tolerances: 1e-4 for float paths (the bar the JAX package held against
Keras). The quantized model: f32 sums in another order upstream can move
an activation across a rounding boundary of its int8 grid, which shifts
that site's output by one quantization step and every site after it. So
the int8 test holds each site's codes to the JAX pass's except where the
pre-rounding value lies within the site's f32 input difference of a .5
boundary, and the output to 1e-3 of max|ref| or, where larger, the port's
own output change under a one-ulp change of the input.
"""
import copy
import json

import flax
from flax import linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu import quant as jquant
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.models import resnet_rs as jrs
from vip_cup_2022_tpu.ops.norms import BatchNorm as JaxBatchNorm
from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu_torch import quant
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.models import resnet_rs as rs
from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q
from vip_cup_2022_tpu_torch.ops.norms import BatchNorm
from vip_cup_2022_tpu_torch.weights.from_jax import state_dict_from_flax

ATOL = 1e-4
QUANT_REL = 1e-3
JAX_INT8_SITES = 52  # 16 blocks x conv_1/2/3 + 4 projections


def _perturb(tree, rng):
    """BN statistics and affine parameters drawn so that every leaf matters
    and activations stay O(1) through 16 residual blocks."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k == "moving_mean":
            tree[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        elif k == "moving_variance":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "gamma":
            tree[k] = rng.uniform(0.5, 1.0, v.shape).astype(np.float32)
        elif k in ("beta", "bias"):
            tree[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
    return tree


def _tree(variables, seed):
    return _perturb(jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables)),
                    np.random.RandomState(seed))


def _load(port, tree):
    """``tree`` loaded into ``port``, in eval mode (a BN in training mode
    normalises with its batch's statistics)."""
    port.load_state_dict(state_dict_from_flax(tree, port.state_dict(), strict=True))
    return port.eval()


def _run(port, *xs):
    with torch.inference_mode():
        return port(*(torch.from_numpy(x) for x in xs)).numpy()


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_batchnorm_matches_jax(dtype):
    x = np.random.RandomState(1).randn(2, 5, 3, 16).astype(np.float32)
    mod = JaxBatchNorm(epsilon=1e-5, dtype=dtype and jnp.bfloat16)
    tree = _tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = np.asarray(mod.apply(tree, jnp.asarray(x)), np.float32)
    port = _load(BatchNorm(16, 1e-5, dtype and torch.bfloat16), tree)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.dtype == (torch.bfloat16 if dtype else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL if dtype is None else 1e-2)


def test_se_matches_jax():
    x = np.random.RandomState(3).randn(2, 6, 5, 64).astype(np.float32)
    mod = jrs.SE(16, 0.25)
    tree = _tree(mod.init(jax.random.PRNGKey(1), jnp.asarray(x)), 4)
    port = _load(rs.SE(16, 0.25, torch.float32), tree)
    np.testing.assert_allclose(_run(port, x), np.asarray(mod.apply(tree, jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("strides,size,cin", [(1, 9, 32), (2, 9, 32), (2, 13, 64), (1, 6, 64)])
def test_bottleneck_block_matches_jax(strides, size, cin):
    """The projection shortcut at stride 1 and 2; odd sizes make the 2 x 2
    SAME average pool's last window cover one row and column."""
    cfg = jrs.ResNetRSConfig()
    x = np.random.RandomState(size).randn(2, size, size, cin).astype(np.float32)
    mod = jrs.BottleneckBlock(cfg, filters=16, strides=strides, use_projection=True,
                              survival_probability=0.0)
    tree = _tree(mod.init(jax.random.PRNGKey(2), jnp.asarray(x)), 5)
    port = _load(rs.BottleneckBlock(rs.ResNetRSConfig(), cin, 16, strides, True), tree)
    want = np.asarray(mod.apply(tree, jnp.asarray(x)))
    got = _run(port, x)
    assert got.shape == want.shape == (2, -(-size // strides), -(-size // strides), 64)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_registry_names():
    from vip_cup_2022_tpu.models import list_models

    from vip_cup_2022_tpu_torch.models.registry import is_model

    jax_names = list_models("resnetrs*") + list_models("ResNetRS*")
    assert len(jax_names) == 9 and all(is_model(n) for n in jax_names)


# ---------------------------------------------------------------------------
# the full-width model at 100 x 100, float and int8
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rs50():
    """Full-width ResNetRS50 at 100 x 100 with perturbed BN statistics, a
    batch of two images, and the JAX model's f32 logits."""
    module, variables, _ = jax_create_model("ResNetRS50", input_size=(100, 100), nb_classes=1,
                                            classifier_activation=None)
    tree = _tree(variables, 0)
    x = np.random.RandomState(6).uniform(0, 1, (2, 100, 100, 3)).astype(np.float32)
    port, _ = create_model("ResNetRS50", input_size=(100, 100), nb_classes=1,
                           classifier_activation=None)
    transfer_weights(tree, port, strict=True)
    want = np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x)))
    return module, tree, x, port, want


def test_full_width_resnetrs50_matches_jax(rs50):
    _, _, x, port, want = rs50
    got = _run(port, x)
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_strict_load_needs_every_statistic(rs50):
    _, tree, _, _, _ = rs50
    broken = copy.deepcopy(tree)
    del broken["batch_stats"]["c4_block_2"]["batch_norm_2"]["moving_variance"]
    fresh, _ = create_model("ResNetRS50", input_size=(100, 100), nb_classes=1)
    with pytest.raises(ValueError, match="c4_block_2.batch_norm_2.running_var: missing"):
        transfer_weights(broken, fresh, strict=True)


def _jax_site_inputs(fn, sites, x):
    """{site: f32 input} of each calibrated conv / dense in one JAX call."""
    seen = {}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and args and isinstance(mod, (linen.Conv,
                                                                           linen.Dense)):
            site = "/".join(str(p) for p in mod.path)
            if site in sites:
                seen[site] = np.asarray(args[0], np.float32)
        return next_fun(*args, **kwargs)

    with linen.intercept_methods(record):
        out = np.asarray(fn(jnp.asarray(x)))
    return out, seen


def _port_site_inputs(model, x):
    """{site: f32 input} of each quantized site in one port call."""
    seen = {}
    handles = [m.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__(mod.site, args[0].detach().float().numpy().copy()))
        for m in model.modules() if isinstance(m, quant.QuantizedSite)]
    try:
        out = _run(model, x)
    finally:
        for h in handles:
            h.remove()
    return out, seen


def _boundary_flips(xj, xp, amax):
    """(codes that differ, those whose pre-rounding value lies within the
    site's max|x_jax - x_port| / s of a .5 boundary) of one site's int8
    codes ``clip(round(x / s), -127, 127)``."""
    inv = np.float32(Q.f32_reciprocal(max(amax, 1e-8) / 127.0))
    vj, vp = xj * inv, xp * inv
    differ = np.clip(np.round(vj), -127, 127) != np.clip(np.round(vp), -127, 127)
    v = vj[differ]
    to_boundary = np.abs(v - np.floor(v) - 0.5)
    reach = np.abs(xj - xp).max() * inv + np.spacing(np.abs(v))  # + the product's own rounding
    return int(differ.sum()), int((to_boundary <= reach).sum())


def test_calibration_and_quantized_forward_match_jax(rs50):
    """Both packages calibrate the same 52 sites with the same abs-max
    (1e-6 relative). With the JAX table, at every quantized site the port's
    int8 codes equal the JAX pass's except at boundary elements: values
    within that site's f32 input difference of a .5 rounding boundary. The
    logits agree within 1e-3 of max|ref| or, where larger, the port's own
    logit change when the input moves by one ulp (one boundary element
    flipping moves a logit by about that much). The site report lists every
    calibrated site quantized, the stem, SE and head skipped."""
    module, tree, x, _, _ = rs50
    apply = lambda b: module.apply(tree, b)  # noqa: E731
    jscales = jquant.calibrate(apply, [jnp.asarray(x)])
    port, _ = create_model("ResNetRS50", input_size=(100, 100), nb_classes=1,
                           classifier_activation=None)
    transfer_weights(tree, port, strict=True)
    scales = quant.calibrate(port, [torch.from_numpy(x)])
    assert set(scales) == set(jscales) and len(scales) == JAX_INT8_SITES
    for site, v in jscales.items():
        assert abs(scales[site] - v) <= 1e-6 * v, site
    jreport, report = {}, {}
    want, jx = _jax_site_inputs(jquant.quantized(apply, jscales, report=jreport), jscales, x)
    Q.reset_launches()
    qport = quant.quantized(port, jscales, report=report)
    got, px = _port_site_inputs(qport, x)
    assert set(jx) == set(px) == set(jscales)
    flips = {site: _boundary_flips(jx[site], px[site], jscales[site]) for site in jscales}
    print("int8 codes differing / of them at a boundary, per site:",
          {s: f for s, f in flips.items() if f[0]})
    assert all(n == at_boundary for n, at_boundary in flips.values()), flips
    ulp = max(np.abs(_run(qport, x * np.float32(1 + 2.0 ** -23)) - got).max(),
              np.abs(_run(qport, x * np.float32(1 - 2.0 ** -24)) - got).max())
    bound = max(QUANT_REL * np.abs(want).max(), ulp)
    print(f"logits max|d| {np.abs(got - want).max():.3e}, one-ulp sensitivity {ulp:.3e}, "
          f"bound {bound:.3e}")
    assert np.abs(got - want).max() <= bound
    assert report == jreport and len(report["quantized_sites"]) == JAX_INT8_SITES
    assert Q.LAUNCHES["ptq_int8_conv"] == 0  # CPU tensors: the plain version
    assert {"stem_conv_1/conv", "c2_block_0/se/se_reduce", "predictions"} <= set(
        report["skipped_sites"])


def test_quantized_bf16_model_needs_f32_weights(rs50):
    _, tree, x, _, _ = rs50
    port, _ = create_model("ResNetRS50", input_size=(100, 100), nb_classes=1,
                           dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="quantized from the f32 values"):
        quant.quantized(port, {"c2_block_0/conv_1/conv": 1.0})


@pytest.mark.slow
def test_resnetrs50_at_200_matches_jax():
    module, variables, _ = jax_create_model("ResNetRS50", input_size=(200, 200), nb_classes=1,
                                            classifier_activation=None)
    tree = _tree(variables, 7)
    x = np.random.RandomState(8).uniform(0, 1, (2, 200, 200, 3)).astype(np.float32)
    port, _ = create_model("ResNetRS50", input_size=(200, 200), nb_classes=1,
                           classifier_activation=None)
    transfer_weights(tree, port, strict=True)
    np.testing.assert_allclose(_run(port, x), np.asarray(module.apply(tree, jnp.asarray(x))),
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the CLI with VIPTPU_INT8
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def workspace(tmp_path_factory, rs50):
    """Eleven JPEGs (one odd-sized), an input CSV, and the 100 x 100
    ResNetRS50 fold behind a one-member manifest; the head's bias puts
    0.487 among the images' float probabilities."""
    _, tree, _, _, _ = rs50
    root = tmp_path_factory.mktemp("torch_rs50")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(9)
    names = []
    for i in range(10):
        names.append(f"img_{9 - i:03d}.jpg")
        Image.fromarray(rng.randint(0, 255, (200, 200, 3), dtype=np.uint8)).save(
            img_dir / names[-1], quality=92)
    Image.fromarray(rng.randint(0, 255, (160, 240, 3), dtype=np.uint8)).save(
        img_dir / "odd.jpg", quality=92)
    names.append("odd.jpg")
    input_csv = img_dir / "input.csv"
    input_csv.write_text("filename\n" + "".join(f"{n}\n" for n in names))
    ckpt_dir = root / "ckpts" / "ResNetRS50-200x200" / "ckpt"
    ckpt_dir.mkdir(parents=True)
    (ckpt_dir / "config.json").write_text(json.dumps(
        {"nb_classes": 1, "classifier_activation": "sigmoid"}))
    (root / "ckpts" / "ckpts.json").write_text(json.dumps([["ResNetRS50-200x200", [100, 100], 0]]))
    save_variables(str(ckpt_dir / "fold0.msgpack"), tree)
    return root, input_csv, names, ckpt_dir, tree


def _recorded(monkeypatch, cls, into: list):
    real = cls.predict_soln_fused

    def record(self, cfg, *a, **kw):
        into.append(real(self, cfg, *a, **kw))
        return into[-1]

    monkeypatch.setattr(cls, "predict_soln_fused", record)


def test_int8_cli_matches_jax_cli(workspace, monkeypatch):
    from vip_cup_2022_tpu.infer.engine import EnsembleEngine as JaxEngine

    import main as jax_cli
    import main_torch

    root, input_csv, names, ckpt_dir, tree = workspace
    monkeypatch.setenv("VIPTPU_CKPT_DIR", str(root / "ckpts"))
    monkeypatch.setenv("VIPTPU_VERBOSE", "0")
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    monkeypatch.setenv("VIPTPU_NO_JIT_CACHE", "1")
    monkeypatch.setenv("VIPTPU_PLATFORM", "cpu")
    ours = []
    _recorded(monkeypatch, engine.EnsembleEngine, ours)
    main_torch.main(["main_torch.py", str(input_csv), str(root / "float.csv")])
    logit = np.log(ours[0]["raw"] / (1 - ours[0]["raw"]))
    tree = copy.deepcopy(tree)
    tree["params"]["predictions"]["bias"] = (tree["params"]["predictions"]["bias"]
                                             + np.log(0.487 / 0.513) - np.median(logit)
                                             ).astype(np.float32)
    save_variables(str(ckpt_dir / "fold0.msgpack"), tree)

    monkeypatch.setenv("VIPTPU_INT8", "ResNetRS50")
    theirs = []
    _recorded(monkeypatch, JaxEngine, theirs)
    Q.reset_launches()
    main_torch.main(["main_torch.py", str(input_csv), str(root / "torch.csv")])
    jax_cli.main(["main.py", str(input_csv), str(root / "jax.csv")])
    got, want = ours[-1], theirs[-1]
    assert list(got["filename"]) == list(want["filename"]) == sorted(names)
    np.testing.assert_allclose(got["raw"], want["raw"].to_numpy(), atol=1e-3)
    clear = np.abs(want["raw"].to_numpy() - 0.487) > 1e-3
    np.testing.assert_array_equal(got["logit"][clear], want["logit"].to_numpy()[clear])
    assert {0.0, 1.0} <= set(got["logit"])
    torch_rows = (root / "torch.csv").read_text().splitlines()
    jax_rows = (root / "jax.csv").read_text().splitlines()
    assert torch_rows[0] == jax_rows[0] == "filename,logit"
    assert [r for r, c in zip(torch_rows[1:], clear) if c] == \
        [r for r, c in zip(jax_rows[1:], clear) if c]


def test_load_members_quantizes_from_the_tree_it_read(workspace, monkeypatch):
    """An int8 member's checkpoint is read once: ``load_members`` keeps the
    f32 tree it loaded, and a bf16 fold quantized from that tree holds the
    int8 weights and column scales of the same fold held in f32."""
    _, _, _, ckpt_dir, _ = workspace
    path = str(ckpt_dir / "fold0.msgpack")
    real, reads = engine.load_weights, []
    monkeypatch.setattr(engine, "load_weights", lambda p: reads.append(p) or real(p))
    cfg = [("ResNetRS50-200x200", [path], (100, 100), 0)]
    eng = engine.EnsembleEngine(device="cpu", compute_dtype=torch.bfloat16, verbose=0)
    try:
        members, f32 = eng.load_members(cfg, keep_f32=[True])
        assert reads == [path]
        assert eng.load_members(cfg)[1] == [None]
    finally:
        eng.close()
    fold = members[0][0][0]
    assert fold.c2_block_0.conv_1.conv.weight.dtype == torch.bfloat16
    ref, _ = create_model("ResNetRS50", input_size=(100, 100), nb_classes=1,
                          classifier_activation="sigmoid")
    transfer_weights(real(path), ref, strict=True)
    scales = {"c2_block_0/conv_1/conv": 1.0, "c3_block_0/conv_2/conv": 2.0}
    quant.quantized(fold, scales, weights=f32[0][0])
    quant.quantized(ref, scales)
    for site in scales:
        got, want = fold.get_submodule(site.replace("/", ".")), ref.get_submodule(
            site.replace("/", "."))
        assert torch.equal(got.qweight, want.qweight)
        assert torch.equal(got.colscale, want.colscale)


@pytest.mark.parametrize("env", ["all", "1", "ResNetRS50,convnext_tiny_in22k"])
def test_int8_for_convnext_raises(tmp_path, monkeypatch, env):
    monkeypatch.setenv("VIPTPU_INT8", env)
    cfg = [("convnext_tiny_in22k-200x200", [], (32, 32), 0), ("ResNetRS50-200x200", [], (64, 64), 0)]
    with pytest.raises(NotImplementedError, match="A12b"):
        engine.EnsembleEngine._int8_members(cfg, engine.EnsembleEngine._int8_names())


@pytest.mark.parametrize("env,want", [("auto", set()), ("", set()), ("off", set()), ("0", set()),
                                      ("all", {"*"}), ("1", {"*"}),
                                      ("ResNetRS50, ResNest50", {"ResNetRS50", "ResNest50"})])
def test_int8_names(monkeypatch, env, want):
    monkeypatch.setenv("VIPTPU_INT8", env)
    assert engine.EnsembleEngine._int8_names() == want
