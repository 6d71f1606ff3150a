"""int8 post-training quantization of the five members beyond ResNet-RS and
ResNest (EfficientNetV2T, EfficientNetV1B4, ECA_NFNetL0, ConvNeXt, GCViT),
and of EfficientNetV2T_GC and an F-series NFNet, against the JAX package's
pass (``vip_cup_2022_tpu/quant/ptq.py``), on the CPU at narrow widths.

For each member both packages calibrate the same sites with the same abs-max
(1e-5 relative), and the port's quantized model reports the same quantized
and skipped sites in the same order as the JAX pass given the same table.
f32 sums in another order upstream can move an activation across a
rounding boundary of its int8 grid, as ``tests/test_torch_resnet_rs.py``
sets out; so, as there, each site's int8 codes equal the JAX pass's except
where the pre-rounding value lies within the site's f32 input difference of
a .5 boundary. One such flip moves a narrow random model's logit by up to
1e-2 of max|ref| at these depths (and a one-ulp change of the input need
not reach that boundary), so the logits are compared on a second port
forward in which each site's input takes the JAX value at the elements
whose codes flipped: everything else the port's own arithmetic, they agree
within 1e-3 of max|ref|. NFNet's weights are standardized in f32 by each package, and XLA's and
torch's moments and rsqrt can differ by an ulp, which moves a weight code
that lies on a .5 boundary: its sites' weight codes are held to the JAX
pass's but at such ties, and its logits are compared with the JAX pass's
weight codes installed in the port's sites (a code flipped at a tie moves
an NFNet's logits by far more than an activation's ulp does).
ConvNeXt and
GCViT are held on their fused block path (both packages forced to it; the
JAX side runs its Pallas kernels in interpret mode) and on the unfused one.
The class of each declares ``int8_sites_match_jax``. ConvNeXt's and
GCViT's cases run in ``test_torch_int8_blocks.py`` (a file of their own, so
that the test workers share the load).

Also: ``ptq_int8_conv_plain`` in groups against the JAX pass's
``_int8_conv`` with ``feature_group_count`` > 1, bit for bit; the engine
with ``VIPTPU_INT8=all`` on a narrow five-member manifest against the JAX
engine's; under ``-m slow`` each member's full-width site count against the
JAX pass's, traced by ``jax.eval_shape`` (no JAX forward at full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_init import jax_model
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from flax import linen
from test_torch_resnet_rs import _boundary_flips, _port_site_inputs, _run
from vip_cup_2022_tpu import quant as jquant
from vip_cup_2022_tpu.infer import engine as jax_engine
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.ops.conv import ScaledStdConv as JaxScaledStdConv
from vip_cup_2022_tpu.parallel.mesh import get_mesh
from vip_cup_2022_tpu.quant import ptq as jptq
from vip_cup_2022_tpu_torch import quant
from vip_cup_2022_tpu_torch.infer import engine
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights
from vip_cup_2022_tpu_torch.models.registry import model_entry
from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q

LOGITS_REL = 1e-3
SCALE_REL = 1e-5

# narrow configurations with sites of every kind: a 3 x 3 fused expansion at
# stride 2 (V2T), V1B4's TF-SAME blocks at an odd size, groups of 32 input
# channels (the NFNets: 1 / 2 / 2 / 2 groups in the L series, 1 / 2 / 4 / 4
# in the F series, whose stride-2 3 x 3 pads (0, 1) at an even size)
V2T = dict(out_channels=(16, 32, 32, 48, 64, 64), depthes=(1,) * 6, first_conv_filter=16,
           output_conv_filter=64)
V1B4 = dict(out_channels=(16, 24, 32, 48, 48, 64, 80), depthes=(1,) * 7, first_conv_filter=16,
            output_conv_filter=96)
NFNET_L = dict(num_blocks=(1, 2, 1, 1), out_channels=(128, 256, 256, 256), stem_width=32,
               group_size=32)
NFNET_F = dict(num_blocks=(1, 2, 1, 1), out_channels=(64, 128, 256, 256), stem_width=32,
               group_size=32)
CONVNEXT = dict(nb_blocks=(1, 1, 1, 1), embed_dim=(32, 64, 256, 512))
GCVIT = dict(dim=32, num_heads=(1, 2, 4, 8), depths=(2, 2, 2, 2))

# name, input side, narrow config, extra config (the block path)
CASES = {
    "EfficientNetV2T": ("EfficientNetV2T", 64, V2T, {}),
    "EfficientNetV1B4": ("EfficientNetV1B4", 57, V1B4, {}),
    "EfficientNetV2T_GC": ("EfficientNetV2T_GC", 64, V2T, {}),
    "ECA_NFNetL0": ("ECA_NFNetL0", 64, NFNET_L, {}),
    "NFNetF0": ("NFNetF0", 64, NFNET_F, {}),
    "convnext fused": ("convnext_tiny_in22k", 64, CONVNEXT, {"fused_block": True}),
    "convnext unfused": ("convnext_tiny_in22k", 64, CONVNEXT, {"fused_block": False}),
    "gcvit fused": ("GCViTTiny", 224, GCVIT, {"fused_block": True}),
    "gcvit unfused": ("GCViTTiny", 224, GCVIT, {"fused_block": False}),
}


def _perturb(tree, rng):
    """Every leaf off its init where the init would hide it: BN statistics and
    affine parameters, LN parameters, biases, gains (per-filter and scalar),
    layer scales, rel-pos tables."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in ("moving_variance", "gamma", "gain") and np.ndim(v):
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("moving_mean", "beta", "bias", "relative_position_bias_table"):
            tree[k] = rng.uniform(-0.1, 0.1, np.shape(v)).astype(np.float32)
        elif k == "gain":
            tree[k] = np.float32(0.5)
    return tree


def _jax_variables(name: str, seed: int, size: int, narrow: dict):
    """The JAX model's variables as ``jax_create_model`` draws them (one output); a
    member's cases and the engine's workspace share one compile of its init."""
    return jax_model(name, rng=jax.random.PRNGKey(seed), input_size=(size, size),
                     nb_classes=1, **narrow)[1]


def _pair(case: str, seed: int = 3):
    """(JAX module, perturbed f32 tree, port model holding it, input) of a case."""
    name, size, narrow, extra = CASES[case]
    kw = dict(input_size=(size, size), nb_classes=1, classifier_activation=None, **narrow,
              **extra)
    module, _, _ = jax_create_model(name, init=False, **kw)
    variables = _jax_variables(name, seed, size, narrow)
    tree = _perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)),
                    np.random.RandomState(seed))
    port, _ = create_model(name, **kw)
    transfer_weights(tree, port, strict=True)
    x = np.random.RandomState(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    return module, tree, port, x


def _jax_site_inputs(fn, sites, x):
    """(output, {site: f32 input}) of one JAX call, the inputs of each
    site's ``nn.Conv`` / ``nn.Dense`` / ``ScaledStdConv``: one jitted
    program (as the JAX package runs its models) that returns them beside
    the output, recorded at trace time."""

    def traced(b):
        seen = {}

        def record(next_fun, args, kwargs, context):
            mod = context.module
            if context.method_name == "__call__" and args and isinstance(
                    mod, (linen.Conv, linen.Dense, JaxScaledStdConv)):
                site = "/".join(str(p) for p in mod.path)
                if site in sites:
                    seen[site] = args[0]
            return next_fun(*args, **kwargs)

        with linen.intercept_methods(record):
            out = fn(b)
        return out, seen

    out, seen = jax.jit(traced)(jnp.asarray(x))
    return np.asarray(out), {site: np.asarray(v, np.float32) for site, v in seen.items()}


def _standardized_codes(params, module):
    """The JAX pass's int8 codes (K, N) and f32 scales (N,) of one
    standardized conv's weight."""
    std = jptq._standardized_weight(module, jnp.asarray(params["kernel"]),
                                    jnp.asarray(params["gain"]))
    q, s = jptq._quant_weight(std, (0, 1, 2))
    q = np.asarray(q)
    ratio = np.abs(np.asarray(std) / np.asarray(s)).reshape(-1, q.shape[-1])
    tie = np.abs(ratio - np.floor(ratio) - 0.5) < 1e-5
    return q.reshape(-1, q.shape[-1]), np.asarray(s), tie


def _standardized_sites_match_jax(qport, tree, scales) -> int:
    """At each standardized-conv site: the port's weight codes equal the JAX
    pass's but at ties (at most one code apart there); then the JAX codes
    and scales are installed in the port's site. Returns the sites checked."""
    n = 0
    for mod in qport.modules():
        if isinstance(mod, quant.QuantizedSite) and hasattr(mod.float_module, "gain"):
            want, s_w, tie = _standardized_codes(tree["params"][mod.site], mod.float_module)
            got = mod.qweight[:, :want.shape[0]].t().numpy()
            assert np.array_equal(got[~tie], want[~tie]), mod.site
            assert (np.abs(got.astype(int) - want) <= 1).all(), mod.site
            mod.qweight.copy_(Q.pack_weight(torch.from_numpy(want)))
            s_x = max(scales[mod.site], 1e-8) / 127.0
            mod.colscale.copy_(torch.tensor(s_x, dtype=torch.float32) * torch.from_numpy(s_w))
            n += 1
    return n


def _run_with_jax_codes(qport, x, jx, scales) -> np.ndarray:
    """The port's logits with each site's input set to the JAX input at the
    elements whose int8 codes differ from the JAX pass's."""
    def align(mod, args):
        xp = args[0]
        inv = Q.f32_reciprocal(max(scales[mod.site], 1e-8) / 127.0)
        xj = torch.from_numpy(np.array(jx[mod.site])).to(xp.dtype)
        differ = Q.quantize(xp, inv) != Q.quantize(xj, inv)
        return (torch.where(differ, xj, xp),)

    handles = [m.register_forward_pre_hook(align) for m in qport.modules()
               if isinstance(m, quant.QuantizedSite)]
    try:
        return _run(qport, x)
    finally:
        for h in handles:
            h.remove()


def _sites_match_jax(case: str) -> dict:
    """The calibration tables, the reports, every site's int8 codes and the
    int8 logits of both packages on one case; returns the JAX report."""
    module, tree, port, x = _pair(case)
    apply = lambda b: module.apply(tree, b)  # noqa: E731
    jscales = jquant.calibrate(apply, [jnp.asarray(x)], use_jit=True)  # one program, as on a TPU
    scales = quant.calibrate(port, [torch.from_numpy(x)])
    assert set(scales) == set(jscales)
    for site, v in jscales.items():
        assert abs(scales[site] - v) <= SCALE_REL * v, site
    jreport, report = {}, {}
    want, jx = _jax_site_inputs(jquant.quantized(apply, jscales, report=jreport), jscales, x)
    qport = quant.quantized(port, jscales, report=report)
    if "NFNet" in case:
        assert _standardized_sites_match_jax(qport, tree, jscales) == len(jscales)
    got, px = _port_site_inputs(qport, x)
    assert report == jreport
    assert set(jx) == set(px) == set(jscales)
    flips = {site: _boundary_flips(jx[site], px[site], jscales[site]) for site in jscales}
    assert all(n == at_boundary for n, at_boundary in flips.values()), flips
    if any(n for n, _ in flips.values()):
        got = _run_with_jax_codes(qport, x, jx, jscales)
    assert np.abs(got - want).max() <= LOGITS_REL * np.abs(want).max()
    assert model_entry(CASES[case][0])[0].int8_sites_match_jax
    return jreport


def _quantized(report: dict, part: str) -> list:
    return [s for s in report["quantized_sites"] if part in s]


def test_efficientnetv2t_sites_match_jax():
    """The depthwise convs skipped by their one input a group, SE by one
    position, the stem by name; the fused stride-2 3 x 3 expansion a site."""
    report = _sites_match_jax("EfficientNetV2T")
    assert "stack_2_block0_sortcut_conv" in report["quantized_sites"]
    assert not _quantized(report, "_dw_") and not _quantized(report, "_se_")
    assert {"stem_conv", "stack_3_block0_MB_dw_", "stack_3_block0_se_1_conv"} <= set(
        report["skipped_sites"])


def test_efficientnetv1b4_sites_match_jax():
    """TF mode at an odd size: every site is a 1 x 1 conv."""
    module, tree, port, x = _pair("EfficientNetV1B4")
    report = _sites_match_jax("EfficientNetV1B4")
    kernels = {port.get_submodule(s).weight.shape[-1] for s in report["quantized_sites"]}
    assert report["quantized_sites"] and kernels == {1}


def test_efficientnetv2t_gc_sites_match_jax():
    """The global-context convs are skipped: the attention conv by its one
    output channel, the MLP convs by their one position."""
    report = _sites_match_jax("EfficientNetV2T_GC")
    assert not _quantized(report, "_gc_")
    assert {"stack_3_block0_gc_attn_conv", "stack_3_block0_gc_mlp_1_conv",
            "stack_3_block0_gc_mlp_2_conv"} <= set(report["skipped_sites"])


@pytest.mark.parametrize("case", ["ECA_NFNetL0", "NFNetF0"])
def test_nfnet_sites_match_jax(case):
    """Every standardized conv but the stem's; the grouped 3 x 3s among
    them (F series: TF SAME, stride 2 at an even size)."""
    report = _sites_match_jax(case)
    grouped = [s for s in report["quantized_sites"]
               if s.endswith(("deep_2_conv", "deep_3_conv")) and not s.startswith("stack1")]
    assert len(grouped) == 8
    assert not _quantized(report, "stem")


def test_quantized_weights_of_standardized_convs_match_jax():
    """The int8 codes of every NFNet site's standardized weight against the
    JAX pass's ``_quant_weight(_standardized_weight(...))``, from the f32
    tree while the model is bf16 (the f32 source, never the module's bf16
    cache): equal, but at an element whose scaled value lies within 1e-5 of a
    half step, where XLA's and torch's rsqrt (one ulp apart) may round it
    either way."""
    module, tree, port, x = _pair("ECA_NFNetL0")
    scales = quant.calibrate(port, [torch.from_numpy(x)])
    f32 = {k: v.clone() for k, v in port.state_dict().items()}
    port.to(torch.bfloat16)
    quant.quantized(port, scales, weights=f32)
    assert _standardized_sites_match_jax(port, tree, scales) == len(scales) > 0


@pytest.mark.parametrize("groups,stride,padding", [(2, 1, ((1, 1), (1, 1))),
                                                   (4, 2, ((0, 1), (0, 1))),
                                                   (3, 2, ((1, 1), (1, 1)))])
def test_grouped_plain_site_equals_jax_int8_conv(groups, stride, padding):
    """``ptq_int8_conv_plain`` with groups (and padding pairs) against the JAX
    pass's ``_int8_conv`` with ``fgc`` = groups and its epilogue: the same
    integer sums, the same f32 result."""
    rng = np.random.RandomState(groups * 10 + stride)
    c, n = 32 * groups, 64 * groups
    x = rng.randn(2, 11, 10, c).astype(np.float32)
    w = rng.randn(3, 3, c // groups, n).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    amax = float(np.abs(x).max())
    qx, s_x = jptq._quant_act(jnp.asarray(x), amax)
    qw, s_w = jptq._quant_weight(jnp.asarray(w), (0, 1, 2))
    acc = jptq._int8_conv(qx, qw, strides=(stride, stride), padding=list(padding),
                          rhs_dilation=(1, 1), fgc=groups)
    want = np.asarray(acc.astype(jnp.float32) * (s_x * s_w) + jnp.asarray(bias))
    colscale = (torch.tensor(s_x, dtype=torch.float32) * torch.from_numpy(np.asarray(s_w)))
    packed = Q.pack_weight(torch.from_numpy(np.asarray(qw)).reshape(-1, n))
    got = Q.ptq_int8_conv_plain(torch.from_numpy(x), packed, colscale, torch.from_numpy(bias),
                                Q.f32_reciprocal(max(amax, 1e-8) / 127.0), kernel=3,
                                stride=stride, padding=padding, groups=groups)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    acc_port = Q.ptq_int8_gemm_plain(Q.quantize(torch.from_numpy(x), Q.f32_reciprocal(
        max(amax, 1e-8) / 127.0)), packed, torch.ones(n), None, kernel=3, stride=stride,
        padding=padding, groups=groups)
    np.testing.assert_array_equal(acc_port.numpy(), np.asarray(acc, np.float32))


def test_int8_refuses_a_class_without_site_parity(monkeypatch):
    """The engine's guard: a chosen member whose model class does not
    declare ``int8_sites_match_jax`` raises, picked by ``all`` or by name;
    the others are chosen as before."""
    monkeypatch.delattr(model_entry("EfficientNetV2T")[0], "int8_sites_match_jax")
    cfg = [["EfficientNetV2T-200x200", [200, 200], 0], ["ResNetRS50-200x200", [200, 200], 0]]
    for names in ({"*"}, {"EfficientNetV2T"}):
        with pytest.raises(NotImplementedError, match="int8_sites_match_jax"):
            engine.EnsembleEngine._int8_members(cfg, names)
    assert engine.EnsembleEngine._int8_members(cfg, {"ResNetRS50"}) == [False, True]


# ---------------------------------------------------------------------------
# the engine: VIPTPU_INT8=all on a narrow manifest of the five members
# ---------------------------------------------------------------------------
ENGINE_MEMBERS = [("EfficientNetV2T", 64, V2T), ("EfficientNetV1B4", 57, V1B4),
                  ("ECA_NFNetL0", 64, NFNET_L), ("convnext_tiny_in22k", 64, CONVNEXT),
                  ("GCViTTiny", 224, GCVIT)]


@pytest.fixture(scope="module")
def int8_workspace(tmp_path_factory):
    """Eight JPEGs, their CSV and a manifest of the five narrow members, each
    one fold of the JAX model's perturbed weights (its config overrides in
    the checkpoint's ``config.json``); also the trees by member name."""
    import json

    from PIL import Image

    from vip_cup_2022_tpu.utils.checkpoint import save_variables

    root = tmp_path_factory.mktemp("int8_members")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(5)
    names = [f"img_{i}.jpg" for i in range(8)]
    for n in names:
        Image.fromarray(rng.randint(0, 256, (200, 200, 3), np.uint8)).save(img_dir / n,
                                                                           quality=92)
    (img_dir / "input.csv").write_text("filename\n" + "".join(f"{n}\n" for n in names))
    manifest, trees = [], {}
    for i, (name, size, narrow) in enumerate(ENGINE_MEMBERS):
        base = f"{name}-{size}x{size}"
        ck = root / "ckpts" / base / "ckpt"
        ck.mkdir(parents=True)
        cfg = dict(nb_classes=1, classifier_activation="sigmoid", **narrow)
        variables = _jax_variables(name, i, size, narrow)
        tree = _perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)),
                        np.random.RandomState(i))
        save_variables(str(ck / "fold0.msgpack"), tree)
        trees[name] = tree
        (ck / "config.json").write_text(json.dumps(
            {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()}))
        manifest.append([base, [size, size], 0])
    (root / "ckpts" / "ckpts.json").write_text(json.dumps(manifest))
    return root, img_dir / "input.csv", trees


def _engine_cfg(config_cls, load_manifest, root, input_csv, out_name):
    cfg = config_cls({})
    cfg.test_csv, cfg.infer_path = str(input_csv), str(input_csv.parent)
    cfg.output_csv_path = str(root / out_name)
    cfg.debug, cfg.verbose, cfg.tta, cfg.agg, cfg.seed, cfg.thr = 0, 0, 1, "mean", 42, 0.487
    cfg.ckpt_cfg = load_manifest(str(root / "ckpts"), str(root / "ckpts" / "ckpts.json"))
    return cfg


def _aligned_to_jax(quantized_fn, tree, jax_inputs: list, flips: list):
    """``quantized_fn`` followed by what the model-level tests align: on a
    model with standardized convs, the JAX pass's weight codes and scales
    installed in its sites (ties of the two packages' rsqrt, as
    :func:`_standardized_sites_match_jax` sets out); at every site, a
    forward pre-hook that takes the next of ``jax_inputs`` (the JAX pass's
    site inputs, in call order) and sets the port's input to it at the
    elements whose int8 codes differ, recording the site's
    :func:`_boundary_flips` in ``flips``."""
    def align(mod, args):
        xp = args[0]
        xj = torch.from_numpy(jax_inputs.pop(0)).reshape(xp.shape).to(xp.dtype)
        flips.append(_boundary_flips(xj.numpy(), xp.numpy(), mod.scale))
        differ = Q.quantize(xp, mod.inv_s) != Q.quantize(xj, mod.inv_s)
        return (torch.where(differ, xj, xp),)

    def install(model, scales, **kw):
        out = quantized_fn(model, scales, **kw)
        if any(hasattr(m, "gain") for m in model.modules()):
            assert _standardized_sites_match_jax(model, tree, scales) == len(scales) > 0
        for m in model.modules():
            if isinstance(m, quant.QuantizedSite):
                m.scale = scales[m.site]
                m.register_forward_pre_hook(align)
        return out

    return install


def test_engine_int8_all_matches_jax(int8_workspace, monkeypatch):
    """Both engines with ``VIPTPU_INT8=all`` on the unfused block paths (the
    JAX engine's choice on the CPU, ``VIPTPU_NO_FUSED_BLOCK``), f32, batch 8,
    calibrated on the CSV's 8 images: each member's calibration table the
    JAX engine's (the same sites, abs-max within 1e-5), every site of every
    member through the port's ``ptq_int8_conv`` wrapper once a batch, the
    rows in the same order and the raw means within 1e-3. As in the
    model-level tests, the port then quantizes with the JAX engine's table
    and, at the NFNet's standardized convs, the JAX pass's weight codes, so
    that an abs-max one ulp apart or a weight on a .5 tie does not move a
    code; and each site's activation codes that differ from the JAX pass's
    (read as the JAX engine runs, on a mesh of one CPU device, where its
    program can call back in order) lie at a .5 boundary within the two
    inputs' difference, and take the JAX input there."""
    from vip_cup_2022_tpu.core.config import Config as JaxConfig
    from vip_cup_2022_tpu_torch.core.config import Config

    root, input_csv, trees = int8_workspace
    for k, v in dict(VIPTPU_INT8="all", VIPTPU_NO_FUSED_BLOCK="1", VIPTPU_MAX_BATCH="8",
                     VIPTPU_INT8_CALIB="8").items():
        monkeypatch.setenv(k, v)
    tables = {"jax": [], "port": []}
    real_jax = jax_engine.EnsembleEngine._calibrate_member
    monkeypatch.setattr(jax_engine.EnsembleEngine, "_calibrate_member", lambda self, *a: (
        tables["jax"].append(real_jax(self, *a)) or tables["jax"][-1]))
    real_port = engine.EnsembleEngine._calibrate_member
    monkeypatch.setattr(engine.EnsembleEngine, "_calibrate_member", lambda self, *a: (
        tables["port"].append(real_port(self, *a)) or tables["jax"][len(tables["port"]) - 1]))
    jax_inputs, flips = [], []
    real_act = jptq._quant_act

    def record_act(x, amax):  # each site's input, in order, as the program runs
        jax.debug.callback(lambda v: jax_inputs.append(np.asarray(v, np.float32)), x,
                           ordered=True)
        return real_act(x, amax)

    monkeypatch.setattr(jptq, "_quant_act", record_act)
    monkeypatch.setattr(engine, "quantized", _aligned_to_jax(
        engine.quantized, trees["ECA_NFNetL0"], jax_inputs, flips))
    theirs = jax_engine.EnsembleEngine(get_mesh(devices=jax.devices()[:1]), verbose=0,
                                       compute_dtype=jnp.float32)
    want = theirs.predict_soln_fused(_engine_cfg(JaxConfig, jax_engine.load_manifest, root,
                                                 input_csv, "jax.csv"))
    calls = []
    real = Q.ptq_int8_conv
    monkeypatch.setattr(Q, "ptq_int8_conv", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ours = engine.EnsembleEngine(device="cpu", verbose=0)
    try:
        got = ours.predict_soln_fused(_engine_cfg(Config, engine.load_manifest, root,
                                                  input_csv, "port.csv"))
    finally:
        ours.close()
    assert len(tables["jax"]) == len(tables["port"]) == len(ENGINE_MEMBERS)
    for jt, pt in zip(tables["jax"], tables["port"]):
        assert jt and set(pt) == set(jt)
        for site, v in jt.items():
            assert abs(pt[site] - v) <= SCALE_REL * v, site
    assert len(calls) == len(flips) == sum(len(t) for t in tables["port"])  # one batch of 8
    assert not jax_inputs
    assert all(n == at_boundary for n, at_boundary in flips), flips
    assert list(got["filename"]) == list(want["filename"])
    assert np.abs(got["raw"] - np.asarray(want["raw"], np.float64)).max() <= LOGITS_REL


# ---------------------------------------------------------------------------
# full width (-m slow): each member's site count, traced in JAX
# ---------------------------------------------------------------------------
def _jax_traced_sites(module, variables, x) -> set:
    """The JAX pass's calibrated sites of one forward, traced by
    ``jax.eval_shape`` (the interceptor records at trace time)."""
    state = jptq.PTQState("calib")
    with jptq._activate(state):
        jax.eval_shape(lambda v, b: module.apply(v, b), variables, x)
    return set(state.traced)


# (name, size, sites): traced in bf16, ConvNeXt and GCViT on the fused path,
# as the card serves them (in f32 the JAX model's stage-3 ConvNeXt blocks
# leave its fused kernel, whose TPU VMEM limit they pass, and its MLPs become
# sites; the port keeps them in its fused kernel, so its f32 int8 ConvNeXt
# at full width has 6 sites fewer than the JAX model's in f32
# blocks, the counts ``chip_smoke.INT8_SITES`` holds the card's runs to)
FULL_WIDTH = [("EfficientNetV2T", 200, 74), ("EfficientNetV1B4", 224, 60),
              ("ECA_NFNetL0", 200, 53), ("convnext_tiny_in22k", 200, 2), ("GCViTTiny", 224, 27)]


@pytest.mark.slow
@pytest.mark.parametrize("name,size,count", FULL_WIDTH)
def test_full_width_site_count_matches_jax(name, size, count):
    """At the manifest size, batch 2: the port calibrates the JAX pass's
    sites; ECA_NFNetL0's 53 hold 22 grouped 3 x 3s (``deep_2`` / ``deep_3``
    of the 11 blocks of stacks 2-4)."""
    kw = dict(input_size=(size, size), nb_classes=1, classifier_activation=None)
    extra = {"fused_block": True} if name in ("convnext_tiny_in22k", "GCViTTiny") else {}
    module, _, _ = jax_create_model(name, init=False, dtype=jnp.bfloat16, **kw, **extra)
    x = jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32)
    variables = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    want = _jax_traced_sites(module, variables, x)
    port, _ = create_model(name, **kw, **extra)
    got = quant.calibrate(port, [torch.rand((2, size, size, 3))])
    assert set(got) == want and len(want) == count
    if name == "ECA_NFNetL0":
        grouped = [s for s in got if port.get_submodule(s).groups > 1]
        assert len(grouped) == 22 and all(s.endswith(("deep_2_conv", "deep_3_conv"))
                                          for s in grouped)
