"""The product contract on all seven members: the repo's manifest
``ckpts/ckpts.json``, each member narrow (ResNetRS50 at its depth's widths),
with fold checkpoints written by the JAX package, through both CLIs on the
CPU; the CSVs must equal byte for byte."""
import json
import os

import numpy as np
import pytest

from test_torch_slice import NARROW, REPO, _cfg, _jax_variables, _member_workspace, _tree_of

from vip_cup_2022_tpu.utils.checkpoint import save_variables
from vip_cup_2022_tpu_torch.infer import engine


@pytest.fixture(scope="module")
def seven_member_workspace(tmp_path_factory):
    """All seven members of ``ckpts/ckpts.json``, in its order and under its
    names: narrow ConvNeXt, ResNest50, GCViTTiny (at 224, its windows' size),
    EfficientNetV2T, EfficientNetV1B4 and ECA_NFNetL0, and ResNetRS50 (its
    widths are its depth's) at 64."""
    import test_torch_efficientnet as eff_tests
    import test_torch_nfnet as nf_tests
    import test_torch_resnet_rs as rs_tests
    from test_torch_gcvit import NARROW as NARROW_GCVIT
    from test_torch_gcvit import _jax_gcvit
    from test_torch_resnest import NARROW as NARROW_RESNEST

    eff = _tree_of(eff_tests)
    convnext = lambda name, size, kw, seed: _jax_variables(  # noqa: E731
        seed, input_size=(size, size), **kw)[1]
    gcvit = lambda name, size, kw, seed: _jax_gcvit(  # noqa: E731
        seed, input_size=(size, size), **kw)[1]
    with open(os.path.join(REPO, "ckpts", "ckpts.json")) as fh:
        order = [base for base, *_ in json.load(fh)]
    members = {
        "convnext_tiny_in22k-200x200": ("convnext_tiny_in22k", 64, NARROW, convnext, "head_fc"),
        "ResNest50-200x200": ("ResNest50", 64, NARROW_RESNEST, eff, "predictions"),
        "GCViTTiny-224x224": ("GCViTTiny", 224, NARROW_GCVIT, gcvit, "head"),
        "EfficientNetV2T-200x200": ("EfficientNetV2T", 64, eff_tests.NARROW["EfficientNetV2T"],
                                    eff, "predictions"),
        "EfficientNetV1B4-224x224": ("EfficientNetV1B4", 72,
                                     eff_tests.NARROW["EfficientNetV1B4"], eff, "predictions"),
        "ECA_NFNetL0-200x200": ("ECA_NFNetL0", 72, nf_tests.NARROW, _tree_of(nf_tests),
                                "predictions"),
        "ResNetRS50-200x200": ("ResNetRS50", 64, {}, _tree_of(rs_tests), "predictions"),
    }
    assert sorted(order) == sorted(members)
    return _member_workspace(
        tmp_path_factory.mktemp("torch_seven_e2e"), "s_", 14,
        [(members[b][0], b, *members[b][1:]) for b in order])


def test_seven_member_cli_csv_equals_jax_byte_for_byte(seven_member_workspace, monkeypatch):
    """The product contract on the repo's manifest: every member, narrow,
    through both CLIs, one ensemble; the first member's head moves the
    threshold between the images, and the CSVs equal byte for byte."""
    root, input_csv, names, trees = seven_member_workspace
    monkeypatch.setenv("VIPTPU_MAX_BATCH", "8")
    eng = engine.EnsembleEngine(device="cpu", verbose=0)
    entries = _cfg(root, input_csv, "all.csv").ckpt_cfg
    probs = []
    for i in range(len(trees)):
        cfg = _cfg(root, input_csv, f"m{i}.csv")
        cfg.ckpt_cfg = [entries[i]]
        probs.append(eng.predict_soln_fused(cfg)["raw"])
    eng.close()
    z0, rest = np.log(probs[0] / (1 - probs[0])), np.sum(probs[1:], axis=0)
    best, shift = 0.0, None
    for d in np.linspace(-8, 8, 3201):
        r = (1 / (1 + np.exp(-(z0 + d))) + rest) / len(probs) - 0.487
        if (r > 0).any() and (r < 0).any() and np.abs(r).min() > best:
            best, shift = np.abs(r).min(), d
    assert shift is not None and best > 1e-4
    first = next(iter(trees))
    tree = trees[first][2]
    tree["params"]["head_fc"]["bias"] = (tree["params"]["head_fc"]["bias"] + shift).astype(
        np.float32)
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
    assert [ln.split(",")[0] for ln in lines[1:]] == sorted(names)
    assert {ln.split(",")[1] for ln in lines[1:]} == {"0.0", "1.0"}
