#!/usr/bin/env python3
"""CSV-in / CSV-out synthetic-image detection CLI on one CUDA GPU.

    python3 main_torch.py <input.csv> <output.csv>

The contract, environment knobs and printed lines of ``main.py``, run by
the PyTorch port (``vip_cup_2022_tpu_torch``):

- the input CSV has a ``filename`` column; the images live next to it;
- checkpoints are resolved from ``<script_dir>/ckpts/ckpts.json``
  (``VIPTPU_CKPT_DIR``, ``VIPTPU_CKPTS_JSON``);
- the output CSV is ``filename,logit`` with logit ``1.0`` where the ensemble
  mean exceeds 0.487, sorted by filename.

Knobs: ``VIPTPU_PLATFORM=cpu`` runs the plain PyTorch path on the CPU (CUDA
otherwise, and no CUDA device is an error); ``VIPTPU_DTYPE``,
``VIPTPU_MAX_BATCH`` (default 256), ``VIPTPU_DEBUG``, ``VIPTPU_VERBOSE``,
``VIPTPU_ALLOW_RANDOM_INIT``, ``VIPTPU_E2E_BATCH_TIMES``;
``VIPTPU_TTA`` (test-time augmentation copies, default 1) with
``VIPTPU_TTA_MODE`` (``map``, the default, or ``fold``);
``VIPTPU_FUSED=0`` runs the sequential per-member path;
``VIPTPU_FUSE_BN`` (``1``/``all`` or registry names) folds conv -> BN pairs;
``VIPTPU_INT8`` (ResNet-RS and ResNest members) runs int8 PTQ;
``VIPTPU_NO_FUSED_BLOCK=1`` runs GCViT's and ConvNeXt's unfused block paths.
``VIPTPU_PALLAS`` and ``VIPTPU_PALLAS_LN`` have no effect. The members of
``ckpts/ckpts.json`` (ConvNeXt, ResNest, GCViT, EfficientNet, NFNet,
ResNet-RS) are all ported. ``VIPTPU_INT8`` naming a ConvNeXt, GCViT,
EfficientNet or NFNet member, f32 compute on CUDA and a manifest member
outside those families raise ``NotImplementedError``: the port has no such
path yet.
"""
import os
import sys
import time

# resolve the script dir the way main.py does
_paths = sys.argv[0].rsplit("/", 1)
CWD = _paths[0] if len(_paths) > 1 else "."


def main(argv):
    input_csv_path = argv[1]
    output_csv_path = argv[2]

    from vip_cup_2022_tpu_torch.core.config import Config
    from vip_cup_2022_tpu_torch.data.pipeline import seeding
    from vip_cup_2022_tpu_torch.infer.engine import EnsembleEngine, load_manifest

    model_dir = os.environ.get("VIPTPU_CKPT_DIR", os.path.join(CWD, "ckpts"))
    manifest_path = os.environ.get("VIPTPU_CKPTS_JSON", os.path.join(model_dir, "ckpts.json"))

    debug = int(os.environ.get("VIPTPU_DEBUG", "0"))
    verbose = int(os.environ.get("VIPTPU_VERBOSE", "1"))
    tta = int(os.environ.get("VIPTPU_TTA", "1"))
    allow_missing = bool(int(os.environ.get("VIPTPU_ALLOW_RANDOM_INIT", "0")))

    CFG = Config({})
    CFG.test_csv = input_csv_path
    CFG.output_csv_path = output_csv_path
    CFG.verbose = verbose
    CFG.model_dir = model_dir
    CFG.infer_path = os.path.dirname(input_csv_path)
    CFG.debug = debug
    CFG.tta = tta
    CFG.agg = "mean"
    CFG.resize_method = "bicubic"
    CFG.num_classes = 1
    CFG.seed = 42
    CFG.thr = 0.487

    CFG.ckpt_cfg = load_manifest(model_dir, manifest_path, allow_missing=allow_missing)
    if verbose:
        print("\n> CHECKPOINTS: ")
        for entry in CFG.ckpt_cfg:
            print(list(entry))
        print("> DEBUG MODE:", bool(CFG.debug))

    CFG.replicas = 1  # one device; the batch split over several is ROADMAP A13
    if verbose:
        print(f"> REPLICAS: {CFG.replicas}")

    seeding(CFG)

    engine = EnsembleEngine(verbose=verbose)
    try:
        start = time.time()
        if int(os.environ.get("VIPTPU_FUSED", "1")):
            # the whole ensemble (members x folds x TTA) per batch
            result = engine.predict_soln_fused(CFG)
        else:
            # the reference-shaped sequential path, one member at a time
            result = engine.predict_soln(CFG, ensemble=True)
        eta = (time.time() - start) / 60
    finally:
        engine.close()
    print(f"\n> TIME TO INFER: {eta:0.2f} min")
    return result


if __name__ == "__main__":
    main(sys.argv)
