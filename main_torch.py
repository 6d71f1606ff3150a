#!/usr/bin/env python3
"""CSV-in / CSV-out synthetic-image detection CLI on one CUDA GPU.

    python3 main_torch.py <input.csv> <output.csv>

The contract, environment knobs and printed lines of ``main.py``, run by
the PyTorch port (``vip_cup_2022_tpu_torch``):

- the input CSV has a ``filename`` column; the images live next to it;
- checkpoints are resolved from ``<script_dir>/ckpts/ckpts.json``
  (``VIPTPU_CKPT_DIR``, ``VIPTPU_CKPTS_JSON``): each member's ``.msgpack``
  folds, else its Keras ``.h5`` folds (``h5py`` needed), else a SavedModel
  (TensorFlow needed);
- the output CSV is ``filename,logit`` with logit ``1.0`` where the ensemble
  mean exceeds 0.487, sorted by filename.

Knobs: ``VIPTPU_PLATFORM=cpu`` runs the plain PyTorch path on the CPU (CUDA
otherwise, and no CUDA device is an error); ``VIPTPU_DTYPE`` (bf16 on CUDA
by default; ``float32`` runs every member in f32 on the card, GCViT and
ConvNeXt on their fused blocks through the f32 modes of the block kernels,
as ``main.py`` does, with TF32 off in the forwards);
``VIPTPU_GCVIT_MM`` (``bf16`` or ``f32``) sets GCViT's fused GEMM dtype as
in ``main.py``, the activations keeping the compute dtype (the block
kernels' mixed modes; f32 GEMMs in bf16 take the checkpoint's f32 weights);
``VIPTPU_MAX_BATCH`` (default 256), ``VIPTPU_DEBUG``, ``VIPTPU_VERBOSE``,
``VIPTPU_ALLOW_RANDOM_INIT``, ``VIPTPU_E2E_BATCH_TIMES``;
``VIPTPU_TTA`` (test-time augmentation copies, default 1) with
``VIPTPU_TTA_MODE`` (``map``, the default, or ``fold``);
``VIPTPU_FUSED=0`` runs the sequential per-member path;
``VIPTPU_FUSE_BN`` (``1``/``all`` or registry names) folds conv -> BN pairs;
``VIPTPU_INT8`` (``1``/``all`` or registry names; any of the seven members)
runs int8 PTQ of their convs and Linears;
``VIPTPU_INT8_KERNELS=1`` runs the dense GEMMs inside ConvNeXt's and
GCViT's fused blocks as s8 wgmma kernels (GCViT's only at the levels at
least ``VIPTPU_GCVIT_INT8_MIN_C``, default 128, wide; its attention stays
in the GEMM dtype; ConvNeXt's narrow stages only while
``VIPTPU_BATCHLANE_FOLD`` is ``1``), in either compute dtype, composing
with ``VIPTPU_INT8`` and ``VIPTPU_GCVIT_MM`` as in ``main.py``;
``VIPTPU_CONVNEXT_FUSED_MIN_C`` sends ConvNeXt's stages from 256 up to it
to the unfused block, as ``main.py``'s model does;
``VIPTPU_NO_FUSED_BLOCK=1`` runs GCViT's and ConvNeXt's unfused block paths.
``VIPTPU_PALLAS`` and ``VIPTPU_PALLAS_LN`` have no effect. The members of
``ckpts/ckpts.json`` (ConvNeXt, ResNest, GCViT, EfficientNet, NFNet,
ResNet-RS) are all ported. ``VIPTPU_LN_BF16_SQ=1`` (a bf16 square in the
JAX bf16 LN's statistics, which the port's two-pass f32 LN does not take)
and a manifest member outside those families raise
``NotImplementedError``: the port has no such path.
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
