"""CSV-in / CSV-out ensemble inference engine on one CUDA device.

Counterpart of ``vip_cup_2022_tpu/infer/engine.py``'s fused path, with the
same contract:

- ckpts.json manifest of ``[base_dir, [H, W], idx]`` entries, checkpoints
  under ``<model_dir>/<base_dir>/ckpt/``;
- each JPEG decoded once on a host thread pool into a 200 x 200 uint8
  image (odd sizes resized on the host with the TF bicubic), streamed in
  batches of 256 (``VIPTPU_MAX_BATCH``), the tail zero-padded;
- on the device, per batch: / 255, the TF bicubic resize to each member's
  size as two matrix products, every member x fold forward, multiclass ->
  binary as ``1 - p[:, 0]``, mean over folds, then over members;
- ``> thr`` (0.487) and a ``filename,logit`` CSV sorted by filename.

GCViT's block path follows ``VIPTPU_NO_FUSED_BLOCK``, which the model reads
at each forward: unset, the fused window block; set, the unfused block (LN,
the window-attention kernel, Linears, MLP), the path the JAX package takes
off the TPU. Every LN of both members runs the LN kernel on CUDA.
``VIPTPU_PALLAS`` and ``VIPTPU_PALLAS_LN``, the JAX package's TPU A/B
switches for those two kernels, have no effect here: on CUDA the kernels run
wherever their module is on the path.

``VIPTPU_INT8`` names the members whose convs and Linears run int8
post-training quantization (:mod:`..quant.ptq`): a one-batch calibration on
the first ``VIPTPU_INT8_CALIB`` (64) images of the CSV with fold 0, then
every fold's eligible sites through the int8 kernel. ``auto``, the default,
is off here as on every backend but the TPU; ``0``/``off`` is off, ``1``/
``all`` every member, or a comma list of registry names. ResNet-RS and
ResNest members are quantized (the JAX package's ``INT8_AUTO`` set on a TPU
is ``ResNetRS50,ResNest50``): int8 for ConvNeXt and GCViT, whose fused
kernel paths hold the Linears the JAX pass would quantize, raises (ROADMAP
A12b), and so does int8 for EfficientNet (A8b) and for NFNet (A9b: its
grouped standardized convs).

Not ported yet, and raising ``NotImplementedError`` rather than running
something else: test-time augmentation (``tta > 1``), the conv-BN fold and
members of the families other than ConvNeXt, GCViT, ResNet-RS, EfficientNet,
ResNest and NFNet, which are all seven of ``ckpts/ckpts.json``. Every Pallas
kernel of the JAX package has a CUDA counterpart; the depthwise kernel (K9)
runs on this path at every stride-1 depthwise conv (EfficientNet, GCViT),
and those the JAX package's experiment tools reach run in the port's tools
(``vip_cup_2022_tpu_torch/tools``).
"""
from __future__ import annotations

import csv
import json
import os
import time
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.decode import ImageDecoder
from ..data.pipeline import _host_resize_uint8
from ..models import create_model, load_weights, transfer_weights
from ..models.efficientnet import EfficientNet
from ..models.nfnets import NFNet
from ..models.registry import is_model, model_entry
from ..ops.resize import resize
from ..quant import calibrate, quantized
from ..weights.from_jax import flax_to_torch

# Per-model batch-size table (reference main.py:43-56): 8 * NAME2BS.get(name, 16).
NAME2BS: Dict[str, int] = {
    "convnext_large_384_in22ft1k-200x200": 16,
    "convnext_large_in22ft1k-200x200": 16,
    "convnext_base_384_in22ft1k-200x200": 32,
    "HorNetBase-200x200": 32,
    "EfficientNetV2M-200x200": 64,
    "convnext_base_in22k-200x200": 32,
    "ECA_NFNetL2-200x200": 32,
    "GCViTBase-224x224": 48,
    "ResNest200-200x200": 64,
    "EfficientNetV2L-200x200": 32,
    "ResNetRS200-200x200": 32,
    "ResNet200D-200x200": 32,
}

NATIVE_SIZE = (200, 200)  # competition eval input spec


def load_manifest(model_dir: str, manifest_path: str, allow_missing: bool = False):
    """Resolve the ckpts.json manifest into ``(base_dir, paths, dim, idx)``
    entries; ``.msgpack`` checkpoints first, then ``.h5``, then a SavedModel."""
    entries = []
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    for base_dir, dim, idx in manifest:
        ckpt_dir = os.path.join(model_dir, base_dir, "ckpt")
        paths = sorted(glob(os.path.join(ckpt_dir, "*.msgpack"))) or sorted(
            glob(os.path.join(ckpt_dir, "*.h5")))
        if not paths:
            sm = os.path.join(ckpt_dir, "saved_model.pb")
            if os.path.isfile(sm):
                paths = [sm]
        if not paths and not allow_missing:
            raise ValueError(f"no model found for : {base_dir}")
        entries.append((base_dir, paths, tuple(dim), idx))
    return entries


def registry_name(model_dir_name: str) -> str:
    """'ResNetRS50-200x200' -> 'ResNetRS50' (manifest dir naming convention)."""
    return model_dir_name.rsplit("-", 1)[0]


def default_device() -> torch.device:
    """CUDA unless ``VIPTPU_PLATFORM=cpu``; no CUDA device is an error, never
    a silent move to the CPU."""
    platform = os.environ.get("VIPTPU_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "gpu", "cuda"):
        raise ValueError(f"VIPTPU_PLATFORM={platform!r} not in cpu|gpu|cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set VIPTPU_PLATFORM=cpu "
                           "to run the plain PyTorch path on the CPU")
    return torch.device("cuda")


def default_compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on CUDA, f32 on the CPU; ``VIPTPU_DTYPE`` overrides."""
    env = os.environ.get("VIPTPU_DTYPE", "")
    if not env:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    dtypes = {"float32": torch.float32, "f32": torch.float32,
              "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
    if env not in dtypes:
        raise ValueError(f"VIPTPU_DTYPE={env!r} not recognized; accepted "
                         f"spellings: {'|'.join(sorted(dtypes))}")
    return dtypes[env]


def check_unported_knobs() -> None:
    """Raise for environment knobs whose features the port does not have yet:
    ``VIPTPU_FUSE_BN`` (the conv-BN fold, A13); ``VIPTPU_TTA`` > 1 (A11)
    raises where the ensemble is built, ``VIPTPU_INT8`` on a member without
    int8 sites (A12b) where the members are known. The JAX package's TPU
    tuning switches (``VIPTPU_PALLAS``, ``VIPTPU_PALLAS_LN``, the
    ``VIPTPU_GCVIT_*`` and ``VIPTPU_DW_*`` family) choose among TPU kernels
    and layouts, have nothing to choose on CUDA and are not read."""
    if os.environ.get("VIPTPU_FUSE_BN", "").strip():
        raise NotImplementedError(
            "VIPTPU_FUSE_BN: the conv-BN fold is ROADMAP item A13, not ported yet")


def _to_binary(p: torch.Tensor) -> torch.Tensor:
    if p.ndim == 1:
        p = p[:, None]
    if p.shape[1] > 1:
        p = 1.0 - p[:, 0:1]  # multiclass -> binary (main.py:113-114)
    return p


class EnsembleEngine:
    def __init__(self, device: Optional[torch.device] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 num_decode_threads: int = 16, verbose: int = 1):
        self.device = torch.device(device) if device is not None else default_device()
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)
        if self.device.type == "cuda" and self.compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                "f32 compute on CUDA: the block kernels take bf16 activations; "
                "f32 kernels are ROADMAP item A15")
        self.verbose = verbose
        self._decoder = ImageDecoder(num_threads=num_decode_threads)

    def close(self) -> None:
        self._decoder.close()

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def _decode_stream(self, paths: Sequence[str], batch_size: int):
        """Yield ``(uint8 batch, n_valid)`` with the next chunk decoding on the
        host pool while the caller's device work for the current one runs."""
        post = lambda im: _host_resize_uint8(im, NATIVE_SIZE)  # noqa: E731
        pending = self._decoder.submit_batch(paths[:batch_size], post)
        for start in range(0, len(paths), batch_size):
            cur = [f.result() for f in pending]
            nxt = start + batch_size
            if nxt < len(paths):
                pending = self._decoder.submit_batch(paths[nxt: nxt + batch_size], post)
            batch = np.zeros((batch_size, *NATIVE_SIZE, 3), np.uint8)
            if cur:
                batch[: len(cur)] = np.stack(cur)
            yield batch, len(cur)

    # ------------------------------------------------------------------
    # model construction
    # ------------------------------------------------------------------
    def _create_member(self, name: str, dim, overrides: Dict):
        """A member built on the CPU with seeded random weights (the random-init
        route when no checkpoint exists; otherwise overwritten)."""
        if not is_model(name):
            raise NotImplementedError(
                f"member {name!r}: only ConvNeXt, GCViT, ResNet-RS, EfficientNet, ResNest and "
                "NFNet are ported; the other model families (ResNet-D, ResNeXt, BotNet, "
                "HaloNet, CotNet and the rest of the JAX zoo) are ROADMAP item A14")
        return create_model(name, input_size=tuple(dim), dtype=self.compute_dtype,
                            **overrides)

    # ------------------------------------------------------------------
    # int8 post-training quantization (quant/ptq.py; VIPTPU_INT8)
    # ------------------------------------------------------------------
    @staticmethod
    def _int8_names() -> set:
        """VIPTPU_INT8: 'auto' (default; the JAX package's measured-win set on
        a TPU, off on every other backend, so off here), '0'/'off' (off),
        '1'/'all' (every member, ``{"*"}``) or a comma list of registry names
        ('ResNetRS50')."""
        env = os.environ.get("VIPTPU_INT8", "auto").strip()
        if not env or env.lower() in ("auto", "0", "off", "false"):
            return set()
        if env.lower() in ("1", "all", "true"):
            return {"*"}
        return {s.strip() for s in env.split(",") if s.strip()}

    @staticmethod
    def _int8_members(ckpt_cfg, names: set) -> List[bool]:
        """Which manifest entries run int8; raises for a chosen member whose
        model class does not declare ``int8_sites_match_jax`` (its int8 sites
        are not the JAX pass's yet: ROADMAP A8b for EfficientNet, A9b for
        NFNet, A12b for ConvNeXt and GCViT)."""
        chosen = []
        for base_dir, *_ in ckpt_cfg:
            name = registry_name(base_dir)
            pick = bool(names) and ("*" in names or name in names)
            cls = model_entry(name)[0] if pick and is_model(name) else None
            if cls is EfficientNet:
                raise NotImplementedError(
                    f"VIPTPU_INT8 selects {name!r}: int8 EfficientNet members are ROADMAP item "
                    "A8b, not ported yet")
            if cls is NFNet:
                raise NotImplementedError(
                    f"VIPTPU_INT8 selects {name!r}: NFNet's int8 sites are grouped "
                    "weight-standardized convs (ScaledStdConv), and ptq_int8_conv takes no "
                    "group count; int8 NFNet members are ROADMAP item A9b, not ported yet")
            if cls is not None and not getattr(cls, "int8_sites_match_jax", False):
                raise NotImplementedError(
                    f"VIPTPU_INT8 selects {name!r}: int8 ConvNeXt and GCViT members (their "
                    "downsample convs, FeatExtract / ReduceSize convs and the Linears the fused "
                    "block kernels hold) are ROADMAP item A12b, not ported yet")
            chosen.append(pick)
        return chosen

    def _calibrate_member(self, model: torch.nn.Module, dim, calib_u8: np.ndarray):
        """The per-site activation abs-max table of one member (fold 0) on the
        calibration images, at the member's size and the compute dtype."""
        x = torch.from_numpy(calib_u8).to(self.device).float() / 255.0
        if tuple(dim) != NATIVE_SIZE:
            x = resize(x, dim)
        return calibrate(model, [x.to(self.compute_dtype)])

    def build_fused_ensemble(self, members, tta: int = 1, agg: str = "mean",
                             quant_scales=None, f32_weights=None):
        """``members``: list of ``(fold modules, dim)``. Returns
        ``fn(u8 (B, 200, 200, 3) numpy) -> (B, 1)`` ensemble-mean probability
        on the device, aggregated binary -> folds -> members.

        ``quant_scales``: optional per-member list; a non-None entry is a
        calibration table from :meth:`_calibrate_member`, and every fold of
        that member has its eligible sites swapped for the int8 kernel, its
        weights quantized from ``f32_weights[member][fold]``."""
        if tta > 1:
            raise NotImplementedError(
                f"tta={tta}: test-time augmentation is ROADMAP item A11, not ported yet")
        if agg != "mean":
            raise NotImplementedError(f"agg={agg!r}: only 'mean' is ported")
        for i, scales in enumerate(quant_scales or []):
            if scales:
                for j, model in enumerate(members[i][0]):
                    quantized(model, scales, weights=f32_weights[i][j] if f32_weights else None)
        device, dtype = self.device, self.compute_dtype
        dims = list(dict.fromkeys(tuple(dim) for _, dim in members))

        @torch.inference_mode()
        def forward(u8: np.ndarray) -> torch.Tensor:
            x0 = torch.from_numpy(u8).to(device).float() / 255.0
            # one resize per distinct member size
            by_dim = {dim: (resize(x0, dim) if dim != NATIVE_SIZE else x0).to(dtype)
                      for dim in dims}
            preds = []
            for folds, dim in members:
                x = by_dim[tuple(dim)]
                fold_preds = [_to_binary(model(x).float()) for model in folds]
                preds.append(torch.stack(fold_preds).mean(0))
            return torch.stack(preds).mean(0)

        return forward

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def load_members(self, ckpt_cfg, keep_f32: Sequence[bool] = ()):
        """``(members, f32_weights)``: one ``(fold modules on the device,
        dim)`` per manifest entry and, for each entry that ``keep_f32`` marks
        (the int8 ones), per fold the f32 values its int8 weights are
        quantized from, as the JAX package quantizes its f32 parameters: the
        checkpoint's tree, read once, in the port's layout; a random-init
        member has no f32 copy, so the values it holds. Unmarked entries get
        None."""
        members, f32_weights = [], []
        for i, (base_dir, ckpt_paths, dim, _idx) in enumerate(ckpt_cfg):
            keep = i < len(keep_f32) and keep_f32[i]
            name = registry_name(base_dir)
            overrides: Dict = {}
            if ckpt_paths:
                cfg_json = os.path.join(os.path.dirname(ckpt_paths[0]), "config.json")
                if os.path.isfile(cfg_json):
                    with open(cfg_json) as fh:
                        overrides = json.load(fh)
                    overrides.pop("input_size", None)
            folds, f32 = [], []
            for ckpt in sorted(ckpt_paths):
                module, _ = self._create_member(name, dim, overrides)
                tree = load_weights(ckpt)
                folds.append(transfer_weights(tree, module, strict=True).to(self.device))
                if keep:
                    f32.append(flax_to_torch(tree))
            if not folds:  # random-init (allow_missing) member
                module, _ = self._create_member(name, dim, overrides)
                folds = [module.to(self.device)]
                if keep:
                    f32.append({k: v.float() for k, v in module.state_dict().items()})
            members.append((folds, tuple(dim)))
            f32_weights.append(f32 if keep else None)
        return members, f32_weights

    def predict_soln_fused(self, cfg) -> Dict[str, np.ndarray]:
        """The whole ensemble per batch; writes ``cfg.output_csv_path`` and
        returns ``{"filename", "logit", "raw"}`` sorted by filename."""
        check_unported_knobs()
        with open(cfg.test_csv, newline="") as fh:
            test_names = [row["filename"] for row in csv.DictReader(fh)]
        test_paths = [os.path.join(cfg.infer_path, n) for n in test_names]
        if cfg.debug:
            test_paths = test_paths[:100]
            test_names = test_names[:100]

        int8 = self._int8_members(cfg.ckpt_cfg, self._int8_names())
        members, f32_weights = self.load_members(cfg.ckpt_cfg, keep_f32=int8)
        quant_scales = None
        if any(int8):
            # one-batch calibration on the head of the CSV, with fold 0
            n_cal = min(int(os.environ.get("VIPTPU_INT8_CALIB", "64")), len(test_paths))
            cal = [_host_resize_uint8(im, NATIVE_SIZE)
                   for im in self._decoder.decode_batch(test_paths[:n_cal])]
            calib_u8 = np.stack(cal) if cal else np.zeros((1, *NATIVE_SIZE, 3), np.uint8)
            quant_scales = []
            for pick, (folds, dim), (base_dir, *_) in zip(int8, members, cfg.ckpt_cfg):
                scales = self._calibrate_member(folds[0], dim, calib_u8) if pick else None
                if self.verbose and pick:
                    print(f"> INT8 {registry_name(base_dir)}: {len(scales)} calibrated sites")
                quant_scales.append(scales)
        fwd = self.build_fused_ensemble(members, tta=cfg.tta, agg=cfg.agg,
                                        quant_scales=quant_scales, f32_weights=f32_weights)
        del f32_weights
        batch_size = int(os.environ.get("VIPTPU_MAX_BATCH", "0")) or 256
        # VIPTPU_E2E_BATCH_TIMES=<path>: diagnostic mode, each batch waited for
        # and its end-to-end latency (decode wait + H2D + compute + D2H) written
        # to a JSON file; by default batches queue and are fetched at the end
        times_path = os.environ.get("VIPTPU_E2E_BATCH_TIMES", "")
        outs, valid, batch_times = [], [], []
        for batch, n_valid in self._decode_stream(test_paths, batch_size):
            if times_path:
                t0 = time.perf_counter()
                outs.append(fwd(batch).cpu())
                batch_times.append(time.perf_counter() - t0)
            else:
                outs.append(fwd(batch))
            valid.append(n_valid)
        if times_path:
            with open(times_path, "w") as fh:
                json.dump({"batch_size": batch_size, "batch_e2e_s": batch_times}, fh)
        pred = (np.concatenate([o.cpu().numpy()[:nv] for o, nv in zip(outs, valid)], 0)
                if outs else np.zeros((0, 1), np.float32))

        order = sorted(range(len(test_names)), key=lambda i: test_names[i])
        names = np.array([test_names[i] for i in order], dtype=object)
        raw = pred[order, 0]
        logit = (raw > cfg.thr) * 1.0
        with open(cfg.output_csv_path, "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            writer.writerow(["filename", "logit"])
            writer.writerows(zip(names, logit.tolist()))
        if cfg.verbose:
            print("\n> FINAL PREDICTION SAVED TO ", cfg.output_csv_path)
        return {"filename": names, "logit": logit, "raw": raw.astype(np.float64)}
