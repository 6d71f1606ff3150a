"""CSV-in / CSV-out ensemble inference engine on one CUDA device.

Counterpart of ``vip_cup_2022_tpu/infer/engine.py``, with the same contract:

- ckpts.json manifest of ``[base_dir, [H, W], idx]`` entries, checkpoints
  under ``<model_dir>/<base_dir>/ckpt/``: the ``.msgpack`` files, else the
  Keras ``.h5`` files, else a SavedModel's ``saved_model.pb``, each fold
  converted by the weight mapper of the member's registry name
  (:func:`..models.factory.load_weights`; ``.h5`` needs ``h5py``, a
  SavedModel TensorFlow) and loaded strictly, its head included;
- each JPEG decoded once on a host thread pool into a 200 x 200 uint8
  image (odd sizes resized on the host with the TF bicubic);
- on the device, per batch: / 255, the TF bicubic resize to each member's
  size as two matrix products, ``tta`` augmented copies (``tta`` > 1), the
  forwards, ``agg`` over the copies' class probabilities, multiclass ->
  binary as ``1 - p[:, 0]``, ``agg`` over folds, then the mean over members;
- ``> thr`` (0.487) and a ``filename,logit`` CSV sorted by filename.

Two drivers, as in the JAX package: :meth:`EnsembleEngine.predict_soln_fused`
(the default) streams batches of 256 (``VIPTPU_MAX_BATCH``, the tail
zero-padded) through every member and fold; :meth:`EnsembleEngine.
predict_soln` (``VIPTPU_FUSED=0``) runs one member at a time over the whole
decoded set at its own batch size, ``8 * NAME2BS.get(base_dir, 16)`` capped
by ``VIPTPU_MAX_BATCH``, and means the members by filename in float64.

Test-time augmentation (:mod:`..data.augment`) takes its per-sample masks
from :meth:`EnsembleEngine.tta_masks`, by default drawn from a
``torch.Generator`` seeded with ``cfg.seed``; every member and fold of a
batch gets the same masks for replica t. ``VIPTPU_TTA_MODE=map`` (the
default) runs ``tta`` forwards at batch B, ``fold`` one forward at
``tta * B``. ``VIPTPU_FUSE_BN`` (``1``/``all``/``true`` or a comma list of
registry names) folds each conv -> BN pair into the conv on the fused path
(:mod:`..utils.surgery`), on the checkpoint's f32 tree before the weight
bridge, with that BN's eps; the BN stays in the model, neutral, and still
runs its passes.

GCViT's and ConvNeXt's block paths follow ``VIPTPU_NO_FUSED_BLOCK``, which
the models read at each forward: unset, the fused blocks; set, the unfused
blocks (GCViT: LN, the window-attention kernel, Linears, MLP; ConvNeXt: the
depthwise kernel, LN, Linears), the paths the JAX package takes off the
TPU. Every LN of both members runs the LN kernel on CUDA.

Knobs of the JAX package's fused kernels that change what is computed, read
as the JAX package reads them:
- ``VIPTPU_INT8_KERNELS=1`` (any other value: off) runs the dense GEMMs of
  the fused blocks int8 (:mod:`..ops.kernels.block_int8`): ConvNeXt's MLP
  at every stage, GCViT's qkv, proj and MLP at the levels at least
  ``VIPTPU_GCVIT_INT8_MIN_C`` (default 128) wide, so GCViTTiny's first
  level and every attention product stay bf16. Weights are quantized per
  output channel once per fold, from the checkpoint's f32 values
  (:func:`..quant.dyn_int8.attach`), activations per row by a dynamic
  abs-max; no calibration. ``VIPTPU_BATCHLANE_FOLD`` other than ``1``
  keeps ConvNeXt's stages narrower than 256 in bf16, as it turns off the
  JAX kernel's int8 there. It composes with ``VIPTPU_INT8``: the PTQ sites
  lie outside the fused blocks, whose Linears the blocks read without
  calling them. The unfused path and training never run it.
- ``VIPTPU_CONVNEXT_FUSED_MIN_C`` (default 256) sends ConvNeXt's stages at
  least 256 wide but narrower than it to the unfused block (and their MLP
  Linears into the PTQ sites), as the JAX model sends them off its
  whole-image kernel.
- ``VIPTPU_LN_BF16_SQ=1`` is refused with ``NotImplementedError``: it
  squares in bf16 for the E[x^2] - E[x]^2 statistics of the JAX bf16 LN,
  and the port's LN kernel takes two-pass f32 statistics in every dtype, so
  there is no such square to make.
``VIPTPU_PALLAS`` and ``VIPTPU_PALLAS_LN``, the JAX package's TPU A/B
switches for those two kernels, and its other TPU tuning switches (the
rest of the ``VIPTPU_GCVIT_*`` family and the ``VIPTPU_DW_*`` family)
choose among TPU kernels and layouts and are not read: on CUDA the kernels
run wherever their module is on the path.

``VIPTPU_INT8`` names the members whose convs and Linears run int8
post-training quantization (:mod:`..quant.ptq`) on the fused path: a
one-batch calibration on the first ``VIPTPU_INT8_CALIB`` (64) images of the
CSV with fold 0 (folded, under ``VIPTPU_FUSE_BN``; its blocks int8 under
``VIPTPU_INT8_KERNELS=1``), then every fold's eligible sites through the
int8 kernel. ``auto``, the default, is off here as on every backend but the
TPU; ``0``/``off`` is off, ``1``/``all`` every member, or a comma list of
registry names. All seven members of ``ckpts/ckpts.json`` quantize, every
ported family the JAX pass's sites (each model class declares
``int8_sites_match_jax``): ResNet-RS, ResNest, EfficientNet (V2T_GC too),
NFNet (its grouped standardized convs, in their groups), ConvNeXt and GCViT
on either block path (the JAX package's ``INT8_AUTO`` set on a TPU is
``ResNetRS50,ResNest50``).

``VIPTPU_DTYPE=float32`` (f32 compute; bf16 is CUDA's default) runs every
member in f32 on CUDA, as the JAX package's f32 reference arm runs: GCViT
and ConvNeXt on their fused blocks, as ``main.py`` on a TPU, unless
``VIPTPU_NO_FUSED_BLOCK`` or their config says otherwise (the models'
``_use_fused_block``; the fused blocks' kernels in their f32 modes, the
unfused blocks' the f32 window attention, depthwise and LN kernels), and
the forwards run with TF32 off for cuDNN and cuBLAS
(:func:`..utils.precision.f32_scope`), so every conv and Linear computes
in f32; the flags are restored after each forward.
``VIPTPU_INT8_KERNELS=1`` with f32 on CUDA raises (its kernels' f32 inputs
and outputs are ROADMAP item A15c); ``VIPTPU_INT8`` composes (the PTQ site
takes f32). ``VIPTPU_GCVIT_MM`` set to the other dtype than the compute
dtype raises on GCViT's fused path (A15c; the models' ``check_gcvit_mm``).

Still raising ``NotImplementedError`` rather than running something else
(a SavedModel checkpoint without TensorFlow installed raises it too):
``VIPTPU_LN_BF16_SQ=1``; ``VIPTPU_INT8_KERNELS=1`` with f32 on CUDA and
``VIPTPU_GCVIT_MM`` against the compute dtype (A15c); and
members of families other than ConvNeXt, GCViT, ResNet-RS, EfficientNet,
ResNest and NFNet (A14), which are all seven of ``ckpts/ckpts.json``.
Every Pallas kernel of the JAX package has a CUDA counterpart (the f32
modes of K1/K2, K4, K5, K6, K8 and K9 too); the depthwise kernel (K9) runs on
this path at every stride-1 depthwise conv (EfficientNet, GCViT), and
those the JAX package's experiment tools reach run in the port's tools
(``vip_cup_2022_tpu_torch/tools``).
"""
from __future__ import annotations

import csv
import json
import os
import time
from glob import glob
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.augment import TTAMasks, apply_augment, draw_masks
from ..data.decode import ImageDecoder
from ..data.pipeline import _host_resize_uint8
from ..models import create_model, load_weights, transfer_weights
from ..models.registry import is_model, model_entry
from ..ops.resize import resize
from ..quant import calibrate, dyn_int8, quantized
from ..utils.precision import f32_scope
from ..utils.surgery import bn_eps, fuse_all_conv_bn
from ..weights.from_jax import flax_to_torch
from ..weights.to_flax import torch_to_flax

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


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy's median: the middle value, or the mean of the two middle ones."""
    s, n = x.sort(dim).values, x.shape[dim]
    return ((s.narrow(dim, (n - 1) // 2, 1) + s.narrow(dim, n // 2, 1)) / 2).squeeze(dim)


_AGGS: Dict[str, Callable[[torch.Tensor, int], torch.Tensor]] = {
    "mean": lambda x, dim: x.mean(dim),
    "median": _median,
    "max": torch.amax,
    "min": torch.amin,
    "sum": lambda x, dim: x.sum(dim),
    "prod": lambda x, dim: x.prod(dim),
    "std": lambda x, dim: x.std(dim, correction=0),
    "var": lambda x, dim: x.var(dim, correction=0),
}


def _agg_fn(agg: str) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """The reduction ``fn(x, dim)`` for the reference's ``getattr(np, agg)``,
    with numpy's semantics (std and var with ddof 0)."""
    if agg not in _AGGS:
        raise ValueError(f"unsupported agg {agg!r}; supported: {'|'.join(_AGGS)}")
    return _AGGS[agg]


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


def _to_binary(p: torch.Tensor) -> torch.Tensor:
    if p.ndim == 1:
        p = p[:, None]
    if p.shape[1] > 1:
        p = 1.0 - p[:, 0:1]  # multiclass -> binary (main.py:113-114)
    return p


def _member_overrides(ckpt_paths: Sequence[str]) -> Dict:
    """The config.json next to a member's checkpoints: head and width
    overrides recorded at conversion time."""
    if ckpt_paths:
        cfg_json = os.path.join(os.path.dirname(ckpt_paths[0]), "config.json")
        if os.path.isfile(cfg_json):
            with open(cfg_json) as fh:
                overrides = json.load(fh)
            overrides.pop("input_size", None)
            return overrides
    return {}


def _batches(imgs: Sequence[np.ndarray], batch_size: int):
    """``(uint8 batch, n_valid)`` over decoded images, the tail zero-padded."""
    for start in range(0, len(imgs), batch_size):
        chunk = imgs[start: start + batch_size]
        batch = np.zeros((batch_size, *NATIVE_SIZE, 3), np.uint8)
        batch[: len(chunk)] = np.stack(chunk)
        yield batch, len(chunk)


def _write_csv(path: str, names, logit) -> None:
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(["filename", "logit"])
        writer.writerows(zip(names, logit.tolist()))


class EnsembleEngine:
    def __init__(self, device: Optional[torch.device] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 num_decode_threads: int = 16, verbose: int = 1):
        self.device = torch.device(device) if device is not None else default_device()
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)
        if verbose and self.device.type == "cuda" and self.compute_dtype == torch.float32:
            print("> F32: every forward with TF32 off; GCViT and ConvNeXt on the f32 kernels of "
                  "their fused blocks")
        if os.environ.get("VIPTPU_LN_BF16_SQ", "0") == "1":
            raise NotImplementedError(
                "VIPTPU_LN_BF16_SQ=1 squares in bf16 for the JAX bf16 LN's E[x^2] - E[x]^2 "
                "statistics; the port's LN takes two-pass f32 statistics in every dtype")
        self.verbose = verbose
        self._decoder = ImageDecoder(num_threads=num_decode_threads)
        # the decoded set, kept by the sequential path for its members (and
        # reused by a fused predict over the same paths)
        self._decoded: Optional[List[np.ndarray]] = None
        self._decoded_key: Optional[Tuple[str, ...]] = None

    def close(self) -> None:
        self._decoder.close()

    def _precision(self):
        """The context of every forward: TF32 off for f32 on CUDA
        (:func:`..utils.precision.f32_scope`)."""
        return f32_scope(self.device, self.compute_dtype)

    def _int8_kernels(self) -> bool:
        """``VIPTPU_INT8_KERNELS=1``; raises for f32 on CUDA, where the int8
        block kernels it runs take bf16 activations (their f32 inputs and
        outputs are ROADMAP item A15c)."""
        on = dyn_int8.int8_kernels_enabled()
        if on and self.device.type == "cuda" and self.compute_dtype == torch.float32:
            raise NotImplementedError(
                "VIPTPU_INT8_KERNELS=1 with f32 compute on CUDA: the int8 block kernels take bf16 "
                "activations; their f32 inputs and outputs are ROADMAP item A15c")
        return on

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def _decode_all(self, paths: Sequence[str]) -> List[np.ndarray]:
        """Every image decoded once at NATIVE_SIZE, kept for the next member."""
        key = tuple(paths)
        if self._decoded is None or self._decoded_key != key:
            imgs = self._decoder.decode_batch(paths)
            self._decoded = [_host_resize_uint8(im, NATIVE_SIZE) for im in imgs]
            self._decoded_key = key
        return self._decoded

    def reset_cache(self) -> None:
        self._decoded = None
        self._decoded_key = None

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

    def tta_masks(self, seed: int, tta: int, batch: int, fused: bool) -> Iterator[List[TTAMasks]]:
        """The augment masks of one key stream: per step (a batch), one
        :class:`TTAMasks` of (``batch``,) per replica. The fused path takes one
        stream for the CSV, the sequential path one per member, stepped on
        across its folds (``fused`` says which asks). These draw from a
        ``torch.Generator`` seeded with ``seed``; the JAX package draws from
        its PRNG keys, per mesh shard on the fused path, and a caller that
        must reproduce those replaces this method."""
        gen = torch.Generator().manual_seed(seed)
        while True:
            yield [draw_masks(gen, batch) for _ in range(tta)]

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
    # the conv-BN fold (utils/surgery.py; VIPTPU_FUSE_BN)
    # ------------------------------------------------------------------
    @staticmethod
    def _fuse_bn_member(name: str) -> bool:
        """VIPTPU_FUSE_BN: '' (off), '1'/'all'/'true', or a comma list of
        registry names."""
        env = os.environ.get("VIPTPU_FUSE_BN", "").strip()
        if not env:
            return False
        if env.lower() in ("1", "all", "true"):
            return True
        return name in {s.strip() for s in env.split(",")}

    def _fuse_bn(self, tree, module: torch.nn.Module, name: str):
        """``tree`` with every conv -> BN pair folded, each with the eps of the
        module's BN at that path."""
        fused, pairs = fuse_all_conv_bn(tree, bn_eps(module))
        if self.verbose and pairs:
            print(f"> FUSE_BN {name}: folded {len(pairs)} conv->BN pairs")
        return fused

    def _fuse_bn_module(self, module: torch.nn.Module, name: str) -> None:
        """Fold the values a random-init member holds, in place."""
        state = module.state_dict()
        fused = flax_to_torch(self._fuse_bn(torch_to_flax(module), module, name))
        with torch.no_grad():
            for key, value in fused.items():
                state[key].copy_(torch.from_numpy(value))

    def _load_folds(self, base_dir: str, ckpt_paths: Sequence[str], dim,
                    fuse_bn: bool = False, keep_f32: bool = False):
        """``(fold modules on the device, f32 values per fold or None)`` of one
        manifest entry; a member without checkpoints is one random-init fold."""
        name = registry_name(base_dir)
        overrides = _member_overrides(ckpt_paths)
        folds, f32 = [], []
        for ckpt in sorted(ckpt_paths):
            module, _ = self._create_member(name, dim, overrides)
            tree = load_weights(ckpt, name)
            if fuse_bn:
                tree = self._fuse_bn(tree, module, name)
            folds.append(transfer_weights(tree, module, strict=True).to(self.device))
            if keep_f32:
                f32.append(flax_to_torch(tree))
        if not folds:  # random-init (allow_missing) member
            module, _ = self._create_member(name, dim, overrides)
            if fuse_bn:
                self._fuse_bn_module(module, name)
            folds = [module.to(self.device)]
            if keep_f32:
                f32.append({k: v.float() for k, v in module.state_dict().items()})
        return folds, (f32 if keep_f32 else None)

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
        """Which manifest entries run int8: every one with ``{"*"}``, else
        those whose registry name is in ``names``; raises for a chosen member
        whose model class does not declare ``int8_sites_match_jax`` (its
        int8 sites are not held to the JAX pass's)."""
        chosen = []
        for base_dir, *_ in ckpt_cfg:
            name = registry_name(base_dir)
            pick = bool(names) and ("*" in names or name in names)
            if pick and is_model(name) and not getattr(model_entry(name)[0],
                                                       "int8_sites_match_jax", False):
                raise NotImplementedError(
                    f"VIPTPU_INT8 selects {name!r}, whose model class does not declare "
                    "int8_sites_match_jax: its int8 sites are not held to the JAX pass's")
            chosen.append(pick)
        return chosen

    def _attach_int8_blocks(self, base_dir: str, folds, f32) -> None:
        """VIPTPU_INT8_KERNELS=1: each fold's fused blocks' int8 weights,
        quantized once from the fold's f32 values ``f32``."""
        blocks = [dyn_int8.attach(model, weights) for model, weights in zip(folds, f32)]
        if self.verbose and blocks and blocks[0]:
            print(f"> INT8_KERNELS {registry_name(base_dir)}: {blocks[0]} blocks a fold")

    def _unit_input(self, u8: np.ndarray) -> torch.Tensor:
        """The uint8 batch on the device in f32, / 255."""
        return torch.from_numpy(u8).to(self.device).float() / 255.0

    def _member_input(self, x0: torch.Tensor, dim) -> torch.Tensor:
        """The resize of :meth:`_unit_input`'s batch to ``dim`` in f32, then the
        compute dtype."""
        return (resize(x0, dim) if tuple(dim) != NATIVE_SIZE else x0).to(self.compute_dtype)

    def _calibrate_member(self, model: torch.nn.Module, dim, calib_u8: np.ndarray):
        """The per-site activation abs-max table of one member (fold 0) on the
        calibration images, at the member's size and the compute dtype."""
        with self._precision():
            return calibrate(model, [self._member_input(self._unit_input(calib_u8), dim)])

    # ------------------------------------------------------------------
    # forwards
    # ------------------------------------------------------------------
    @staticmethod
    def _tta_forward(model, xs: List[torch.Tensor], mode: str, agg_fn) -> torch.Tensor:
        """``agg`` over the raw f32 class probabilities of the augmented copies
        ``xs``: one forward each (``map``) or one over their concatenation
        (``fold``)."""
        if mode == "fold":
            out = model(torch.cat(xs)).float()
            outs = out.reshape(len(xs), xs[0].shape[0], *out.shape[1:])
        else:
            outs = torch.stack([model(x).float() for x in xs])
        return agg_fn(outs, 0)

    def build_fused_ensemble(self, members, tta: int = 1, agg: str = "mean",
                             quant_scales=None, f32_weights=None):
        """``members``: list of ``(fold modules, dim)``. Returns
        ``fn(u8 (B, 200, 200, 3) numpy, masks=None) -> (B, 1)`` ensemble-mean
        probability on the device: ``agg`` over the TTA copies (``masks``, one
        :class:`TTAMasks` a replica, at ``tta`` > 1), the binary map, ``agg``
        over folds, the mean over members (``VIPTPU_TTA_MODE`` picks map or
        fold).

        ``quant_scales``: optional per-member list; a non-None entry is a
        calibration table from :meth:`_calibrate_member`, and every fold of
        that member has its eligible sites swapped for the int8 kernel, its
        weights quantized from ``f32_weights[member][fold]``."""
        agg_fn = _agg_fn(agg)
        mode = os.environ.get("VIPTPU_TTA_MODE", "map").strip().lower()
        if mode not in ("map", "fold"):
            raise ValueError(f"VIPTPU_TTA_MODE={mode!r} not in map|fold")
        for i, scales in enumerate(quant_scales or []):
            if scales:
                for j, model in enumerate(members[i][0]):
                    quantized(model, scales, weights=f32_weights[i][j] if f32_weights else None)
        dims = list(dict.fromkeys(tuple(dim) for _, dim in members))

        @torch.inference_mode()
        def forward(u8: np.ndarray, masks: Optional[Sequence[TTAMasks]] = None) -> torch.Tensor:
            with self._precision():
                return fused_forward(u8, masks)

        def fused_forward(u8: np.ndarray, masks: Optional[Sequence[TTAMasks]]) -> torch.Tensor:
            if tta > 1 and (masks is None or len(masks) != tta):
                raise ValueError(f"tta={tta} takes one TTAMasks a replica")
            # one resize per distinct member size, one augment per size and replica
            x0 = self._unit_input(u8)
            by_dim = {dim: self._member_input(x0, dim) for dim in dims}
            if tta > 1:
                masks = [m.to(self.device) for m in masks]
                augmented = {dim: [apply_augment(x, m) for m in masks]
                             for dim, x in by_dim.items()}
            preds = []
            for folds, dim in members:
                fold_preds = [_to_binary(
                    self._tta_forward(model, augmented[tuple(dim)], mode, agg_fn) if tta > 1
                    else model(by_dim[tuple(dim)]).float()) for model in folds]
                preds.append(agg_fn(torch.stack(fold_preds), 0))
            return torch.stack(preds).mean(0)

        return forward

    def _build_forward(self, model: torch.nn.Module, dim, tta: int, agg: str = "mean"):
        """One member's forward for the sequential path: ``fn(u8, masks=None)
        -> (B, classes)`` f32 probabilities, ``agg`` over the TTA copies (one
        forward each, as the JAX package's ``lax.map``)."""
        agg_fn = _agg_fn(agg)

        @torch.inference_mode()
        def forward(u8: np.ndarray, masks: Optional[Sequence[TTAMasks]] = None) -> torch.Tensor:
            with self._precision():
                x = self._member_input(self._unit_input(u8), dim)
                if tta > 1:
                    xs = [apply_augment(x, m.to(self.device)) for m in masks]
                    return self._tta_forward(model, xs, "map", agg_fn)
                return model(x).float()

        return forward

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def load_members(self, ckpt_cfg, keep_f32: Sequence[bool] = ()):
        """``(members, f32_weights)``: one ``(fold modules on the device,
        dim)`` per manifest entry, each folded under ``VIPTPU_FUSE_BN``, and,
        for each entry that ``keep_f32`` marks (the int8 ones), per fold the
        f32 values its int8 weights are quantized from, as the JAX package
        quantizes its f32 parameters: the checkpoint's tree (folded), read
        once, in the port's layout; a random-init member has no f32 copy, so
        the values it holds. Unmarked entries get None."""
        members, f32_weights = [], []
        for i, (base_dir, ckpt_paths, dim, _idx) in enumerate(ckpt_cfg):
            folds, f32 = self._load_folds(
                base_dir, ckpt_paths, dim, fuse_bn=self._fuse_bn_member(registry_name(base_dir)),
                keep_f32=i < len(keep_f32) and keep_f32[i])
            members.append((folds, tuple(dim)))
            f32_weights.append(f32)
        return members, f32_weights

    @staticmethod
    def _test_names(cfg) -> Tuple[List[str], List[str]]:
        with open(cfg.test_csv, newline="") as fh:
            names = [row["filename"] for row in csv.DictReader(fh)]
        if cfg.debug:
            names = names[:100]
        return names, [os.path.join(cfg.infer_path, n) for n in names]

    def predict_soln_fused(self, cfg) -> Dict[str, np.ndarray]:
        """The whole ensemble per batch; writes ``cfg.output_csv_path`` and
        returns ``{"filename", "logit", "raw"}`` sorted by filename."""
        test_names, test_paths = self._test_names(cfg)

        int8 = self._int8_members(cfg.ckpt_cfg, self._int8_names())
        int8_kernels = self._int8_kernels()
        members, f32_weights = self.load_members(
            cfg.ckpt_cfg, keep_f32=[pick or int8_kernels for pick in int8])
        if int8_kernels:  # before calibration: JAX calibrates with its blocks int8
            for (folds, _), f32, (base_dir, *_) in zip(members, f32_weights, cfg.ckpt_cfg):
                self._attach_int8_blocks(base_dir, folds, f32)
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
        # streaming, unless the sequential path already holds these images
        if self._decoded is not None and self._decoded_key == tuple(test_paths):
            batches = _batches(self._decoded, batch_size)
        else:
            batches = self._decode_stream(test_paths, batch_size)
        masks = self.tta_masks(cfg.seed, cfg.tta, batch_size, fused=True) if cfg.tta > 1 else None
        # VIPTPU_E2E_BATCH_TIMES=<path>: diagnostic mode, each batch waited for
        # and its end-to-end latency (decode wait + H2D + compute + D2H) written
        # to a JSON file; by default batches queue and are fetched at the end
        times_path = os.environ.get("VIPTPU_E2E_BATCH_TIMES", "")
        outs, valid, batch_times = [], [], []
        for batch, n_valid in batches:
            step = next(masks) if masks is not None else None
            if times_path:
                t0 = time.perf_counter()
                outs.append(fwd(batch, step).cpu())
                batch_times.append(time.perf_counter() - t0)
            else:
                outs.append(fwd(batch, step))
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
        _write_csv(cfg.output_csv_path, names, logit)
        if cfg.verbose:
            print("\n> FINAL PREDICTION SAVED TO ", cfg.output_csv_path)
        return {"filename": names, "logit": logit, "raw": raw.astype(np.float64)}

    def predict_model(self, model_dir_name: str, ckpt_paths: Sequence[str], dim,
                      paths: Sequence[str], tta: int = 1, agg: str = "mean",
                      batch_size: Optional[int] = None, seed: int = 42) -> np.ndarray:
        """One member over every fold, at its own batch size; returns its
        (N, 1) binary probabilities, ``agg`` over folds. The TTA masks come
        from one stream from ``seed``, stepped on across the folds."""
        if batch_size is None:
            batch_size = 8 * NAME2BS.get(model_dir_name, 16)  # main.py:85
        max_batch = int(os.environ.get("VIPTPU_MAX_BATCH", "0"))
        if max_batch:
            batch_size = min(batch_size, max_batch)
        int8_kernels = self._int8_kernels()
        folds, f32 = self._load_folds(model_dir_name, ckpt_paths, dim, keep_f32=int8_kernels)
        if int8_kernels:
            self._attach_int8_blocks(model_dir_name, folds, f32)
            del f32
        imgs = self._decode_all(paths)
        masks = self.tta_masks(seed, tta, batch_size, fused=False) if tta > 1 else None
        fold_preds = []
        for model in folds:
            fwd = self._build_forward(model, dim, tta, agg)
            outs, valid = [], []
            for batch, n_valid in _batches(imgs, batch_size):
                outs.append(fwd(batch, next(masks) if masks is not None else None))
                valid.append(n_valid)
            pred = np.concatenate([o.cpu().numpy()[:nv] for o, nv in zip(outs, valid)], 0)
            if pred.ndim == 1:
                pred = pred[:, None]
            if pred.shape[1] > 1:  # multiclass -> binary (main.py:113-114)
                pred = 1.0 - pred[:, 0:1]
            fold_preds.append(pred)
        return getattr(np, agg)(fold_preds, axis=0)

    def predict_soln(self, cfg, ensemble: bool = True):
        """The reference's sequential driver (main.py:58-149): one member at a
        time over the whole decoded set. With ``ensemble``, writes the CSV of
        the members' float64 mean by filename (one row per unique filename,
        sorted) and returns ``{"filename", "logit", "raw"}``; otherwise returns
        each member's ``{"filename", "logit"}`` in the CSV's order."""
        if cfg.verbose == 1:
            print("=" * 35)
            print("### INFERENCE ###")
            print("=" * 35)
        test_names, test_paths = self._test_names(cfg)
        per_member = []
        for i, (base_dir, ckpt_paths, dim, _idx) in enumerate(cfg.ckpt_cfg):
            if cfg.verbose:
                print(f"> MODEL({i + 1}/{len(cfg.ckpt_cfg)}): {base_dir} | DIM: {list(dim)}")
            t0 = time.time()
            preds = self.predict_model(base_dir, ckpt_paths, dim, test_paths, tta=cfg.tta,
                                       agg=cfg.agg, seed=cfg.seed)
            if cfg.verbose:
                dt = time.time() - t0
                print(f"  {len(test_paths)} imgs in {dt:.2f}s "
                      f"({len(test_paths) * max(cfg.tta, 1) / max(dt, 1e-9):.1f} img/s)")
            per_member.append({"filename": np.array(test_names, dtype=object),
                               "logit": preds[:, 0].astype(np.float64)})
        if not ensemble:
            return per_member
        names, inverse = np.unique(
            np.concatenate([m["filename"] for m in per_member]).astype(str), return_inverse=True)
        values = np.concatenate([m["logit"] for m in per_member])
        raw = np.bincount(inverse, weights=values) / np.bincount(inverse)
        logit = (raw > cfg.thr) * 1.0  # main.py:144
        names = names.astype(object)
        _write_csv(cfg.output_csv_path, names, logit)
        if cfg.verbose:
            print("\n> FINAL PREDICTION SAVED TO ", cfg.output_csv_path)
            for name, value in list(zip(names, logit))[:2]:
                print(f"{name},{value}")
        return {"filename": names, "logit": logit, "raw": raw}
