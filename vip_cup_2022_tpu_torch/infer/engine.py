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

Not ported yet, and raising ``NotImplementedError`` rather than running
something else: test-time augmentation (``tta > 1``), int8 members, the
conv-BN fold and members other than ConvNeXt and GCViT. Of the JAX
package's Pallas kernels, only the four that its experiment tools reach
(``tools/exp_convnext_s12.py``, ``tools/exp_attn_parts.py``,
``tools/int8_pallas_spike.py``) have no CUDA counterpart; none is on this
path.
"""
from __future__ import annotations

import csv
import json
import os
import time
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.decode import ImageDecoder
from ..data.pipeline import _host_resize_uint8
from ..models import create_model, load_weights, transfer_weights
from ..models.registry import is_model
from ..ops.resize import resize

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
    ``VIPTPU_INT8`` (int8 members, A12) and ``VIPTPU_FUSE_BN`` (the conv-BN
    fold, A13); ``VIPTPU_TTA`` > 1 (A11) raises where the ensemble is built.
    The JAX package's TPU tuning switches (``VIPTPU_PALLAS``,
    ``VIPTPU_PALLAS_LN``, the ``VIPTPU_GCVIT_*`` and ``VIPTPU_DW_*`` family)
    choose among TPU kernels and layouts, have nothing to choose on CUDA and
    are not read."""
    int8 = os.environ.get("VIPTPU_INT8", "auto").strip().lower()
    if int8 not in ("", "auto", "0", "off", "false"):
        raise NotImplementedError(
            f"VIPTPU_INT8={int8!r}: int8 members are ROADMAP item A12, not ported yet")
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
                f"member {name!r}: only ConvNeXt and GCViT are ported; ResNetRS50 is "
                "ROADMAP item A3, ResNest A7, EfficientNet A8, NFNet A9")
        return create_model(name, input_size=tuple(dim), dtype=self.compute_dtype,
                            **overrides)

    def build_fused_ensemble(self, members, tta: int = 1, agg: str = "mean"):
        """``members``: list of ``(fold modules, dim)``. Returns
        ``fn(u8 (B, 200, 200, 3) numpy) -> (B, 1)`` ensemble-mean probability
        on the device, aggregated binary -> folds -> members."""
        if tta > 1:
            raise NotImplementedError(
                f"tta={tta}: test-time augmentation is ROADMAP item A11, not ported yet")
        if agg != "mean":
            raise NotImplementedError(f"agg={agg!r}: only 'mean' is ported")
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
    def load_members(self, ckpt_cfg) -> List[Tuple[List[torch.nn.Module], Tuple[int, int]]]:
        """One ``(fold modules on the device, dim)`` per manifest entry."""
        members = []
        for base_dir, ckpt_paths, dim, _idx in ckpt_cfg:
            name = registry_name(base_dir)
            overrides: Dict = {}
            if ckpt_paths:
                cfg_json = os.path.join(os.path.dirname(ckpt_paths[0]), "config.json")
                if os.path.isfile(cfg_json):
                    with open(cfg_json) as fh:
                        overrides = json.load(fh)
                    overrides.pop("input_size", None)
            folds = []
            for ckpt in sorted(ckpt_paths):
                module, _ = self._create_member(name, dim, overrides)
                folds.append(transfer_weights(load_weights(ckpt), module, strict=True)
                             .to(self.device))
            if not folds:  # random-init (allow_missing) member
                module, _ = self._create_member(name, dim, overrides)
                folds = [module.to(self.device)]
            members.append((folds, tuple(dim)))
        return members

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

        fwd = self.build_fused_ensemble(self.load_members(cfg.ckpt_cfg),
                                        tta=cfg.tta, agg=cfg.agg)
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
