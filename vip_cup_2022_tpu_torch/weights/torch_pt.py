"""timm / PyTorch checkpoint converter (counterpart of
``vip_cup_2022_tpu/weights/torch_pt.py``).

The mapping target is the Flax variables tree, the tree every checkpoint
route of the port yields (:func:`.from_jax.state_dict_from_flax` carries it
into the modules), so conversion is explicit per-family name mapping plus
the three layout rules of tfimm's and kecam's torch ingestion:

- conv weight  OIHW -> HWIO            (depthwise (C,1,k,k) -> (k,k,1,C))
- linear weight (out, in) -> (in, out)
- norm weight/bias -> gamma/beta; running_mean/var -> batch_stats

State dicts are read with ``torch.load(..., weights_only=True)`` (no pickled
code executes) or accepted as in-memory mappings. A bfloat16 tensor has no
numpy dtype: it raises, as the JAX package's ``v.numpy()`` does, naming the
entry.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

_TORCH_MAPPERS: Dict[str, Callable] = {}


def register_torch_mapper(*names: str):
    """Register the decorated mapper under each (lower-cased) name prefix."""
    def deco(fn):
        for n in names:
            _TORCH_MAPPERS[n.lower()] = fn
        return fn

    return deco


def read_torch_checkpoint(path_or_dict) -> Dict[str, np.ndarray]:
    """{timm name: numpy array} from a .pt/.pth path or in-memory mapping."""
    if isinstance(path_or_dict, Mapping):
        state = path_or_dict
    else:
        state = torch.load(path_or_dict, map_location="cpu", weights_only=True)
        for key in ("state_dict", "model"):  # common training-ckpt nesting
            if key in state and isinstance(state[key], Mapping):
                state = state[key]
                break
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            raise TypeError(f"{k}: a bfloat16 tensor has no numpy dtype; save the "
                            "checkpoint in float32 (e.g. {k: v.float()} of the state dict)")
        out[k] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
    return out


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO (also maps depthwise (C,1,k,k) -> (k,k,1,C))."""
    return np.transpose(w, (2, 3, 1, 0))


def linear_kernel(w: np.ndarray) -> np.ndarray:
    """(out, in) -> (in, out)."""
    return np.transpose(w, (1, 0))


def _set(tree: Dict, path: str, value: np.ndarray):
    node = tree
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _map_norm(params, flax_name, torch_name, weights):
    if f"{torch_name}.weight" in weights:
        _set(params, f"{flax_name}/gamma", weights[f"{torch_name}.weight"])
    if f"{torch_name}.bias" in weights:
        _set(params, f"{flax_name}/beta", weights[f"{torch_name}.bias"])


@register_torch_mapper("vit", "deit")
def map_vit_torch(weights: Dict[str, np.ndarray], model_name: str):
    """timm VisionTransformer state dict -> our models/vit.py tree."""
    p: Dict = {}
    for k, v in weights.items():
        if k == "cls_token":
            _set(p, "cls_token", v)
        elif k == "pos_embed":
            _set(p, "pos_embed", v)
        elif k == "patch_embed.proj.weight":
            _set(p, "patch_embed_proj/kernel", conv_kernel(v))
        elif k == "patch_embed.proj.bias":
            _set(p, "patch_embed_proj/bias", v)
        elif k.startswith("blocks."):
            _, idx, rest = k.split(".", 2)
            base = f"blocks_{idx}"
            name, leaf = rest.rsplit(".", 1)
            name = name.replace(".", "/")
            if rest.startswith(("norm1", "norm2")):
                _set(p, f"{base}/{name}/" + ("gamma" if leaf == "weight" else "beta"), v)
            elif leaf == "weight":
                _set(p, f"{base}/{name}/kernel", linear_kernel(v))
            else:
                _set(p, f"{base}/{name}/bias", v)
        elif k.startswith("norm."):
            _map_norm(p, "norm", "norm", weights)
        elif k == "head.weight":
            _set(p, "head/kernel", linear_kernel(v))
        elif k == "head.bias":
            _set(p, "head/bias", v)
    return {"params": p}


@register_torch_mapper("convnext")
def map_convnext_torch(weights: Dict[str, np.ndarray], model_name: str):
    """timm ConvNeXt state dict -> our models/convnext.py tree. Handles both
    head namings ('head.norm'/'head.fc' and bare 'norm'/'head')."""
    p: Dict = {}
    for k, v in weights.items():
        if k.startswith("stem.0."):
            leaf = "kernel" if k.endswith("weight") else "bias"
            _set(p, f"stem_conv/{leaf}", conv_kernel(v) if leaf == "kernel" else v)
        elif k.startswith("stem.1."):
            _set(p, "stem_norm/" + ("gamma" if k.endswith("weight") else "beta"), v)
        elif k.startswith("stages."):
            parts = k.split(".")
            s = parts[1]
            if parts[2] == "downsample":
                which = parts[3]
                leaf = parts[4]
                if which == "0":  # LN
                    _set(p, f"stages_{s}_downsample_norm/" + ("gamma" if leaf == "weight" else "beta"), v)
                else:  # conv
                    _set(p, f"stages_{s}_downsample_conv/" + ("kernel" if leaf == "weight" else "bias"),
                         conv_kernel(v) if leaf == "weight" else v)
            else:  # blocks
                b = parts[3]
                base = f"stages_{s}_blocks_{b}"
                rest = ".".join(parts[4:])
                if rest == "gamma":
                    _set(p, f"{base}/gamma", v)
                elif rest.startswith("conv_dw."):
                    leaf = "kernel" if rest.endswith("weight") else "bias"
                    _set(p, f"{base}/conv_dw/{leaf}", conv_kernel(v) if leaf == "kernel" else v)
                elif rest.startswith("norm."):
                    _set(p, f"{base}/norm/" + ("gamma" if rest.endswith("weight") else "beta"), v)
                elif rest.startswith("mlp."):
                    name = "mlp_fc1" if ".fc1." in f".{rest}" else "mlp_fc2"
                    leaf = "kernel" if rest.endswith("weight") else "bias"
                    _set(p, f"{base}/{name}/{leaf}", linear_kernel(v) if leaf == "kernel" else v)
        elif k in ("head.norm.weight", "norm.weight"):
            _set(p, "head_norm/gamma", v)
        elif k in ("head.norm.bias", "norm.bias"):
            _set(p, "head_norm/beta", v)
        elif k in ("head.fc.weight", "head.weight"):
            _set(p, "head_fc/kernel", linear_kernel(v))
        elif k in ("head.fc.bias", "head.bias"):
            _set(p, "head_fc/bias", v)
    return {"params": p}


def convert_torch_weights(path_or_dict, model_name: str, mapper: str = ""):
    """Convert a timm/PyTorch checkpoint to a Flax variables pytree using the
    family mapper registered for ``model_name`` (same dispatch scheme as the
    Keras-h5 converters)."""
    weights = read_torch_checkpoint(path_or_dict)
    key = model_name.lower()
    if mapper:
        return _TORCH_MAPPERS[mapper.lower()](weights, model_name)
    fn = None
    for prefix, candidate in sorted(_TORCH_MAPPERS.items(), key=lambda kv: -len(kv[0])):
        if key.startswith(prefix):
            fn = candidate
            break
    if fn is None:
        raise KeyError(
            f"no torch mapper registered for '{model_name}' "
            f"(have: {sorted(_TORCH_MAPPERS)})"
        )
    return fn(weights, model_name)
