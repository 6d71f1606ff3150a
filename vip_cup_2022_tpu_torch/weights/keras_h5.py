"""Keras .h5 checkpoint reader + per-family name mappers (counterpart of
``vip_cup_2022_tpu/weights/keras_h5.py``).

The reference's ensemble checkpoints are whole Keras models (``.h5`` /
SavedModel). No graph is deserialized: the h5 weight arrays are read
directly and mapped onto the Flax variables tree of the matching model,
the tree every other checkpoint route of the port yields;
:func:`.from_jax.state_dict_from_flax` then carries it into the port's
modules, and raises on any leaf a mapper left out. Each model family
registers a mapper; families share the generic helpers here, including the
families the port has not built yet (their trees are pure renames).

Keras h5 layouts handled:
- full ``model.save``: weights under the ``model_weights`` group
- ``model.save_weights``: layers at root, ``layer_names`` attrs

Weight-array conventions (same memory layout, so mapping is mostly renames):
- Conv2D kernel HWIO == Flax ``nn.Conv`` kernel
- DepthwiseConv2D kernel (h, w, C, 1) -> Flax grouped-conv (h, w, 1, C),
  which the bridge then stores as the port's (h, w, C)
- Dense kernel (in, out) == Flax
- BatchNorm gamma/beta -> params, moving_mean/moving_variance -> batch_stats

``h5py`` is imported only inside :func:`read_keras_h5`.
"""
from __future__ import annotations

import re
from typing import Callable, Dict

import numpy as np

_WEIGHT_MAPPERS: Dict[str, Callable] = {}


def register_weight_mapper(*names: str):
    """Register the decorated mapper under each (lower-cased) name prefix."""
    def deco(fn):
        for n in names:
            _WEIGHT_MAPPERS[n.lower()] = fn
        return fn

    return deco


def read_keras_h5(path: str) -> Dict[str, np.ndarray]:
    """Flatten a Keras h5 into {'layer/weight': array} with ':0' stripped."""
    import h5py

    out: Dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                key = name.split(":")[0]
                out[key] = np.asarray(obj)

        root.visititems(visit)
    # drop optimizer state if present at top level
    return {k: v for k, v in out.items() if not k.startswith("optimizer")}


def _dedupe_layer_prefix(key: str) -> str:
    """Keras h5 nests 'layer_name/layer_name/weight'; collapse the repeat."""
    parts = key.split("/")
    if len(parts) >= 2 and parts[0] == parts[1]:
        parts = parts[1:]
    return "/".join(parts)


def _set(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def apply_weight_mapper(weights: Dict[str, np.ndarray], model_name: str, mapper: str = ""):
    """Map a flat {'layer/weight': array} dict onto the Flax variables pytree
    using the family mapper registered for ``model_name`` (or the explicitly
    named ``mapper`` — used when a name prefix is ambiguous, e.g. timm
    'resnet50' vs kecam 'resnet50d'; manifest sidecars may set {"mapper": ...})."""
    key = model_name.lower()
    if mapper:
        return _WEIGHT_MAPPERS[mapper.lower()](weights, model_name)
    fn = None
    for prefix, candidate in sorted(_WEIGHT_MAPPERS.items(), key=lambda kv: -len(kv[0])):
        if key.startswith(prefix):
            fn = candidate
            break
    if fn is None:
        raise KeyError(
            f"no weight mapper registered for '{model_name}' "
            f"(have: {sorted(_WEIGHT_MAPPERS)})"
        )
    return fn(weights, model_name)


def convert_keras_h5(path: str, model_name: str, mapper: str = ""):
    """Convert an h5 checkpoint to a variables pytree via the family mapper."""
    weights = {_dedupe_layer_prefix(k): v for k, v in read_keras_h5(path).items()}
    return apply_weight_mapper(weights, model_name, mapper)


# ---------------------------------------------------------------------------
# ResNet-RS (reference models/resnet_rs/resnet_rs_model.py layer names)
# ---------------------------------------------------------------------------

_RS_BLOCK_RE = re.compile(r"^(c\d+)_(block_\d+)_(.+)$")


@register_weight_mapper("resnetrs", "resnet-rs")
def map_resnet_rs(weights: Dict[str, np.ndarray], model_name: str):
    params: Dict = {}
    batch_stats: Dict = {}

    for key, value in weights.items():
        layer, wname = key.rsplit("/", 1)
        m = _RS_BLOCK_RE.match(layer)
        if m:
            block = f"{m.group(1)}_{m.group(2)}"
            sub = m.group(3)
        else:
            block, sub = None, layer

        if "batch_norm" in sub:
            target = batch_stats if wname.startswith("moving_") else params
            path = ([block] if block else []) + [sub, wname]
            _set(target, tuple(path), value)
        elif sub in ("se_reduce", "se_expand"):
            _set(params, (block, "se", sub, wname), value)
        elif sub.startswith(("conv", "projection_conv", "stem_conv")) or sub.endswith("conv"):
            # our Conv wrapper nests an nn.Conv named 'conv'
            path = ([block] if block else []) + [sub, "conv", wname]
            _set(params, tuple(path), value)
        elif sub == "predictions":
            _set(params, ("predictions", wname), value)
        # anything else (normalization preprocessing layers etc.) is skipped

    return {"params": params, "batch_stats": batch_stats}


# ---------------------------------------------------------------------------
# GCViT (subclassed-Keras save_weights layout: '<layer>/<model_name>/<path>')
# ---------------------------------------------------------------------------

_GCVIT_STRIP_RE = re.compile(r"^(?:.*?)/(gcvit[^/]*|GCViT[^/]*)/(.*)$")


def _merge_numeric(parts):
    """'levels/0/blocks/1' -> ['levels_0', 'blocks_1'] (Keras sublayer lists
    are numbered path components; flax names use underscores)."""
    out = []
    for p in parts:
        if p.isdigit() and out:
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return out


@register_weight_mapper("gcvit")
def map_gcvit(weights: Dict[str, np.ndarray], model_name: str):
    params: Dict = {}
    for key, value in weights.items():
        m = _GCVIT_STRIP_RE.match(key)
        path = m.group(2) if m else key
        parts = _merge_numeric(path.split("/"))
        # FeatExtract pyramid is flattened in the flax module
        if len(parts) >= 2 and parts[0].startswith("levels") and parts[1] == "q_global_gen":
            parts = [parts[0], f"q_global_gen_{parts[2]}"] + parts[3:]
        wname = parts[-1]
        if wname == "depthwise_kernel":
            # keras (h, w, C, 1) -> flax grouped conv (h, w, 1, C)
            value = np.transpose(value, (0, 1, 3, 2))
            parts[-1] = "kernel"
        _set(params, tuple(parts), value)
    return {"params": params}


# ---------------------------------------------------------------------------
# Generic kecam mapper: our kecam-family flax modules reuse the exact
# functional-Keras layer names, so conversion is rename-free — split
# layer/weight, route BN moving stats, transpose depthwise kernels.
# Covers: EfficientNet V1/V2, NFNets/ECA_NFNet, ResNest, ResNet-D/AotNet,
# HorNet, ... (register each family's prefixes below as they land).
# ---------------------------------------------------------------------------


@register_weight_mapper("efficientnet", "eca_nfnet", "nfnet", "resnest", "aotnet",
                        "resnet", "hornet", "regnet", "resnext", "kecam",
                        "mlpmixer", "resmlp", "gmlp", "swintransformer")
def map_kecam(weights: Dict[str, np.ndarray], model_name: str):
    params: Dict = {}
    batch_stats: Dict = {}
    for key, value in weights.items():
        comps = key.split("/")
        wname = comps[-1]
        body = comps[:-1]
        # functional h5 nests '<layer.name>/<layer.name>/<weight>' where
        # layer.name itself may contain slashes (e.g. mixer's
        # 'MixerBlock_0/token_mixing/Dense_0') — detect the duplicated halves
        half = len(body) // 2
        extra: tuple = ()
        if body and len(body) % 2 == 0 and body[:half] == body[half:]:
            layer = "_".join(body[:half])
        elif len(body) >= 2:
            # keras layers with sublayer weights (e.g. MultiHeadAttention:
            # '<layer>/query/kernel' after prefix dedupe) -> nested flax path
            layer, extra = body[0], tuple(body[1:])
        else:
            layer = body[-1] if body else key
        if wname == "depthwise_kernel":
            value = np.transpose(value, (0, 1, 3, 2))
            wname = "kernel"
        target = batch_stats if wname.startswith("moving_") else params
        _set(target, (layer, *extra, wname), value)
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


# ---------------------------------------------------------------------------
# EfficientDet: det layers (biFPN/heads/extra levels) live at the flax root,
# everything else is the EfficientNet backbone nested under 'backbone'
# ---------------------------------------------------------------------------

_EFFDET_HEAD_RE = re.compile(r"^(biFPN_|regressor_|classifier_|object_|p\d+_p\d+_)")


@register_weight_mapper("efficientdet")
def map_efficientdet(weights: Dict[str, np.ndarray], model_name: str):
    out = map_kecam(weights, model_name)

    def split(tree):
        root, backbone = {}, {}
        for layer, sub in tree.items():
            (root if _EFFDET_HEAD_RE.match(layer) else backbone)[layer] = sub
        if backbone:
            root["backbone"] = backbone
        return root

    result = {"params": split(out["params"])}
    if "batch_stats" in out:
        result["batch_stats"] = split(out["batch_stats"])
    return result


# ---------------------------------------------------------------------------
# tfimm ConvNeXt (subclassed model; layer names stem/0, stages/0/blocks/0/...)
# ---------------------------------------------------------------------------

_CONVNEXT_STRIP_RE = re.compile(r"^(?:.*?)/(convnext[^/]*)/(.*)$")


@register_weight_mapper("convnext")
def map_convnext(weights: Dict[str, np.ndarray], model_name: str):
    params: Dict = {}
    for key, value in weights.items():
        m = _CONVNEXT_STRIP_RE.match(key)
        path = m.group(2) if m else key
        parts = path.split("/")
        wname = parts[-1]
        if wname == "depthwise_kernel":
            value = np.transpose(value, (0, 1, 3, 2))
            wname = "kernel"

        if parts[0] == "stem":
            dest = ("stem_conv" if parts[1] == "0" else "stem_norm", wname)
        elif parts[0] == "head":
            dest = (f"head_{parts[1]}", wname)
        elif parts[0] == "stages":
            j = parts[1]
            if parts[2] == "downsample":
                which = "norm" if parts[3] == "0" else "conv"
                dest = (f"stages_{j}_downsample_{which}", wname)
            elif parts[2] == "blocks":
                i = parts[3]
                block = f"stages_{j}_blocks_{i}"
                rest = parts[4:-1]
                if rest == ["mlp", "fc1"]:
                    dest = (block, "mlp_fc1", wname)
                elif rest == ["mlp", "fc2"]:
                    dest = (block, "mlp_fc2", wname)
                elif rest:
                    dest = (block, *rest, wname)
                else:  # block-level gamma
                    dest = (block, wname)
            else:
                continue
        else:
            continue
        _set(params, dest, value)
    return {"params": params}


# ---------------------------------------------------------------------------
# tfimm ViT/DeiT (subclassed; '<layer>/<model_name>/<path>' h5 layout)
# ---------------------------------------------------------------------------

_VIT_STRIP_RE = re.compile(r"^(?:.*?)/((?:vit|deit|cait|pit|pvt|resnetv2|swin)[^/]*)/(.*)$")


@register_weight_mapper("vit", "deit", "cait", "pit", "pvt", "resnetv2", "swin")
def map_vit(weights: Dict[str, np.ndarray], model_name: str):
    params: Dict = {}
    for key, value in weights.items():
        m = _VIT_STRIP_RE.match(key)
        path = m.group(2) if m else key
        parts = _merge_numeric(path.split("/"))
        if parts[0].startswith("patch_embed"):
            parts = [parts[0] + "_" + parts[1]] + parts[2:]
        elif parts[0] == "pre_logits":
            parts = ["pre_logits_" + parts[1]] + parts[2:]
        if parts[-1] == "depthwise_kernel":
            value = np.transpose(value, (0, 1, 3, 2))
            parts[-1] = "kernel"
        _set(params, tuple(parts), value)
    return {"params": params}


# additional kecam-family prefixes routed to the generic mapper
for _prefix in ("mobilenet", "lcnet", "fbnet", "tinynet", "beit", "uniformer", "wavemlp",
                "davit", "coatnet", "edgenext", "efficientformer", "levit",
                "mobilevit", "nat", "volo", "halonet", "botnet", "cotnet",
                "cmt", "coat", "yolox", "yolor", "regnety", "regnetz", "resnet51q", "resnet61q", "resnetq"):
    _WEIGHT_MAPPERS[_prefix] = map_kecam


# ---------------------------------------------------------------------------
# tfimm poolformer / convmixer (subclassed; slash-nested layer names mapped to
# underscore-joined flax module names)
# ---------------------------------------------------------------------------

_TFIMM_FLAT_RE = re.compile(r"^(?:.*?)/((?:poolformer|convmixer)[^/]*)/(.*)$")


@register_weight_mapper("poolformer", "convmixer")
def map_tfimm_flat(weights: Dict[str, np.ndarray], model_name: str):
    params: Dict = {}
    batch_stats: Dict = {}
    for key, value in weights.items():
        m = _TFIMM_FLAT_RE.match(key)
        path = m.group(2) if m else key
        # convmixer stems embed the model name inside the layer name again
        m2 = _TFIMM_FLAT_RE.match(path)
        if m2:
            path = m2.group(2)
        parts = path.split("/")
        wname = parts[-1]
        if wname == "depthwise_kernel":
            value = np.transpose(value, (0, 1, 3, 2))
            wname = "kernel"
        if wname.startswith("layer_scale"):
            # param lives directly on the block layer -> flax root leaf
            _set(params, ("_".join(parts),), value)
            continue
        target = batch_stats if wname.startswith("moving_") else params
        _set(target, ("_".join(parts[:-1]), wname), value)
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


# ---------------------------------------------------------------------------
# timm-style tfimm ResNet ('<layer>/<model_name>/<path>' with Sequential
# stems/downsamples). Plain 'resnetNN' names collide with the kecam prefix;
# convert with mapper="timm_resnet" (auto-routed for the unambiguous ones).
# ---------------------------------------------------------------------------


@register_weight_mapper("timm_resnet", "tv_resnet", "wide_resnet", "ig_resnext",
                        "ssl_resne", "swsl_resne", "ecaresnet", "seresne",
                        "resnetblur")
def map_timm_resnet(weights: Dict[str, np.ndarray], model_name: str):
    params: Dict = {}
    batch_stats: Dict = {}
    for key, value in weights.items():
        comps = key.split("/")
        # strip everything through the embedded model name
        if model_name in comps:
            comps = comps[comps.index(model_name) + 1 :]
        parts = _merge_numeric(comps)
        wname = parts[-1]
        if wname == "blur_kernel":  # fixed binomial kernel, computed statically
            continue
        target = batch_stats if wname.startswith("moving_") else params
        _set(target, tuple(parts), value)
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out
