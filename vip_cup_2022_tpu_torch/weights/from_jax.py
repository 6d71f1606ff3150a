"""Map a Flax variables tree onto the port's ``state_dict``.

The inverse of ``vip_cup_2022_tpu/weights/torch_pt.py``'s layout rules:

- conv kernel HWIO -> OIHW, except a depthwise kernel (kh, kw, 1, C), which
  keeps Flax's layout with the I axis dropped, (kh, kw, C): the layout the
  depthwise kernel reads; a grouped kernel (kh, kw, I / groups, O) is
  HWIO like any other (NFNet's (3, 3, 64, C));
- 1-D conv kernel (k, I, O) -> (O, I, k) (ECA's ``conv1d``);
- Dense kernel (in, out) -> (out, in);
- norm gamma / beta -> weight / bias; the BatchNorm ``batch_stats``
  ``moving_mean`` / ``moving_variance`` -> ``running_mean`` /
  ``running_var``;
- any other leaf (a block's layer-scale ``gamma``) keeps its name.

The port names its modules after the Flax modules, so a Flax path
``params/stages_0_blocks_0/mlp_fc1/kernel`` becomes the key
``stages_0_blocks_0.mlp_fc1.weight``.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Tuple

import numpy as np

_CLASSIFIER_PREFIXES = ("predictions", "head", "classifier", "logits")


def is_classifier_key(key: str) -> bool:
    """True for the classifier head (``head_fc``, ``head_norm``, ...), whose
    shape may differ from a checkpoint's (the classifier swap)."""
    return any(part.startswith(_CLASSIFIER_PREFIXES) for part in key.split("."))


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v, tree


def _leaf_name(collection: str, leaf: str, siblings: Mapping) -> str:
    if collection == "batch_stats":
        return {"moving_mean": "running_mean", "moving_variance": "running_var"}.get(leaf, leaf)
    if leaf == "kernel":
        return "weight"
    if leaf in ("beta", "bias"):
        return "bias"
    if leaf == "gamma" and "beta" in siblings:
        return "weight"
    return leaf


def _to_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return value
    # depthwise: one input feature per group. A grouped conv's I axis is its
    # group size, which is 1 only when the groups are the channels, so no
    # grouped conv of a member lands here (NFNet's groups are 64 wide); a
    # plain conv on a 1-channel input does (a member built with
    # in_channels=1), and state_dict_from_flax restores it from its target
    if value.ndim == 4 and value.shape[2] == 1 and value.shape[3] > 1:
        return value[:, :, 0, :]
    if value.ndim == 4:  # HWIO -> OIHW, grouped or not
        return np.transpose(value, (3, 2, 0, 1))
    if value.ndim == 3:  # conv1d (k, I, O) -> (O, I, k)
        return np.transpose(value, (2, 1, 0))
    if value.ndim == 2:  # (in, out) -> (out, in)
        return value.T
    raise ValueError(f"kernel of rank {value.ndim} has no torch layout rule")


def flax_to_torch(variables: Mapping) -> Dict[str, np.ndarray]:
    """{state_dict key: numpy array in torch layout} for every leaf."""
    out: Dict[str, np.ndarray] = {}
    for path, value, siblings in _flatten(variables):
        collection, modules, leaf = path[0], path[1:-1], path[-1]
        key = ".".join(modules + (_leaf_name(collection, leaf, siblings),))
        if key in out:
            raise ValueError(f"two Flax leaves map to the state_dict key {key!r}")
        value = _to_torch_layout(leaf, np.asarray(value))
        # ascontiguousarray would make a scalar (ZeroInitGain's gain) 1-d
        out[key] = value if value.flags.c_contiguous else np.ascontiguousarray(value)
    return out


def _adapt_in_channels(kernel: np.ndarray, in_channels: int) -> np.ndarray:
    """First-conv input-channel adaptation of an HWIO kernel (the JAX
    factory's ``_adapt_in_channels``, tfimm's): 1 channel -> the sum over
    the source's; N channels -> the source's tiled to N, rescaled."""
    src_ch = kernel.shape[2]
    if in_channels == 1:
        return kernel.sum(axis=2, keepdims=True)
    reps = int(np.ceil(in_channels / src_ch))
    tiled = np.tile(kernel, (1, 1, reps, 1))[:, :, :in_channels, :]
    return tiled * (src_ch / in_channels)


def _adaptable(value: np.ndarray, shape: Tuple[int, ...]) -> bool:
    """An OIHW kernel that differs from ``shape`` in its input channels only."""
    return (value.ndim == 4 and len(shape) == 4 and value.shape[0] == shape[0]
            and tuple(value.shape[2:]) == tuple(shape[2:]))


def _one_input_conv(value: np.ndarray, shape: Tuple[int, ...]) -> bool:
    """A plain conv kernel on one input channel, (kh, kw, 1, O) in Flax,
    which :func:`flax_to_torch` took for a depthwise (kh, kw, O): the
    target's OIHW (O, 1, kh, kw) tells them apart."""
    return (value.ndim == 3 and len(shape) == 4 and shape[1] == 1
            and tuple(value.shape) == (shape[2], shape[3], shape[0]))


def state_dict_from_flax(variables: Mapping, target: Mapping[str, Any],
                         strict: bool = False, adapt_first_conv: bool = True,
                         on_mismatch: str = "raise") -> Dict[str, Any]:
    """Build a complete state dict for ``target`` (a module's ``state_dict()``)
    from a Flax tree. A conv kernel that differs only in its input channels
    is adapted to the target's (``adapt_first_conv``, as the JAX factory
    does). Unless ``strict``, entries of the classifier head whose shape
    differs, or that the tree lacks, keep ``target``'s value (the classifier
    swap of fine-tuning). Any other uncovered, unexpected or shape-mismatched
    entry (with ``strict`` the head's too) raises under ``on_mismatch``
    ``"raise"``; under ``"warn"`` it keeps ``target``'s value with a warning,
    under ``"silent"`` without one (an intended partial transfer)."""
    import torch

    if on_mismatch not in ("warn", "raise", "silent"):
        raise ValueError(f"on_mismatch must be warn|raise|silent, got {on_mismatch!r}")
    src = flax_to_torch(variables)
    swappable = (lambda key: False) if strict else is_classifier_key
    out: Dict[str, Any] = {}
    problems = []
    for key, dst in target.items():
        if key not in src:
            if not swappable(key):
                problems.append(f"{key}: missing from the checkpoint")
            out[key] = dst
            continue
        value = src[key]
        if _one_input_conv(value, tuple(dst.shape)):
            value = np.ascontiguousarray(np.transpose(value, (2, 0, 1))[:, None])
        if tuple(value.shape) != tuple(dst.shape):
            if adapt_first_conv and _adaptable(value, tuple(dst.shape)):
                hwio = np.ascontiguousarray(np.transpose(value, (2, 3, 1, 0)))
                value = np.ascontiguousarray(np.transpose(
                    _adapt_in_channels(hwio, dst.shape[1]), (3, 2, 0, 1)))
            else:
                if not swappable(key):
                    problems.append(f"{key}: checkpoint {value.shape} vs model {tuple(dst.shape)}")
                out[key] = dst
                continue
        out[key] = torch.tensor(value, dtype=dst.dtype)
    extra = [k for k in src if k not in target and not swappable(k)]
    problems += [f"{k}: in the checkpoint but not in the model" for k in extra]
    if problems and on_mismatch != "silent":
        msg = (f"weight bridge: {len(problems)} uncovered or mismatched leaf(s)"
               + (": " if on_mismatch == "raise" else " (kept at the model's values): ")
               + "; ".join(problems[:8]) + (" ..." if len(problems) > 8 else ""))
        if on_mismatch == "raise":
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=3)
    return out
