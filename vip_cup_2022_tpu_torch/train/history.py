"""Training-history tools (counterpart of ``vip_cup_2022_tpu/train/history.py``,
kecam's ``imagenet/eval_func.py:157-273``): ``combine_hist_into_one``, the
log-cubic ``curve_fit`` extrapolation (scipy), ``plot_and_peak_scatter``
and ``plot_hists``. History files are the per-epoch JSON dicts
``train/trainer.py`` writes. matplotlib is imported only to plot, with its
Agg backend, and the figures are saved (``save_path``), not shown: a
training host has no display.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np


def combine_hist_into_one(hist_list: Sequence[Union[str, dict]],
                          save_file: Optional[str] = None) -> dict:
    """Concatenate the per-key curves of several history JSONs
    (eval_func.py:157-170 — resumes produce multiple files)."""
    hh: dict = {}
    for hist in hist_list:
        if isinstance(hist, str):
            with open(hist) as ff:
                hist = json.load(ff)
        for kk, vv in hist.items():
            hh.setdefault(kk, []).extend(vv)
    if save_file:
        with open(save_file, "w") as ff:
            json.dump(hh, ff)
    return hh


def curve_fit(source, target_len: int = 10, skip: int = 5, use_recent: int = 40) -> List[float]:
    """Extrapolate a metric curve ``target_len`` epochs ahead with the
    reference's log-cubic fit (eval_func.py:173-190): fit
    a*ln(x)^3 + b*ln(x)^2 + c*ln(x) + d on the recent window."""
    from scipy.optimize import curve_fit as scipy_curve_fit

    def func_curv(x, a, b, c, d):
        pp = np.log(x)
        return a * pp**3 + b * pp**2 + c * pp + d

    source = list(source)
    recent = source[skip:]
    use_recent = len(source) if use_recent == -1 else use_recent
    if len(recent) > use_recent:
        recent = recent[-use_recent:]
    start = len(source) - len(recent)
    popt, _ = scipy_curve_fit(func_curv, np.arange(start, len(source)), recent)
    tail = func_curv(np.arange(start, len(source) + target_len), *popt)
    return source[: -len(recent)] + tail.tolist()


def plot_and_peak_scatter(ax, source_array, peak_method, label, skip_first: int = 0,
                          color=None, va: str = "bottom", pred_curve: int = 0, **kwargs):
    """Plot a curve, mark+annotate its peak, optionally add the curve-fit
    extrapolation as a dotted line (eval_func.py:193-210)."""
    array = list(source_array[skip_first:])
    for idx, vv in enumerate(array):  # forward-fill NaNs
        if isinstance(vv, float) and np.isnan(vv):
            array[idx] = array[idx - 1] if idx else 0.0
    xs = range(skip_first, skip_first + len(array))
    ax.plot(xs, array, label=label, color=color, **kwargs)
    color = ax.lines[-1].get_color() if color is None else color
    pp = int(peak_method(array))
    ax.scatter(pp + skip_first, array[pp], color=color, marker="v")
    ax.text(pp + skip_first, array[pp], f"{array[pp]:.4f}", va=va, ha="right", color=color)
    if pred_curve > 0:
        kwargs.pop("linestyle", None)
        pred = curve_fit(list(source_array), pred_curve)[skip_first:]
        ax.plot(range(skip_first, skip_first + len(pred)), pred, color=color,
                linestyle=":", **kwargs)
    return color


def plot_hists(hists, names=None, base_size: int = 6, addition_plots=("lr",),
               text_va=("bottom",), skip_first: int = 0, pred_curve: int = 0,
               save_path: Optional[str] = None):
    """Loss/accuracy/LR panels for one or more histories
    (eval_func.py:212-273). Returns the figure; saves to ``save_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    addition_plots = list(addition_plots or [])
    num_axes = 2 + len(addition_plots)
    fig, axes = plt.subplots(1, num_axes, figsize=(num_axes * base_size, base_size))
    hists = [hists] if isinstance(hists, (str, dict)) else list(hists)
    names = names if isinstance(names, (list, tuple)) else [names]

    for hid, hist in enumerate(hists):
        name = names[min(hid, len(names) - 1)] if names and names[0] is not None else None
        cur_va = text_va[hid % len(text_va)]
        if isinstance(hist, str):
            name = name or os.path.splitext(os.path.basename(hist))[0]
            with open(hist) as ff:
                hist = json.load(ff)
        name = name or str(hid)

        acc_keys = [k for k in hist if "acc" in k and "val" not in k]
        val_acc_keys = [k for k in hist if "acc" in k and "val" in k]
        acc_key = acc_keys[0] if acc_keys else "acc"
        val_acc_key = val_acc_keys[0] if val_acc_keys else "val_acc"
        cur_pred = (pred_curve[min(hid, len(pred_curve) - 1)]
                    if isinstance(pred_curve, (list, tuple)) else pred_curve)

        color = plot_and_peak_scatter(axes[0], hist["loss"], np.argmin, f"{name} loss",
                                      skip_first, None, cur_va, pred_curve=cur_pred)
        if hist.get("val_loss") and "val_loss" not in addition_plots:
            plot_and_peak_scatter(axes[0], hist["val_loss"], np.argmin, f"{name} val_loss",
                                  skip_first, color, cur_va, cur_pred, linestyle="--")
        if hist.get(acc_key):
            plot_and_peak_scatter(axes[1], hist[acc_key], np.argmax, f"{name} accuracy",
                                  skip_first, color, cur_va, cur_pred)
        if hist.get(val_acc_key):
            plot_and_peak_scatter(axes[1], hist[val_acc_key], np.argmax, f"{name} val_accuracy",
                                  skip_first, color, cur_va, cur_pred, linestyle="--")
        for aid, key in enumerate(addition_plots):
            if hist.get(key):
                peak = np.argmin if "loss" in key else np.argmax
                plot_and_peak_scatter(axes[2 + aid], hist[key], peak, f"{name} {key}",
                                      skip_first, color, cur_va, cur_pred)
    for ax in axes:
        ax.legend()
        ax.grid(True)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig
