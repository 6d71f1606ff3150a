#!/usr/bin/env python3
"""Measurements of the int8 MLP pair (``VIPTPU_INT8_KERNELS=1``) on one CUDA card.

    python3 -m vip_cup_2022_tpu_torch.tools.exp_int8_mlp [--parts gelu scan cuts widths]
        [--batch 256]

- ``gelu``: the per-element epilogue of ``mlp_int8_scale_residual`` alone,
  out of registers at full occupancy (``csrc/int8_mlp_cuts.cu``:
  ``gelu_throughput``): the GELU (``gelu_rn``), with the dequant before it,
  with the code after it, 4 and 8 independent elements a thread; clocks an
  element on an SM, at the card's maximum SM clock (what bounds the pair's
  epilogue on the CUDA cores);
- ``scan``: where the kernels' GELU is monotone, over every f32 input:
  descents on [0, inf) and the inputs they start at, its largest magnitude
  below 0 and where, the falls of |GELU| between 0 and that point and its
  rises beyond (``ln_fc1_rowmax_int8`` leans on the first two; the card
  test and ``chip_smoke.py`` check them with ``block_int8.gelu_mono_check``);
- ``cuts``: ``mlp_int8_scale_residual``'s phase cuts at ConvNeXt's stages
  s1-s4 (batch ``--batch``): ``loads`` (the TMA loads, waits and barriers
  alone), ``products`` (+ fc1 and fc2), ``whole`` (the kernel), by device
  time;
- ``widths``: ``ln_fc1_rowmax_int8`` with items of 128, 96 and 64 columns at
  ConvNeXt's s1-s4 and GCViT's L2-L4, by device time, each checked equal to
  the plan's launch.

No counterpart in the JAX package. Needs a CUDA device; the last line is the
results as one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
from typing import Optional, Sequence

import torch

from ..ops.kernels import block_int8 as B8
from ..ops.kernels import build
from ..ops.kernels.convnext_block import _stream
from ..quant import dyn_int8
from .bench_util import card_line, device_ms

PARTS = ("gelu", "scan", "cuts", "widths")
CUTS = {"loads": 0, "products": 1, "whole": 2}
# name: grid, C, N / C (ConvNeXt's stages at 200 px, GCViTTiny's levels at 224)
SHAPES = {"s1": (99, 96, 4), "s2": (49, 192, 4), "s3": (24, 384, 4), "s4": (12, 768, 4),
          "L2": (28, 128, 3), "L3": (14, 256, 3), "L4": (7, 512, 3)}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("int8_mlp_cuts")
    for name, args in {"mlp_cut": [_I] + [_P] * 12 + [_I] * 8 + [_P],
                       "gelu_throughput": [_I] * 4 + [_P, _P], "gelu_scan": [_P, _P],
                       "sm_clock_khz": []}.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _ok(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def gelu(dev: torch.device) -> dict:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = _lib().sm_clock_khz() * 1e3
    blocks, iters = sms * 8, 2048
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    results = {}
    for mode, name in enumerate(("gelu_rn", "dequant + gelu_rn", "dequant + gelu_rn + code")):
        for ilp in (4, 8):
            def run():
                _ok(_lib().gelu_throughput(mode, ilp, blocks, iters, out.data_ptr(), _stream(dev)),
                    "gelu_throughput")
            ms = device_ms(run, calls=3, replays=3)
            elems = blocks * 256 * iters * ilp
            clk = ms * 1e-3 * clock_hz * sms / elems
            results[f"{name} ilp{ilp}"] = clk
            print(f"[gelu] {name:26s} ilp {ilp}: {ms:.3f} ms, {elems / ms * 1e-6:.1f} G "
                  f"elements/s, {clk:.3f} clocks an element on an SM at {clock_hz * 1e-6:.0f} MHz",
                  flush=True)
    return results


def scan(dev: torch.device) -> dict:
    buf = torch.zeros(9, dtype=torch.int64, device=dev)
    buf[6:] = 0xFFFFFFFF  # each: a minimum (low word, 0xffffffff) and a maximum (high word, 0)
    _ok(_lib().gelu_scan(buf.data_ptr(), _stream(dev)), "gelu_scan")
    v = [int(x) & 0xFFFFFFFFFFFFFFFF for x in buf.tolist()]
    def f(bits: int) -> float:  # an f32's value from its bits (as a signed 32-bit int)
        return float(torch.tensor([bits], dtype=torch.int32).view(torch.float32))

    def s32(u: int) -> int:
        return u - (1 << 32) if u >= 1 << 31 else u

    peak_bits = (~v[3]) & 0xFFFFFFFF
    r = {"pos_descents": v[0], "pos_negative": v[1], "neg_positive": v[2],
         "peak": f(s32((v[3] >> 32) & 0xFFFFFFFF)), "peak_at": -f(s32(peak_bits)),
         "near_falls": v[4], "far_rises": v[5],
         "near_band": [-f(s32(v[7] & 0xFFFFFFFF)), -f(s32(v[7] >> 32))],
         "far_band": [-f(s32(v[8] & 0xFFFFFFFF)), -f(s32(v[8] >> 32))]}
    print(f"[scan] on [0, inf): {r['pos_descents']} descents, {r['pos_negative']} values < 0; "
          f"below 0: {r['neg_positive']} values > 0, largest |GELU| {r['peak']!r} at "
          f"{r['peak_at']!r}; between 0 and there {r['near_falls']} falls of |GELU| "
          f"(from {r['near_band'][0]!r} to {r['near_band'][1]!r}), beyond {r['far_rises']} rises "
          f"(from {r['far_band'][0]!r} to {r['far_band'][1]!r})", flush=True)
    return r


def _weights(g, n, k, dev):
    w = (torch.rand((n, k), generator=g, device=dev) * 2 - 1) * k ** -0.5
    return dyn_int8.quantize_linear(w)


def cuts(dev: torch.device, batch: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(5)
    results = {}
    for name in ("s1", "s2", "s3", "s4"):
        grid, c, ratio = SHAPES[name]
        m, n = batch * grid * grid, ratio * c
        x = torch.rand((m, c), generator=g, device=dev) * 2 - 1
        fc1, fc2 = _weights(g, n, c, dev), _weights(g, c, n, dev)
        b1, b2 = torch.zeros(n, device=dev), torch.zeros(c, device=dev)
        gamma, lg = torch.ones(c, device=dev), torch.ones(c, device=dev)
        lb = torch.zeros(c, device=dev)
        res = x.to(torch.bfloat16)
        x_q, x_s, h_s = B8.ln_fc1_rowmax_int8(x, lg, lb, fc1.q, fc1.s, b1, 1e-6)
        out = torch.empty((m, c), dtype=torch.bfloat16, device=dev)
        p = B8.int8_plan("mlp", c, n)
        args = [a.data_ptr() for a in (x_q, x_s, h_s, fc1.q, fc1.s, b1, fc2.q, fc2.s, b2, gamma,
                                       res, out)]
        want = B8.mlp_int8_scale_residual(x_q, x_s, h_s, fc1.q, fc1.s, b1, fc2.q, fc2.s, b2, gamma,
                                          res, torch.bfloat16)
        ms = {}
        for cut, which in CUTS.items():
            def run():
                _ok(_lib().mlp_cut(which, *args, m, c, n, p["col_tiles"], p["s1"], p["s2"],
                                   p["x_buffers"], int(p["resident"]), _stream(dev)), "mlp_cut")
            run()
            ms[cut] = device_ms(run, calls=5, replays=4)
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: the whole cut differs from mlp_int8_scale_residual")
        results[name] = ms
        print(f"[cuts] {name} (M {m}, C {c}, N {n}; plan {p}): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
        del x, x_q, x_s, h_s, out, want, res
        torch.cuda.empty_cache()
    return results


def widths(dev: torch.device, batch: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(3)
    results = {}
    for name, (grid, c, ratio) in SHAPES.items():
        m, n = batch * grid * grid, ratio * c
        x = torch.rand((m, c), generator=g, device=dev) * 2 - 1
        lg = torch.rand((c,), generator=g, device=dev) + 0.5
        lb = torch.rand((c,), generator=g, device=dev) * 0.2 - 0.1
        fc1, b1 = _weights(g, n, c, dev), torch.rand((n,), generator=g, device=dev) * 0.2 - 0.1
        want = B8.ln_fc1_rowmax_int8(x, lg, lb, fc1.q, fc1.s, b1, 1e-6)
        ms = {}
        for bn in (128, 96, 64):
            if n % bn:
                continue
            p = B8._ln_plan("rowmax", c, n, (bn,))
            outs = [torch.empty_like(t) for t in want]

            def run():
                err = B8._lib().ln_fc1_rowmax_int8(
                    x.data_ptr(), lg.data_ptr(), lb.data_ptr(), fc1.q.data_ptr(), fc1.s.data_ptr(),
                    b1.data_ptr(), *(o.data_ptr() for o in outs), m, c, n, 1e-6, bn, p["stages"],
                    p["a_buffers"], int(p["resident"]), _stream(dev))
                _ok(err, "ln_fc1_rowmax_int8")
            run()
            if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                raise AssertionError(f"{name}: items of {bn} columns differ from the plan's")
            ms[bn] = device_ms(run, calls=5, replays=4)
        results[name] = ms
        print(f"[widths] ln_fc1_rowmax_int8 {name} (M {m}, C {c}, N {n}, plan's "
              f"{B8.int8_plan('rowmax', c, n)['bn']}): "
              + ", ".join(f"{bn} columns {t:.3f} ms" for bn, t in ms.items()), flush=True)
        del x, want
        torch.cuda.empty_cache()
    return results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("exp_int8_mlp: no CUDA device is available; the measurements are CUDA kernels")
    dev = torch.device("cuda")
    print(f"device={torch.cuda.get_device_name(0)} [{card_line()}]", flush=True)
    results = {}
    for part in args.parts:
        results[part] = {"gelu": lambda: gelu(dev), "scan": lambda: scan(dev),
                         "cuts": lambda: cuts(dev, args.batch),
                         "widths": lambda: widths(dev, args.batch)}[part]()
    print(json.dumps(results, default=str))
    return results


if __name__ == "__main__":
    main()
