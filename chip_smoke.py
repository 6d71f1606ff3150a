#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``vip_cup_2022_tpu_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA GPU and nvcc; builds every kernel from ``csrc/`` first. Phases,
each printing its results on earlier lines, any failure exiting non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the ConvNeXt and the GCViT block kernels, one nvcc per
   source, both at once;
3. kernels: each of ``dwconv7x7_nhwc``, ``ln_fc1_gelu`` and
   ``fc2_scale_residual`` against its plain PyTorch version in f32 (TF32 off)
   on the same bf16-rounded inputs at the stage shapes s1-s4, with batch 8
   (ragged row tiles) and with the main path's batch 256, max|d| / max|ref|
   <= 1e-2 (bf16 rounding of the LN output and the hidden feeding sums over
   K = C ... 4C); then each timed against its plain version on the same
   batch-256 inputs (CUDA events);
4. gcvit kernels: each of ``ln_qkv`` (local q/k/v and global k/v),
   ``window_attention`` (local and global query), ``proj_scale_residual``,
   ``ln_fc1_gelu`` (eps 1e-5, N = 3C) and ``fc2_scale_residual`` (f32
   residual) against its plain version in f32 (TF32 off) on the same inputs
   at the GCViTTiny@224 level shapes L1-L4 (56/28/14/7 grids, C 64-512,
   windows 7/7/14/7), at batch 8 and 256, under the same 1e-2 bound; then
   each timed against its plain version at batch 256;
5. model: full-width convnext_tiny_in22k at 200 x 200 with seeded random
   weights and layer scale ~ U(0.5, 1.5), and full-width GCViTTiny at
   224 x 224 with seeded random weights, rel-pos tables ~ U(-1, 1) and LN
   scales ~ U(0.5, 1.5) (so attention and MLP branches matter against the
   residual): each member's kernel-path logits against its plain path's
   (f32 and bf16) at batch 8 and at batch 256, max|d| / max|ref| <= 5e-2
   (bf16 activations through 18 or 31 residual blocks), then one batch-256
   forward timed on each path; ``--profile`` adds a torch.profiler table of
   each member's forward;
6. slice: 300 random 200 x 200 JPEGs, an input CSV and a two-member manifest
   (``convnext_tiny_in22k-200x200``, ``GCViTTiny-224x224``) run through
   ``main_torch.main`` at batch 256 (one full batch and one zero-padded
   tail) with ``VIPTPU_ALLOW_RANDOM_INIT=1``; the CSV must hold 300 sorted
   rows with logits in {0.0, 1.0} and every kernel of both families must
   have been launched by that run.

The line before the last is the kernels' JSON record: ``launches`` from the
slice phase's first run, ``ms`` and ``plain_ms`` per batch-256 forward of both
members together (phases 3 and 4; ``ln_fc1_gelu`` and ``fc2_scale_residual``
serve both), ``max_abs_err`` over every check of phases 3 and 4. The last
line is ``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import main_torch  # noqa: E402
from vip_cup_2022_tpu_torch.models import create_model  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import build  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G  # noqa: E402

CONVNEXT_KERNELS = ("dwconv7x7_nhwc", "ln_fc1_gelu", "fc2_scale_residual")
GCVIT_KERNELS = ("ln_qkv", "window_attention", "proj_scale_residual")
KERNELS = CONVNEXT_KERNELS + GCVIT_KERNELS
SOURCES = {n: "vip_cup_2022_tpu_torch/csrc/convnext_block.cu" for n in CONVNEXT_KERNELS}
SOURCES.update({n: "vip_cup_2022_tpu_torch/csrc/gcvit_block.cu" for n in GCVIT_KERNELS})
TPU = "vip_cup_2022_tpu/ops/pallas/convnext_block.py"
GTPU = "vip_cup_2022_tpu/ops/pallas/gcvit_block.py"
REPLACES = {  # K1 fused_convnext_block, K2 fused_ln_mlp_residual_batchlane, K4 ln_dense,
    # K5 grouped_window_attention, K6 proj_res_ln_mlp, K7 mono_window_transformer_block
    "dwconv7x7_nhwc": f"{TPU}:602",
    "ln_fc1_gelu": f"{TPU}:602, {TPU}:443, {GTPU}:667, {GTPU}:906",
    "fc2_scale_residual": f"{TPU}:602, {TPU}:443, {GTPU}:667, {GTPU}:906",
    "ln_qkv": f"{GTPU}:247, {GTPU}:906",
    "window_attention": f"{GTPU}:542, {GTPU}:906",
    "proj_scale_residual": f"{GTPU}:667, {GTPU}:906",
}
STAGES = ((99, 99, 96, 3), (49, 49, 192, 3), (24, 24, 384, 9), (12, 12, 768, 3))  # H, W, C, blocks
# GCViTTiny@224 levels: grid, C, heads, window, local blocks, global-query blocks
LEVELS = ((56, 64, 2, 7, 2, 1), (28, 128, 4, 7, 2, 2), (14, 256, 8, 14, 10, 9),
          (7, 512, 16, 7, 3, 2))
KERNEL_BOUND = 1e-2
MODEL_BOUND = 5e-2
N_IMAGES = 300
BATCH = 256


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def abs_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return (a.float() - ref.float()).abs().max().item()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_blocks():
    """Route the model's blocks through the plain versions (the reference
    path on the card); the wrappers themselves never fall back."""
    mods = [(K, n) for n in CONVNEXT_KERNELS] + [(G, n) for n in GCVIT_KERNELS]
    saved = [(m, n, getattr(m, n)) for m, n in mods]
    for m, n in mods:
        setattr(m, n, getattr(m, n + "_plain"))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def block_inputs(b, h, w, c, gen):
    dev = "cuda"

    def u(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    return dict(
        x=u((b, h, w, c), -1, 1).to(torch.bfloat16),
        dw=u((7, 7, c), -0.2, 0.2), dwb=u((c,), -0.1, 0.1),
        lg=u((c,), 0.5, 1.5), lb=u((c,), -0.1, 0.1),
        w1=(u((4 * c, c), -1, 1) * c ** -0.5).to(torch.bfloat16), b1=u((4 * c,), -0.1, 0.1),
        w2=(u((c, 4 * c), -1, 1) * (4 * c) ** -0.5).to(torch.bfloat16),
        b2=u((c,), -0.1, 0.1), ls=u((c,), 0.5, 1.5),  # layer scale of order 1, not 1e-6
    )


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(smi.splitlines()[0])
    return smi.splitlines()[0]


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build.build_all(["convnext_block", "gcvit_block"], verbose=True)
    K._lib()
    G._lib()
    print(f"[build] {sorted(paths.values())} ready in {time.perf_counter() - t0:.1f} s")


def run_stage(b, h, w, c, gen) -> dict:
    """One stage's block inputs at batch ``b`` and the three kernels' outputs."""
    p = block_inputs(b, h, w, c, gen)
    m = b * h * w
    p["x2"] = p["x"].view(m, c)
    p["d"] = K.dwconv7x7_nhwc(p["x"], p["dw"], p["dwb"]).view(m, c)
    p["hid"] = K.ln_fc1_gelu(p["d"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6)
    p["out"] = K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["ls"], p["x2"])
    torch.cuda.synchronize()
    return p


def check(refs: dict, label: str, stats: dict) -> None:
    """Each kernel output in ``refs`` (name -> (output, reference maker))
    against its plain version in f32 on the same (bf16-rounded) inputs;
    references are made one at a time to bound memory."""
    for name, (got, make_ref) in refs.items():
        ref = make_ref()
        r = rel_err(got, ref)
        kernel = name.split(" ")[0]
        stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], abs_err(got, ref))
        del ref
        print(f"[kernels] {name:26s} {label} max|d|/max|ref| = {r:.3e} (bound {KERNEL_BOUND:g})")
        if not r <= KERNEL_BOUND:
            raise AssertionError(f"{name} at {label} disagrees with its plain version: "
                                 f"{r:.3e} > {KERNEL_BOUND:g}")


def check_stage(p: dict, shape: tuple, stats: dict) -> None:
    c = shape[-1]
    check({
        "dwconv7x7_nhwc": (p["d"], lambda: K.dwconv7x7_nhwc_plain(
            p["x"].float(), p["dw"], p["dwb"]).view(-1, c)),
        "ln_fc1_gelu": (p["hid"], lambda: K.ln_fc1_gelu_plain(
            p["d"], p["lg"], p["lb"], p["w1"].float(), p["b1"], 1e-6)),
        "fc2_scale_residual": (p["out"], lambda: K.fc2_scale_residual_plain(
            p["hid"].float(), p["w2"].float(), p["b2"], p["ls"], p["x2"].float())),
    }, str(shape), stats)


def time_pair(kern, plain) -> tuple:
    """Kernel and plain ms per launch, interleaved k, p, p, k."""
    ms = [cuda_ms(kern), cuda_ms(plain), cuda_ms(plain), cuda_ms(kern)]
    return (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2


def phase_kernels(card: str, stats: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, w, c, _ in STAGES:  # batch 8: ragged row tiles (B*H*W not a multiple of 64)
        check_stage(run_stage(8, h, w, c, gen), (8, h, w, c), stats)
    per_fwd = {n: [0.0, 0.0] for n in CONVNEXT_KERNELS}
    for h, w, c, nblocks in STAGES:  # the main path's batch-256 shapes: checked, then timed
        p = run_stage(BATCH, h, w, c, gen)
        check_stage(p, (BATCH, h, w, c), stats)
        calls = {
            "dwconv7x7_nhwc": (lambda: K.dwconv7x7_nhwc(p["x"], p["dw"], p["dwb"]),
                               lambda: K.dwconv7x7_nhwc_plain(p["x"], p["dw"], p["dwb"])),
            "ln_fc1_gelu": (
                lambda: K.ln_fc1_gelu(p["d"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6),
                lambda: K.ln_fc1_gelu_plain(p["d"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6)),
            "fc2_scale_residual": (
                lambda: K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["ls"], p["x2"]),
                lambda: K.fc2_scale_residual_plain(p["hid"], p["w2"], p["b2"], p["ls"], p["x2"])),
        }
        for name, (kern, plain) in calls.items():
            k_ms, p_ms = time_pair(kern, plain)
            per_fwd[name][0] += nblocks * k_ms
            per_fwd[name][1] += nblocks * p_ms
            print(f"[kernels] {name:26s} ({BATCH},{h},{w},{c}) kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms per launch [{card}]")
        del p, calls
        torch.cuda.empty_cache()
    for name, (k_ms, p_ms) in per_fwd.items():
        stats[name]["ms"] += k_ms
        stats[name]["plain_ms"] += p_ms
        print(f"[kernels] {name:26s} per convnext_tiny batch-256 forward (3/3/9/3 blocks): "
              f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms [{card}]")


def gcvit_level_inputs(b, grid, c, heads, ws, gen) -> dict:
    """One GCViT level's block inputs at batch ``b``, window-ordered tokens."""
    dev, bf = "cuda", torch.bfloat16
    n = ws * ws

    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    m = b * grid * grid
    return dict(
        n=n, m=m, x=u((m, c)).to(bf), qg=u((b, n, c)).to(bf),
        lg=u((c,), 0.5, 1.5), lb=u((c,), -0.1, 0.1),
        wqkv=(u((3 * c, c)) * c ** -0.5).to(bf), bqkv=u((3 * c,), -0.1, 0.1),
        bias=u((heads, n, n)), wp=(u((c, c)) * c ** -0.5).to(bf), bp=u((c,), -0.1, 0.1),
        g1=u((c,), 0.5, 1.5), lg2=u((c,), 0.5, 1.5), lb2=u((c,), -0.1, 0.1),
        w1=(u((3 * c, c)) * c ** -0.5).to(bf), b1=u((3 * c,), -0.1, 0.1),
        w2=(u((c, 3 * c)) * (3 * c) ** -0.5).to(bf), b2=u((c,), -0.1, 0.1),
        g2=u((c,), 0.5, 1.5), scale=32 ** -0.5,
    )


def gcvit_calls(p: dict, b: int, c: int) -> dict:
    """name -> (kernel call, plain call) for every GCViT launch of one level,
    both block kinds; the plain versions run on the same bf16 inputs."""
    n, m = p["n"], p["m"]
    wkv, bkv = p["wqkv"][c:], p["bqkv"][c:]
    t = lambda a: a.view(b, -1, c)  # noqa: E731
    q, k, v = p["qkv"]
    return {
        "ln_qkv local": (lambda: G.ln_qkv(p["x"], p["lg"], p["lb"], p["wqkv"], p["bqkv"], 1e-5),
                         lambda: G.ln_qkv_plain(p["x"], p["lg"], p["lb"], p["wqkv"], p["bqkv"],
                                                1e-5)),
        "ln_qkv global": (lambda: G.ln_qkv(p["x"], p["lg"], p["lb"], wkv, bkv, 1e-5),
                          lambda: G.ln_qkv_plain(p["x"], p["lg"], p["lb"], wkv, bkv, 1e-5)),
        "window_attention local": (
            lambda: G.window_attention(t(q), t(k), t(v), p["bias"], n, p["scale"]),
            lambda: G.window_attention_plain(t(q), t(k), t(v), p["bias"], n, p["scale"])),
        "window_attention global": (
            lambda: G.window_attention(p["qg"], t(k), t(v), p["bias"], n, p["scale"], True),
            lambda: G.window_attention_plain(p["qg"], t(k), t(v), p["bias"], n, p["scale"], True)),
        "proj_scale_residual": (
            lambda: G.proj_scale_residual(p["attn"], p["wp"], p["bp"], p["g1"], p["x"]),
            lambda: G.proj_scale_residual_plain(p["attn"], p["wp"], p["bp"], p["g1"], p["x"])),
        "ln_fc1_gelu": (
            lambda: K.ln_fc1_gelu(p["r1"], p["lg2"], p["lb2"], p["w1"], p["b1"], 1e-5),
            lambda: K.ln_fc1_gelu_plain(p["r1"], p["lg2"], p["lb2"], p["w1"], p["b1"], 1e-5)),
        "fc2_scale_residual": (
            lambda: K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"]),
            lambda: K.fc2_scale_residual_plain(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"])),
    }


def run_check_level(b, level, gen, stats) -> tuple:
    """Run every GCViT launch of one level at batch ``b`` and check each
    against its plain version in f32; returns the inputs and the calls."""
    grid, c, heads, ws, _, _ = level
    p = gcvit_level_inputs(b, grid, c, heads, ws, gen)
    n = p["n"]
    p["qkv"] = G.ln_qkv(p["x"], p["lg"], p["lb"], p["wqkv"], p["bqkv"], 1e-5)
    kv = G.ln_qkv(p["x"], p["lg"], p["lb"], p["wqkv"][c:], p["bqkv"][c:], 1e-5)
    t = lambda a: a.view(b, -1, c)  # noqa: E731
    q, k, v = p["qkv"]
    attn_l = G.window_attention(t(q), t(k), t(v), p["bias"], n, p["scale"])
    attn_g = G.window_attention(p["qg"], t(k), t(v), p["bias"], n, p["scale"], True)
    p["attn"] = attn_l.view(-1, c)
    p["r1"] = G.proj_scale_residual(p["attn"], p["wp"], p["bp"], p["g1"], p["x"])
    p["hid"] = K.ln_fc1_gelu(p["r1"], p["lg2"], p["lb2"], p["w1"], p["b1"], 1e-5)
    out = K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"])
    torch.cuda.synchronize()
    f = lambda a: a.float()  # noqa: E731
    check({
        "ln_qkv local": (torch.cat(p["qkv"], 1), lambda: torch.cat(G.ln_qkv_plain(
            p["x"], p["lg"], p["lb"], f(p["wqkv"]), p["bqkv"], 1e-5), 1)),
        "ln_qkv global": (torch.cat(kv, 1), lambda: torch.cat(G.ln_qkv_plain(
            p["x"], p["lg"], p["lb"], f(p["wqkv"][c:]), p["bqkv"][c:], 1e-5), 1)),
        "window_attention local": (attn_l, lambda: G.window_attention_plain(
            f(t(q)), f(t(k)), f(t(v)), p["bias"], n, p["scale"])),
        "window_attention global": (attn_g, lambda: G.window_attention_plain(
            f(p["qg"]), f(t(k)), f(t(v)), p["bias"], n, p["scale"], True)),
        "proj_scale_residual": (p["r1"], lambda: G.proj_scale_residual_plain(
            f(p["attn"]), f(p["wp"]), p["bp"], p["g1"], f(p["x"]))),
        "ln_fc1_gelu": (p["hid"], lambda: K.ln_fc1_gelu_plain(
            p["r1"], p["lg2"], p["lb2"], f(p["w1"]), p["b1"], 1e-5)),
        "fc2_scale_residual": (out, lambda: K.fc2_scale_residual_plain(
            f(p["hid"]), f(p["w2"]), p["b2"], p["g2"], p["r1"])),
    }, f"L b{b} {grid}x{grid}x{c} w{ws}", stats)
    return p


def phase_gcvit_kernels(card: str, stats: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    for level in LEVELS:  # batch 8: ragged row tiles
        run_check_level(8, level, gen, stats)
        torch.cuda.empty_cache()
    per_fwd = {n: [0.0, 0.0] for n in ("ln_qkv", "window_attention", "proj_scale_residual",
                                       "ln_fc1_gelu", "fc2_scale_residual")}
    for level in LEVELS:  # the main path's batch-256 shapes: checked, then timed
        grid, c, heads, ws, n_local, n_global = level
        p = run_check_level(BATCH, level, gen, stats)
        for name, (kern, plain) in gcvit_calls(p, BATCH, c).items():
            k_ms, p_ms = time_pair(kern, plain)
            count = (n_local if name.endswith("local") else n_global if name.endswith("global")
                     else n_local + n_global)
            per_fwd[name.split(" ")[0]][0] += count * k_ms
            per_fwd[name.split(" ")[0]][1] += count * p_ms
            print(f"[kernels] {name:26s} ({BATCH},{grid},{grid},{c}) w{ws} kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.3f} ms per launch [{card}]")
        del p
        torch.cuda.empty_cache()
    for name, (k_ms, p_ms) in per_fwd.items():
        stats[name]["ms"] += k_ms
        stats[name]["plain_ms"] += p_ms
        print(f"[kernels] {name:26s} per GCViTTiny batch-256 forward (3/4/19/5 blocks): "
              f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms [{card}]")


MEMBERS = {  # name: (input size, output width)
    "convnext_tiny_in22k": ((200, 200), 21841),
    "GCViTTiny": ((224, 224), 1000),
}


def _model(name: str, dtype: torch.dtype) -> torch.nn.Module:
    """Full-width member with seeded random weights; ConvNeXt's layer scale
    ~ U(0.5, 1.5), GCViT's rel-pos tables ~ U(-1, 1) and LN scales
    ~ U(0.5, 1.5), so the blocks' branches matter against the residual."""
    size, _ = MEMBERS[name]
    model, _ = create_model(name, input_size=size, classifier_activation=None, dtype=dtype, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith((".gamma", "norm1.weight", "norm2.weight")):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
            elif pname.endswith("relative_position_bias_table"):
                p.copy_(torch.rand(p.shape, generator=gen) * 2 - 1)
    if name == "GCViTTiny":
        model.gather_bias()
    return model.cuda()


def compare_logits(name, kernel_model, ref_model, x: torch.Tensor) -> None:
    """The kernel path's logits against the plain f32 and plain bf16 paths."""
    with torch.inference_mode():
        logits = kernel_model(x)
        with plain_blocks():
            ref = ref_model(x)
            plain_bf16 = kernel_model(x)
        torch.cuda.synchronize()
    b, width = x.shape[0], MEMBERS[name][1]
    if logits.shape != (b, width) or not torch.isfinite(logits).all():
        raise AssertionError(f"{name} output {tuple(logits.shape)} not finite ({b}, {width})")
    for label, other in (("plain f32", ref), ("plain bf16", plain_bf16)):
        r = rel_err(logits, other)
        print(f"[model] {name} {x.shape[1]}x{x.shape[2]} b{b} kernel path vs {label} path: "
              f"max|d|/max|ref| = {r:.3e} (bound {MODEL_BOUND:g}), max|ref| = "
              f"{other.float().abs().max().item():.3e}")
        if not r <= MODEL_BOUND:
            raise AssertionError(f"{name} b{b} logits disagree with the {label} path: {r:.3e}")


def phase_model(name: str, card: str, profile: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, w = MEMBERS[name][0]
    x8 = torch.rand((8, h, w, 3), generator=gen, device="cuda")
    xb = torch.rand((BATCH, h, w, 3), generator=gen, device="cuda")
    kernel_model, ref_model = _model(name, torch.bfloat16), _model(name, torch.float32)
    compare_logits(name, kernel_model, ref_model, x8)
    compare_logits(name, kernel_model, ref_model, xb)  # the main path's batch
    del ref_model
    torch.cuda.empty_cache()
    with torch.inference_mode():
        fwd = lambda: kernel_model(xb)  # noqa: E731
        k1 = cuda_ms(fwd, iters=3, warmup=1)
        with plain_blocks():
            p1 = cuda_ms(fwd, iters=3, warmup=1)
            p2 = cuda_ms(fwd, iters=3, warmup=1)
        k2 = cuda_ms(fwd, iters=3, warmup=1)
        print(f"[model] {name} batch-{BATCH} forward: kernel path {(k1 + k2) / 2:.2f} ms "
              f"({BATCH * 2000 / (k1 + k2):.1f} img/s), plain bf16 path {(p1 + p2) / 2:.2f} ms "
              f"({BATCH * 2000 / (p1 + p2):.1f} img/s) [{card}]")
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fwd()
                torch.cuda.synchronize()
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    del kernel_model
    torch.cuda.empty_cache()


def _write_images(img_dir: str, n: int) -> list:
    rng = np.random.RandomState(0)
    names = []
    try:
        import cv2

        def save(path, arr):
            if not cv2.imwrite(path, arr[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 92]):
                raise RuntimeError(f"cv2 could not write {path}")
    except ImportError:
        from PIL import Image

        def save(path, arr):
            Image.fromarray(arr).save(path, quality=92)
    for i in range(n):
        names.append(f"img_{i:04d}.jpg")
        save(os.path.join(img_dir, names[-1]), rng.randint(0, 256, (200, 200, 3), dtype=np.uint8))
    return names


def phase_slice(card: str) -> dict:
    with tempfile.TemporaryDirectory() as ws:
        img_dir = os.path.join(ws, "images")
        os.makedirs(img_dir)
        names = _write_images(img_dir, N_IMAGES)
        input_csv = os.path.join(img_dir, "input.csv")
        with open(input_csv, "w") as fh:
            fh.write("filename\n" + "".join(f"{n}\n" for n in reversed(names)))
        os.makedirs(os.path.join(ws, "ckpts"))
        with open(os.path.join(ws, "ckpts", "ckpts.json"), "w") as fh:
            json.dump([["convnext_tiny_in22k-200x200", [200, 200], 0],
                       ["GCViTTiny-224x224", [224, 224], 0]], fh)
        print(f"[slice] {N_IMAGES} JPEGs written; decode runs through the port's host pool")
        os.environ.update(VIPTPU_CKPT_DIR=os.path.join(ws, "ckpts"), VIPTPU_ALLOW_RANDOM_INIT="1",
                          VIPTPU_MAX_BATCH=str(BATCH), VIPTPU_VERBOSE="1")
        output_csv = os.path.join(ws, "output.csv")

        K.reset_launches()
        G.reset_launches()
        t0 = time.perf_counter()
        main_torch.main(["main_torch.py", input_csv, output_csv])
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {**K.LAUNCHES, **G.LAUNCHES}

        os.environ["VIPTPU_E2E_BATCH_TIMES"] = os.path.join(ws, "batch_times.json")
        t0 = time.perf_counter()
        main_torch.main(["main_torch.py", input_csv, output_csv])
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        del os.environ["VIPTPU_E2E_BATCH_TIMES"]
        with open(os.path.join(ws, "batch_times.json")) as fh:
            batch_s = json.load(fh)["batch_e2e_s"]

        with open(output_csv) as fh:
            lines = fh.read().splitlines()
    if lines[0] != "filename,logit" or len(lines) != N_IMAGES + 1:
        raise AssertionError(f"CSV has {len(lines) - 1} rows / header {lines[0]!r}")
    rows = [ln.split(",") for ln in lines[1:]]
    if [r[0] for r in rows] != sorted(names) or not {r[1] for r in rows} <= {"0.0", "1.0"}:
        raise AssertionError("CSV rows are not the sorted filenames with logits in {0.0, 1.0}")
    print(f"[slice] CSV: {len(rows)} sorted rows, logits {sorted({r[1] for r in rows})}")
    print(f"[slice] launches in the CSV->CSV run: {launches}")
    missing = [n for n in KERNELS if launches[n] <= 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing}")
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, 2 members: cold {cold:.2f} s "
          f"({N_IMAGES / cold:.1f} img/s), warm {warm:.2f} s ({N_IMAGES / warm:.1f} img/s); "
          f"warm per-batch e2e {', '.join(f'{s * 1000:.1f} ms' for s in batch_s)} [{card}]")
    return launches


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    card = phase_device()
    phase_build()
    stats = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for n in KERNELS}
    phase_kernels(card, stats)
    phase_gcvit_kernels(card, stats)
    for name in MEMBERS:
        phase_model(name, card, profile="--profile" in argv)
    launches = phase_slice(card)
    record = [{"name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
               "launches": launches[n], "max_abs_err": stats[n]["max_abs_err"],
               "ms": stats[n]["ms"], "plain_ms": stats[n]["plain_ms"]} for n in KERNELS]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
