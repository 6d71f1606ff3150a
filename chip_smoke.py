#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``vip_cup_2022_tpu_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA GPU and nvcc; builds every kernel from ``csrc/`` first. Phases,
each printing its results on earlier lines, any failure exiting non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the ConvNeXt block kernels;
3. kernels: each of ``dwconv7x7_nhwc``, ``ln_fc1_gelu`` and
   ``fc2_scale_residual`` against its plain PyTorch version in f32 (TF32 off)
   on the same bf16-rounded inputs at the stage shapes s1-s4, with batch 8
   (ragged row tiles) and with the main path's batch 256, max|d| / max|ref|
   <= 1e-2 (bf16 rounding of the LN output and the hidden feeding sums over
   K = C ... 4C); then each timed against its plain version on the same
   batch-256 inputs (CUDA events);
4. model: full-width convnext_tiny_in22k at 200 x 200 with seeded random
   weights and layer scale ~ U(0.5, 1.5): the kernel path's logits against
   the plain path's (f32 and bf16) at batch 8 and at batch 256,
   max|d| / max|ref| <= 5e-2 (bf16 activations through 18 residual blocks),
   then one batch-256 forward timed on each path; ``--profile`` adds a
   torch.profiler table of that forward;
5. slice: 300 random 200 x 200 JPEGs, an input CSV and a one-member manifest
   run through ``main_torch.main`` at batch 256 (one full batch and one
   zero-padded tail) with ``VIPTPU_ALLOW_RANDOM_INIT=1``; the CSV must hold 300
   sorted rows with logits in {0.0, 1.0} and every kernel must have been
   launched by that run.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
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

KERNELS = ("dwconv7x7_nhwc", "ln_fc1_gelu", "fc2_scale_residual")
SOURCE = "vip_cup_2022_tpu_torch/csrc/convnext_block.cu"
TPU = "vip_cup_2022_tpu/ops/pallas/convnext_block.py"
REPLACES = {  # K1 fused_convnext_block's body; K2 fused_ln_mlp_residual_batchlane's
    "dwconv7x7_nhwc": f"{TPU}:212",
    "ln_fc1_gelu": f"{TPU}:212, {TPU}:368",
    "fc2_scale_residual": f"{TPU}:212, {TPU}:368",
}
STAGES = ((99, 99, 96, 3), (49, 49, 192, 3), (24, 24, 384, 9), (12, 12, 768, 3))  # H, W, C, blocks
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
    saved = {n: getattr(K, n) for n in KERNELS}
    for n in KERNELS:
        setattr(K, n, getattr(K, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(K, n, fn)


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
    path = build.build("convnext_block", verbose=True)
    K._lib()
    print(f"[build] {path} ready in {time.perf_counter() - t0:.1f} s")


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


def check_stage(p: dict, shape: tuple, stats: dict) -> None:
    """Each kernel's output against its plain version in f32 on the same
    (bf16-rounded) inputs; references are made one at a time to bound memory."""
    c = shape[-1]
    refs = {
        "dwconv7x7_nhwc": (p["d"], lambda: K.dwconv7x7_nhwc_plain(
            p["x"].float(), p["dw"], p["dwb"]).view(-1, c)),
        "ln_fc1_gelu": (p["hid"], lambda: K.ln_fc1_gelu_plain(
            p["d"], p["lg"], p["lb"], p["w1"].float(), p["b1"], 1e-6)),
        "fc2_scale_residual": (p["out"], lambda: K.fc2_scale_residual_plain(
            p["hid"].float(), p["w2"].float(), p["b2"], p["ls"], p["x2"].float())),
    }
    for name, (got, make_ref) in refs.items():
        ref = make_ref()
        r = rel_err(got, ref)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], abs_err(got, ref))
        del ref
        print(f"[kernels] {name:19s} {shape} max|d|/max|ref| = {r:.3e} (bound {KERNEL_BOUND:g})")
        if not r <= KERNEL_BOUND:
            raise AssertionError(f"{name} at {shape} disagrees with its plain version: "
                                 f"{r:.3e} > {KERNEL_BOUND:g}")


def phase_kernels(card: str) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for n in KERNELS}
    for h, w, c, _ in STAGES:  # batch 8: ragged row tiles (B*H*W not a multiple of 64)
        check_stage(run_stage(8, h, w, c, gen), (8, h, w, c), stats)
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
            ms = [cuda_ms(kern), cuda_ms(plain), cuda_ms(plain), cuda_ms(kern)]  # k, p, p, k
            k_ms, p_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
            stats[name]["ms"] += nblocks * k_ms
            stats[name]["plain_ms"] += nblocks * p_ms
            print(f"[kernels] {name:19s} ({BATCH},{h},{w},{c}) kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms per launch [{card}]")
        del p, calls
        torch.cuda.empty_cache()
    for name, s in stats.items():
        print(f"[kernels] {name:19s} per batch-256 forward (3/3/9/3 blocks): kernel "
              f"{s['ms']:.2f} ms, plain {s['plain_ms']:.2f} ms [{card}]")
    return stats


def _model(dtype: torch.dtype) -> torch.nn.Module:
    model, _ = create_model("convnext_tiny_in22k", input_size=(200, 200),
                            classifier_activation=None, dtype=dtype, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):  # layer scale of order 1
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
    return model.cuda()


def compare_logits(kernel_model, ref_model, x: torch.Tensor) -> None:
    """The kernel path's logits against the plain f32 and plain bf16 paths."""
    with torch.inference_mode():
        logits = kernel_model(x)
        with plain_blocks():
            ref = ref_model(x)
            plain_bf16 = kernel_model(x)
        torch.cuda.synchronize()
    b = x.shape[0]
    if logits.shape != (b, 21841) or not torch.isfinite(logits).all():
        raise AssertionError(f"model output {tuple(logits.shape)} not finite ({b}, 21841)")
    for label, other in (("plain f32", ref), ("plain bf16", plain_bf16)):
        r = rel_err(logits, other)
        print(f"[model] convnext_tiny_in22k 200x200 b{b} kernel path vs {label} path: "
              f"max|d|/max|ref| = {r:.3e} (bound {MODEL_BOUND:g}), max|ref| = "
              f"{other.float().abs().max().item():.3e}")
        if not r <= MODEL_BOUND:
            raise AssertionError(f"b{b} logits disagree with the {label} path: {r:.3e}")


def phase_model(card: str, profile: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    x8 = torch.rand((8, 200, 200, 3), generator=gen, device="cuda")
    xb = torch.rand((BATCH, 200, 200, 3), generator=gen, device="cuda")
    kernel_model, ref_model = _model(torch.bfloat16), _model(torch.float32)
    compare_logits(kernel_model, ref_model, x8)
    compare_logits(kernel_model, ref_model, xb)  # the main path's batch
    del ref_model
    torch.cuda.empty_cache()
    with torch.inference_mode():
        fwd = lambda: kernel_model(xb)  # noqa: E731
        k1 = cuda_ms(fwd, iters=3, warmup=1)
        with plain_blocks():
            p1 = cuda_ms(fwd, iters=3, warmup=1)
            p2 = cuda_ms(fwd, iters=3, warmup=1)
        k2 = cuda_ms(fwd, iters=3, warmup=1)
        print(f"[model] batch-{BATCH} forward: kernel path {(k1 + k2) / 2:.2f} ms "
              f"({BATCH * 2000 / (k1 + k2):.1f} img/s), plain bf16 path {(p1 + p2) / 2:.2f} ms "
              f"({BATCH * 2000 / (p1 + p2):.1f} img/s) [{card}]")
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fwd()
                torch.cuda.synchronize()
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


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
            json.dump([["convnext_tiny_in22k-200x200", [200, 200], 0]], fh)
        print(f"[slice] {N_IMAGES} JPEGs written; decode runs through the port's host pool")
        os.environ.update(VIPTPU_CKPT_DIR=os.path.join(ws, "ckpts"), VIPTPU_ALLOW_RANDOM_INIT="1",
                          VIPTPU_MAX_BATCH=str(BATCH), VIPTPU_VERBOSE="1")
        output_csv = os.path.join(ws, "output.csv")

        K.reset_launches()
        t0 = time.perf_counter()
        main_torch.main(["main_torch.py", input_csv, output_csv])
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)

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
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}: cold {cold:.2f} s "
          f"({N_IMAGES / cold:.1f} img/s), warm {warm:.2f} s ({N_IMAGES / warm:.1f} img/s); "
          f"warm per-batch e2e {', '.join(f'{s * 1000:.1f} ms' for s in batch_s)} [{card}]")
    return launches


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    card = phase_device()
    phase_build()
    stats = phase_kernels(card)
    phase_model(card, profile="--profile" in argv)
    launches = phase_slice(card)
    record = [{"name": n, "route": "cuda", "source": SOURCE, "replaces": REPLACES[n],
               "launches": launches[n], "max_abs_err": stats[n]["max_abs_err"],
               "ms": stats[n]["ms"], "plain_ms": stats[n]["plain_ms"]} for n in KERNELS]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
