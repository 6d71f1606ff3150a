#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``vip_cup_2022_tpu_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA GPU and nvcc; builds every kernel from ``csrc/`` first. Phases,
each printing its results on earlier lines, any failure exiting non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every source of ``csrc/`` (the ConvNeXt and GCViT block
   kernels, window attention, LayerNorm, depthwise, the LN-MLP, the
   attention-parts and the int8 GEMM kernels, and the phase cuts of the
   wgmma + TMA engine's kernels, of the depthwise kernel and of the LN-MLP
   kernel), one nvcc per source, all at once, with ``-Xptxas -v``;
3. kernels: each of ``dwconv7x7_nhwc``, ``ln_fc1_gelu`` and
   ``fc2_scale_residual`` against its plain PyTorch version in f32 (TF32 off)
   on the same bf16-rounded inputs at the stage shapes s1-s4, with batch 8
   (ragged row tiles) and with the main path's batch 256, max|d| / max|ref|
   <= 1e-2 (bf16 rounding of the LN output and the hidden feeding sums over
   K = C ... 4C), the depthwise (f32 out) <= 1e-5; then each timed against its plain version and, where one
   PyTorch call computes the same function, that call, on the same batch-256
   inputs (CUDA events), with the kernel/library ratio per shape and per
   forward; ``ln_fc1_gelu`` and ``fc2_scale_residual`` also beside cuBLAS's
   product of the same bf16 operands alone (``F.linear``, TF32 off; not a
   ``library_ms``: it computes only the GEMM), with the kernel/cuBLAS ratio;
   then the ``exp_dwconv`` tool's phase cuts of ``dwconv7x7_nhwc`` (loads /
   + FMAs / whole, and the FMAs without their shared-memory reads) beside
   cuDNN at s1-s4;
4. gcvit kernels: each of ``ln_qkv`` (local q/k/v and global k/v),
   ``window_attention`` (local and global query), ``proj_scale_residual``,
   ``ln_fc1_gelu`` (eps 1e-5, N = 3C) and ``fc2_scale_residual`` (f32
   residual) against its plain version in f32 (TF32 off) on the same inputs
   at the GCViTTiny@224 level shapes L1-L4 (56/28/14/7 grids, C 64-512,
   windows 7/7/14/7), at batch 8 and 256, under the same 1e-2 bound; then
   each timed as in 3 at batch 256, ``ln_qkv`` and ``proj_scale_residual``
   also beside cuBLAS's product alone; then the ``exp_mlp_gemm`` tool's
   phase cuts of the kernels on the wgmma + TMA engine (loads / + LN / +
   products / whole, and the epilogue without its math or without its
   stores) at s1-s4 and L1-L4, ``ln_qkv``'s and ``proj_scale_residual``'s
   at L1-L4;
5. unfused-path kernels, under the same bound at batch 8 and 256, timed as
   in 3 at batch 256:
   - ``window_attention_bhnd`` on (B*nWin, heads, N, 32) at L1-L4, local and
     global (repeated) query; the library call is
     ``F.scaled_dot_product_attention`` with the bias as a float mask; then
     the ``exp_window_attention`` tool's phase cuts of the kernel at L1-L4;
   - ``layer_norm`` at every LN shape both members call on the unfused path
     (recorded from one forward of each); the library call is
     ``F.layer_norm`` on the f32 copy, with the casts;
   - ``depthwise_conv_nhwc`` at the six ``exp_dw`` shapes and at ragged
     cases (C = 336, 24 and 8, k = 3, 5 and 7, asymmetric paddings), then
     the ``exp_dw`` tool itself, which times the kernel and cuDNN's
     depthwise conv by device time and its plain version by events;
   - the tool kernels: ``fused_ln_mlp_residual``, ``lnmlp_batchlane`` and
     ``lnmlp_chanfirst`` (one LN-MLP kernel in three layouts) at the
     ``exp_convnext_s12`` shapes s1-s4 (no library call computes LN -> MLP
     -> residual), timed by device time beside the engine's two-launch
     ``ln_fc1_gelu`` + ``fc2_scale_residual`` pair and cuBLAS's two
     products alone, then the ``exp_lnmlp_dw`` tool's phase cuts of the
     rows-layout kernel; and ``attn_parts``'s six variants at the
     ``exp_attn_parts`` shapes l1 and l2 (its ``full`` variant timed by
     device time, a CUDA graph of its launches replayed, beside SDPA with
     the group bias as a float mask, timed the same way); then both tools
     end to end (``exp_convnext_s12`` at s1-s4 and ``exp_attn_parts`` at l1
     and l2 with the streamed-key mode's phase cuts, ``--iters 10``), which
     must launch each of the four;
   - K13's three spike bodies (``int8_spike_bf16``, ``int8_spike_int8``,
     ``int8_spike_direct``) at the spike's three shapes, w packed by the
     wrapper and beforehand, direct and int8 exactly, bf16 within 1e-2; then
     the port's ``int8_pallas_spike`` tool in ``equiv`` and ``gemm`` modes
     (which times each body by device time beside cuBLAS bf16 and
     ``torch._int_mm`` on a column-major w, with w packed once outside the
     timing), which must launch all three;
6. model: full-width convnext_tiny_in22k at 200 x 200 with seeded random
   weights and layer scale ~ U(0.5, 1.5), and full-width GCViTTiny at
   224 x 224, on its fused and on its unfused block path, with seeded random
   weights, rel-pos tables ~ U(-1, 1) and LN scales ~ U(0.5, 1.5) (so
   attention and MLP branches matter against the residual): each member's
   kernel-path logits against its plain path's (f32 and bf16) at batch 8 and
   at batch 256, max|d| / max|ref| <= 5e-2 (bf16 activations through 18 or
   31 residual blocks), then one batch-256 forward timed on each path;
   ``--profile`` adds a torch.profiler table of each member's forward;
   GCViT's fused forward also timed with its 11 stride-1 depthwise convs on
   cuDNN instead of K9 (the path before K9 ran them);
   then full-width EfficientNetV2T at 200 x 200 and EfficientNetV1B4 at
   224 x 224 (the registry's 1000-class head) with seeded weights, each
   BN's statistics measured on its input and the last BN of each residual
   branch damped to U(0.1, 0.3): the kernel path (bf16, K9 at the 27 / 28
   stride-1 depthwise sites, cuDNN convs, plain BN) against the plain f32
   path within 5e-2 of max|ref| at batch 8 and 256, the batch-256 forward
   timed with K9 and with cuDNN at those sites, the plain BNs timed alone
   (their share of the forward), ``--profile`` tables; then K9 at every
   stride-1 depthwise site of GCViT's and both EfficientNets' forwards,
   batch 8 and 256, within 1e-2 of its plain version, timed at 256 by
   device time beside cuDNN's grouped conv of the same input and taps;
   then full-width ECA_NFNetL0 at 200 x 200 (the registry's 1000-class
   head) with seeded weights, gains ~ U(0.5, 1.5) and biases ~ U(-0.1,
   0.1): its bf16 path (cuDNN convs, the grouped 3 x 3s as grouped convs, no
   kernel) against the plain f32 path within 5e-2 of max|ref| at batch 8 and
   256, the batch-256 forward timed, ``--profile`` table;
   then full-width ResNetRS50 and ResNest50 at 200 x 200 (the registry's
   1000-class head) with seeded weights and each BN's statistics measured
   on its input, so activations stay O(1): ResNetRS50 on two draws, with
   the last BN of each residual branch damped to U(0.1, 0.3) and without,
   ResNest50 on the damped one (its closing ``3_bn``, zero at init). On
   each: its int8 path (calibrated on 64 images; 52 and 68 sites, the JAX
   pass's counts) against the same quantized model with the plain int8
   version within 5e-2 of max|ref| at batch 8 and 256; its bf16 path
   (cuDNN convs, no kernel) against the plain f32 path, held to 5e-2 on
   the damped draw and reported on the undamped one; int8 against bf16
   with the decision flips at 0.487 reported. The damped draw's batch-256
   bf16 and int8 forwards are timed, its plain BNs alone; at every site
   shape that forward recorded, batch 8 and 256, the site's
   launches, ``ptq_int8_quantize`` (exactly its plain version) and the GEMM
   ``ptq_int8_conv`` (``int8_gemm.ptq_int8_gemm``, on x itself at the rows
   sites that quantize in the GEMM; within 1e-6 of max|ref| of its plain
   version, and the whole site too), timed at 256
   beside cuDNN's bf16 conv of the site (and, at a 1 x 1 site,
   ``torch._int_mm`` on its pre-quantized rows); then the ``exp_ptq_int8``
   tool's phase cuts of the site (loads / + quantize / + products / whole)
   at one 1 x 1 and one 3 x 3 site of each ResNetRS50 stage;
7. slice: 300 random 200 x 200 JPEGs, an input CSV and a two-member manifest
   (``convnext_tiny_in22k-200x200``, ``GCViTTiny-224x224``) run through
   ``main_torch.main`` at batch 256 (one full batch and one zero-padded
   tail) with ``VIPTPU_ALLOW_RANDOM_INIT=1``, twice on the fused block path
   and once with ``VIPTPU_NO_FUSED_BLOCK=1``; each CSV must hold 300 sorted
   rows with logits in {0.0, 1.0}; the first fused run must have launched
   every kernel of both block families, ``ln_fc1_gelu`` and
   ``fc2_scale_residual`` at each of ConvNeXt's 18 and GCViT's 31 blocks,
   ``dwconv7x7_nhwc`` at each ConvNeXt block, ``ln_qkv`` and
   ``proj_scale_residual`` at each GCViT block, and the LN kernel at each
   standalone LN, the unfused run (both members on their unfused blocks)
   the window-attention kernel at each of GCViT's 31 blocks, the depthwise
   kernel at each of ConvNeXt's 18 blocks and GCViT's 11 stride-1 sites and
   the LN kernel at every LN, per batch, and no fused block kernel; then a
   three-member manifest (adding
   ``ResNetRS50-200x200``) without int8, which launches no int8 kernel, and
   with ``VIPTPU_INT8=ResNetRS50``, which must launch ``ptq_int8_conv`` at
   every calibrated site of each batch and ``ptq_int8_quantize`` at those
   that do not quantize in the GEMM; then the product contract, the seven
   members of ``ckpts/ckpts.json`` in its order (ConvNeXt, ResNest50, GCViT,
   EfficientNetV2T, EfficientNetV1B4, ECA_NFNetL0, ResNetRS50), cold and
   warm, which must launch every fused block kernel at each block, the LN
   kernel at each standalone LN and ``depthwise_conv_nhwc`` at each
   stride-1 depthwise site (GCViT's 11, 27 and 28) of each batch, and no
   int8 kernel; and once more with ``VIPTPU_INT8=ResNetRS50,ResNest50``
   (the JAX package's ``INT8_AUTO`` set), which must launch the same and
   ``ptq_int8_conv`` at the 52 + 68 sites of each batch and
   ``ptq_int8_quantize`` at those of them that run the pass;
8. serving: the seven members again, each with a one-output sigmoid head
   (the product checkpoints' head; the registry's softmax heads hold
   ``1 - p[:, 0]`` near 1 whatever the features): the plain fused run;
   ``VIPTPU_TTA=2`` in map mode, which must launch every fused-block
   kernel, the LN kernel and K9 twice as often as the plain run; then the
   ConvNeXt stage-1 block's three kernels, a GCViT level-1 block's five,
   K9 at the largest stride-1 site and the LN at batch 512 against their
   plain versions under their usual bounds; ``VIPTPU_TTA_MODE=fold``, the
   plain run's launches with every block kernel's, K9's and the LN's
   leading dimension twice map mode's (batch 512), its raw means within
   1e-2 of map mode's; ``VIPTPU_FUSED=0``, each member at batch 128, the
   plain run's launches per member's batch (three), within 1e-2 of the
   plain run; ``VIPTPU_FUSE_BN=all``, each member's folded conv -> BN
   pairs JAX's count (``FUSE_BN_PAIRS``), within 1e-2 of the plain run.
   Each comparison prints its max|d| and the decisions it flips at 0.487,
   each run its img/s, and the sequential run each member's;
9. train (``phase_train``, once a member): full-width GCViTTiny@224
   (``_model``'s seeded weights), convnext_tiny_in22k@200 (``_model``'s)
   and ResNetRS50@200 (the registry's seeded init, the scale of each
   residual branch's last BN ~ U(0.1, 0.3)), one output, no activation,
   bf16 compute, f32 parameters, on the path training takes: GCViT's and
   ConvNeXt's unfused blocks, ResNetRS50's BNs in batch statistics. One
   step at drop rates 0 on one seeded batch of 64 against the same step of
   the f32 model under ``plain_kernels()``: the loss within 2e-2
   (relative), the gradient's global norm within 5e-2 of the f32 one's,
   the cosine of the flattened gradients >= 0.99 and the worst tensor's
   >= 0.9 (bf16 rounds each activation to 2^-9 relative; through 31 blocks
   forward and back the logits move by up to 5e-2 of max|ref| (phase 6),
   and a gradient error of that size is a cosine of 0.9988, of 45 % still
   0.9); ResNetRS50's undamped draw is compared first and printed only (a
   BN network at full branch scale in training amplifies the rounding: a
   cosine of 0.61 on the card); the step's launches exactly GCViT's K8 31,
   K9 11 and K10 71, ConvNeXt's K9 18 and K10 23, none for ResNetRS50
   (forward only: each backward is the plain version's gradient) and none
   of any other kernel; the forward, the backward and the optimizer's
   share of a step timed, a profile of one step printed. Then
   ``Trainer.fit`` takes eight AdamW steps (lr 3e-4, weight decay 1e-4,
   the ``tools/train_flip.py`` setting) on a repeated batch from the
   registry's seeded init and drop rates (the JAX train tools' start:
   GCViT drop_path 0.2, ConvNeXt 0.1, ResNetRS50's head dropout 0.25; for
   GCViT ``_model``'s rel-pos tables ~ U(-1, 1) and LN scales ~ U(0.5,
   1.5) make the loss at that lr spike and end above its start): each loss
   finite, GCViT's last below its first; the median step ms, img/s and
   peak memory printed; it evaluates (GCViT and ConvNeXt on the fused
   path; the eval loss before and after printed) and checkpoints; a fresh
   trainer resumes from the checkpoint to the same parameters, running
   statistics and step; and a fresh bf16 model loaded from the checkpoint
   serves on the fused path within 5e-2 of max|ref| of the trained model's
   own eval logits. Last, a short run of the port's ``tools/train_flip.py``
   (``--epochs 1 --steps 40 --n-eval 512``: the three members trained on
   its checkerboard task, then the f32, bf16 and int8 arms on held-out
   images), its JSON printed, each number finite.

The line before the last is the kernels' JSON record. ``launches`` come from
the run of each kernel's path, counted from 0 just before it: the first fused
CSV run for the block families, the unfused CSV run for
``window_attention_bhnd`` and ``layer_norm``, the cold seven-member CSV run
for ``depthwise_conv_nhwc``, the two tools' runs for the four tool kernels, the
``int8_pallas_spike`` run for the three spike bodies and the seven-member
``VIPTPU_INT8=ResNetRS50,ResNest50`` CSV run for ``ptq_int8_quantize`` and
``ptq_int8_conv``.
``ms``, ``plain_ms`` and ``library_ms`` (null where no one PyTorch call
computes the function) are per batch-256 forward of both members together on
that path (phases 3-5; ``ln_fc1_gelu`` and ``fc2_scale_residual`` serve both
members), for ``depthwise_conv_nhwc`` per batch-256 forward of its three
members (GCViT and both EfficientNets; kernel and cuDNN by device time; the
``exp_dw`` tool's times are printed on earlier lines), for the LN-MLP kernels per
batch-256 launch at each of s1-s4 summed (by device time), for
``attn_parts`` per batch-256 ``full`` launch at l1 and l2 summed, for the
spike bodies per launch at the spike's three shapes summed
(library: cuBLAS bf16, and ``torch._int_mm`` on a column-major copy of w,
the layout cuBLASLt's int8 path takes; none for the quantize-on-load body;
the int8 body's ms is its two launches, the quantize pass and the GEMM;
``attn_parts`` and the spike bodies, kernel and library, by device time),
and for ``ptq_int8_quantize`` and ``ptq_int8_conv`` per batch-256 int8
forward of ResNetRS50 and ResNest50 together, each member's part printed
apart (no one call computes the int8 site). ``bound_ms`` is the least
time the card could take for the same launches, each launch's bytes (inputs
read once, outputs written once) over 3.35 TB/s or its operations over the
peak for their type (989 TFLOP/s bf16 and 1,979 TOP/s int8 tensor-core
products, 67 TFLOP/s f32 elsewhere; NVIDIA's H100 SXM data sheet), whichever
is larger, summed; ``bound_by`` says which of the two made most of it. ``max_abs_err`` is over every check of
phases 3-6. Before it the script prints its own wall time. The last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import main_torch  # noqa: E402
from vip_cup_2022_tpu_torch import quant  # noqa: E402
from vip_cup_2022_tpu_torch.infer import engine  # noqa: E402
from vip_cup_2022_tpu_torch.models import create_model, transfer_weights  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import attn_parts as A  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import build  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import ln_mlp as LM  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels.reference import plain_kernels  # noqa: E402
from vip_cup_2022_tpu_torch.ops.norms import BatchNorm  # noqa: E402
from vip_cup_2022_tpu_torch.tools import (exp_attn_parts, exp_convnext_s12, exp_dw,  # noqa: E402
                                          exp_dwconv, exp_lnmlp_dw, exp_mlp_gemm, exp_ptq_int8,
                                          exp_window_attention, int8_pallas_spike)
from vip_cup_2022_tpu_torch.tools.bench_util import cuda_ms, device_ms  # noqa: E402
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer  # noqa: E402
from vip_cup_2022_tpu_torch.train.losses import binary_cross_entropy_timm  # noqa: E402
from vip_cup_2022_tpu_torch.train.sam import value_and_grad  # noqa: E402
from vip_cup_2022_tpu_torch.utils.checkpoint import load_variables  # noqa: E402

CONVNEXT_KERNELS = ("dwconv7x7_nhwc", "ln_fc1_gelu", "fc2_scale_residual")
GCVIT_KERNELS = ("ln_qkv", "window_attention", "proj_scale_residual")
ATTN, LN, DW = "window_attention_bhnd", "layer_norm", "depthwise_conv_nhwc"
LNMLP_KERNELS = ("fused_ln_mlp_residual", "lnmlp_batchlane", "lnmlp_chanfirst")
PARTS = "attn_parts"
SPIKE_KERNELS = ("int8_spike_bf16", "int8_spike_int8", "int8_spike_direct")
PTQ, QUANT = "ptq_int8_conv", "ptq_int8_quantize"  # the PTQ site's GEMM and quantize pass
KERNELS = (CONVNEXT_KERNELS + GCVIT_KERNELS + (ATTN, LN, DW) + LNMLP_KERNELS + (PARTS,)
           + SPIKE_KERNELS + (QUANT, PTQ))
CSRC = "vip_cup_2022_tpu_torch/csrc"
SOURCES = {n: f"{CSRC}/convnext_block.cu" for n in CONVNEXT_KERNELS}
SOURCES.update({n: f"{CSRC}/gcvit_block.cu" for n in GCVIT_KERNELS})
SOURCES.update({ATTN: f"{CSRC}/window_attention.cu", LN: f"{CSRC}/layernorm.cu",
                DW: f"{CSRC}/depthwise.cu", PARTS: f"{CSRC}/attn_parts.cu"})
SOURCES.update({n: f"{CSRC}/ln_mlp.cu" for n in LNMLP_KERNELS})
SOURCES.update({n: f"{CSRC}/int8_gemm.cu" for n in SPIKE_KERNELS})
SOURCES.update({n: f"{CSRC}/ptq_int8.cuh" for n in (QUANT, PTQ)})  # built into int8_gemm.cu's
PALLAS = "vip_cup_2022_tpu/ops/pallas"
TPU = f"{PALLAS}/convnext_block.py"
GTPU = f"{PALLAS}/gcvit_block.py"
REPLACES = {  # K1 fused_convnext_block, K2 fused_ln_mlp_residual_batchlane, K4 ln_dense,
    # K5 grouped_window_attention, K6 proj_res_ln_mlp, K7 mono_window_transformer_block,
    # K8 window_attention, K10 fused_layernorm -> _pallas_ln2, K9 depthwise_conv_nhwc,
    # K3 fused_ln_mlp_residual, K12 lnmlp_batchlane / lnmlp_chanfirst, K11 build,
    # K13 _call (and XLA's int8 conv / dot of the PTQ pass)
    "dwconv7x7_nhwc": f"{TPU}:602",
    "ln_fc1_gelu": f"{TPU}:602, {TPU}:443, {GTPU}:667, {GTPU}:906",
    "fc2_scale_residual": f"{TPU}:602, {TPU}:443, {GTPU}:667, {GTPU}:906",
    "ln_qkv": f"{GTPU}:247, {GTPU}:906",
    "window_attention": f"{GTPU}:542, {GTPU}:906",
    "proj_scale_residual": f"{GTPU}:667, {GTPU}:906",
    ATTN: f"{PALLAS}/window_attention.py:45",
    LN: f"{PALLAS}/norms.py:65, {PALLAS}/norms.py:34",
    DW: f"{PALLAS}/depthwise.py:41",
    "fused_ln_mlp_residual": f"{TPU}:310",
    "lnmlp_batchlane": "tools/exp_convnext_s12.py:87",
    "lnmlp_chanfirst": "tools/exp_convnext_s12.py:164",
    PARTS: "tools/exp_attn_parts.py:76",
    **{n: "tools/int8_pallas_spike.py:55" for n in SPIKE_KERNELS},
    PTQ: "tools/int8_pallas_spike.py:55, vip_cup_2022_tpu/quant/ptq.py:172, "
         "vip_cup_2022_tpu/quant/ptq.py:258",
    QUANT: "vip_cup_2022_tpu/quant/ptq.py:172, vip_cup_2022_tpu/quant/ptq.py:258",
}
STAGES = ((99, 99, 96, 3), (49, 49, 192, 3), (24, 24, 384, 9), (12, 12, 768, 3))  # H, W, C, blocks
LEVELS = exp_window_attention.LEVELS  # GCViTTiny@224: grid, C, heads, window, blocks
CONVNEXT_BLOCKS, GCVIT_BLOCKS = 18, 31
GCVIT_DW_SITES = 11  # GCViTTiny's stride-1 depthwise convs (ReduceSize / FeatExtract), K9
# timed beside cuBLAS's product alone (and so is ln_qkv)
MLP_KERNELS = ("ln_fc1_gelu", "fc2_scale_residual")
# LN calls per forward: ConvNeXt's stem, three downsamples and head; GCViT's
# stem and downsample ReduceSizes (two each) and head; on the unfused path
# also each block's norm1 and norm2
CONVNEXT_LNS, GCVIT_LNS = 5, 9
KERNEL_BOUND = 1e-2
# a kernel with f32 sums and output: the ConvNeXt head LN, and the depthwise
# pass (its f32 sums of 49 products in another order than the plain conv's)
F32_KERNEL_BOUND = 1e-5
INT8_BOUND = 1e-6  # int8 kernels: the same integer sums and f32 epilogue as the plain version
MODEL_BOUND = 5e-2
SERVING_BOUND = 1e-2  # raw means of two serving paths of the same bf16 ensemble
N_IMAGES = 300
BATCH = 256
# the card's data-sheet peaks (NVIDIA H100 SXM, 700 W): memory, dense bf16
# and int8 tensor-core products, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# the JAX pass's int8 sites (tests/test_torch_resnet_rs.py, tests/test_torch_ptq.py)
INT8_SITES = {"ResNetRS50": 52, "ResNest50": 68}
# conv -> BN pairs VIPTPU_FUSE_BN folds in each full-width member: the JAX
# package's discovery on its trees (tests/test_torch_fuse_bn.py)
FUSE_BN_PAIRS = {"convnext_tiny_in22k": 0, "ResNest50": 38, "GCViTTiny": 0, "EfficientNetV2T": 78,
                 "EfficientNetV1B4": 64, "ECA_NFNetL0": 0, "ResNetRS50": 56}


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def abs_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return (a.float() - ref.float()).abs().max().item()


KERNEL_MODULES = (K, G, WA, L, D, LM, A, Q)


def reset_launches() -> None:
    for module in KERNEL_MODULES:
        module.reset_launches()


def all_launches() -> dict:
    return {name: n for module in KERNEL_MODULES for name, n in module.LAUNCHES.items()}


def depthwise_cudnn(x: torch.Tensor, kern: torch.Tensor, *, padding) -> torch.Tensor:
    """The library call for K9: cuDNN's grouped conv on the same bf16 input
    and taps (the path stride-1 depthwise convs took before K9 ran them)."""
    (pt, pb), (pl, pr) = padding
    c = x.shape[-1]
    w = kern.reshape(kern.shape[0], kern.shape[1], c).permute(2, 0, 1).unsqueeze(1).to(x.dtype)
    if pt == pb and pl == pr:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=(pt, pl), groups=c)
    else:
        y = F.conv2d(F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2), w, groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


@contextlib.contextmanager
def cudnn_depthwise():
    """Route the stride-1 depthwise convs through cuDNN instead of K9."""
    real = D.depthwise_conv_nhwc
    D.depthwise_conv_nhwc = depthwise_cudnn
    try:
        yield
    finally:
        D.depthwise_conv_nhwc = real


@contextlib.contextmanager
def recording_depthwise(calls: list):
    """Record (input shape without the batch, k, padding) of each K9 call."""
    real = D.depthwise_conv_nhwc

    def record(x, kern, *, padding):
        calls.append((tuple(x.shape[1:]), kern.shape[0], padding))
        return real(x, kern, padding=padding)

    D.depthwise_conv_nhwc = record
    try:
        yield
    finally:
        D.depthwise_conv_nhwc = real


def depthwise_sites(model: torch.nn.Module, size: tuple) -> list:
    """The stride-1 depthwise calls of one batch-1 forward of ``model``."""
    calls = []
    with torch.inference_mode(), recording_depthwise(calls):
        model(torch.rand((1, *size, 3), device="cuda"))
    return calls


def new_stats() -> dict:
    return {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "gemm_ms": 0.0} for n in KERNELS}


def account(stats: dict, name: str, count: int, times: tuple, nbytes: float, ops: float,
            kind: str) -> float:
    """Add ``count`` launches of one shape, timed (kernel, plain, library) ms
    per launch, to ``name``'s per-forward numbers; return the launch's bound
    in ms: its bytes over the memory rate or its operations over the peak
    for their ``kind``, whichever is larger."""
    st = stats[name]
    k_ms, p_ms, l_ms = times
    st["ms"] += count * k_ms
    st["plain_ms"] += count * p_ms
    if l_ms is not None:
        st["library_ms"] = (st["library_ms"] or 0.0) + count * l_ms
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    bound = max(t_bytes, t_ops)
    st["bound_ms"] += count * bound
    st["bytes_ms" if t_bytes >= t_ops else "ops_ms"] += count * bound
    return bound


def fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.3f} ms"


def fmt_ratio(k_ms: float, l_ms) -> str:
    return "" if l_ms is None else f", kernel/library {k_ms / l_ms:.2f}"


def fmt_gemm(k_ms: float, g_ms) -> str:
    return "" if not g_ms else f", cuBLAS GEMM alone {g_ms:.3f} ms, kernel/cuBLAS {k_ms / g_ms:.2f}"


def print_launch(name: str, shape: str, times: tuple, bound: float, card: str,
                 gemm_ms=None) -> None:
    k_ms, p_ms, l_ms = times
    print(f"[kernels] {name:26s} {shape} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library "
          f"{fmt_ms(l_ms)}, bound {bound:.3f} ms per launch{fmt_ratio(k_ms, l_ms)}"
          f"{fmt_gemm(k_ms, gemm_ms)} [{card}]")


def print_per_forward(stats: dict, before: dict, names, label: str, card: str) -> None:
    for n in names:
        d = {k: stats[n][k] - before[n][k] for k in ("ms", "plain_ms", "bound_ms", "gemm_ms")}
        lib = stats[n]["library_ms"]
        lib = None if lib is None else lib - (before[n]["library_ms"] or 0.0)
        print(f"[kernels] {n:26s} per {label}: kernel {d['ms']:.2f} ms, plain "
              f"{d['plain_ms']:.2f} ms, library {fmt_ms(lib)}, bound {d['bound_ms']:.3f} ms"
              f"{fmt_ratio(d['ms'], lib)}{fmt_gemm(d['ms'], d['gemm_ms'])} [{card}]")


def time_gemm(stats: dict, name: str, count: int, gemm) -> float:
    """cuBLAS's product alone (``gemm``), ms per launch, two readings
    averaged; added ``count`` times to ``name``'s per-forward figure."""
    g_ms = (cuda_ms(gemm) + cuda_ms(gemm)) / 2
    stats[name]["gemm_ms"] += count * g_ms
    return g_ms


def snapshot(stats: dict) -> dict:
    return {n: dict(st) for n, st in stats.items()}


def time_calls(kern, plain, library=None, device: bool = False) -> tuple:
    """Kernel, plain and library ms per launch, interleaved k, p, l, l, p, k;
    with ``device`` the kernel's and the library's by device time (a CUDA
    graph of the launches replayed, ``bench_util.device_ms``), the plain
    version's by CUDA events all the same."""
    timer = device_ms if device else cuda_ms
    fns = [(kern, timer), (plain, cuda_ms)] + ([(library, timer)] if library is not None else [])
    first = [t(f) for f, t in fns]
    second = [t(f) for f, t in reversed(fns)][::-1]
    ms = [(a + b) / 2 for a, b in zip(first, second)]
    return ms[0], ms[1], (ms[2] if library is not None else None)


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
    names = sorted({os.path.basename(src)[:-len(".cu")] for src in SOURCES.values()
                    if src.endswith(".cu")}  # ptq_int8.cuh is built into int8_gemm.cu
                   | {"mlp_gemm_cuts", "dwconv_cuts", "ptq_int8_cuts", "ln_mlp_cuts"})  # the cuts
    paths = build.build_all(names, verbose=True)
    for module in KERNEL_MODULES:
        module._lib()
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


def check(refs: dict, label: str, stats: dict, bound: float = KERNEL_BOUND) -> None:
    """Each kernel output in ``refs`` (name -> (output, reference maker))
    against its plain version in f32 on the same (bf16-rounded) inputs,
    within ``bound`` of max|ref|; references are made one at a time to bound
    memory."""
    for name, (got, make_ref) in refs.items():
        ref = make_ref()
        r = rel_err(got, ref)
        kernel = name.split(" ")[0]
        stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], abs_err(got, ref))
        del ref
        print(f"[kernels] {name:26s} {label} max|d|/max|ref| = {r:.3e} (bound {bound:g})")
        if not r <= bound:
            raise AssertionError(f"{name} at {label} disagrees with its plain version: "
                                 f"{r:.3e} > {bound:g}")


def check_stage(p: dict, shape: tuple, stats: dict) -> None:
    c = shape[-1]
    check({"dwconv7x7_nhwc": (p["d"], lambda: K.dwconv7x7_nhwc_plain(
        p["x"].float(), p["dw"], p["dwb"]).view(-1, c))}, str(shape), stats, F32_KERNEL_BOUND)
    check({
        "ln_fc1_gelu": (p["hid"], lambda: K.ln_fc1_gelu_plain(
            p["d"], p["lg"], p["lb"], p["w1"].float(), p["b1"], 1e-6)),
        "fc2_scale_residual": (p["out"], lambda: K.fc2_scale_residual_plain(
            p["hid"].float(), p["w2"].float(), p["b2"], p["ls"], p["x2"].float())),
    }, str(shape), stats)


def phase_kernels(card: str, stats: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, w, c, _ in STAGES:  # batch 8: ragged row tiles (B*H*W not a multiple of 64)
        check_stage(run_stage(8, h, w, c, gen), (8, h, w, c), stats)
    before = snapshot(stats)
    for h, w, c, nblocks in STAGES:  # the main path's batch-256 shapes: checked, then timed
        p = run_stage(BATCH, h, w, c, gen)
        check_stage(p, (BATCH, h, w, c), stats)
        m, n = BATCH * h * w, 4 * c
        # cuDNN's depthwise conv on the same channels-last bf16 input
        xc = p["x"].permute(0, 3, 1, 2)
        wc = p["dw"].permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)
        bc = p["dwb"].to(torch.bfloat16)
        calls = {  # name: (kernel, plain, library, bytes, operations, their type)
            "dwconv7x7_nhwc": (
                lambda: K.dwconv7x7_nhwc(p["x"], p["dw"], p["dwb"]),
                lambda: K.dwconv7x7_nhwc_plain(p["x"], p["dw"], p["dwb"]),
                lambda: F.conv2d(xc, wc, bc, padding=3, groups=c),
                m * c * 2 + 50 * c * 4 + m * c * 4, 2 * 49 * m * c, "f32"),
            "ln_fc1_gelu": (
                lambda: K.ln_fc1_gelu(p["d"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6),
                lambda: K.ln_fc1_gelu_plain(p["d"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6),
                None, m * c * 4 + n * c * 2 + (n + 2 * c) * 4 + m * n * 2, 2 * m * c * n, "bf16"),
            "fc2_scale_residual": (
                lambda: K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["ls"], p["x2"]),
                lambda: K.fc2_scale_residual_plain(p["hid"], p["w2"], p["b2"], p["ls"], p["x2"]),
                None, m * n * 2 + n * c * 2 + 2 * c * 4 + 2 * m * c * 2, 2 * m * n * c, "bf16"),
        }
        y = p["d"].to(torch.bfloat16)  # the LN output's stand-in for cuBLAS's product alone
        alone = {"ln_fc1_gelu": lambda: F.linear(y, p["w1"]),
                 "fc2_scale_residual": lambda: F.linear(p["hid"], p["w2"])}
        for name, (kern, plain, lib, nbytes, ops, kind) in calls.items():
            times = time_calls(kern, plain, lib)
            bound = account(stats, name, nblocks, times, nbytes, ops, kind)
            g_ms = time_gemm(stats, name, nblocks, alone[name]) if name in alone else None
            print_launch(name, f"({BATCH},{h},{w},{c})", times, bound, card, g_ms)
        del p, calls, xc, wc, bc, y, alone
        torch.cuda.empty_cache()
    print_per_forward(stats, before, CONVNEXT_KERNELS,
                      "convnext_tiny batch-256 forward (3/3/9/3 blocks)", card)
    exp_dwconv.main(["--iters", "10"])  # the depthwise kernel's phase cuts at s1-s4


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


def gcvit_calls(p: dict, b: int, c: int, heads: int) -> dict:
    """name -> (kernel call, plain call, library call or None, bytes,
    operations) for every GCViT launch of one level, both block kinds; the
    plain versions run on the same bf16 inputs. The library call of the
    attention is SDPA on the same (window, head) tiles, the global query
    repeated over the windows beforehand."""
    n, m = p["n"], p["m"]
    wkv, bkv = p["wqkv"][c:], p["bqkv"][c:]
    t = lambda a: a.view(b, -1, c)  # noqa: E731
    heads_view = lambda a: a.reshape(-1, n, heads, 32).transpose(1, 2)  # noqa: E731
    q, k, v = p["qkv"]
    q_rep = p["qg"].repeat_interleave(m // (b * n), 0)
    mask = p["bias"].to(torch.bfloat16)
    sdpa = lambda qq: F.scaled_dot_product_attention(  # noqa: E731
        heads_view(qq), heads_view(k), heads_view(v), attn_mask=mask, scale=p["scale"])
    act, weights = m * c * 2, c * c * 2  # bytes of one bf16 (M, C) activation, one C x C weight
    attn_ops, bias_bytes = 4 * m * n * c, heads * n * n * 4
    return {
        "ln_qkv local": (lambda: G.ln_qkv(p["x"], p["lg"], p["lb"], p["wqkv"], p["bqkv"], 1e-5),
                         lambda: G.ln_qkv_plain(p["x"], p["lg"], p["lb"], p["wqkv"], p["bqkv"],
                                                1e-5),
                         None, 4 * act + 3 * weights, 2 * m * c * 3 * c),
        "ln_qkv global": (lambda: G.ln_qkv(p["x"], p["lg"], p["lb"], wkv, bkv, 1e-5),
                          lambda: G.ln_qkv_plain(p["x"], p["lg"], p["lb"], wkv, bkv, 1e-5),
                          None, 3 * act + 2 * weights, 2 * m * c * 2 * c),
        "window_attention local": (
            lambda: G.window_attention(t(q), t(k), t(v), p["bias"], n, p["scale"]),
            lambda: G.window_attention_plain(t(q), t(k), t(v), p["bias"], n, p["scale"]),
            lambda: sdpa(q), 4 * act + bias_bytes, attn_ops),
        "window_attention global": (
            lambda: G.window_attention(p["qg"], t(k), t(v), p["bias"], n, p["scale"], True),
            lambda: G.window_attention_plain(p["qg"], t(k), t(v), p["bias"], n, p["scale"], True),
            lambda: sdpa(q_rep), 3 * act + b * n * c * 2 + bias_bytes, attn_ops),
        "proj_scale_residual": (
            lambda: G.proj_scale_residual(p["attn"], p["wp"], p["bp"], p["g1"], p["x"]),
            lambda: G.proj_scale_residual_plain(p["attn"], p["wp"], p["bp"], p["g1"], p["x"]),
            None, 2 * act + weights + m * c * 4, 2 * m * c * c),
        "ln_fc1_gelu": (
            lambda: K.ln_fc1_gelu(p["r1"], p["lg2"], p["lb2"], p["w1"], p["b1"], 1e-5),
            lambda: K.ln_fc1_gelu_plain(p["r1"], p["lg2"], p["lb2"], p["w1"], p["b1"], 1e-5),
            None, m * c * 4 + 3 * weights + 3 * act, 2 * m * c * 3 * c),
        "fc2_scale_residual": (
            lambda: K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"]),
            lambda: K.fc2_scale_residual_plain(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"]),
            None, 3 * act + 3 * weights + m * c * 4 + act, 2 * m * 3 * c * c),
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
    before = snapshot(stats)
    for level in LEVELS:  # the main path's batch-256 shapes: checked, then timed
        grid, c, heads, ws, n_local, n_global = level
        p = run_check_level(BATCH, level, gen, stats)
        y = p["r1"].to(torch.bfloat16)  # the LN output's stand-in for cuBLAS's product alone
        alone = {"ln_fc1_gelu": lambda: F.linear(y, p["w1"]),
                 "fc2_scale_residual": lambda: F.linear(p["hid"], p["w2"]),
                 "ln_qkv local": lambda: F.linear(p["x"], p["wqkv"]),
                 "ln_qkv global": lambda: F.linear(p["x"], p["wqkv"][c:]),
                 "proj_scale_residual": lambda: F.linear(p["attn"], p["wp"])}
        for name, (kern, plain, lib, nbytes, ops) in gcvit_calls(p, BATCH, c, heads).items():
            times = time_calls(kern, plain, lib)
            count = (n_local if name.endswith("local") else n_global if name.endswith("global")
                     else n_local + n_global)
            bound = account(stats, name.split(" ")[0], count, times, nbytes, ops, "bf16")
            g_ms = (time_gemm(stats, name.split(" ")[0], count, alone[name]) if name in alone
                    else None)
            print_launch(name, f"({BATCH},{grid},{grid},{c}) w{ws}", times, bound, card, g_ms)
        del p, y, alone
        torch.cuda.empty_cache()
    print_per_forward(stats, before, ("ln_qkv", "window_attention", "proj_scale_residual",
                                      "ln_fc1_gelu", "fc2_scale_residual"),
                      "GCViTTiny batch-256 forward (3/4/19/5 blocks)", card)
    print_per_forward(stats, {n: new_stats()[n] for n in MLP_KERNELS}, MLP_KERNELS,
                      "ConvNeXt + fused GCViT batch-256 forward (18 + 31 blocks)", card)
    exp_mlp_gemm.main(["--iters", "10"])  # the two MLP GEMM kernels' phase cuts


def attention_inputs(b, grid, heads, ws, gen) -> dict:
    """The window-attention kernel's inputs at one GCViT level and batch
    ``b``: bf16 q, k, v (b * nWin, heads, N, 32), a per-image global query
    repeated over its windows, and an f32 (heads, N, N) bias."""
    n, nwin = ws * ws, (grid // ws) ** 2

    def u(shape):
        return torch.rand(shape, generator=gen, device="cuda") * 2 - 1

    shape = (b * nwin, heads, n, 32)
    q, k, v = (u(shape).to(torch.bfloat16) for _ in range(3))
    qg = u((b, heads, n, 32)).to(torch.bfloat16).repeat_interleave(nwin, 0)
    return dict(q=q, qg=qg, k=k, v=v, bias=u((heads, n, n)), scale=32 ** -0.5)


def phase_attention(card: str, stats: dict) -> None:
    """The unfused path's window attention at L1-L4, local and global query."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    before = snapshot(stats)
    for b in (8, BATCH):
        for grid, c, heads, ws, n_local, n_global in LEVELS:
            p = attention_inputs(b, grid, heads, ws, gen)
            k, v, bias, scale = p["k"], p["v"], p["bias"], p["scale"]
            f = lambda a: a.float()  # noqa: E731
            outs = {kind: WA.window_attention(p[key], k, v, bias, scale)
                    for kind, key in (("local", "q"), ("global", "qg"))}
            torch.cuda.synchronize()
            check({f"{ATTN} local": (outs["local"], lambda: WA.window_attention_plain(
                       f(p["q"]), f(k), f(v), bias, scale)),
                   f"{ATTN} global": (outs["global"], lambda: WA.window_attention_plain(
                       f(p["qg"]), f(k), f(v), bias, scale))},
                  f"L b{b} {tuple(p['q'].shape)}", stats)
            if b == BATCH:
                mask = bias.to(torch.bfloat16)
                nbytes = 4 * p["q"].numel() * 2 + bias.numel() * 4
                ops = 4 * p["q"].numel() * p["q"].shape[2]
                for kind, q, count in (("local", p["q"], n_local), ("global", p["qg"], n_global)):
                    times = time_calls(
                        lambda: WA.window_attention(q, k, v, bias, scale),
                        lambda: WA.window_attention_plain(q, k, v, bias, scale),
                        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                               scale=scale))
                    bound = account(stats, ATTN, count, times, nbytes, ops, "bf16")
                    print_launch(f"{ATTN} {kind}", f"{tuple(q.shape)} L{grid}x{grid}", times,
                                 bound, card)
            del p, outs
            torch.cuda.empty_cache()
    print_per_forward(stats, before, (ATTN,), "GCViTTiny unfused batch-256 forward (31 blocks)",
                      card)
    exp_window_attention.main(["--iters", "10"])  # the template's phase cuts at L1-L4


@contextlib.contextmanager
def recording_layer_norms(calls: list):
    """Record (shape without the batch, dtype, eps) of each LN wrapper call."""
    real = L.layer_norm

    def record(x, weight, bias, eps):
        calls.append((tuple(x.shape[1:]), x.dtype, float(eps)))
        return real(x, weight, bias, eps)

    L.layer_norm = record
    try:
        yield
    finally:
        L.layer_norm = real


def member_layer_norms(name: str, **kw) -> list:
    """Every LN call of one batch-1 bf16 forward of a full-width member."""
    model = _model(name, torch.bfloat16, **kw)
    calls = []
    with torch.inference_mode(), recording_layer_norms(calls):
        model(torch.rand((1, *MEMBERS[name][0], 3), device="cuda"))
    del model
    torch.cuda.empty_cache()
    return calls


def phase_layernorm(card: str, stats: dict) -> None:
    """The LN kernel at every LN shape of both members on the unfused path."""
    calls = {"convnext_tiny_in22k": member_layer_norms("convnext_tiny_in22k"),
             "GCViTTiny fused": member_layer_norms("GCViTTiny", fused_block=True),
             "GCViTTiny unfused": member_layer_norms("GCViTTiny", fused_block=False)}
    want = {"convnext_tiny_in22k": CONVNEXT_LNS, "GCViTTiny fused": GCVIT_LNS,
            "GCViTTiny unfused": GCVIT_LNS + 2 * GCVIT_BLOCKS}
    for path, got in calls.items():
        print(f"[kernels] {LN} calls per {path} forward: {len(got)} (expected {want[path]})")
        if len(got) != want[path]:
            raise AssertionError(f"{path} ran {len(got)} LNs through the LN wrapper, "
                                 f"expected {want[path]}")
    per_forward = Counter(calls["convnext_tiny_in22k"] + calls["GCViTTiny unfused"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    before = snapshot(stats)
    for b in (8, BATCH):
        for (shape, dtype, eps), count in per_forward.items():
            c = shape[-1]
            x = (torch.rand((b, *shape), generator=gen, device="cuda") * 4 - 2).to(dtype)
            w = torch.rand((c,), generator=gen, device="cuda") + 0.5
            bb = torch.rand((c,), generator=gen, device="cuda") * 0.2 - 0.1
            out = L.layer_norm(x, w, bb, eps)
            torch.cuda.synchronize()
            label = f"{tuple(x.shape)} eps {eps:g} x{count}"
            check({LN: (out, lambda: L.layer_norm_plain(x.float(), w, bb, eps))}, label, stats,
                  F32_KERNEL_BOUND if dtype == torch.float32 else KERNEL_BOUND)
            if b == BATCH:
                times = time_calls(
                    lambda: L.layer_norm(x, w, bb, eps),
                    lambda: L.layer_norm_plain(x, w, bb, eps),
                    lambda: F.layer_norm(x.float(), (c,), w, bb, eps).to(x.dtype))
                bound = account(stats, LN, count, times, 2 * x.numel() * x.element_size()
                                + 2 * c * 4, 8 * x.numel(), "f32")
                print_launch(LN, label, times, bound, card)
            del x, out
            torch.cuda.empty_cache()
    print_per_forward(stats, before, (LN,), "two-member batch-256 forward, GCViT unfused "
                      f"({sum(per_forward.values())} LNs)", card)


# ragged depthwise cases beside the exp_dw shapes: (tag, H, W, C, k, padding);
# C = 336 (ten 32-channel slices and a tail of 16), 24 and 8 (a tail alone)
DW_RAGGED = (
    ("c336_k3_asym", 28, 28, 336, 3, ((1, 0), (0, 1))),
    ("c336_k5_asym", 28, 28, 336, 5, ((2, 1), (0, 2))),
    ("c336_k7_asym", 14, 14, 336, 7, ((3, 2), (1, 3))),
    ("c24_k5_asym", 13, 11, 24, 5, ((2, 0), (1, 3))),
    ("c8_k7_asym", 13, 11, 8, 7, ((0, 3), (3, 1))),
    ("c8_k3", 13, 11, 8, 3, ((1, 1), (1, 1))),
)


def phase_depthwise(card: str, stats: dict) -> None:
    """The depthwise kernel at the six ``exp_dw`` shapes and at the ragged
    ``DW_RAGGED`` cases, batch 8 and 256, then the ``exp_dw`` tool (its entry
    point), which times the kernel and cuDNN by device time, printed beside
    the bound (the record's K9 numbers are its model path's,
    :func:`phase_depthwise_sites`)."""
    cases = [(tag, h, w, c, k, ((k // 2, k // 2), (k // 2, k // 2)))
             for tag, _, h, w, c, k in exp_dw.SHAPES] + list(DW_RAGGED)
    for b in (8, BATCH):
        for tag, h, w, c, k, pad in cases:
            x, kern = exp_dw.inputs(b, h, w, c, k)
            out = D.depthwise_conv_nhwc(x, kern, padding=pad)
            torch.cuda.synchronize()
            check({f"{DW} {tag}": (out, lambda: D.depthwise_conv_nhwc_plain(
                x.float(), kern, padding=pad))}, f"b{b}", stats)
            del x, kern, out
            torch.cuda.empty_cache()
    reset_launches()
    results = exp_dw.main(["--iters", "10"])
    launches = D.LAUNCHES[DW]
    tool = new_stats()
    for r in results:
        b, h, w, c = r["shape"]
        k = r["k"]
        times = (r["ms"], r["plain_ms"], r["cudnn_ms"])
        bound = account(tool, DW, 1, times, 2 * b * h * w * c * 2 + k * k * c * 4,
                        2 * k * k * b * h * w * c, "f32")
        stats[DW]["max_abs_err"] = max(stats[DW]["max_abs_err"], r["max_abs_err"])
        print_launch(DW, r["tag"], times, bound, card)
    print(f"[kernels] {DW} per pass over the six exp_dw shapes: kernel {tool[DW]['ms']:.3f} ms "
          f"device, plain {tool[DW]['plain_ms']:.2f} ms, cuDNN {tool[DW]['library_ms']:.3f} ms "
          f"device, bound {tool[DW]['bound_ms']:.3f} ms; {launches} launches in the exp_dw run "
          f"[{card}]")
    if launches <= 0:
        raise AssertionError("the exp_dw run launched no depthwise kernel")


def phase_depthwise_sites(card: str, stats: dict, members: dict) -> None:
    """K9 at every stride-1 depthwise site of each member's forward
    (``members``: name -> (the sites :func:`depthwise_sites` recorded, the
    batch-256 forward's ms)), batch 8 and 256, against its plain version
    within 1e-2 of max|ref| (bf16 output); at batch 256 the kernel and
    cuDNN's grouped conv of the same bf16 input and taps by device time, the
    plain version by CUDA events, counted per forward into the record; each
    member's K9 time beside its forward."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, (sites, forward_ms) in members.items():
        before = snapshot(stats)
        for b in (8, BATCH):
            for (shape, k, pad), count in Counter(sites).items():
                x = torch.rand((b, *shape), generator=gen, device="cuda").to(torch.bfloat16)
                kern = (torch.rand((k, k, shape[-1]), generator=gen, device="cuda") - 0.5).to(
                    torch.bfloat16)
                out = D.depthwise_conv_nhwc(x, kern, padding=pad)
                torch.cuda.synchronize()
                label = f"{name} b{b} {(b, *shape)} k{k} pad {pad} x{count}"
                check({DW: (out, lambda: D.depthwise_conv_nhwc_plain(x.float(), kern,
                                                                     padding=pad))}, label, stats)
                if b == BATCH:
                    times = time_calls(lambda: D.depthwise_conv_nhwc(x, kern, padding=pad),
                                       lambda: D.depthwise_conv_nhwc_plain(x, kern, padding=pad),
                                       lambda: depthwise_cudnn(x, kern, padding=pad), device=True)
                    bound = account(stats, DW, count, times,
                                    (x.numel() + out.numel() + kern.numel()) * 2,
                                    2 * k * k * out.numel(), "f32")
                    print_launch(DW, label + " device", times, bound, card)
                del x, kern, out
                torch.cuda.empty_cache()
        print_per_forward(stats, before, (DW,), f"{name} batch-256 forward ({len(sites)} sites)",
                          card)
        k_ms, l_ms = (stats[DW][key] - (before[DW][key] or 0.0) for key in ("ms", "library_ms"))
        print(f"[kernels] {DW} share of the {name} batch-256 forward ({forward_ms:.2f} ms): "
              f"K9 {100 * k_ms / forward_ms:.1f} %, cuDNN at the same sites would be "
              f"{100 * l_ms / forward_ms:.1f} % [{card}]")


def lnmlp_inputs(b, h, w, c, gen) -> tuple:
    """bf16 x and residual (b, h, w, c) and the LN-MLP parameters (hidden 4C)."""
    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    n = 4 * c
    x, r = u((b, h, w, c)).to(torch.bfloat16), u((b, h, w, c)).to(torch.bfloat16)
    prm = (u((c,), 0.5, 1.5), u((c,), -0.1, 0.1), (u((n, c)) * c ** -0.5).to(torch.bfloat16),
           u((n,), -0.1, 0.1), (u((c, n)) * n ** -0.5).to(torch.bfloat16), u((c,), -0.1, 0.1),
           u((c,), 0.5, 1.5))
    return x, r, prm


def phase_lnmlp(card: str, stats: dict) -> None:
    """K3 and K12 (one LN-MLP kernel in three layouts) at the ``exp_convnext_s12``
    shapes s1-s4, batch 8 and 256, each against its plain version; timed at
    batch 256 by device time (the plain version by CUDA events) beside the
    engine's two-launch pair ``ln_fc1_gelu`` + ``fc2_scale_residual`` on the
    same inputs (x as the f32 rows ``ln_fc1_gelu`` takes) and cuBLAS's two
    products alone, both by device time. No one PyTorch call computes LN ->
    MLP -> residual. Then the ``exp_lnmlp_dw`` tool's phase cuts of the
    rows-layout kernel at s1-s4."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    before, pair_sum, gemm_sum = snapshot(stats), 0.0, 0.0
    for b in (8, BATCH):
        for tag, (h, w, c, n) in exp_convnext_s12.SHAPES.items():
            x, r, prm = lnmlp_inputs(b, h, w, c, gen)
            p32 = tuple(t.float() for t in prm)
            m = b * h * w
            for name in LNMLP_KERNELS:
                perm = LM.LAYOUTS[name]
                xl, rl = x.permute(*perm).contiguous(), r.permute(*perm).contiguous()
                kern, plain = getattr(LM, name), getattr(LM, name + "_plain")
                out = kern(xl, rl, *prm)
                torch.cuda.synchronize()
                check({f"{name} {tag}": (out, lambda: plain(xl.float(), rl.float(), *p32))},
                      f"b{b} {tuple(xl.shape)}", stats)
                if b == BATCH:
                    times = time_calls(lambda: kern(xl, rl, *prm), lambda: plain(xl, rl, *prm),
                                       device=True)
                    nbytes = 3 * m * c * 2 + 2 * n * c * 2 + (4 * c + n) * 4
                    bound = account(stats, name, 1, times, nbytes, 4 * m * c * n, "bf16")
                    print_launch(name, f"{tag} {tuple(xl.shape)} device", times, bound, card)
                del xl, rl, out
            if b == BATCH:  # the yardsticks: the engine's pair and cuBLAS's products alone
                g, lb, w1, b1, w2, b2, ls = prm
                xf, r2, y = x.view(m, c).float(), r.view(m, c), x.view(m, c)
                hid = F.linear(y, w1)
                pair, gemm = (sum(device_ms(fn, calls=10) for _ in range(2)) / 2 for fn in (
                    lambda: K.fc2_scale_residual(K.ln_fc1_gelu(xf, g, lb, w1, b1, 1e-6), w2, b2,
                                                 ls, r2),
                    lambda: (F.linear(y, w1), F.linear(hid, w2))))
                pair_sum, gemm_sum = pair_sum + pair, gemm_sum + gemm
                for name in LNMLP_KERNELS:
                    stats[name]["gemm_ms"] += gemm
                print(f"[kernels] LN-MLP yardsticks {tag} ({m}, {c}) hidden {n}: ln_fc1_gelu + "
                      f"fc2_scale_residual {pair:.4f} ms device, cuBLAS's two products alone "
                      f"{gemm:.4f} ms device [{card}]")
                del xf, r2, y, hid
            del x, r
            torch.cuda.empty_cache()
    for name in LNMLP_KERNELS:
        k_ms = stats[name]["ms"] - before[name]["ms"]
        print(f"[kernels] {name:26s} over s1-s4: kernel {k_ms:.4f} ms device, pair "
              f"{pair_sum:.4f} ms device (kernel/pair {k_ms / pair_sum:.2f}), cuBLAS's products "
              f"alone {gemm_sum:.4f} ms, bound "
              f"{stats[name]['bound_ms'] - before[name]['bound_ms']:.3f} ms [{card}]")
    exp_lnmlp_dw.main(["--only", "lnmlp", "--cuts", "--iters", "5"])  # the phase cuts


def phase_attn_parts(card: str, stats: dict) -> None:
    """K11's six variants at the ``exp_attn_parts`` shapes l1 and l2, batch 8
    and 256, each against its plain version; the ``full`` variant timed at
    batch 256 beside SDPA with the group bias as a float mask, the copy
    kernel beside ``q + v``."""
    for b in (8, BATCH):
        for tag, (nwin, n, c, heads, g) in exp_attn_parts.SHAPES.items():
            t = exp_attn_parts.inputs(b, nwin, n, c, heads, g)
            t32 = {k: t[k].float() for k in ("q", "k", "v")}
            t32["mb"] = t["mb"]
            for variant in exp_attn_parts.VARIANTS:
                out = exp_attn_parts.call(variant, t, heads, n, g)()
                torch.cuda.synchronize()
                check({f"{PARTS} {variant}": (
                    out, exp_attn_parts.call(variant, t32, heads, n, g, plain=True))},
                    f"b{b} {tag} {tuple(t['q'].shape)}", stats)
                del out
            if b == BATCH:
                gn, hd = g * n, c // heads
                heads_view = lambda a: (a.view(b, -1, gn, heads, hd).transpose(2, 3)  # noqa: E731
                                        .reshape(-1, heads, gn, hd).contiguous())
                qh, kh, vh = (heads_view(t[k]) for k in ("q", "k", "v"))
                mask = t["mb"].to(torch.bfloat16)
                times = time_calls(exp_attn_parts.call("full", t, heads, n, g),
                                   lambda: A.attn_parts_plain(t["q"], t["k"], t["v"], t["mb"],
                                                              heads=heads, n=n, g=g,
                                                              parts=exp_attn_parts.VARIANTS["full"]),
                                   lambda: F.scaled_dot_product_attention(
                                       qh, kh, vh, attn_mask=mask, scale=hd ** -0.5),
                                   device=True)
                act = t["q"].numel() * 2
                bound = account(stats, PARTS, 1, times, 4 * act + t["mb"].numel() * 4,
                                4 * b * (nwin // g) * heads * gn * gn * hd, "bf16")
                print_launch(f"{PARTS} full", f"{tag} {tuple(t['q'].shape)} g{g}", times, bound,
                             card)
                k_ms, p_ms, _ = time_calls(exp_attn_parts.call("empty", t, heads, n, g),
                                           lambda: t["q"] + t["v"])
                print(f"[kernels] {PARTS}_copy {tag}: kernel {k_ms:.3f} ms, q + v {p_ms:.3f} ms, "
                      f"bound {3 * act / HBM_BYTES_PER_S * 1e3:.3f} ms [{card}]")
                del qh, kh, vh, mask
            del t, t32
            torch.cuda.empty_cache()


def phase_tools(card: str) -> dict:
    """The two tools end to end (their entry points) with every launch count
    set to 0 just before; returns the four tool kernels' launches."""
    reset_launches()
    for tag in exp_convnext_s12.SHAPES:
        exp_convnext_s12.main([tag, "--iters", "10"])
    for tag in exp_attn_parts.SHAPES:
        exp_attn_parts.main([tag, "--iters", "10"])
    launches = all_launches()
    want = LNMLP_KERNELS + (PARTS, "attn_parts_copy")
    print(f"[tools] launches in the two tools' runs: { {n: launches[n] for n in want} } [{card}]")
    missing = [n for n in want if launches[n] <= 0]
    if missing:
        raise AssertionError(f"the tools' runs launched none of {missing}")
    return {n: launches[n] for n in LNMLP_KERNELS + (PARTS,)}


def phase_spike(card: str, stats: dict) -> dict:
    """K13's three bodies at the spike's shapes against their plain versions
    (direct and int8 exactly, bf16 within 1e-2), w packed by the wrapper and
    beforehand, then the port's ``int8_pallas_spike`` tool (its entry point)
    in ``equiv`` and ``gemm`` modes with every count at 0 just before; the
    tool's timings (kernel and cuBLAS bf16 or ``torch._int_mm`` on a
    column-major w by device time, plain by CUDA events) go into the record.
    Returns the three bodies' launches in the tool's run."""
    for tag, m, k, n in int8_pallas_spike.SHAPES:
        t = int8_pallas_spike.inputs(m, k, n)
        sx = 1.0 / 16.0
        for label, p8, p16 in (("w", {}, {}),
                               ("w_packed", dict(w_packed=Q.pack_weight(t["w8"])),
                                dict(w_packed=Q.pack_weight(t["w16"])))):
            direct = Q.int8_spike_direct(t["x8"], t["w8"], **p8)
            torch.cuda.synchronize()
            for name, got, ref in (
                    ("int8_spike_direct", direct, Q.int8_spike_direct_plain(t["x8"], t["w8"])),
                    ("int8_spike_int8 bf16 x", Q.int8_spike_int8(t["x16"], t["w8"], sx, **p8),
                     Q.int8_spike_int8_plain(t["x16"], t["w8"], sx)),
                    ("int8_spike_int8 f32 x",
                     Q.int8_spike_int8(t["x16"].float(), t["w8"], sx, **p8),
                     Q.int8_spike_int8_plain(t["x16"].float(), t["w8"], sx))):
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name} at {tag} ({label}) is not exact")
                check({name: (got, lambda ref=ref: ref)}, f"{tag} {label}", stats, 0.0)
            check({"int8_spike_bf16": (Q.int8_spike_bf16(t["x16"], t["w16"], **p16), lambda:
                                       Q.int8_spike_bf16_plain(t["x16"], t["w16"], torch.float32))},
                  f"{tag} {label}", stats)
        del t, direct
        torch.cuda.empty_cache()
    reset_launches()
    int8_pallas_spike.main(["equiv"])
    results = int8_pallas_spike.main(["gemm", "--iters", "20"])
    launches = {n: Q.LAUNCHES[n] for n in SPIKE_KERNELS}
    for r in results:
        m, k, n, ms = r["m"], r["k"], r["n"], r["ms"]
        ops = 2 * m * k * n
        for name, body, nbytes, kind in (
                ("int8_spike_bf16", "bf16", 2 * m * k + 2 * k * n + 2 * m * n, "bf16"),
                ("int8_spike_int8", "int8", 2 * m * k + k * n + 4 * m * n, "int8"),
                ("int8_spike_direct", "direct", m * k + k * n + 4 * m * n, "int8")):
            times = (ms[body]["kernel"], ms[body]["plain"], ms[body]["library"])
            bound = account(stats, name, 1, times, nbytes, ops, kind)
            print_launch(name, f"{r['tag']} ({m},{k},{n})", times, bound, card)
    print(f"[tools] launches in the int8_pallas_spike run: {launches} [{card}]")
    if not all(launches.values()):
        raise AssertionError(f"the int8_pallas_spike run launched {launches}")
    return launches


MEMBERS = {  # name: (input size, output width)
    "convnext_tiny_in22k": ((200, 200), 21841),
    "GCViTTiny": ((224, 224), 1000),
}


def _model(name: str, dtype: torch.dtype, **kw) -> torch.nn.Module:
    """Full-width member with seeded random weights; ConvNeXt's layer scale
    ~ U(0.5, 1.5), GCViT's rel-pos tables ~ U(-1, 1) and LN scales
    ~ U(0.5, 1.5), so the blocks' branches matter against the residual."""
    size, _ = MEMBERS[name]
    model, _ = create_model(name, input_size=size, classifier_activation=None, dtype=dtype, seed=0,
                            **kw)
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


def compare_logits(name, label, kernel_model, ref_model, x: torch.Tensor) -> None:
    """The kernel path's logits against the plain f32 and plain bf16 paths."""
    with torch.inference_mode():
        logits = kernel_model(x)
        with plain_kernels():
            ref = ref_model(x)
            plain_bf16 = kernel_model(x)
        torch.cuda.synchronize()
    b, width = x.shape[0], MEMBERS[name][1]
    if logits.shape != (b, width) or not torch.isfinite(logits).all():
        raise AssertionError(f"{label} output {tuple(logits.shape)} not finite ({b}, {width})")
    for path, other in (("plain f32", ref), ("plain bf16", plain_bf16)):
        r = rel_err(logits, other)
        print(f"[model] {label} {x.shape[1]}x{x.shape[2]} b{b} kernel path vs {path} path: "
              f"max|d|/max|ref| = {r:.3e} (bound {MODEL_BOUND:g}), max|ref| = "
              f"{other.float().abs().max().item():.3e}")
        if not r <= MODEL_BOUND:
            raise AssertionError(f"{label} b{b} logits disagree with the {path} path: {r:.3e}")


def time_forward(label: str, fwd, card: str, sites: list, plain: bool = True) -> float:
    """One batch-256 forward timed (CUDA events, in turns): the kernel path,
    where it has stride-1 depthwise sites the same path with cuDNN's
    grouped conv at them (the path before K9 ran them), and with ``plain``
    the plain bf16 path; returns the kernel path's ms."""
    paths = [("kernel path", contextlib.nullcontext)]
    if sites:
        paths.append(("depthwise on cuDNN", cudnn_depthwise))
    if plain:
        paths.append(("plain bf16 path", plain_kernels))
    ms = {}
    for path, ctx in paths + paths[::-1]:
        with ctx():
            ms.setdefault(path, []).append(cuda_ms(fwd, iters=3, warmup=1))
    ms = {path: sum(t) / len(t) for path, t in ms.items()}
    print(f"[model] {label} batch-{BATCH} forward: " + ", ".join(
        f"{path} {t:.2f} ms ({BATCH * 1000 / t:.1f} img/s)" for path, t in ms.items())
        + (f"; {len(sites)} stride-1 depthwise sites, K9 / cuDNN forward "
           f"{ms['kernel path'] / ms['depthwise on cuDNN']:.3f}" if sites else "") + f" [{card}]")
    return ms["kernel path"]


def print_profile(label: str, fwd) -> None:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    print(f"[model] {label} batch-{BATCH} forward profile")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def phase_model(name: str, card: str, profile: bool, **kw) -> tuple:
    """One member against its plain paths, then its batch-256 forward timed;
    ``kw`` (``fused_block``) goes to the model's config. Returns the
    member's stride-1 depthwise sites and its kernel path's forward ms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = name + ("" if kw.get("fused_block", True) else " unfused")
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, w = MEMBERS[name][0]
    x8 = torch.rand((8, h, w, 3), generator=gen, device="cuda")
    xb = torch.rand((BATCH, h, w, 3), generator=gen, device="cuda")
    kernel_model, ref_model = _model(name, torch.bfloat16, **kw), _model(name, torch.float32, **kw)
    compare_logits(name, label, kernel_model, ref_model, x8)
    compare_logits(name, label, kernel_model, ref_model, xb)  # the main path's batch
    del ref_model
    torch.cuda.empty_cache()
    sites = depthwise_sites(kernel_model, (h, w))
    with torch.inference_mode():
        fwd = lambda: kernel_model(xb)  # noqa: E731
        forward_ms = time_forward(label, fwd, card, sites)
        if profile:
            print_profile(label, fwd)
    del kernel_model
    torch.cuda.empty_cache()
    return sites, forward_ms


RESNET_CLASSES = 1000  # the registry's head: the logits' scale spans many classes


def _resnet_state(damped: bool) -> dict:
    """The f32 state of full-width ResNetRS50 at 200 x 200 with seeded random
    weights: BN scale ~ U(0.5, 1), shift ~ U(-0.1, 0.1), and each BN's
    statistics the mean and variance of its input over 16 seeded random
    images, so every BN output is O(1). ``damped`` draws the last BN of each
    residual branch from U(0.1, 0.3) instead, so the branches stay small
    against the shortcut (the common recipe initialises that scale at 0);
    undamped, every one of the 16 branches adds an O(1) term and the bf16
    path drifts further from f32."""
    model, _ = create_model("ResNetRS50", input_size=(200, 200), nb_classes=RESNET_CLASSES,
                            classifier_activation=None, dtype=torch.float32, seed=0)
    return measured_bn_state(model.cuda(), (200, 200),
                             lambda name: damped and name.endswith("batch_norm_3"))


def measured_bn_state(model: torch.nn.Module, size: tuple, damped) -> dict:
    """The f32 ``model``'s state with BN scale ~ U(0.5, 1) (U(0.1, 0.3) where
    ``damped(name)``), shift ~ U(-0.1, 0.1), and each BN's statistics the
    mean and variance of its input over 16 seeded random images (the plain
    path's), so every BN output is O(1). A BN on pooled features (one
    spatial position: ResNest's split-attention ``sa_2_bn``) keeps mean 0
    and variance 1: random weights pool noise images to nearly one vector,
    and the variance measured across them would have the BN blow up the
    bf16 rounding of its input."""
    gen = torch.Generator().manual_seed(1)

    def measure(bn, args):
        x = args[0].float()
        if x.shape[1] * x.shape[2] == 1:
            return
        bn.running_mean.copy_(x.mean(dim=(0, 1, 2)))
        bn.running_var.copy_(x.var(dim=(0, 1, 2), unbiased=False))

    hooks = []
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                lo, hi = (0.1, 0.3) if damped(name) else (0.5, 1.0)
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) * (hi - lo) + lo)
                m.bias.copy_(torch.rand(m.bias.shape, generator=gen) * 0.2 - 0.1)
                hooks.append(m.register_forward_pre_hook(measure))
        x = torch.rand((16, *size, 3), generator=torch.Generator(device="cuda").manual_seed(9),
                       device="cuda")
        with plain_kernels():
            model(x)
        for h in hooks:
            h.remove()
    return model.state_dict()


EFFNETS = {"EfficientNetV2T": (200, 200), "EfficientNetV1B4": (224, 224)}  # manifest sizes
# the conv members' manifest sizes
SIZES = {**EFFNETS, "ResNetRS50": (200, 200), "ResNest50": (200, 200), "ECA_NFNetL0": (200, 200)}
# stride-1 depthwise convs per forward: V2T's MBConv stages 3-5 (6 + 9 + 14
# blocks less two strided), V1B4's 32 blocks less four strided; none elsewhere
DW_SITES = {"EfficientNetV2T": 27, "EfficientNetV1B4": 28}


def _member(name: str, dtype: torch.dtype, state: dict = None) -> torch.nn.Module:
    """Full-width ``name`` at its manifest size with the registry's
    1000-class head, logits out; ``state`` loaded where given."""
    model, _ = create_model(name, input_size=SIZES[name], classifier_activation=None,
                            dtype=dtype, seed=0)
    if state is not None:
        model.load_state_dict(state)
    return model.cuda()


def _effnet_state(name: str) -> dict:
    """Full-width ``name`` at its manifest size (the registry's 1000-class
    head) with seeded random weights and measured BN statistics
    (:func:`measured_bn_state`), the last BN of each residual branch (the
    projection's, in a block that takes the shortcut) damped to
    U(0.1, 0.3), so the 29-39 blocks stay O(1) in bf16."""
    model = _member(name, torch.float32)
    damped = {spec.name + ("fu_bn" if spec.fused and not spec.expand else "MB_pw_bn")
              for spec in model.blocks if spec.shortcut}
    return measured_bn_state(model, EFFNETS[name], lambda n: n in damped)


def _resnest_state() -> dict:
    """Full-width ResNest50 at 200 x 200 with seeded random weights and
    measured BN statistics (:func:`measured_bn_state`), each block's closing
    ``3_bn`` (zero at the JAX init, which makes every deep branch add 0)
    damped to U(0.1, 0.3)."""
    return measured_bn_state(_member("ResNest50", torch.float32), SIZES["ResNest50"],
                             lambda n: n.endswith("_3_bn"))


def _nfnet_state() -> dict:
    """Full-width ECA_NFNetL0 at 200 x 200 with seeded random weights, each
    standardized conv's per-filter gain ~ U(0.5, 1.5) and every bias ~
    U(-0.1, 0.1) (off their 1 / 0 init, so every leaf matters); no BN to
    measure: the standardized convs keep the activations O(1)."""
    model = _member("ECA_NFNetL0", torch.float32)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith(".gain"):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
            elif pname.endswith(".bias"):
                p.copy_(torch.rand(p.shape, generator=gen) * 0.2 - 0.1)
    return model.state_dict()


@contextlib.contextmanager
def recording_batchnorms(model: torch.nn.Module, calls: list):
    """Record (input shape without the batch, dtype) of each BN call."""
    hooks = [m.register_forward_pre_hook(
        lambda bn, args: calls.append((bn, tuple(args[0].shape[1:]), args[0].dtype)))
        for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def batchnorm_ms(model: torch.nn.Module, size: tuple) -> tuple:
    """(ms, count) of the plain BNs of one batch-256 forward: each BN call
    recorded in a batch-1 forward, then timed alone (CUDA events) on a
    batch-256 input of its shape."""
    calls = []
    with torch.inference_mode(), recording_batchnorms(model, calls):
        model(torch.rand((1, *size, 3), device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(12)
    total = 0.0
    with torch.inference_mode():
        for bn, shape, dtype in calls:
            x = torch.randn((BATCH, *shape), generator=gen, device="cuda").to(dtype)
            total += cuda_ms(lambda: bn(x), iters=5, warmup=1)
            del x
    torch.cuda.empty_cache()
    return total, len(calls)


def phase_member(name: str, card: str, profile: bool, state: dict) -> tuple:
    """Full-width ``name`` (an EfficientNet, :func:`_effnet_state`, or
    ECA_NFNetL0, :func:`_nfnet_state`, as ``state``): its kernel path (bf16,
    K9 at every stride-1 depthwise site, cuDNN elsewhere, plain BN) against
    the plain f32 path within 5e-2 of max|ref| at batch 8 and 256; its
    batch-256 forward timed, with K9 and with cuDNN at its depthwise sites
    where it has any, its plain BNs' share where it has BNs; ``--profile``
    adds a profiler table. Returns its depthwise sites and the kernel path's
    forward ms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size = SIZES[name]
    kernel_model, ref_model = _member(name, torch.bfloat16, state), _member(name, torch.float32,
                                                                            state)
    del state
    sites = depthwise_sites(kernel_model, size)
    print(f"[model] {name} {size[0]}x{size[1]}: {len(sites)} stride-1 depthwise sites per "
          f"forward (expected {DW_SITES.get(name, 0)}), {len(kernel_model.blocks)} blocks")
    if len(sites) != DW_SITES.get(name, 0):
        raise AssertionError(f"{name} runs K9 at {len(sites)} sites")
    gen = torch.Generator(device="cuda").manual_seed(10)
    for b in (8, BATCH):
        x = torch.rand((b, *size, 3), generator=gen, device="cuda")
        with torch.inference_mode():
            logits = kernel_model(x)
            with plain_kernels():
                ref = ref_model(x)
            torch.cuda.synchronize()
        if logits.shape != (b, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"{name} output {tuple(logits.shape)} not finite (b, 1000)")
        r = rel_err(logits, ref)
        print(f"[model] {name} b{b} kernel path vs plain f32 path: max|d|/max|ref| = {r:.3e} "
              f"(bound {MODEL_BOUND:g}), max|ref| = {ref.float().abs().max().item():.3e}")
        if not r <= MODEL_BOUND:
            raise AssertionError(f"{name} b{b} logits disagree with the plain f32 path: {r:.3e}")
        del x, logits, ref
    del ref_model
    torch.cuda.empty_cache()
    xb = torch.rand((BATCH, *size, 3), generator=gen, device="cuda")
    with torch.inference_mode():
        fwd = lambda: kernel_model(xb)  # noqa: E731
        forward_ms = time_forward(name, fwd, card, sites, plain=False)
        bn_ms, n_bn = batchnorm_ms(kernel_model, size)
        if n_bn:
            print(f"[model] {name} plain BN: {n_bn} calls, {bn_ms:.2f} ms alone per "
                  f"batch-{BATCH} forward, {100 * bn_ms / forward_ms:.1f} % of the kernel path's "
                  f"{forward_ms:.2f} ms [{card}]")
        if profile:
            print_profile(name, fwd)
    del kernel_model, xb
    torch.cuda.empty_cache()
    return sites, forward_ms


@contextlib.contextmanager
def recording_ptq_sites(calls: list):
    """Record (input shape without the batch, kernel, stride, padding, N) of
    each ``ptq_int8_conv`` call."""
    real = Q.ptq_int8_conv

    def record(x, qweight, *args, **kw):
        calls.append((tuple(x.shape[1:]), kw["kernel"], kw["stride"], kw["padding"],
                      qweight.shape[0]))
        return real(x, qweight, *args, **kw)

    Q.ptq_int8_conv = record
    try:
        yield
    finally:
        Q.ptq_int8_conv = real


def _int8_compare(name: str, draw: str, state: dict, x8: torch.Tensor, xb: torch.Tensor,
                  gate_bf16: bool) -> tuple:
    """One weight draw of an int8 member (ResNetRS50 or ResNest50): the f32,
    bf16 and int8 (calibrated on 64 images, the engine's count, weights
    quantized from ``state``) models at batch 8 and 256. The int8 kernel path
    must equal the plain int8 version within 5e-2 and quantize the JAX
    pass's sites; the bf16 path is held to 5e-2 of the plain f32 path when
    ``gate_bf16``, else reported; int8 against bf16 is reported with the
    decisions at 0.487 that flip between them (the sigmoid of logit 0,
    centred on the f32 path's batch median: random weights put every image
    on one side otherwise). Returns the bf16 and int8 models, the int8
    sites called in one forward and the calibrated site count."""
    ref_model, bf16_model, int8_model = (_member(name, d, state) for d in (
        torch.float32, torch.bfloat16, torch.bfloat16))
    scales = quant.calibrate(int8_model, [xb[:64]])
    report = {}
    quant.quantized(int8_model, scales, report=report, weights=state)
    calls = []
    with torch.inference_mode(), recording_ptq_sites(calls):
        int8_model(x8[:1])
    print(f"[resnet] {name} {draw}: int8 {len(scales)} calibrated sites, "
          f"{len(report['quantized_sites'])} quantized, {len(calls)} kernel calls per forward "
          f"(JAX: {INT8_SITES[name]})")
    if not len(scales) == len(report["quantized_sites"]) == len(calls) == INT8_SITES[name]:
        raise AssertionError(f"{name}'s int8 sites differ from the JAX pass's {INT8_SITES[name]}")
    for x in (x8, xb):
        with torch.inference_mode():
            f32, bf16, i8 = ref_model(x), bf16_model(x), int8_model(x)
            with plain_kernels():
                i8_plain = int8_model(x)
            torch.cuda.synchronize()
        b = x.shape[0]
        for label, got, ref, gated in (("bf16 path vs plain f32", bf16, f32, gate_bf16),
                                       ("int8 kernel path vs plain int8", i8, i8_plain, True)):
            if got.shape != (b, RESNET_CLASSES) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {label}: output {tuple(got.shape)} not finite")
            r = rel_err(got, ref)
            print(f"[resnet] {name} {draw} b{b} {label}: max|d|/max|ref| = {r:.3e} "
                  f"({f'bound {MODEL_BOUND:g}' if gated else 'reported, not gated'}), max|ref| = "
                  f"{ref.float().abs().max().item():.3e}")
            if gated and not r <= MODEL_BOUND:
                raise AssertionError(f"{name} {draw} b{b} {label}: {r:.3e} > {MODEL_BOUND:g}")
        shift = float(np.log(0.487 / 0.513)) - f32[:, 0].median()
        p_i8, p_bf16 = (torch.sigmoid(t[:, 0].float() + shift) for t in (i8, bf16))
        flips = (p_i8 > 0.487) != (p_bf16 > 0.487)
        print(f"[resnet] {name} {draw} b{b} int8 vs bf16: max|d|/max|ref| = "
              f"{rel_err(i8, bf16):.3e}; {int(flips.sum())} of {b} decisions flip at 0.487 "
              f"(logit 0 centred, bf16 p in [{p_bf16.min().item():.4f}, "
              f"{p_bf16.max().item():.4f}], max|p_int8 - p_bf16| = "
              f"{(p_i8 - p_bf16).abs().max().item():.2e})")
    del ref_model
    torch.cuda.empty_cache()
    return bf16_model, int8_model, calls, len(scales)


def phase_int8_member(name: str, card: str, profile: bool) -> tuple:
    """An int8 member at 200 x 200 through :func:`_int8_compare`: ResNetRS50
    on two weight draws (``_resnet_state``), undamped, whose drift is
    reported beside the int8 numbers it changes, then damped, whose bf16
    path (plain convs, no kernel) is held to the plain f32 path; ResNest50
    on its damped draw (:func:`_resnest_state`). Then the damped draw's
    batch-256 bf16 and int8 forwards timed. Returns the int8 sites called in
    one forward and the calibrated site count."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    x8 = torch.rand((8, *SIZES[name], 3), generator=gen, device="cuda")
    xb = torch.rand((BATCH, *SIZES[name], 3), generator=gen, device="cuda")
    if name == "ResNetRS50":
        undamped = _int8_compare(name, "undamped", _resnet_state(damped=False), x8, xb,
                                 gate_bf16=False)
        del undamped
        torch.cuda.empty_cache()
        state = _resnet_state(damped=True)
    else:
        state = _resnest_state()
    bf16_model, int8_model, calls, n_scales = _int8_compare(name, "damped", state, x8, xb,
                                                            gate_bf16=True)
    with torch.inference_mode():
        fwd_b, fwd_i = (lambda: bf16_model(xb)), (lambda: int8_model(xb))
        b1, i1, i2, b2 = (cuda_ms(f, iters=5, warmup=1) for f in (fwd_b, fwd_i, fwd_i, fwd_b))
        print(f"[resnet] {name} batch-{BATCH} forward: bf16 (cuDNN convs) {(b1 + b2) / 2:.2f} "
              f"ms ({BATCH * 2000 / (b1 + b2):.1f} img/s), int8 (ptq_int8_conv) {(i1 + i2) / 2:.2f} "
              f"ms ({BATCH * 2000 / (i1 + i2):.1f} img/s) [{card}]")
        bn_ms, n_bn = batchnorm_ms(bf16_model, SIZES[name])
        print(f"[resnet] {name} plain BN: {n_bn} calls, {bn_ms:.2f} ms alone per batch-{BATCH} "
              f"forward, {200 * bn_ms / (b1 + b2):.1f} % of the bf16 forward [{card}]")
        if profile:
            print_profile(f"{name} bf16", fwd_b)
            print_profile(f"{name} int8", fwd_i)
    del bf16_model, int8_model
    torch.cuda.empty_cache()
    return calls, n_scales


def phase_ptq_sites(card: str, stats: dict, calls: list, name: str = "ResNetRS50",
                    tool: bool = True) -> None:
    """The int8 PTQ site at every int8 site shape of ``name`` (recorded from
    one forward), batch 8 and 256, bf16 x and output as on the path: its
    quantize pass (``ptq_int8_quantize``) exactly its plain version, its
    GEMM (``ptq_int8_conv``'s launch, ``ptq_int8_gemm``, on x quantized by
    the pass or, at a site that quantizes in the GEMM, on x itself) and the
    whole site within 1e-6 of max|ref| of their plain versions (int8
    products summed in f64); timed at batch 256 beside their plain versions
    (the pass only at the sites that run it), and the site beside cuDNN's
    bf16 conv of the same site for context (no one call computes the int8
    site, so no library time); then, with ``tool``, the ``exp_ptq_int8``
    tool's phase cuts."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    per_forward = Counter(calls)
    before = snapshot(stats)
    cudnn_total = int_mm_total = site_total = 0.0
    for b in (8, BATCH):
        for (shape, kernel, stride, padding, n), count in per_forward.items():
            h, w, c = shape
            x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
            k = kernel * kernel * c
            qw = Q.pack_weight(torch.randint(-127, 128, (k, n), generator=gen, device="cuda")
                               .to(torch.int8))
            cs = torch.rand((n,), generator=gen, device="cuda") * 1e-3
            inv = Q.f32_reciprocal(x.float().abs().max().item() / 127.0)
            kw = dict(kernel=kernel, stride=stride, padding=padding)
            gkw = dict(kw, out_dtype=torch.bfloat16)
            out = Q.ptq_int8_conv(x, qw, cs, None, inv, **kw)
            xq = Q.ptq_int8_quantize(x, inv)
            # the GEMM's A as the site gives it: x quantized by the pass, or x itself
            in_gemm = Q.quantizes_in_gemm(x.dtype, x.dtype, k=k, n=n, **kw)
            a, a_inv = (x, inv) if in_gemm else (xq, None)
            gemm = Q.ptq_int8_gemm(a, qw, cs, None, inv_s=a_inv, **gkw)
            torch.cuda.synchronize()
            label = (f"{name} b{b} {(b, h, w, c)} -> {n} k{kernel} s{stride} x{count}"
                     + (" quantized in the GEMM" if in_gemm else ""))
            if not torch.equal(xq, Q.ptq_int8_quantize_plain(x, inv)):
                raise AssertionError(f"{QUANT} at {label} differs from its plain version")
            check({QUANT: (xq, lambda: Q.ptq_int8_quantize_plain(x, inv))}, label, stats, 0.0)
            check({PTQ: (gemm, lambda: Q.ptq_int8_gemm_plain(xq, qw, cs, None, **gkw)),
                   f"{PTQ} (whole site)": (out, lambda: Q.ptq_int8_conv_plain(
                       x, qw, cs, None, inv, **kw))}, label, stats, INT8_BOUND)
            if b == BATCH:
                m = out.numel() // n
                g_times = time_calls(lambda: Q.ptq_int8_gemm(a, qw, cs, None, inv_s=a_inv, **gkw),
                                     lambda: Q.ptq_int8_gemm_plain(xq, qw, cs, None, **gkw))
                site = cuda_ms(lambda: Q.ptq_int8_conv(x, qw, cs, None, inv, **kw))
                site_total += count * site
                wc = torch.randn((n, c, kernel, kernel), generator=gen, device="cuda").to(
                    torch.bfloat16)
                xc = x.permute(0, 3, 1, 2)
                cudnn = cuda_ms(lambda: torch.nn.functional.conv2d(xc, wc, None, stride, padding))
                cudnn_total += count * cudnn
                if kernel == 1:  # a 1 x 1 site is an (M, K) @ (K, N) product
                    xr = xq.view(-1, c)
                    wq = qw[:, :c].contiguous()  # (N, K): the column-major B cuBLASLt takes
                    int_mm = cuda_ms(lambda: torch._int_mm(xr, wq.t()))
                    int_mm_total += count * int_mm
                if not in_gemm:  # the pass: bf16 x read, int8 written
                    q_times = time_calls(lambda: Q.ptq_int8_quantize(x, inv),
                                         lambda: Q.ptq_int8_quantize_plain(x, inv))
                    q_bound = account(stats, QUANT, count, q_times, x.numel() * 3, x.numel(),
                                      "f32")
                    print_launch(QUANT, label, q_times, q_bound, card)
                a_bytes = x.numel() * a.element_size()  # int8 after the pass, else bf16
                g_bound = account(stats, PTQ, count, g_times, a_bytes + k * n + m * n * 2 + n * 4,
                                  2 * m * k * n, "int8")
                print_launch(PTQ, label, g_times, g_bound, card)
                print(f"[kernels] {'':26s} the site (both launches) {site:.3f} ms; cuDNN bf16 conv "
                      f"of the same site {cudnn:.3f} ms"
                      + (f", torch._int_mm on its pre-quantized rows {int_mm:.3f} ms"
                         if kernel == 1 else ""))
            del x, qw, out, xq, gemm, a
            torch.cuda.empty_cache()
    print_per_forward(stats, before, (QUANT, PTQ), f"{name} batch-256 int8 forward "
                      f"({sum(per_forward.values())} sites)", card)
    print(f"[kernels] the {sum(per_forward.values())} int8 sites per {name} batch-256 forward: "
          f"both launches {site_total:.2f} ms; in cuDNN bf16 convs {cudnn_total:.2f} ms; the "
          f"1 x 1 sites as torch._int_mm on pre-quantized rows {int_mm_total:.2f} ms [{card}]")
    if tool:
        exp_ptq_int8.main(["--iters", "10"])  # the site's phase cuts


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


# the members of ckpts/ckpts.json, all seven ported, in its order
MANIFEST = [["convnext_tiny_in22k-200x200", [200, 200], 0], ["ResNest50-200x200", [200, 200], 0],
            ["GCViTTiny-224x224", [224, 224], 0], ["EfficientNetV2T-200x200", [200, 200], 0],
            ["EfficientNetV1B4-224x224", [224, 224], 0], ["ECA_NFNetL0-200x200", [200, 200], 0],
            ["ResNetRS50-200x200", [200, 200], 0]]
ENTRY = {base: [base, dim, idx] for base, dim, idx in MANIFEST}
TWO = [ENTRY["convnext_tiny_in22k-200x200"], ENTRY["GCViTTiny-224x224"]]
THREE = TWO + [ENTRY["ResNetRS50-200x200"]]


@contextlib.contextmanager
def csv_workspace(manifest: list):
    """A temporary workspace of ``N_IMAGES`` random JPEGs, an input CSV
    listing them in reverse order and a random-init ``manifest``, with the
    engine's environment pointed at it; yields (input CSV, output CSV, batch
    times path, the image names)."""
    with tempfile.TemporaryDirectory() as ws:
        img_dir = os.path.join(ws, "images")
        os.makedirs(img_dir)
        names = _write_images(img_dir, N_IMAGES)
        input_csv = os.path.join(img_dir, "input.csv")
        with open(input_csv, "w") as fh:
            fh.write("filename\n" + "".join(f"{n}\n" for n in reversed(names)))
        os.makedirs(os.path.join(ws, "ckpts"))
        with open(os.path.join(ws, "ckpts", "ckpts.json"), "w") as fh:
            json.dump(manifest, fh)
        print(f"[slice] {N_IMAGES} JPEGs written, manifest {[m[0] for m in manifest]}")
        os.environ.update(VIPTPU_CKPT_DIR=os.path.join(ws, "ckpts"), VIPTPU_ALLOW_RANDOM_INIT="1",
                          VIPTPU_MAX_BATCH=str(BATCH), VIPTPU_VERBOSE="1")
        yield (input_csv, os.path.join(ws, "output.csv"), os.path.join(ws, "batch_times.json"),
               names)


def run_csv(input_csv: str, output_csv: str, names: list, batch_times: str = "") -> tuple:
    """One ``main_torch`` CSV run with every launch count set to 0 just
    before it; returns (launches, seconds, per-batch e2e seconds or None,
    the engine's result with its raw means) after checking the CSV."""
    if batch_times:
        os.environ["VIPTPU_E2E_BATCH_TIMES"] = batch_times
    reset_launches()
    t0 = time.perf_counter()
    result = main_torch.main(["main_torch.py", input_csv, output_csv])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    batch_s = None
    if batch_times:
        del os.environ["VIPTPU_E2E_BATCH_TIMES"]
        with open(batch_times) as fh:
            batch_s = json.load(fh)["batch_e2e_s"]
    with open(output_csv) as fh:
        lines = fh.read().splitlines()
    if lines[0] != "filename,logit" or len(lines) != N_IMAGES + 1:
        raise AssertionError(f"CSV has {len(lines) - 1} rows / header {lines[0]!r}")
    rows = [ln.split(",") for ln in lines[1:]]
    if [r[0] for r in rows] != sorted(names) or not {r[1] for r in rows} <= {"0.0", "1.0"}:
        raise AssertionError("CSV rows are not the sorted filenames with logits in {0.0, 1.0}")
    print(f"[slice] CSV: {len(rows)} sorted rows, logits {sorted({r[1] for r in rows})}")
    return launches, seconds, batch_s, result


def expect_launches(launches: dict, want: dict, label: str) -> None:
    """``want``: name -> exact count, or None for "at least once"."""
    print(f"[slice] launches in the {label} run: {launches}")
    bad = {n: launches[n] for n, w in want.items()
           if (launches[n] <= 0 if w is None else launches[n] != w)}
    if bad:
        raise AssertionError(f"the {label} run launched {bad}; expected {want}")


def phase_slice(card: str) -> dict:
    """The two-member CSV run: fused cold and warm, then unfused; returns
    each kernel's launches from the run of its path."""
    batches = -(-N_IMAGES // BATCH)
    os.environ.pop("VIPTPU_NO_FUSED_BLOCK", None)
    with csv_workspace(TWO) as (input_csv, output_csv, times, names):
        fused, cold, *_ = run_csv(input_csv, output_csv, names)
        _, warm, batch_s, _ = run_csv(input_csv, output_csv, names, times)
        os.environ["VIPTPU_NO_FUSED_BLOCK"] = "1"
        try:
            unfused, t_unfused, batch_u, _ = run_csv(input_csv, output_csv, names, times)
        finally:
            del os.environ["VIPTPU_NO_FUSED_BLOCK"]

    expect_launches(fused, {**{n: None for n in GCVIT_KERNELS},
                            "dwconv7x7_nhwc": batches * CONVNEXT_BLOCKS,
                            "ln_qkv": batches * GCVIT_BLOCKS,
                            "proj_scale_residual": batches * GCVIT_BLOCKS,
                            **{n: batches * (CONVNEXT_BLOCKS + GCVIT_BLOCKS) for n in MLP_KERNELS},
                            ATTN: 0, LN: batches * (CONVNEXT_LNS + GCVIT_LNS)}, "fused CSV->CSV")
    expect_launches(unfused, {**{n: 0 for n in CONVNEXT_KERNELS + GCVIT_KERNELS},
                              ATTN: batches * GCVIT_BLOCKS,
                              DW: batches * (CONVNEXT_BLOCKS + GCVIT_DW_SITES),
                              LN: batches * (CONVNEXT_LNS + CONVNEXT_BLOCKS + GCVIT_LNS
                                             + 2 * GCVIT_BLOCKS)},
                    "unfused CSV->CSV")
    ms = lambda s: ", ".join(f"{t * 1000:.1f} ms" for t in s)  # noqa: E731
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, 2 members: cold {cold:.2f} s "
          f"({N_IMAGES / cold:.1f} img/s), warm {warm:.2f} s ({N_IMAGES / warm:.1f} img/s); "
          f"warm per-batch e2e {ms(batch_s)} [{card}]")
    print(f"[slice] CSV->CSV with VIPTPU_NO_FUSED_BLOCK=1: {t_unfused:.2f} s "
          f"({N_IMAGES / t_unfused:.1f} img/s); per-batch e2e {ms(batch_u)} [{card}]")
    return {**{n: fused[n] for n in CONVNEXT_KERNELS + GCVIT_KERNELS},
            ATTN: unfused[ATTN], LN: unfused[LN]}


def pass_sites(calls: list) -> int:
    """How many of one forward's int8 sites (bf16 x and output, as the
    model runs them) run the quantize pass: the rest quantize in the GEMM."""
    return sum(not Q.quantizes_in_gemm(torch.bfloat16, torch.bfloat16, kernel, stride, padding,
                                       (kernel or 1) ** 2 * shape[-1], n)
               for shape, kernel, stride, padding, n in calls)


def phase_slice_int8(card: str, sites: int, passes: int) -> dict:
    """A three-member CSV run (ConvNeXt, GCViT, ResNetRS50) without int8,
    then with ``VIPTPU_INT8=ResNetRS50``, which must launch ``ptq_int8_conv``
    at every calibrated site of each batch, ``ptq_int8_quantize`` at the
    ``passes`` of them that run the pass, and nothing else of int8; returns
    the int8 run's launches of the two."""
    batches = -(-N_IMAGES // BATCH)
    with csv_workspace(THREE) as (input_csv, output_csv, times, names):
        plain, t_plain, batch_p, _ = run_csv(input_csv, output_csv, names, times)
        os.environ["VIPTPU_INT8"] = "ResNetRS50"
        try:
            int8, t_int8, batch_i, _ = run_csv(input_csv, output_csv, names, times)
        finally:
            del os.environ["VIPTPU_INT8"]
    fused = {n: None for n in CONVNEXT_KERNELS + GCVIT_KERNELS}
    expect_launches(plain, {**fused, PTQ: 0, QUANT: 0, LN: batches * (CONVNEXT_LNS + GCVIT_LNS)},
                    "three-member CSV->CSV")
    expect_launches(int8, {**fused, PTQ: batches * sites, QUANT: batches * passes,
                           **{n: 0 for n in SPIKE_KERNELS}},
                    "three-member VIPTPU_INT8=ResNetRS50 CSV->CSV")
    ms = lambda s: ", ".join(f"{t * 1000:.1f} ms" for t in s)  # noqa: E731
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, 3 members (ResNetRS50 bf16): "
          f"{t_plain:.2f} s ({N_IMAGES / t_plain:.1f} img/s); per-batch e2e {ms(batch_p)} [{card}]")
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, 3 members, VIPTPU_INT8=ResNetRS50: "
          f"{t_int8:.2f} s ({N_IMAGES / t_int8:.1f} img/s); per-batch e2e {ms(batch_i)} [{card}]")
    return {n: int8[n] for n in (QUANT, PTQ)}


def phase_slice_seven(card: str, dw_sites: int, int8_sites: int, int8_passes: int) -> dict:
    """The product contract: the seven members of ``ckpts/ckpts.json``
    (``MANIFEST``, checked against the file) through ``main_torch.main``,
    cold and warm: every kernel of the fused block families at each block,
    the LN kernel at each standalone LN, K9 at each of the ``dw_sites``
    stride-1 depthwise sites of one forward (GCViT's and both
    EfficientNets'), per batch, and no int8 kernel. Then warm with
    ``VIPTPU_INT8=ResNetRS50,ResNest50`` (the JAX package's ``INT8_AUTO``
    set): the same, and ``ptq_int8_conv`` at the ``int8_sites`` of both
    members and ``ptq_int8_quantize`` at the ``int8_passes`` of them that
    run the pass, per batch. Returns K9's launches in the cold run and the
    int8 kernels' in the int8 run."""
    with open(os.path.join(REPO, "ckpts", "ckpts.json")) as fh:
        if json.load(fh) != MANIFEST:
            raise AssertionError("MANIFEST is not ckpts/ckpts.json")
    batches = -(-N_IMAGES // BATCH)
    with csv_workspace(MANIFEST) as (input_csv, output_csv, times, names):
        cold_launches, cold, batch_c, _ = run_csv(input_csv, output_csv, names, times)
        warm_launches, warm, batch_w, _ = run_csv(input_csv, output_csv, names, times)
        os.environ["VIPTPU_INT8"] = "ResNetRS50,ResNest50"
        try:
            int8_launches, t_int8, batch_i, _ = run_csv(input_csv, output_csv, names, times)
        finally:
            del os.environ["VIPTPU_INT8"]
    fused = seven_launches(batches, dw_sites)
    for label, launches in (("seven-member cold", cold_launches),
                            ("seven-member warm", warm_launches)):
        expect_launches(launches, {**fused, PTQ: 0, QUANT: 0}, f"{label} CSV->CSV")
    expect_launches(int8_launches, {**fused, PTQ: batches * int8_sites,
                                    QUANT: batches * int8_passes,
                                    **{n: 0 for n in SPIKE_KERNELS}},
                    "seven-member VIPTPU_INT8=ResNetRS50,ResNest50 CSV->CSV")
    ms = lambda s: ", ".join(f"{t * 1000:.1f} ms" for t in s)  # noqa: E731
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, 7 members: cold {cold:.2f} s "
          f"({N_IMAGES / cold:.1f} img/s; per-batch e2e {ms(batch_c)}), warm {warm:.2f} s "
          f"({N_IMAGES / warm:.1f} img/s; per-batch e2e {ms(batch_w)}) [{card}]")
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, 7 members, "
          f"VIPTPU_INT8=ResNetRS50,ResNest50: {t_int8:.2f} s ({N_IMAGES / t_int8:.1f} img/s; "
          f"per-batch e2e {ms(batch_i)}) [{card}]")
    return {DW: cold_launches[DW], PTQ: int8_launches[PTQ], QUANT: int8_launches[QUANT]}


def seven_launches(forwards: int, dw_sites: int) -> dict:
    """The launches ``forwards`` forwards of the seven members make on the
    fused block path, bf16: every fused-block kernel at each block, the LN
    kernel at each standalone LN, K9 at each of the ``dw_sites``; no
    unfused attention and no int8 kernel."""
    return {**{n: None for n in GCVIT_KERNELS}, "dwconv7x7_nhwc": forwards * CONVNEXT_BLOCKS,
            "ln_qkv": forwards * GCVIT_BLOCKS, "proj_scale_residual": forwards * GCVIT_BLOCKS,
            **{n: forwards * (CONVNEXT_BLOCKS + GCVIT_BLOCKS) for n in MLP_KERNELS},
            ATTN: 0, LN: forwards * (CONVNEXT_LNS + GCVIT_LNS), DW: forwards * dw_sites,
            PTQ: 0, QUANT: 0}


@contextlib.contextmanager
def knobs(**env):
    """The engine's environment knobs set for the block, then restored."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the block kernels' wrappers whose leading dimension (the batch of a
# (B, ...) input, the rows of an (M, C) one) the TTA runs record
BATCHED = ((K, ("dwconv7x7_nhwc", "ln_fc1_gelu", "fc2_scale_residual")),
           (G, ("ln_qkv", "window_attention", "proj_scale_residual")), (L, (LN,)), (D, (DW,)))


@contextlib.contextmanager
def recording_leading_dims(seen: dict):
    """Record in ``seen`` the largest leading dimension each of ``BATCHED``'s
    wrappers is called with."""
    saved = []
    for module, names in BATCHED:
        for name in names:
            real = getattr(module, name)

            def record(x, *args, _real=real, _name=name, **kw):
                seen[_name] = max(seen.get(_name, 0), x.shape[0])
                return _real(x, *args, **kw)

            saved.append((module, name, real))
            setattr(module, name, record)
    try:
        yield
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


@contextlib.contextmanager
def binary_heads():
    """Members built with one sigmoid output, the head of the product's
    checkpoints, in place of the registry's softmax over 1000 or 21841
    classes, whose ``1 - p[:, 0]`` sits near 1 whatever the features."""
    real = engine.create_model

    def create(name, **kw):
        return real(name, **{"nb_classes": 1, "classifier_activation": "sigmoid", **kw})

    engine.create_model = create
    try:
        yield
    finally:
        engine.create_model = real


@contextlib.contextmanager
def recording_folds(pairs: list):
    """Record how many conv -> BN pairs each of the engine's folds finds."""
    real = engine.fuse_all_conv_bn

    def record(tree, *args, **kw):
        out = real(tree, *args, **kw)
        pairs.append(len(out[1]))
        return out

    engine.fuse_all_conv_bn = record
    try:
        yield
    finally:
        engine.fuse_all_conv_bn = real


def check_fold_batch(card: str, stats: dict, dw_sites: list) -> None:
    """One kernel of each family at the batch TTA's fold mode gives them
    (2 x 256), against its plain version under its usual bound: the
    ConvNeXt stage-1 block's three, a GCViT level-1 block's five, K9 at the
    largest of ``dw_sites`` and the LN at ConvNeXt's stem LN."""
    b = 2 * BATCH
    gen = torch.Generator(device="cuda").manual_seed(17)
    torch.cuda.empty_cache()
    h, w, c, _ = STAGES[0]
    check_stage(run_stage(b, h, w, c, gen), (b, h, w, c), stats)
    torch.cuda.empty_cache()
    run_check_level(b, LEVELS[0], gen, stats)
    torch.cuda.empty_cache()
    shape, k, pad = max(dw_sites, key=lambda site: np.prod(site[0]))
    x = torch.rand((b, *shape), generator=gen, device="cuda").to(torch.bfloat16)
    kern = (torch.rand((k, k, shape[-1]), generator=gen, device="cuda") - 0.5).to(torch.bfloat16)
    out = D.depthwise_conv_nhwc(x, kern, padding=pad)
    check({DW: (out, lambda: D.depthwise_conv_nhwc_plain(x.float(), kern, padding=pad))},
          f"b{b} {shape} k{k} pad {pad}", stats)
    del x, kern, out
    x = (torch.rand((b, h, w, c), generator=gen, device="cuda") * 4 - 2).to(torch.bfloat16)
    lw = torch.rand((c,), generator=gen, device="cuda") + 0.5
    lb = torch.rand((c,), generator=gen, device="cuda") * 0.2 - 0.1
    out = L.layer_norm(x, lw, lb, 1e-6)
    check({LN: (out, lambda: L.layer_norm_plain(x.float(), lw, lb, 1e-6))},
          f"{tuple(x.shape)} eps 1e-06", stats)
    del x, out
    torch.cuda.empty_cache()
    print(f"[serving] the block kernels, K9 and the LN hold at batch {b} [{card}]")


def compare_raw(label: str, got: dict, ref: dict, ref_label: str, bound=SERVING_BOUND) -> None:
    """The max |d| of two runs' raw means (same sorted filenames), printed
    with the decisions they flip at 0.487; within ``bound`` unless None."""
    if list(got["filename"]) != list(ref["filename"]):
        raise AssertionError(f"{label} and {ref_label} scored other filenames")
    d = float(np.abs(got["raw"] - ref["raw"]).max())
    flips = int(((got["raw"] > 0.487) != (ref["raw"] > 0.487)).sum())
    print(f"[serving] raw means, {label} against {ref_label}: max|d| {d:.3e}, "
          f"{flips} of {len(ref['raw'])} decisions flip at 0.487 (bound {bound})")
    if bound is not None and not d <= bound:
        raise AssertionError(f"{label} is {d:.3e} off {ref_label}, over {bound:g}")


def phase_serving(card: str, stats: dict, dw_sites: list) -> None:
    """The serving options on the seven-member manifest and its 300 JPEGs,
    each member with a one-output sigmoid head (:func:`binary_heads`): the
    plain fused run; ``VIPTPU_TTA=2`` in map mode, every block kernel, the
    LN kernel and K9 launched twice a batch; the batch-512 kernel checks;
    fold mode, once a batch at twice map mode's leading dimensions (batch
    512), its raw means within 1e-2 of map mode's; ``VIPTPU_FUSED=0``, each
    member at its own batch 128, the same kernels per member's batch,
    within 1e-2 of the fused run; and ``VIPTPU_FUSE_BN=all``, each member's
    folded pairs JAX's count, within 1e-2 of the unfolded run."""
    batches = -(-N_IMAGES // BATCH)
    seq_batch = 8 * 16  # NAME2BS's default for every member of the manifest
    seq_batches = -(-N_IMAGES // seq_batch)
    ms = lambda s: ", ".join(f"{t * 1000:.1f} ms" for t in s)  # noqa: E731
    dims = {"map": {}, "fold": {}}
    pairs = []
    with csv_workspace(MANIFEST) as (input_csv, output_csv, times, names), binary_heads():
        fused_launches, t_fused, batch_p, fused_result = run_csv(input_csv, output_csv, names,
                                                                 times)
        with knobs(VIPTPU_TTA="2", VIPTPU_TTA_MODE="map"), recording_leading_dims(dims["map"]):
            map_launches, t_map, batch_m, map_result = run_csv(input_csv, output_csv, names, times)
        check_fold_batch(card, stats, dw_sites)
        with knobs(VIPTPU_TTA="2", VIPTPU_TTA_MODE="fold"), recording_leading_dims(dims["fold"]):
            fold_launches, t_fold, batch_f, fold_result = run_csv(input_csv, output_csv, names,
                                                                   times)
        with knobs(VIPTPU_FUSED="0"):
            seq_launches, t_seq, _, seq_result = run_csv(input_csv, output_csv, names)
        with knobs(VIPTPU_FUSE_BN="all"), recording_folds(pairs):
            bn_launches, t_bn, batch_b, bn_result = run_csv(input_csv, output_csv, names, times)
    expect_launches(fused_launches, seven_launches(batches, len(dw_sites)),
                    "seven-member, binary heads")
    expect_launches(map_launches, seven_launches(2 * batches, len(dw_sites)),
                    "seven-member VIPTPU_TTA=2 map")
    expect_launches(fold_launches, seven_launches(batches, len(dw_sites)),
                    "seven-member VIPTPU_TTA=2 fold")
    print(f"[serving] largest leading dimension a wrapper took, map -> fold: {dims}")
    short = {n: (dims["map"].get(n), dims["fold"].get(n)) for _, group in BATCHED for n in group
             if dims["fold"].get(n) != 2 * dims["map"].get(n, -1)}
    if short or dims["fold"][DW] != 2 * BATCH or dims["fold"]["dwconv7x7_nhwc"] != 2 * BATCH:
        raise AssertionError(f"fold mode did not run every block kernel at batch {2 * BATCH}: "
                             f"{short or dims['fold']}")
    expect_launches(seq_launches, seven_launches(seq_batches, len(dw_sites)),
                    f"seven-member VIPTPU_FUSED=0 (batch {seq_batch})")
    expect_launches(bn_launches, seven_launches(batches, len(dw_sites)),
                    "seven-member VIPTPU_FUSE_BN=all")
    folded = dict(zip((engine.registry_name(base) for base, *_ in MANIFEST), pairs))
    print(f"[serving] conv -> BN pairs folded per member: {folded}")
    if folded != {n: FUSE_BN_PAIRS[n] for n in folded} or len(pairs) != len(MANIFEST):
        raise AssertionError(f"VIPTPU_FUSE_BN folded {folded}, JAX's discovery finds "
                             f"{FUSE_BN_PAIRS}")
    compare_raw("TTA=2 fold", fold_result, map_result, "TTA=2 map")
    compare_raw("VIPTPU_FUSED=0", seq_result, fused_result, "the fused run")
    compare_raw("VIPTPU_FUSE_BN=all", bn_result, fused_result, "the unfolded run")
    compare_raw("TTA=2 map", map_result, fused_result, "TTA=1", bound=None)
    for label, t, batch_s in (("binary heads", t_fused, batch_p),
                              ("VIPTPU_TTA=2 map", t_map, batch_m),
                              ("VIPTPU_TTA=2 fold", t_fold, batch_f),
                              ("VIPTPU_FUSE_BN=all", t_bn, batch_b)):
        print(f"[serving] CSV->CSV {N_IMAGES} images, batch {BATCH}, 7 members, {label}: "
              f"{t:.2f} s ({N_IMAGES / t:.1f} img/s; per-batch e2e {ms(batch_s)}) [{card}]")
    print(f"[serving] CSV->CSV {N_IMAGES} images, 7 members, VIPTPU_FUSED=0 (each member at "
          f"batch {seq_batch}, its img/s on the engine's lines above): {t_seq:.2f} s "
          f"({N_IMAGES / t_seq:.1f} img/s) [{card}]")


TRAIN_BATCH, TRAIN_STEPS = 64, 8
# the members trained on the card, at their manifest sizes, and each one's
# launches in one training step: each forward's (the backwards are plain);
# ResNetRS50's step runs no kernel (cuDNN convs, BN in batch statistics)
TRAIN_MEMBERS = {
    "GCViTTiny": ((224, 224), {ATTN: GCVIT_BLOCKS, DW: GCVIT_DW_SITES,
                               LN: GCVIT_LNS + 2 * GCVIT_BLOCKS}),
    "convnext_tiny_in22k": ((200, 200), {DW: CONVNEXT_BLOCKS, LN: CONVNEXT_LNS + CONVNEXT_BLOCKS}),
    "ResNetRS50": ((200, 200), {}),
}
# members whose eight fit steps must end below their first loss (each run
# so far fell; the others' falls are printed)
FALLS_IN_FIT = ("GCViTTiny",)
# the kernel step against the plain f32 step (phase 9 of the docstring)
TRAIN_LOSS_BOUND, TRAIN_NORM_BOUND = 2e-2, 5e-2
TRAIN_COS_BOUND, TRAIN_TENSOR_COS_BOUND = 0.99, 0.9
# the short tools/train_flip.py run of phase 9 (the full run is the tool's defaults)
TRAIN_FLIP_ARGS = ["--members", "3", "--epochs", "1", "--steps", "40", "--n-eval", "512"]


def _train_model(name: str, dtype: torch.dtype, damped: bool = True) -> torch.nn.Module:
    """A full-width member to compare one step on, one output, no
    activation, drop rates 0, the parameters in f32 whatever the compute
    dtype: ConvNeXt and GCViT with ``_model``'s seeded weights, ResNetRS50
    with the registry's seeded init (its BNs normalise with the batch's
    statistics in training) and, ``damped``, the scale of each residual
    branch's last BN ~ U(0.1, 0.3), as ``_resnet_state`` damps it."""
    if name in MEMBERS:
        return _model(name, dtype, nb_classes=1, drop_path_rate=0.0, param_dtype=torch.float32)
    model, _ = create_model(name, input_size=TRAIN_MEMBERS[name][0], nb_classes=1,
                            classifier_activation=None, dtype=dtype, seed=0, drop_rate=0.0,
                            param_dtype=torch.float32)
    if damped:
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for pname, p in model.named_parameters():
                if pname.endswith("batch_norm_3.weight"):
                    p.copy_(torch.rand(p.shape, generator=gen) * 0.2 + 0.1)
    return model.cuda()


def _trainable_model(name: str) -> torch.nn.Module:
    """A full-width member with the registry's seeded init and drop rates
    (the JAX train tools start from it: GCViT drop_path 0.2, ConvNeXt 0.1,
    ResNetRS50 head dropout 0.25), one output, no activation, bf16 compute,
    f32 parameters."""
    model, _ = create_model(name, input_size=TRAIN_MEMBERS[name][0], nb_classes=1,
                            classifier_activation=None, dtype=torch.bfloat16,
                            param_dtype=torch.float32)
    return model.cuda()


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    na, nb = a.norm(), b.norm()
    if na == 0 and nb == 0:
        return 1.0
    return (torch.dot(a, b) / (na * nb)).item()


def compare_train_step(card: str, name: str, x: torch.Tensor, y: torch.Tensor, tr: Trainer,
                       damped: bool = True) -> None:
    """The trainer's kernel step (forward and backward) against the plain
    f32 step on the same batch (held to the bounds unless it is ResNetRS50's
    undamped draw, which is printed only), and the kernel step's launches."""
    model = tr.model
    loss_fn = lambda: tr._loss(y, model(x).float())  # noqa: E731
    model.train()
    reset_launches()
    loss, grads = value_and_grad(loss_fn, tr.params)
    torch.cuda.synchronize()
    launches = all_launches()
    expected = TRAIN_MEMBERS[name][1]
    want = {n: expected.get(n, 0) for n in KERNELS}
    print(f"[train] {name}: launches in one training step (forward and backward): "
          f"{ {n: c for n, c in launches.items() if c} }")
    bad = {n: launches[n] for n in KERNELS if launches[n] != want[n]}
    if bad:
        raise AssertionError(f"the {name} training step launched {bad}; expected {expected} "
                             "and no other kernel")
    ref = _train_model(name, torch.float32, damped).train()
    ref_params = dict(ref.named_parameters())
    with plain_kernels():
        ref_loss, ref_grads = value_and_grad(
            lambda: binary_cross_entropy_timm(y, ref(x).float()).mean(), ref_params)
    torch.cuda.synchronize()
    flat = torch.cat([grads[k].flatten() for k in grads])
    ref_flat = torch.cat([ref_grads[k].flatten() for k in grads])
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    norm_ratio = (flat.norm() / ref_flat.norm()).item()
    cos = _cos(flat, ref_flat)
    per = {k: _cos(grads[k].flatten(), ref_grads[k].flatten()) for k in grads}
    worst = min(per, key=per.get)
    table_norms = [grads[k].norm().item() for k in grads if k.endswith("bias_table")]
    tables = (f"; rel-pos tables' gradient norms {min(table_norms):.3e} .. "
              f"{max(table_norms):.3e}" if table_norms else "")
    draw = "" if name in MEMBERS else (" damped" if damped else " undamped (printed only)")
    print(f"[train] {name}{draw}: one step, batch {TRAIN_BATCH}, drop rates 0, kernel path (bf16 "
          f"compute, f32 parameters) vs the plain f32 path: loss {loss.item():.6f} vs "
          f"{ref_loss.item():.6f} (rel {loss_rel:.3e}, bound {TRAIN_LOSS_BOUND:g}); gradient "
          f"global norm {flat.norm().item():.4e} vs {ref_flat.norm().item():.4e} (ratio "
          f"{norm_ratio:.4f}, bound 1 +- {TRAIN_NORM_BOUND:g}); cosine {cos:.6f} (bound "
          f"{TRAIN_COS_BOUND:g}); worst tensor {worst} cosine {per[worst]:.4f} (bound "
          f"{TRAIN_TENSOR_COS_BOUND:g}) of {len(per)}{tables} [{card}]")
    if not damped:
        return
    if not (loss_rel <= TRAIN_LOSS_BOUND and abs(norm_ratio - 1) <= TRAIN_NORM_BOUND
            and cos >= TRAIN_COS_BOUND and per[worst] >= TRAIN_TENSOR_COS_BOUND
            and all(t > 0 for t in table_norms)):
        raise AssertionError(f"the {name} kernel training step disagrees with the plain f32 "
                             "step")
    del ref, ref_params, ref_grads


def time_train_step(card: str, name: str, x: torch.Tensor, y: torch.Tensor, tr: Trainer,
                    profile: bool) -> None:
    """The forward (with its graph), forward + backward and whole step
    (with the AdamW update) timed in turns, and one step's profile."""
    model = tr.model
    model.train()
    state = tr.opt_state  # lr-0 steps leave the parameters as they are, not this

    def fwd():
        return tr._loss(y, model(x).float())

    parts = {"forward": fwd, "forward + backward": lambda: value_and_grad(fwd, tr.params),
             "step": lambda: tr.train_step(x, y, 0.0)}
    ms = {}
    for part, fn in list(parts.items()) + list(parts.items())[::-1]:
        ms.setdefault(part, []).append(cuda_ms(fn, iters=3, warmup=1))
    ms = {n: sum(t) / len(t) for n, t in ms.items()}
    fw, fb, st = ms["forward"], ms["forward + backward"], ms["step"]
    print(f"[train] {name}: batch-{TRAIN_BATCH} step: forward {fw:.2f} ms, backward "
          f"{fb - fw:.2f} ms ({(fb - fw) / st:.1%} of the step), optimizer and the rest "
          f"{st - fb:.2f} ms, step {st:.2f} ms ({TRAIN_BATCH * 1000 / st:.1f} img/s) [{card}]")
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train_step(x, y, 0.0)
        torch.cuda.synchronize()
    tr.opt_state = state
    print(f"[train] {name}: batch-{TRAIN_BATCH} training step profile (device time)")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40 if profile else 20))


def phase_train(card: str, profile: bool, name: str) -> None:
    """Full-width ``name`` trained on the card: one kernel step against the
    plain f32 step and its launches, the step's parts timed, then
    ``Trainer.fit`` for eight AdamW steps, evaluation, checkpoint, resume
    and the trained weights served on the fused path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, _ = TRAIN_MEMBERS[name]
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((TRAIN_BATCH, *size, 3), generator=gen, device="cuda")
    y = (torch.rand((TRAIN_BATCH, 1), generator=gen, device="cuda") > 0.5).float()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = TrainConfig(epochs=1, steps_per_epoch=TRAIN_STEPS, lr_base=3e-4,
                          lr_schedule="constant", optimizer="adamw", weight_decay=1e-4,
                          loss="bce_timm", monitor="loss", ckpt_dir=ckpt_dir,
                          basic_save_name="member", seed=0)
        if name not in MEMBERS:  # ResNetRS50: the registry's draw first, printed only
            compare_train_step(card, name, x, y,
                               Trainer(_train_model(name, torch.bfloat16, False), cfg), False)
        tr = Trainer(_train_model(name, torch.bfloat16), cfg)
        compare_train_step(card, name, x, y, tr)
        time_train_step(card, name, x, y, tr, profile)
        del tr
        torch.cuda.empty_cache()

        tr = Trainer(_trainable_model(name), cfg)
        eval_before = tr.eval_step(x, y)[0].item()
        losses, step_ms = [], []
        train_step = tr.train_step

        def timed_step(images, labels, lr):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = train_step(images, labels, lr)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1000)
            losses.append(loss.item())
            return loss

        tr.train_step = timed_step
        batch = lambda: iter([(x, y)] * TRAIN_STEPS)  # noqa: E731
        torch.cuda.reset_peak_memory_stats()
        history = tr.fit(batch, lambda: iter([(x, y)]), verbose=1)
        peak = torch.cuda.max_memory_allocated()
        median = float(np.median(step_ms[1:]))
        fmt = lambda vs, f: ", ".join(format(v, f) for v in vs)  # noqa: E731
        print(f"[train] {name}: Trainer.fit, {TRAIN_STEPS} AdamW steps (lr 3e-4, weight decay "
              f"1e-4, the registry's drop rates) on one batch of {TRAIN_BATCH}: losses "
              f"{fmt(losses, '.4f')} (last {'below' if losses[-1] < losses[0] else 'not below'} "
              f"the first); step ms {fmt(step_ms, '.1f')}, median after the first "
              f"{median:.2f} ms ({TRAIN_BATCH * 1000 / median:.1f} img/s); peak memory "
              f"{peak / 2 ** 30:.2f} GiB; eval loss on the batch {eval_before:.4f} before, "
              f"{history['val_loss'][0]:.4f} after; history {history} [{card}]")
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"the {TRAIN_STEPS} {name} training losses {losses} are not "
                                 "all finite")
        if name in FALLS_IN_FIT and not losses[-1] < losses[0]:
            raise AssertionError(f"the {TRAIN_STEPS} {name} training losses {losses} did not "
                                 "fall")
        path = os.path.join(ckpt_dir, "member_latest.msgpack")
        resumed = Trainer(_trainable_model(name), cfg)
        if not resumed.restore_latest() or resumed.global_step != TRAIN_STEPS:
            raise AssertionError(f"the {name} trainer did not resume from its latest checkpoint")
        moved = max((resumed.params[k] - p).abs().max().item() for k, p in tr.params.items())
        stats = max([(resumed._stats[k] - b).abs().max().item() for k, b in tr._stats.items()],
                    default=0.0)
        count = int(resumed.opt_state["count"])
        print(f"[train] {name}: resumed from {os.path.basename(path)}: step "
              f"{resumed.global_step}, optimizer count {count}, max|param - trained| "
              f"{moved:.1e}, max|running statistic - trained| {stats:.1e} over "
              f"{len(tr._stats)} buffers")
        if moved != 0 or stats != 0 or count != TRAIN_STEPS:
            raise AssertionError(f"the resumed {name} parameters, statistics or optimizer "
                                 "state differ")
        del resumed

        served, _ = create_model(name, input_size=size, nb_classes=1,
                                 classifier_activation=None, dtype=torch.bfloat16)
        state = load_variables(path)  # the trainer's: also opt_state and meta
        transfer_weights({k: state[k] for k in ("params", "batch_stats")}, served, strict=True)
        served = served.cuda().eval()
        tr.model.eval()
        reset_launches()
        with torch.inference_mode():
            got = served(x)
            want = tr.model(x)
        torch.cuda.synchronize()
        launches = all_launches()
        r = rel_err(got, want)
        fused = {"GCViTTiny": GCVIT_KERNELS, "convnext_tiny_in22k": CONVNEXT_KERNELS}.get(name, ())
        blocks = GCVIT_BLOCKS if name == "GCViTTiny" else CONVNEXT_BLOCKS
        print(f"[train] {name}: the checkpoint served by a fresh bf16 model on the fused path "
              f"vs the trained model's eval logits: max|d|/max|ref| = {r:.3e} (bound "
              f"{MODEL_BOUND:g}); fused-block launches { {n: launches[n] for n in fused} } "
              f"[{card}]")
        if not r <= MODEL_BOUND or any(launches[n] != 2 * blocks for n in fused):
            raise AssertionError(f"the trained {name} weights do not serve on the fused path")


def phase_train_flip(card: str) -> None:
    """A short run of the port's ``train_flip`` tool: the three members
    trained on the checkerboard task, then the f32, bf16 and int8 arms'
    decisions on held-out images; its JSON printed."""
    from vip_cup_2022_tpu_torch.tools import train_flip

    t0 = time.perf_counter()
    reset_launches()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train_flip.main(TRAIN_FLIP_ARGS + ["--ckpt-dir", ckpt_dir])
    seconds = time.perf_counter() - t0
    launches = {n: c for n, c in all_launches().items() if c}
    print(f"[train_flip] {' '.join(TRAIN_FLIP_ARGS)}: {json.dumps(out)} ({seconds:.1f} s; "
          f"launches {launches}) [{card}]")
    numbers = [out["task_balanced_acc_f32"]] + [v for arm in ("bf16", "int8")
                                                 for v in out[arm].values()]
    if out["n"] != int(TRAIN_FLIP_ARGS[-1]) or not all(np.isfinite(numbers)):
        raise AssertionError(f"train_flip gave {out}")
    if not launches.get(PTQ):  # the int8 arm runs ResNetRS50's sites on the int8 kernel
        raise AssertionError(f"train_flip's int8 arm launched no {PTQ}: {launches}")


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    stats = new_stats()
    phase_kernels(card, stats)
    phase_gcvit_kernels(card, stats)
    phase_attention(card, stats)
    phase_layernorm(card, stats)
    phase_depthwise(card, stats)
    phase_lnmlp(card, stats)
    phase_attn_parts(card, stats)
    tool_launches = phase_tools(card)
    spike_launches = phase_spike(card, stats)
    profile = "--profile" in argv
    phase_model("convnext_tiny_in22k", card, profile)
    dw_members = {"GCViTTiny": phase_model("GCViTTiny", card, profile, fused_block=True)}
    phase_model("GCViTTiny", card, profile, fused_block=False)
    for name in EFFNETS:
        dw_members[name] = phase_member(name, card, profile, _effnet_state(name))
    phase_depthwise_sites(card, stats, dw_members)
    phase_member("ECA_NFNetL0", card, profile, _nfnet_state())
    calls = {}
    for name in INT8_SITES:  # ResNetRS50, then ResNest50
        calls[name] = phase_int8_member(name, card, profile)[0]
        phase_ptq_sites(card, stats, calls[name], name, tool=name == "ResNetRS50")
    launches = {**phase_slice(card), **tool_launches, **spike_launches}
    phase_slice_int8(card, len(calls["ResNetRS50"]), pass_sites(calls["ResNetRS50"]))
    every = calls["ResNetRS50"] + calls["ResNest50"]
    dw_sites = [site for sites, _ in dw_members.values() for site in sites]
    launches.update(phase_slice_seven(card, len(dw_sites), len(every), pass_sites(every)))
    phase_serving(card, stats, dw_sites)
    for name in TRAIN_MEMBERS:
        phase_train(card, profile, name)
    phase_train_flip(card)
    record = [{"name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
               "launches": launches[n], "max_abs_err": stats[n]["max_abs_err"],
               "ms": stats[n]["ms"], "plain_ms": stats[n]["plain_ms"],
               "bound_ms": stats[n]["bound_ms"],
               "bound_by": "bytes" if stats[n]["bytes_ms"] >= stats[n]["ops_ms"] else "operations",
               "library_ms": stats[n]["library_ms"]} for n in KERNELS]
    print(f"[smoke] wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
