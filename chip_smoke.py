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
     ``F.layer_norm`` on the f32 copy, with the casts; beside it, by device
     time, the kernel, ``F.layer_norm`` on the bf16 input itself (the same
     function: f32 statistics, bf16 out; weight and bias in bf16, as CUDA's
     takes them) and on the f32 copy;
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
   - the fused blocks' int8 GEMMs (``VIPTPU_INT8_KERNELS=1``,
     ``phase_int8_kernels``): first the MLP pair's GELU against
     ``ln_fc1_gelu_int8``'s over all 2^32 f32 inputs (bit for bit) and the
     two facts pass 1 leans on (``block_int8.gelu_mono_check``); then the
     MLP pair ``ln_fc1_rowmax_int8`` -> ``mlp_int8_scale_residual`` and the
     chain it replaced, ``ln_fc1_gelu_int8`` -> ``quantize_rows`` ->
     ``fc2_scale_residual_int8``, at ConvNeXt's s1-s4, ``ln_qkv_int8``
     (local q / k / v and global k / v), ``quantize_rows`` of the attention
     output, ``proj_scale_residual_int8`` and both MLPs at GCViT's L2-L4,
     batch 256, weights quantized from f32: the pair's output and hidden row
     scales equal to the chain's bit for bit; pass 1's codes equal to the
     plain LN's but within 2^-11 of a .5 tie (``codes_equal_off_ties``),
     its scales within 1e-6 of theirs; pass 2 within 1e-2 of max|ref| of
     its plain version; ``quantize_rows``'
     codes and row scales and the residual GEMMs' outputs equal to their
     plain versions bit for bit, the LN GEMMs within 1e-2 of max|ref|; each
     timed by device time beside its plain version (events), ``torch._int_mm``
     on the same s8 operands with the quantize of A in PyTorch ops, and its
     bf16 variant (per launch, then per forward); the MLP per forward on the
     pair, on the chain and on the bf16 pair, in this call;
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
   ``torch._int_mm`` on its pre-quantized rows), the pass beside
   ``torch.quantize_per_tensor`` on the f32 copy (its codes compared: it
   clamps to -128, the pass to -127, and a probe past the range shows
   it); then the ``exp_ptq_int8``
   tool's phase cuts of the site (loads / + quantize / + products / whole)
   at one 1 x 1 and one 3 x 3 site of each ResNetRS50 stage;
   then int8 on the other five members (``phase_int8_other``: ConvNeXt and
   GCViT on their fused block path with ``_model``'s weights, the
   EfficientNets and ECA_NFNetL0 with the weights of their phase 6 runs),
   each calibrated on 64 images at batch 256 and quantized from its f32
   weights: its site count the JAX pass's full-width count
   (``INT8_SITES``, ``tests/test_torch_int8_members.py``), its int8 path
   against the same quantized model under ``plain_kernels()`` within 5e-2
   of max|ref| at batch 8, int8 against bf16 at batch 256 (max|d| and the
   decisions that flip at 0.487, printed), its bf16 and int8 batch-256
   forwards timed; ECA_NFNetL0's grouped 3 x 3 sites through the PTQ site
   phase above (``ptq_int8_conv`` in groups, within 1e-6 of its plain
   version, timed beside cuDNN's grouped bf16 conv); and the LN kernel at
   EfficientNetV2T_GC's ``gc_ln`` widths (12, 26, 32, 52: its 29 LNs of a
   full-width bf16 forward at 200 x 200) and at one odd width (13), bf16,
   against its plain version (``phase_layernorm_gc``); the PTQ sites' cuDNN
   and ``torch._int_mm`` yardsticks summed over the seven members; then
   ConvNeXt and GCViTTiny under ``VIPTPU_INT8_KERNELS=1``
   (``phase_int8_models``: ``_model``'s weights, the int8 weights quantized
   from the f32 model's): one batch-256 forward's int8 launches (ConvNeXt's
   18 blocks, GCViT's 28 at L2-L4 on the MLP pair and none on the chain,
   L1's 3 on the bf16 kernels), the peak device memory of the forward on
   the pair and on the chain (ConvNeXt's must differ by at least half its
   s1 f32 hidden) and their logits (equal), the logits within 5e-2 of
   max|ref| of the bf16 kernel path, the decisions int8 and
   bf16 each flip at 0.487 against the plain f32 forward, the int8 / bf16
   forward ratio;
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
   ``ptq_int8_quantize`` at those of them that run the pass; and once more
   with ``VIPTPU_INT8=all``, every member calibrated (one bf16 forward of
   the 64 calibration images, which launches each member's block kernels,
   K9 and the LN once more) and quantized, which must launch
   ``ptq_int8_conv`` at every site of the seven members (``INT8_SITES``
   summed) of each batch and ``ptq_int8_quantize`` at those that run the
   pass, its img/s and per-batch ms printed beside the bf16
   run's; then ``VIPTPU_INT8_KERNELS=1`` with one-output sigmoid heads
   (``phase_slice_int8_kernels``): the two-member and the seven-member
   manifests each beside its bf16 run, the seven also with the blocks' MLP
   on the chain the pair replaced (``mlp_chain``: 0 of 300 decisions may
   flip), then the seven with ``VIPTPU_INT8=all`` too (the calibration
   forward's launches once more): the int8 block kernels at each ConvNeXt
   and L2-L4 GCViT block of each batch, the bf16 ones at L1,
   ``ptq_int8_conv`` at the 336 sites, the raw means within 5e-2 of the
   bf16 run's, img/s printed;
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
9. pth (``phase_pth``): the timm ``.pth`` weight route at full width. The
   seeded convnext_tiny_in22k@200 weights of phase 6, its 21,841-class
   head included, written as a timm state dict (``timm_convnext_state``,
   ``torch.save``), converted by ``load_weights`` and loaded by
   ``create_model(model_path=..., nb_classes=1)``: every leaf but the
   swapped head equal to the source's bit for bit, in f32 and in the
   served bf16; the served model's batch-256 forward on the fused path
   launching the three ConvNeXt kernels at each of its 18 blocks and the LN
   kernel at its 5 LNs, its logits equal (max|d| = 0) to those of the same
   weights from ``.msgpack``; the host seconds to write, convert and load
   printed; neither h5py nor TensorFlow imported;
10. f32 (``phase_f32``, ``VIPTPU_DTYPE=float32``): each of the seven members
   in f32 as the engine builds it (on the card GCViT and ConvNeXt take
   their unfused blocks by the models' rule), seeded weights, one output:
   its batch-8 logits
   on the kernel path against ``plain_kernels()`` with TF32 off within
   2e-4 of max(1, max|ref|), the decisions at 0.487 equal but within 1e-4
   of it; its batch-256 f32 forward timed; every K9 call (84) and LN call
   (94, all f32) of one forward recorded. Then ``window_attention_bhnd_f32``
   at GCViTTiny's L1-L4 (local and global query), ``depthwise_conv_nhwc_f32``
   at every recorded K9 site and ``layer_norm_f32`` at every recorded LN
   shape, batch 8 and 256, against their plain versions within 1e-5 of
   max|ref|, timed at 256 (K8 by events beside SDPA in f32 with the bias as
   a float mask; K9 by device time beside cuDNN's f32 grouped conv; K10 by
   device time beside ``F.layer_norm``), per seven-member f32 forward into
   the record. Then the seven members with sigmoid heads through
   ``main_torch.main`` with ``VIPTPU_DTYPE=float32``, cold and warm, both
   TF32 flags set on before each run: K8, K9 and K10 in f32 at each of
   their sites a batch (31, 84 and 94), no other kernel, no plain version
   called, every forward with both flags off and the flags on again after;
   then the same CSV in bf16, the decisions that flip between the dtypes
   printed (no gate). Last, ``Trainer.eval_step`` and one
   ``Trainer.train_step`` (batch 16, drop rates 0, SGD at lr 1) of an f32
   GCViTTiny and of an f32 ConvNeXt against the same calls of a second
   trainer under ``plain_kernels()``, both TF32 flags on before each call:
   inside each call both off and on again after; the eval loss (on the
   unfused block), the step's loss and the norm of the gradients its
   closure took within 1e-4 (relative), their cosine >= 0.9999, the
   parameters moved by minus the gradient (cosine >= 0.9999, and against
   the plain step's moves); the eval's and the step's launches each exactly
   K8 31, K9 11 and K10 71 (GCViT), K9 18 and K10 23 (ConvNeXt), all f32,
   the plain trainer's none;
11. train (``phase_train``, once a member): full-width GCViTTiny@224
   (``_model``'s seeded weights), convnext_tiny_in22k@200 (``_model``'s),
   ResNetRS50@200, ResNest50@200, EfficientNetV2T@200, EfficientNetV1B4@224
   and ECA_NFNetL0@200 (the registry's seeded init; in the BN members the
   scale of each residual branch's last BN ~ U(0.1, 0.3): ResNetRS50's
   ``batch_norm_3``, ResNest50's zero-gamma ``3_bn``, the EfficientNets'
   ``MB_pw_bn`` / ``fu_bn`` where the block takes the shortcut), one
   output, no activation, bf16 compute, f32 parameters, on the path
   training takes: GCViT's and ConvNeXt's unfused blocks, the BNs in batch
   statistics, K9 under autograd at the EfficientNets' stride-1 depthwise
   convs, ECA_NFNetL0's standardized weights in the graph. One step at drop
   rates 0 on one seeded batch of 64 (noise images; for the last four
   members each with a colour cast, ``CAST_MEMBERS``) against the same step
   of the f32 model under ``plain_kernels()``: the loss within 2e-2
   (relative), the gradient's global norm within 5e-2 of the f32 one's, the
   cosine of the flattened gradients >= 0.99 and the worst tensor's >= 0.9
   over the tensors whose plain f32 gradient is above the kernel path's
   rounding in the tensors whose true gradient is 0 (bf16 rounds each
   activation to 2^-9 relative; through 31 blocks forward and back the
   logits move by up to 5e-2 of max|ref| (phase 6), and a gradient error of
   that size is a cosine of 0.9988, of 45 % still 0.9); each BN member's
   undamped draw is compared first and printed only (a BN network at full
   branch scale in training amplifies the rounding: a cosine of 0.61 on
   ResNetRS50); the step's launches exactly GCViT's K8 31, K9 11 and K10
   71, ConvNeXt's K9 18 and K10 23, V2T's K9 27, V1B4's K9 28, none for
   ResNetRS50, ResNest50 and ECA_NFNetL0 (forward only: each backward is
   the plain version's gradient) and none of any other kernel; the forward,
   the backward and the optimizer's share of a step timed, a profile of one
   step printed, then one step by host clock beside its device time (a
   CUDA-only profile) and, where it runs K9, K9's plain backward at the
   step's sites (device time and its share). Then ``Trainer.fit`` takes
   eight AdamW steps (lr 3e-4, weight decay 1e-4, the
   ``tools/train_flip.py`` setting) on a repeated batch from the registry's
   seeded init and drop rates (the JAX train tools' start: GCViT drop_path
   0.2, ConvNeXt 0.1, ResNetRS50's head dropout 0.25; V2T's dropout 0.2,
   V1B4's drop-connect 0.2 and dropout 0.4, ECA_NFNetL0's dropout 0.2; for
   GCViT ``_model``'s rel-pos tables ~ U(-1, 1) and LN scales ~ U(0.5, 1.5)
   make the loss at that lr spike and end above its start): each loss
   finite, GCViT's last below its first; the median step ms, img/s and peak
   memory printed; it evaluates (GCViT and ConvNeXt on the fused path; the
   eval loss before and after printed) and checkpoints; a fresh trainer
   resumes from the checkpoint to the same parameters, running statistics
   and step; and a fresh bf16 model loaded from the checkpoint serves
   within 5e-2 of max|ref| of the trained model's own eval logits, the two
   forwards launching exactly GCViT's and ConvNeXt's fused-block kernels
   and the EfficientNets' K9 twice a site. Last, a short run of the port's
   ``tools/train_flip.py`` (``--epochs 1 --steps 40 --n-eval 512``: the
   three members trained on its checkerboard task, then the f32, bf16 and
   int8 arms on held-out images), its JSON printed, each number finite.

The line before the last is the kernels' JSON record. ``launches`` come from
the run of each kernel's path, counted from 0 just before it: the first fused
CSV run for the block families, the unfused CSV run for
``window_attention_bhnd`` and ``layer_norm`` (plus the 29 of the V2T_GC
forward of ``phase_layernorm_gc``), the cold seven-member CSV run
for ``depthwise_conv_nhwc``, the two tools' runs for the four tool kernels, the
``int8_pallas_spike`` run for the three spike bodies, the seven-member
``VIPTPU_INT8=all`` CSV run for ``ptq_int8_quantize`` and
``ptq_int8_conv`` and the seven-member ``VIPTPU_INT8_KERNELS=1`` CSV run
for the int8 block kernels and the cold seven-member ``VIPTPU_DTYPE=float32``
CSV run for ``window_attention_bhnd_f32``, ``depthwise_conv_nhwc_f32`` and
``layer_norm_f32`` (whose ``ms``, ``plain_ms`` and ``library_ms`` are per
batch-256 f32 forward of the seven members; the LN wrapper keeps one
counter for both dtypes, so ``layer_norm_f32``'s launches are that run's
``layer_norm`` launches, each of its recorded LN calls f32), the int8 block kernels' ``ms``
(kernel and library by device time), ``plain_ms`` and ``library_ms`` (``torch._int_mm`` with the
quantize of A; for ``mlp_int8_scale_residual`` two ``torch._int_mm`` with
the GELU and the hidden's quantize between; none for ``quantize_rows``)
are per batch-256 forward of ConvNeXt's 18 and GCViT's 28 int8 blocks
(``quantize_rows``' of GCViT's attention output alone). The chain the MLP
pair replaced (``ln_fc1_gelu_int8``, ``quantize_rows`` of the hidden as
``quantize_rows_hidden``, ``fc2_scale_residual_int8``) is off the model path
and not in the record: its per-forward times and its launches in the
seven-member CSV run on the chain are printed on their own ``[int8k]``
lines as the pair's yardstick.
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
forward of ResNetRS50 and ResNest50 together plus ECA_NFNetL0's grouped
sites, each member's part printed apart (no one call computes the int8
site); the LN's row adds the V2T_GC widths' launches to the two members'. ``bound_ms`` is the least
time the card could take for the same launches, each launch's bytes (inputs
read once, outputs written once) over 3.35 TB/s or its operations over the
peak for their type (989 TFLOP/s bf16 and 1,979 TOP/s int8 tensor-core
products, 67 TFLOP/s f32 elsewhere; NVIDIA's H100 SXM data sheet), whichever
is larger, summed; ``bound_by`` says which of the two made most of it. ``max_abs_err`` is over every check of
phases 3-6 (the f32 kernels': phase 10). Before it the script prints its own wall time. The last line is
``{"ok": true, "device": {...}}``.
Before the wall time it prints the wall seconds of each group of phases.
"""
import contextlib
import copy
import json
import os
import re
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
from vip_cup_2022_tpu_torch.data import augment as AUG  # noqa: E402
from vip_cup_2022_tpu_torch.data import randaugment as RA  # noqa: E402
from vip_cup_2022_tpu_torch.data.tfds import init_dataset, post_process_batch  # noqa: E402
from vip_cup_2022_tpu_torch.data.train_pipeline import (  # noqa: E402
    EvalLoader, loaders_from_custom_json, recognition_dataset_from_custom_json)
from vip_cup_2022_tpu_torch.eval import evaluation  # noqa: E402
from vip_cup_2022_tpu_torch.infer import engine  # noqa: E402
from vip_cup_2022_tpu_torch.models import (create_model, load_weights,  # noqa: E402
                                           transfer_weights)
from vip_cup_2022_tpu_torch.models.registry import model_entry  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import attn_parts as A  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import block_int8 as B8  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import build  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import convnext_block as K  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import depthwise as D  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import gcvit_block as G  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import int8_gemm as Q  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import layernorm as L  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import ln_mlp as LM  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels import window_attention as WA  # noqa: E402
from vip_cup_2022_tpu_torch.ops.kernels.reference import (MODEL_KERNELS,  # noqa: E402
                                                           plain_kernels)
from vip_cup_2022_tpu_torch.ops.norms import BatchNorm  # noqa: E402
from vip_cup_2022_tpu_torch.quant import dyn_int8  # noqa: E402
from vip_cup_2022_tpu_torch.tools import (exp_attn_parts, exp_convnext_s12, exp_dw,  # noqa: E402
                                          exp_dwconv, exp_lnmlp_dw, exp_mlp_gemm, exp_ptq_int8,
                                          exp_window_attention, int8_pallas_spike)
from vip_cup_2022_tpu_torch.tools.bench_util import cuda_ms, device_ms  # noqa: E402
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer  # noqa: E402
from vip_cup_2022_tpu_torch.train import history as train_history  # noqa: E402
from vip_cup_2022_tpu_torch.train import trainer as trainer_module  # noqa: E402
from vip_cup_2022_tpu_torch.train.losses import binary_cross_entropy_timm  # noqa: E402
from vip_cup_2022_tpu_torch.train.sam import value_and_grad  # noqa: E402
from vip_cup_2022_tpu_torch.utils.checkpoint import load_variables, save_variables  # noqa: E402
from vip_cup_2022_tpu_torch.weights.from_jax import flax_to_torch  # noqa: E402
from vip_cup_2022_tpu_torch.weights.to_flax import torch_to_flax  # noqa: E402

CONVNEXT_KERNELS = ("dwconv7x7_nhwc", "ln_fc1_gelu", "fc2_scale_residual")
GCVIT_KERNELS = ("ln_qkv", "window_attention", "proj_scale_residual")
ATTN, LN, DW = "window_attention_bhnd", "layer_norm", "depthwise_conv_nhwc"
# their f32 modes (VIPTPU_DTYPE=float32): K8's and K9's a symbol and a launch counter each;
# K10's one counter counts both dtypes, so LN32's launches are read from its recorded calls
ATTN32, DW32, LN32 = ATTN + "_f32", DW + "_f32", LN + "_f32"
# the fused blocks' f32 modes: a symbol and a launch counter each, launched by the bf16
# kernels' wrappers when the weights (the depthwise: x, the attention: k) are f32
CONVNEXT_F32 = tuple(n + "_f32" for n in CONVNEXT_KERNELS)
GCVIT_F32 = tuple(n + "_f32" for n in GCVIT_KERNELS)
BLOCK_F32 = CONVNEXT_F32 + GCVIT_F32
LNMLP_KERNELS = ("fused_ln_mlp_residual", "lnmlp_batchlane", "lnmlp_chanfirst")
PARTS = "attn_parts"
SPIKE_KERNELS = ("int8_spike_bf16", "int8_spike_int8", "int8_spike_direct")
PTQ, QUANT = "ptq_int8_conv", "ptq_int8_quantize"  # the PTQ site's GEMM and quantize pass
# the fused blocks' int8 GEMMs (VIPTPU_INT8_KERNELS=1) and each one's bf16 variant: the MLP
# pair, and GCViT's qkv, attention-output quantize and proj
PAIR = ("ln_fc1_rowmax_int8", "mlp_int8_scale_residual")
INT8_KERNELS = ("ln_qkv_int8", "quantize_rows", "proj_scale_residual_int8") + PAIR
# the three-launch MLP chain the pair replaced: its yardstick, off the model path and out of
# the kernels record (its quantize of the hidden timed apart from quantize_rows)
QROWS_HIDDEN = "quantize_rows_hidden"
CHAIN_KERNELS = ("ln_fc1_gelu_int8", "fc2_scale_residual_int8")
CHAIN = ("ln_fc1_gelu_int8", QROWS_HIDDEN, "fc2_scale_residual_int8")
BF16_VARIANT = {"ln_fc1_gelu_int8": "ln_fc1_gelu", "ln_qkv_int8": "ln_qkv",
                "fc2_scale_residual_int8": "fc2_scale_residual",
                "proj_scale_residual_int8": "proj_scale_residual"}
# the last modes (ROADMAP A15c), a launch counter each: the int8 block kernels on f32
# activations (VIPTPU_DTYPE=float32 VIPTPU_INT8_KERNELS=1; ln_qkv_int8_mmf32: a bf16 block's
# f32 q, k, v under VIPTPU_GCVIT_MM=f32) and GCViT's mixed GEMM dtypes (VIPTPU_GCVIT_MM): f32
# GEMMs on bf16 activations (_mmf32) and bf16 GEMMs on f32 ones (_mmbf16)
INT8_F32 = ("ln_qkv_int8_f32", "ln_qkv_int8_mmf32", "proj_scale_residual_int8_f32",
            "mlp_int8_scale_residual_f32")
MIXED_MODES = {"mmf32": (torch.bfloat16, torch.float32), "mmbf16": (torch.float32, torch.bfloat16)}
MIXED_KERNELS = GCVIT_KERNELS + ("fc2_scale_residual",)
MIXED = tuple(f"{n}_{mode}" for mode in MIXED_MODES for n in MIXED_KERNELS)
A15C = INT8_F32 + MIXED
KERNELS = (CONVNEXT_KERNELS + GCVIT_KERNELS + (ATTN, LN, DW) + LNMLP_KERNELS + (PARTS,)
           + SPIKE_KERNELS + (QUANT, PTQ) + INT8_KERNELS + (ATTN32, DW32) + BLOCK_F32 + A15C)
# every launch counter the launch checks read (the chain's f32 fc2 too: off the model path)
COUNTED = KERNELS + CHAIN_KERNELS + ("fc2_scale_residual_int8_f32",)
RECORDED = KERNELS + (LN32,)  # the kernels record's entries
CSRC = "vip_cup_2022_tpu_torch/csrc"
SOURCES = {n: f"{CSRC}/convnext_block.cu" for n in CONVNEXT_KERNELS}
SOURCES.update({n: f"{CSRC}/gcvit_block.cu" for n in GCVIT_KERNELS})
SOURCES.update({ATTN: f"{CSRC}/window_attention.cu", LN: f"{CSRC}/layernorm.cu",
                DW: f"{CSRC}/depthwise.cu", PARTS: f"{CSRC}/attn_parts.cu"})
SOURCES.update({ATTN32: SOURCES[ATTN], LN32: SOURCES[LN], DW32: SOURCES[DW]})
SOURCES.update({n + "_f32": SOURCES[n] for n in CONVNEXT_KERNELS + GCVIT_KERNELS})
SOURCES.update({n: f"{CSRC}/ln_mlp.cu" for n in LNMLP_KERNELS})
SOURCES.update({n: f"{CSRC}/int8_gemm.cu" for n in SPIKE_KERNELS})
SOURCES.update({n: f"{CSRC}/ptq_int8.cuh" for n in (QUANT, PTQ)})  # built into int8_gemm.cu's
SOURCES.update({n: f"{CSRC}/block_int8.cu" for n in INT8_KERNELS + INT8_F32})
SOURCES.update({f"{n}_{mode}": SOURCES[n] for mode in MIXED_MODES for n in MIXED_KERNELS})
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
    # the int8 mode of K1, K2, K4, K6, K7
    "quantize_rows": f"{TPU}:602, {TPU}:443, {GTPU}:667, {GTPU}:906",
    "ln_qkv_int8": f"{GTPU}:247, {GTPU}:906",
    "proj_scale_residual_int8": f"{GTPU}:667, {GTPU}:906",
    **{n: f"{TPU}:602, {TPU}:443, {GTPU}:667, {GTPU}:906" for n in PAIR},
}
REPLACES.update({ATTN32: REPLACES[ATTN], LN32: REPLACES[LN], DW32: REPLACES[DW]})  # f32 modes
REPLACES.update({n + "_f32": REPLACES[n] for n in CONVNEXT_KERNELS + GCVIT_KERNELS})
REPLACES.update({f"{n}_{mode}": REPLACES[n] for mode in MIXED_MODES for n in MIXED_KERNELS})
REPLACES.update({"ln_qkv_int8_f32": REPLACES["ln_qkv_int8"],
                 "ln_qkv_int8_mmf32": REPLACES["ln_qkv_int8"],
                 "proj_scale_residual_int8_f32": REPLACES["proj_scale_residual_int8"],
                 "mlp_int8_scale_residual_f32": REPLACES["mlp_int8_scale_residual"]})
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
# f32 operations a hidden element of each pass of the MLP pair, an FMA two: the value
# f32(acc) * (s_x * s_w1) + b1 (3), then pass 1 the row's largest (1; the GELU of one value
# a row and item, and of values below 0 where they could matter, not counted), pass 2 the
# GELU as gelu_rn computes it (34) and the code's product (1); floor over PEAK_OPS_PER_S["f32"]
PAIR_F32_OPS = {"ln_fc1_rowmax_int8": 4, "mlp_int8_scale_residual": 38}
MODEL_BOUND = 5e-2
SERVING_BOUND = 1e-2  # raw means of two serving paths of the same bf16 ensemble
N_IMAGES = 300
BATCH = 256
# the card's data-sheet peaks (NVIDIA H100 SXM, 700 W): memory, dense bf16
# and int8 tensor-core products, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# the JAX pass's int8 sites (tests/test_torch_resnet_rs.py, tests/test_torch_ptq.py)
# the JAX pass's int8 sites of each member at full width and its manifest size
# (tests/test_torch_resnet_rs.py, test_torch_ptq.py, test_torch_int8_members.py, -m slow);
# ConvNeXt and GCViT on the fused block path
INT8_SITES = {"ResNetRS50": 52, "ResNest50": 68, "convnext_tiny_in22k": 2, "GCViTTiny": 27,
              "EfficientNetV2T": 74, "EfficientNetV1B4": 60, "ECA_NFNetL0": 53}
INT8_RESNETS = ("ResNetRS50", "ResNest50")
GC_NAME, GC_SIZE = "EfficientNetV2T_GC", (200, 200)
GC_LN_WIDTHS = {12: 1, 26: 6, 32: 9, 52: 13}  # V2T_GC's gc_ln widths: LNs a forward
GC_ODD_WIDTH = 13
# conv -> BN pairs VIPTPU_FUSE_BN folds in each full-width member: the JAX
# package's discovery on its trees (tests/test_torch_fuse_bn.py)
FUSE_BN_PAIRS = {"convnext_tiny_in22k": 0, "ResNest50": 38, "GCViTTiny": 0, "EfficientNetV2T": 78,
                 "EfficientNetV1B4": 64, "ECA_NFNetL0": 0, "ResNetRS50": 56}


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def abs_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return (a.float() - ref.float()).abs().max().item()


KERNEL_MODULES = (K, G, WA, L, D, LM, A, Q, B8)


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
                "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "gemm_ms": 0.0}
            for n in RECORDED + CHAIN}


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


def block_inputs(b, h, w, c, gen, dtype=torch.bfloat16):
    """A ConvNeXt block's inputs, x and the two GEMM weights in ``dtype``."""
    dev = "cuda"

    def u(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    return dict(
        x=u((b, h, w, c), -1, 1).to(dtype),
        dw=u((7, 7, c), -0.2, 0.2), dwb=u((c,), -0.1, 0.1),
        lg=u((c,), 0.5, 1.5), lb=u((c,), -0.1, 0.1),
        w1=(u((4 * c, c), -1, 1) * c ** -0.5).to(dtype), b1=u((4 * c,), -0.1, 0.1),
        w2=(u((c, 4 * c), -1, 1) * (4 * c) ** -0.5).to(dtype),
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


def run_stage(b, h, w, c, gen, dtype=torch.bfloat16) -> dict:
    """One stage's block inputs at batch ``b`` and the three kernels' outputs
    (their f32 modes for ``dtype`` f32)."""
    p = block_inputs(b, h, w, c, gen, dtype)
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
    """The three kernels' outputs of :func:`run_stage` against their plain
    versions in f32; in the f32 mode (f32 x) under ``F32_KERNEL_BOUND``
    and in the ``_f32`` symbols' records."""
    c = shape[-1]
    f32 = p["x"].dtype == torch.float32
    sfx = "_f32" if f32 else ""
    check({"dwconv7x7_nhwc" + sfx: (p["d"], lambda: K.dwconv7x7_nhwc_plain(
        p["x"].float(), p["dw"], p["dwb"]).view(-1, c))}, str(shape), stats, F32_KERNEL_BOUND)
    check({
        "ln_fc1_gelu" + sfx: (p["hid"], lambda: K.ln_fc1_gelu_plain(
            p["d"], p["lg"], p["lb"], p["w1"].float(), p["b1"], 1e-6)),
        "fc2_scale_residual" + sfx: (p["out"], lambda: K.fc2_scale_residual_plain(
            p["hid"].float(), p["w2"].float(), p["b2"], p["ls"], p["x2"].float())),
    }, str(shape), stats, F32_KERNEL_BOUND if f32 else KERNEL_BOUND)


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


def gcvit_level_inputs(b, grid, c, heads, ws, gen, bf=torch.bfloat16) -> dict:
    """One GCViT level's block inputs at batch ``b``, window-ordered tokens;
    the activations and GEMM weights in ``bf`` (bf16, or f32)."""
    dev = "cuda"
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
    plain versions run on the same bf16 (or f32) inputs. The library call of
    the attention is SDPA on the same (window, head) tiles, the global query
    repeated over the windows beforehand; in f32 each GEMM's is cuBLAS's
    f32 product alone (``F.linear``, TF32 off), and each name takes the
    ``_f32`` suffix of its symbol."""
    n, m = p["n"], p["m"]
    f32 = p["x"].dtype == torch.float32
    sfx, e = ("_f32", 4) if f32 else ("", 2)  # the symbols' suffix, bytes an element
    wkv, bkv = p["wqkv"][c:], p["bqkv"][c:]
    t = lambda a: a.view(b, -1, c)  # noqa: E731
    heads_view = lambda a: a.reshape(-1, n, heads, 32).transpose(1, 2)  # noqa: E731
    q, k, v = p["qkv"]
    q_rep = p["qg"].repeat_interleave(m // (b * n), 0)
    mask = p["bias"].to(p["x"].dtype)
    sdpa = lambda qq: F.scaled_dot_product_attention(  # noqa: E731
        heads_view(qq), heads_view(k), heads_view(v), attn_mask=mask, scale=p["scale"])
    gemm = (lambda a, w: lambda: F.linear(a, w)) if f32 else (lambda a, w: None)  # noqa: E731
    act, weights = m * c * e, c * c * e  # bytes of one (M, C) activation, one C x C weight
    attn_ops, bias_bytes = 4 * m * n * c, heads * n * n * 4
    return {
        "ln_qkv" + sfx + " local": (
            lambda: G.ln_qkv(p["x"], p["lg"], p["lb"], p["wqkv"], p["bqkv"], 1e-5),
            lambda: G.ln_qkv_plain(p["x"], p["lg"], p["lb"], p["wqkv"], p["bqkv"], 1e-5),
            gemm(p["x"], p["wqkv"]), 4 * act + 3 * weights, 2 * m * c * 3 * c),
        "ln_qkv" + sfx + " global": (
            lambda: G.ln_qkv(p["x"], p["lg"], p["lb"], wkv, bkv, 1e-5),
            lambda: G.ln_qkv_plain(p["x"], p["lg"], p["lb"], wkv, bkv, 1e-5),
            gemm(p["x"], wkv), 3 * act + 2 * weights, 2 * m * c * 2 * c),
        "window_attention" + sfx + " local": (
            lambda: G.window_attention(t(q), t(k), t(v), p["bias"], n, p["scale"]),
            lambda: G.window_attention_plain(t(q), t(k), t(v), p["bias"], n, p["scale"]),
            lambda: sdpa(q), 4 * act + bias_bytes, attn_ops),
        "window_attention" + sfx + " global": (
            lambda: G.window_attention(p["qg"], t(k), t(v), p["bias"], n, p["scale"], True),
            lambda: G.window_attention_plain(p["qg"], t(k), t(v), p["bias"], n, p["scale"], True),
            lambda: sdpa(q_rep), 3 * act + b * n * c * e + bias_bytes, attn_ops),
        "proj_scale_residual" + sfx: (
            lambda: G.proj_scale_residual(p["attn"], p["wp"], p["bp"], p["g1"], p["x"]),
            lambda: G.proj_scale_residual_plain(p["attn"], p["wp"], p["bp"], p["g1"], p["x"]),
            gemm(p["attn"], p["wp"]), 2 * act + weights + m * c * 4, 2 * m * c * c),
        "ln_fc1_gelu" + sfx: (
            lambda: K.ln_fc1_gelu(p["r1"], p["lg2"], p["lb2"], p["w1"], p["b1"], 1e-5),
            lambda: K.ln_fc1_gelu_plain(p["r1"], p["lg2"], p["lb2"], p["w1"], p["b1"], 1e-5),
            gemm(p["r1"], p["w1"]), m * c * 4 + 3 * weights + 3 * act, 2 * m * c * 3 * c),
        "fc2_scale_residual" + sfx: (
            lambda: K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"]),
            lambda: K.fc2_scale_residual_plain(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"]),
            gemm(p["hid"], p["w2"]), 3 * act + 3 * weights + m * c * 4 + act,
            2 * m * 3 * c * c),
    }


def run_check_level(b, level, gen, stats, dtype=torch.bfloat16) -> tuple:
    """Run every GCViT launch of one level at batch ``b`` and check each
    against its plain version in f32; returns the inputs and the calls.
    ``dtype`` f32: the kernels' f32 modes, under ``F32_KERNEL_BOUND``."""
    grid, c, heads, ws, _, _ = level
    p = gcvit_level_inputs(b, grid, c, heads, ws, gen, dtype)
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
    f32 = dtype == torch.float32
    sfx = "_f32" if f32 else ""
    check({
        "ln_qkv" + sfx + " local": (torch.cat(p["qkv"], 1), lambda: torch.cat(G.ln_qkv_plain(
            p["x"], p["lg"], p["lb"], f(p["wqkv"]), p["bqkv"], 1e-5), 1)),
        "ln_qkv" + sfx + " global": (torch.cat(kv, 1), lambda: torch.cat(G.ln_qkv_plain(
            p["x"], p["lg"], p["lb"], f(p["wqkv"][c:]), p["bqkv"][c:], 1e-5), 1)),
        "window_attention" + sfx + " local": (attn_l, lambda: G.window_attention_plain(
            f(t(q)), f(t(k)), f(t(v)), p["bias"], n, p["scale"])),
        "window_attention" + sfx + " global": (attn_g, lambda: G.window_attention_plain(
            f(p["qg"]), f(t(k)), f(t(v)), p["bias"], n, p["scale"], True)),
        "proj_scale_residual" + sfx: (p["r1"], lambda: G.proj_scale_residual_plain(
            f(p["attn"]), f(p["wp"]), p["bp"], p["g1"], f(p["x"]))),
        "ln_fc1_gelu" + sfx: (p["hid"], lambda: K.ln_fc1_gelu_plain(
            p["r1"], p["lg2"], p["lb2"], f(p["w1"]), p["b1"], 1e-5)),
        "fc2_scale_residual" + sfx: (out, lambda: K.fc2_scale_residual_plain(
            f(p["hid"]), f(p["w2"]), p["b2"], p["g2"], p["r1"])),
    }, f"L b{b} {grid}x{grid}x{c} w{ws}", stats, F32_KERNEL_BOUND if f32 else KERNEL_BOUND)
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
    device_totals = {"kernel": 0.0, "F.layer_norm on the input": 0.0,
                     "F.layer_norm on the f32 copy": 0.0}
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
                layernorm_yardsticks(x, w, bb, eps, count, label, device_totals)
            del x, out
            torch.cuda.empty_cache()
    print_per_forward(stats, before, (LN,), "two-member batch-256 forward, GCViT unfused "
                      f"({sum(per_forward.values())} LNs)", card)
    print(f"[kernels] {LN} per two-member batch-256 forward by device time: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in device_totals.items())
        + f"; kernel / F.layer_norm on the input "
        f"{device_totals['kernel'] / device_totals['F.layer_norm on the input']:.2f} [{card}]")


def layernorm_yardsticks(x, w, bb, eps, count: int, label: str, totals: dict) -> None:
    """K10 by device time beside ``F.layer_norm`` on its own input (bf16 in,
    f32 statistics, bf16 out: the same function, its weight and bias cast
    to the input's dtype beforehand, as CUDA's takes them) and on the f32
    copy (the record's library call, which adds the casts); ``count`` times
    each into ``totals``, and the bf16 call's output against the plain
    version."""
    c = x.shape[-1]
    wl, bl = w.to(x.dtype), bb.to(x.dtype)
    lib = F.layer_norm(x, (c,), wl, bl, eps)
    ref = L.layer_norm_plain(x.float(), w, bb, eps)
    ms = {"kernel": device_ms(lambda: L.layer_norm(x, w, bb, eps)),
          "F.layer_norm on the input": device_ms(lambda: F.layer_norm(x, (c,), wl, bl, eps)),
          "F.layer_norm on the f32 copy": device_ms(
              lambda: F.layer_norm(x.float(), (c,), w, bb, eps).to(x.dtype))}
    for k, v in ms.items():
        totals[k] += count * v
    print(f"[kernels] {LN:26s} {label} device: " + ", ".join(f"{k} {v:.4f} ms"
                                                                for k, v in ms.items())
          + f"; F.layer_norm on the input ({lib.dtype}) vs plain: max|d|/max|ref| = "
          f"{rel_err(lib, ref):.3e}")


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


# ---------------------------------------------------------------------------
# the fused blocks' int8 GEMMs (VIPTPU_INT8_KERNELS=1)
# ---------------------------------------------------------------------------
# GCViTTiny's levels whose blocks run int8 at the default VIPTPU_GCVIT_INT8_MIN_C: L2-L4
INT8_LEVELS = tuple(lv for lv in LEVELS if lv[1] >= dyn_int8.GCVIT_INT8_MIN_C)
GCVIT_INT8_BLOCKS = sum(lv[4] + lv[5] for lv in INT8_LEVELS)  # 28; L1's 3 stay bf16


def int8_forward_launches(forwards: int, members=("convnext", "gcvit"),
                          chain: bool = False) -> dict:
    """The fused-block launches of ``forwards`` forwards of ConvNeXt and / or
    GCViTTiny under ``VIPTPU_INT8_KERNELS=1``: ConvNeXt's 18 blocks and
    GCViT's 28 at C >= 128 on the int8 kernels (their MLP on the pair, none
    on the chain it replaced; a GCViT int8 block quantizes the attention
    output), GCViT's 3 at L1 on the bf16 ones, the depthwise and the
    attention as they were. ``chain``: under :func:`mlp_chain`, the MLP on
    the three-launch chain, none on the pair."""
    cx, gc = "convnext" in members, "gcvit" in members
    bf16_gc = GCVIT_BLOCKS - GCVIT_INT8_BLOCKS
    return {n: forwards * v for n, v in {
        "dwconv7x7_nhwc": CONVNEXT_BLOCKS * cx, "window_attention": GCVIT_BLOCKS * gc,
        "ln_qkv": bf16_gc * gc, "proj_scale_residual": bf16_gc * gc,
        "ln_fc1_gelu": bf16_gc * gc, "fc2_scale_residual": bf16_gc * gc,
        **{n: 0 if chain else CONVNEXT_BLOCKS * cx + GCVIT_INT8_BLOCKS * gc for n in PAIR},
        **{n: CONVNEXT_BLOCKS * cx + GCVIT_INT8_BLOCKS * gc if chain else 0
           for n in ("ln_fc1_gelu_int8", "fc2_scale_residual_int8")},
        "quantize_rows": (CONVNEXT_BLOCKS * cx + GCVIT_INT8_BLOCKS * gc) * chain
                         + GCVIT_INT8_BLOCKS * gc,
        "ln_qkv_int8": GCVIT_INT8_BLOCKS * gc, "proj_scale_residual_int8": GCVIT_INT8_BLOCKS * gc,
    }.items()}


@contextlib.contextmanager
def mlp_chain():
    """The int8 blocks' MLP on the three-launch chain the pair replaced
    (``block_int8.mlp_int8_chain``), for the pair's yardstick runs."""
    real = B8.mlp_int8
    B8.mlp_int8 = B8.mlp_int8_chain
    try:
        yield
    finally:
        B8.mlp_int8 = real


def torch_row_quantize(a: torch.Tensor) -> torch.Tensor:
    """Per-row dynamic int8 of ``a`` in plain PyTorch ops, capturable (no
    host synchronisation): the quantize half of the int8 kernels' yardstick."""
    af = a.float()
    s = af.abs().amax(-1, keepdim=True).clamp_min(dyn_int8.MIN_AMAX) * dyn_int8.INV_127
    return torch.clamp(torch.round(af * torch.reciprocal(s)), -127, 127).to(torch.int8)


def int_mm_yardstick(a: torch.Tensor, w_q: torch.Tensor):
    """The library yardstick of an int8 GEMM kernel: ``a`` quantized per row
    in PyTorch ops, then ``torch._int_mm`` of the codes and the (N, K)
    weight codes (column-major, the layout cuBLASLt's int8 path takes); and
    ``torch._int_mm`` alone on codes made beforehand. (None, None) where
    cuBLASLt refuses the shape."""
    wt, a_q = w_q.t(), torch_row_quantize(a)
    try:
        torch._int_mm(a_q, wt)
    except RuntimeError as err:
        print(f"[int8k] torch._int_mm refuses {tuple(a.shape)} x {tuple(wt.shape)}: "
              f"{str(err).splitlines()[0][:80]}")
        return None, None
    return (lambda: torch._int_mm(torch_row_quantize(a), wt)), (lambda: torch._int_mm(a_q, wt))


def check_int8(label: str, stats: dict, outs: dict) -> None:
    """Each int8 kernel output in ``outs`` (name -> (output, reference
    maker, exact)) against its plain version on the same inputs: a
    (codes, row scales) pair equal to the plain one; an ``exact`` output
    equal bit for bit (the same integer sums and f32 steps); else within
    1e-2 of max|ref| (an LN output an ulp off the plain one moves a code on a
    .5 tie)."""
    for name, (got, make_ref, exact) in outs.items():
        ref = make_ref()
        pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
        kernel = name.split(" ")[0]
        err = max(abs_err(a, b) for a, b in pairs)
        stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], err)
        same = all(torch.equal(a, b) for a, b in pairs)
        r = max(rel_err(a, b) for a, b in pairs)
        print(f"[int8k] {name:26s} {label} max|d|/max|ref| = {r:.3e}, "
              f"{'equal to' if same else 'not equal to'} the plain version"
              f"{' (must be equal)' if exact else f' (bound {KERNEL_BOUND:g})'}")
        if (exact and not same) or not r <= KERNEL_BOUND:
            raise AssertionError(f"{name} at {label} disagrees with its plain version")
        del ref


def time_int8(kern, plain, lib) -> tuple:
    """Kernel and library ms per launch by device time (``device_ms``), the
    plain version's by CUDA events, in turns k, p, l, l, p, k."""
    fns = [(kern, lambda f: device_ms(f, calls=5, replays=4)), (plain, lambda f: cuda_ms(f, 3, 1))]
    if lib is not None:
        fns.append((lib, lambda f: device_ms(f, calls=5, replays=4)))
    first = [t(f) for f, t in fns]
    second = [t(f) for f, t in reversed(fns)][::-1]
    ms = [(a + b) / 2 for a, b in zip(first, second)]
    return ms[0], ms[1], (ms[2] if lib is not None else None)


def pair_floor(name: str, int8_ops: float, elements: float) -> tuple:
    """(operations, their type) of an MLP pass's larger floor: its s8
    products at the int8 peak, or its epilogue's f32 operations
    (``PAIR_F32_OPS`` an element of the (M, N) hidden) at the f32 peak."""
    f32_ops = PAIR_F32_OPS[name] * elements
    if f32_ops / PEAK_OPS_PER_S["f32"] >= int8_ops / PEAK_OPS_PER_S["int8"]:
        return f32_ops, "f32"
    return int8_ops, "int8"


def pair_calls(count: int, d, lg, lb, fc1, b1, fc2, b2, gamma, residual, eps: float,
               pass1: tuple) -> dict:
    """``run_int8_calls``' entries for the MLP pair at one shape: pass 1 on
    the LN input ``d`` (M, C) and pass 2 on pass 1's outputs; library: pass
    1 as the old fc1's (``torch._int_mm`` with the quantize of A), pass 2 as
    ``torch._int_mm`` of x's codes, the dequant and GELU, the hidden's
    quantize in PyTorch ops and ``torch._int_mm`` again (no residual);
    bounds by ``pair_floor``."""
    m, c = d.shape
    n = fc1.q.shape[0]
    x_q, x_s, h_s = pass1
    w1t, w2t = fc1.q.t(), fc2.q.t()
    res_bytes = residual.element_size()

    def library2():
        h = F.gelu(torch._int_mm(x_q, w1t).float() * (x_s.view(-1, 1) * fc1.s) + b1)
        return torch._int_mm(torch_row_quantize(h), w2t)

    return {
        "ln_fc1_rowmax_int8": (
            count, lambda: B8.ln_fc1_rowmax_int8(d, lg, lb, fc1.q, fc1.s, b1, eps),
            lambda: B8.ln_fc1_rowmax_int8_plain(d, lg, lb, fc1.q, fc1.s, b1, eps),
            int_mm_yardstick(d, fc1.q), m * c * 4 + m * c + 2 * m * 4 + n * c + (2 * n + 2 * c) * 4,
            *pair_floor("ln_fc1_rowmax_int8", 2 * m * c * n, m * n), None),
        "mlp_int8_scale_residual": (
            count, lambda: B8.mlp_int8_scale_residual(x_q, x_s, h_s, fc1.q, fc1.s, b1, fc2.q, fc2.s,
                                                      b2, gamma, residual, torch.bfloat16),
            lambda: B8.mlp_int8_scale_residual_plain(x_q, x_s, h_s, fc1.q, fc1.s, b1, fc2.q, fc2.s,
                                                     b2, gamma, residual, torch.bfloat16),
            (library2, None),
            m * c + 2 * m * 4 + 2 * n * c + 2 * n * 4 + 3 * c * 4 + m * c * res_bytes + m * c * 2,
            *pair_floor("mlp_int8_scale_residual", 4 * m * c * n, m * n), None),
    }


# pass 1's codes may differ from its plain version's only where the plain value before
# rounding lies within 2^-11 of k + 0.5 (64 ulps of a code near 127: the kernel's LN is a few
# ulps from torch's), at most 4 or 0.4 % of the values lying there
TIE_WINDOW = 2.0 ** -11


def codes_equal_off_ties(label: str, stats: dict, got: tuple, ln: torch.Tensor,
                         want: tuple) -> None:
    """Pass 1's x codes and scales ``got`` against its plain version's
    ``want`` (codes of the plain LN output ``ln`` with the plain scales):
    the scales within 1e-6 relative, the codes equal but within
    ``TIE_WINDOW`` of a .5 tie, where they may move by one."""
    (x_q, x_s), (p_q, p_s) = got, want
    v = ln.float() * (1.0 / p_s.view(-1, 1))
    near = ((v - torch.floor(v)) - 0.5).abs() <= TIE_WINDOW
    diff = x_q.int() - p_q.int()
    off, n_near = int(torch.count_nonzero(diff[~near])), int(near.sum())
    s_err = ((x_s - p_s).abs() / p_s).max().item()
    d_max = diff.abs().max().item()
    st = stats["ln_fc1_rowmax_int8"]
    st["max_abs_err"] = max(st["max_abs_err"], float(d_max), abs_err(x_s, p_s))
    print(f"[int8k] ln_fc1_rowmax_int8 codes, scales {label}: {int(torch.count_nonzero(diff))} of "
          f"{diff.numel()} codes differ from the plain version's (max {d_max}), {off} of them "
          f"off a .5 tie (must be 0); {n_near} values within {TIE_WINDOW:g} of a tie; scales "
          f"max rel err {s_err:.3e} (bound 1e-6)")
    if off or d_max > 1 or n_near > max(4, 4e-3 * v.numel()) or not s_err <= 1e-6:
        raise AssertionError(f"ln_fc1_rowmax_int8's codes or scales at {label} disagree with "
                             "its plain version")


def check_pair(label: str, stats: dict, d, lg, lb, fc1, b1, fc2, b2, gamma, residual, eps: float,
               chain: tuple) -> tuple:
    """The MLP pair at one shape against the chain's (h_s, out) on the same
    inputs: pass 2's output and pass 1's hidden row scales equal bit for
    bit; pass 1's codes and scales against its plain version
    (:func:`codes_equal_off_ties`), pass 2 within 1e-2 of its plain version
    given pass 1's outputs (the plain GELU is torch's, a few ulps off the
    kernels'). Returns pass 1's outputs."""
    x_q, x_s, h_s = B8.ln_fc1_rowmax_int8(d, lg, lb, fc1.q, fc1.s, b1, eps)
    out = B8.mlp_int8_scale_residual(x_q, x_s, h_s, fc1.q, fc1.s, b1, fc2.q, fc2.s, b2, gamma,
                                     residual, torch.bfloat16)
    torch.cuda.synchronize()
    c_s, c_out = chain
    check_int8(label, stats, {
        "ln_fc1_rowmax_int8 hidden scales vs the chain": (h_s, lambda: c_s, True),
        "mlp_int8_scale_residual vs the chain": (out, lambda: c_out, True),
        "mlp_int8_scale_residual": (out, lambda: B8.mlp_int8_scale_residual_plain(
            x_q, x_s, h_s, fc1.q, fc1.s, b1, fc2.q, fc2.s, b2, gamma, residual, torch.bfloat16),
            False)})
    ln = B8._layer_norm(d, lg, lb, eps)
    codes_equal_off_ties(label, stats, (x_q, x_s), ln, B8.quantize_rows_plain(ln))
    del out, ln
    return x_q, x_s, h_s


def run_int8_calls(calls: dict, label: str, stats: dict, apart: dict, card: str) -> dict:
    """Time each int8 kernel launch of ``calls`` (name -> (count, kernel,
    plain, (library, ``torch._int_mm`` alone) or None, bytes, operations,
    their type, bf16 variant or None)) and add it ``count`` times to the
    kernel's per-forward numbers, the bf16 variant's and ``torch._int_mm``'s
    device times to ``apart``'s two Counters; returns each name's kernel ms
    times ``count``."""
    spent = {}
    for name, (count, kern, plain, yardsticks, nbytes, ops, kind, bf16) in calls.items():
        kernel = name.split(" ")[0]
        lib, int_mm = yardsticks or (None, None)
        times = time_int8(kern, plain, lib)
        bound = account(stats, kernel, count, times, nbytes, ops, kind)
        b_ms = device_ms(bf16, calls=5, replays=4) if bf16 is not None else None
        m_ms = device_ms(int_mm, calls=5, replays=4) if int_mm is not None else None
        if b_ms is not None:
            apart["bf16"][kernel] += count * b_ms
        if m_ms is not None:
            apart["int_mm"][kernel] += count * m_ms
        k_ms, p_ms, l_ms = times
        spent[name] = count * k_ms
        by = "bytes" if nbytes / HBM_BYTES_PER_S * 1e3 >= bound else kind
        print(f"[int8k] {name:26s} {label} x{count}: kernel {k_ms:.3f} ms (device), plain "
              f"{p_ms:.3f} ms, torch._int_mm + quantize {fmt_ms(l_ms)} (_int_mm alone "
              f"{fmt_ms(m_ms)}), bound {bound:.3f} ms ({by}) per launch"
              + (f"; bf16 variant {b_ms:.3f} ms, int8 / bf16 {k_ms / b_ms:.2f}" if b_ms else "")
              + f" [{card}]")
    return spent


def phase_int8_kernels(card: str, stats: dict) -> None:
    """The seven int8 kernels at the main path's batch-256 shapes (ConvNeXt
    s1-s4; GCViT L2-L4, ``ln_qkv_int8`` local q / k / v and global k / v):
    each against its plain version (:func:`check_int8`), the MLP pair also
    against the chain it replaced (:func:`check_pair`), then timed
    (:func:`time_int8`) beside torch._int_mm with the quantize and its bf16
    variant, per launch and per forward; the pair's MLP per forward beside
    the chain's and the bf16 pair's, all by device time in this call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    differ, first = B8.gelu_bits_check(dev)
    facts = B8.gelu_mono_check(dev)
    print(f"[int8k] the pair's GELU over all 2^32 f32 inputs: {differ} differ from "
          f"ln_fc1_gelu_int8's (first {first}); pass 1's facts: {facts} (all but at_peak "
          f"must be 0)")
    if differ or facts["below_zero"] or facts["descents"] or facts["over_peak"]:
        raise AssertionError(f"the pair's GELU: {differ} inputs off the chain's, facts {facts}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    before, apart = snapshot(stats), {"bf16": Counter(), "int_mm": Counter()}
    mlp = Counter()  # ms a forward: the pair, the chain (fc1, the hidden's quantize, fc2)
    bf16 = torch.bfloat16
    for h, w, c, nblocks in STAGES:
        p = block_inputs(BATCH, h, w, c, gen)
        m, n = BATCH * h * w, 4 * c
        x2 = p["x"].view(m, c)
        fc1, fc2 = (dyn_int8.quantize_linear(p[k].float()) for k in ("w1", "w2"))
        d = K.dwconv7x7_nhwc(p["x"], p["dw"], p["dwb"]).view(m, c)
        hid = B8.ln_fc1_gelu_int8(d, p["lg"], p["lb"], fc1.q, fc1.s, p["b1"], 1e-6)
        h_q, h_s = B8.quantize_rows(hid)
        out = B8.fc2_scale_residual_int8(h_q, h_s, fc2.q, fc2.s, p["b2"], p["ls"], x2, bf16)
        torch.cuda.synchronize()
        label = f"({BATCH},{h},{w},{c})"
        check_int8(label, stats, {
            "ln_fc1_gelu_int8": (hid, lambda: B8.ln_fc1_gelu_int8_plain(
                d, p["lg"], p["lb"], fc1.q, fc1.s, p["b1"], 1e-6), False),
            QROWS_HIDDEN: ((h_q, h_s), lambda: B8.quantize_rows_plain(hid), True),
            "fc2_scale_residual_int8": (out, lambda: B8.fc2_scale_residual_int8_plain(
                h_q, h_s, fc2.q, fc2.s, p["b2"], p["ls"], x2, bf16), True)})
        mlp_args = (d, p["lg"], p["lb"], fc1, p["b1"], fc2, p["b2"], p["ls"], x2, 1e-6)
        pass1 = check_pair(label, stats, *mlp_args, (h_s, out))
        hid16 = hid.to(bf16)
        spent = run_int8_calls({
            "ln_fc1_gelu_int8": (
                nblocks, lambda: B8.ln_fc1_gelu_int8(d, p["lg"], p["lb"], fc1.q, fc1.s, p["b1"], 1e-6),
                lambda: B8.ln_fc1_gelu_int8_plain(d, p["lg"], p["lb"], fc1.q, fc1.s, p["b1"], 1e-6),
                int_mm_yardstick(d, fc1.q), m * c * 4 + n * c + (2 * n + 2 * c) * 4 + m * n * 4,
                2 * m * c * n, "int8",
                lambda: K.ln_fc1_gelu(d, p["lg"], p["lb"], p["w1"], p["b1"], 1e-6)),
            QROWS_HIDDEN: (nblocks, lambda: B8.quantize_rows(hid),
                           lambda: B8.quantize_rows_plain(hid), None, m * n * 5 + m * 4,
                           m * n, "f32", None),
            "fc2_scale_residual_int8": (
                nblocks, lambda: B8.fc2_scale_residual_int8(h_q, h_s, fc2.q, fc2.s, p["b2"],
                                                            p["ls"], x2, bf16),
                lambda: B8.fc2_scale_residual_int8_plain(h_q, h_s, fc2.q, fc2.s, p["b2"], p["ls"],
                                                         x2, bf16),
                int_mm_yardstick(hid, fc2.q), m * n + m * 4 + n * c + 3 * c * 4 + 2 * m * c * 2,
                2 * m * n * c, "int8",
                lambda: K.fc2_scale_residual(hid16, p["w2"], p["b2"], p["ls"], x2)),
            **pair_calls(nblocks, *mlp_args, pass1),
        }, label, stats, apart, card)
        mlp["pair"] += sum(spent[n] for n in PAIR)
        mlp["chain"] += sum(spent[n] for n in CHAIN)
        del p, x2, d, hid, hid16, h_q, h_s, out, pass1, mlp_args
        torch.cuda.empty_cache()
    for grid, c, heads, ws, n_local, n_global in INT8_LEVELS:
        p = gcvit_level_inputs(BATCH, grid, c, heads, ws, gen)
        n, m, x, count = p["n"], p["m"], p["x"], n_local + n_global
        qkv8, kv8, p8, f1, f2 = (dyn_int8.quantize_linear(wt.float()) for wt in (
            p["wqkv"], p["wqkv"][c:], p["wp"], p["w1"], p["w2"]))
        t = lambda a: a.view(BATCH, -1, c)  # noqa: E731
        qkv = B8.ln_qkv_int8(x, p["lg"], p["lb"], qkv8.q, qkv8.s, p["bqkv"], 1e-5)
        kv = B8.ln_qkv_int8(x, p["lg"], p["lb"], kv8.q, kv8.s, p["bqkv"][c:], 1e-5)
        attn = G.window_attention(*(t(a) for a in qkv), p["bias"], n, p["scale"]).view(m, c)
        a_q, a_s = B8.quantize_rows(attn)
        r1 = B8.proj_scale_residual_int8(a_q, a_s, p8.q, p8.s, p["bp"], p["g1"], x)
        hid = B8.ln_fc1_gelu_int8(r1, p["lg2"], p["lb2"], f1.q, f1.s, p["b1"], 1e-5)
        h_q, h_s = B8.quantize_rows(hid)
        out = B8.fc2_scale_residual_int8(h_q, h_s, f2.q, f2.s, p["b2"], p["g2"], r1, bf16)
        torch.cuda.synchronize()
        label = f"({BATCH},{grid},{grid},{c}) w{ws}"
        check_int8(label, stats, {
            "ln_qkv_int8 local": (torch.cat(qkv, 1), lambda: torch.cat(B8.ln_qkv_int8_plain(
                x.float(), p["lg"], p["lb"], qkv8.q, qkv8.s, p["bqkv"], 1e-5), 1), False),
            "ln_qkv_int8 global": (torch.cat(kv, 1), lambda: torch.cat(B8.ln_qkv_int8_plain(
                x.float(), p["lg"], p["lb"], kv8.q, kv8.s, p["bqkv"][c:], 1e-5), 1), False),
            "quantize_rows attention": ((a_q, a_s), lambda: B8.quantize_rows_plain(attn), True),
            "proj_scale_residual_int8": (r1, lambda: B8.proj_scale_residual_int8_plain(
                a_q, a_s, p8.q, p8.s, p["bp"], p["g1"], x), True),
            "ln_fc1_gelu_int8": (hid, lambda: B8.ln_fc1_gelu_int8_plain(
                r1, p["lg2"], p["lb2"], f1.q, f1.s, p["b1"], 1e-5), False),
            QROWS_HIDDEN: ((h_q, h_s), lambda: B8.quantize_rows_plain(hid), True),
            "fc2_scale_residual_int8": (out, lambda: B8.fc2_scale_residual_int8_plain(
                h_q, h_s, f2.q, f2.s, p["b2"], p["g2"], r1, bf16), True)})
        mlp_args = (r1, p["lg2"], p["lb2"], f1, p["b1"], f2, p["b2"], p["g2"], r1, 1e-5)
        pass1 = check_pair(label, stats, *mlp_args, (h_s, out))
        hid16, act = hid.to(bf16), m * c * 2  # one bf16 (M, C) activation's bytes
        spent = run_int8_calls({
            "ln_qkv_int8 local": (
                n_local, lambda: B8.ln_qkv_int8(x, p["lg"], p["lb"], qkv8.q, qkv8.s, p["bqkv"], 1e-5),
                lambda: B8.ln_qkv_int8_plain(x, p["lg"], p["lb"], qkv8.q, qkv8.s, p["bqkv"], 1e-5),
                int_mm_yardstick(x, qkv8.q), 4 * act + 3 * c * c + (6 * c + 2 * c) * 4,
                2 * m * c * 3 * c, "int8",
                lambda: G.ln_qkv(x, p["lg"], p["lb"], p["wqkv"], p["bqkv"], 1e-5)),
            "ln_qkv_int8 global": (
                n_global, lambda: B8.ln_qkv_int8(x, p["lg"], p["lb"], kv8.q, kv8.s, p["bqkv"][c:],
                                                 1e-5),
                lambda: B8.ln_qkv_int8_plain(x, p["lg"], p["lb"], kv8.q, kv8.s, p["bqkv"][c:],
                                             1e-5),
                int_mm_yardstick(x, kv8.q), 3 * act + 2 * c * c + (4 * c + 2 * c) * 4,
                2 * m * c * 2 * c, "int8",
                lambda: G.ln_qkv(x, p["lg"], p["lb"], p["wqkv"][c:], p["bqkv"][c:], 1e-5)),
            "quantize_rows attention": (count, lambda: B8.quantize_rows(attn),
                                        lambda: B8.quantize_rows_plain(attn), None,
                                        m * c * 3 + m * 4, m * c, "f32", None),
            "proj_scale_residual_int8": (
                count, lambda: B8.proj_scale_residual_int8(a_q, a_s, p8.q, p8.s, p["bp"], p["g1"], x),
                lambda: B8.proj_scale_residual_int8_plain(a_q, a_s, p8.q, p8.s, p["bp"], p["g1"], x),
                int_mm_yardstick(attn, p8.q), m * c + m * 4 + c * c + 3 * c * 4 + act + m * c * 4,
                2 * m * c * c, "int8",
                lambda: G.proj_scale_residual(attn, p["wp"], p["bp"], p["g1"], x)),
            "ln_fc1_gelu_int8": (
                count, lambda: B8.ln_fc1_gelu_int8(r1, p["lg2"], p["lb2"], f1.q, f1.s, p["b1"], 1e-5),
                lambda: B8.ln_fc1_gelu_int8_plain(r1, p["lg2"], p["lb2"], f1.q, f1.s, p["b1"], 1e-5),
                int_mm_yardstick(r1, f1.q), m * c * 4 + 3 * c * c + (6 * c + 2 * c) * 4 + m * 3 * c * 4,
                2 * m * c * 3 * c, "int8",
                lambda: K.ln_fc1_gelu(r1, p["lg2"], p["lb2"], p["w1"], p["b1"], 1e-5)),
            QROWS_HIDDEN: (count, lambda: B8.quantize_rows(hid),
                           lambda: B8.quantize_rows_plain(hid), None,
                           m * 3 * c * 5 + m * 4, m * 3 * c, "f32", None),
            "fc2_scale_residual_int8": (
                count, lambda: B8.fc2_scale_residual_int8(h_q, h_s, f2.q, f2.s, p["b2"], p["g2"], r1,
                                                          bf16),
                lambda: B8.fc2_scale_residual_int8_plain(h_q, h_s, f2.q, f2.s, p["b2"], p["g2"], r1,
                                                         bf16),
                int_mm_yardstick(hid, f2.q), m * 3 * c + m * 4 + 3 * c * c + 3 * c * 4 + m * c * 4 + act,
                2 * m * 3 * c * c, "int8",
                lambda: K.fc2_scale_residual(hid16, p["w2"], p["b2"], p["g2"], r1)),
            **pair_calls(count, *mlp_args, pass1),
        }, label, stats, apart, card)
        mlp["pair"] += sum(spent[n] for n in PAIR)
        mlp["chain"] += sum(spent[n] for n in CHAIN)
        del p, x, qkv, kv, attn, a_q, a_s, r1, hid, hid16, h_q, h_s, out, pass1, mlp_args
        torch.cuda.empty_cache()
    print_per_forward(stats, before, INT8_KERNELS,
                      "ConvNeXt + GCViTTiny batch-256 forward "
                      f"({CONVNEXT_BLOCKS} + {GCVIT_INT8_BLOCKS} int8 blocks)", card)
    print_per_forward(stats, before, CHAIN, "ConvNeXt + GCViTTiny batch-256 forward, the "
                      "chain the MLP pair replaced (yardstick, off the model path)", card)
    for name, b_ms in apart["bf16"].items():
        k_ms = stats[name]["ms"] - before[name]["ms"]
        print(f"[int8k] {name:26s} per forward: int8 {k_ms:.2f} ms against its bf16 variant "
              f"{BF16_VARIANT[name]} {b_ms:.2f} ms on the same blocks (device), int8 / bf16 "
              f"{k_ms / b_ms:.3f}; torch._int_mm alone {apart['int_mm'][name]:.2f} ms [{card}]")
    bf16_pair = apart["bf16"]["ln_fc1_gelu_int8"] + apart["bf16"]["fc2_scale_residual_int8"]
    passes = ", ".join(f"{n} {stats[n]['ms'] - before[n]['ms']:.2f}" for n in PAIR)
    print(f"[int8k] the MLP per ConvNeXt + GCViTTiny batch-256 forward (device, this call): the "
          f"pair {mlp['pair']:.2f} ms ({passes}), the chain it replaced {mlp['chain']:.2f} ms, "
          f"the bf16 pair {bf16_pair:.2f} ms; pair / chain {mlp['pair'] / mlp['chain']:.3f}, "
          f"pair / bf16 {mlp['pair'] / bf16_pair:.3f} [{card}]")


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
    """Record (input shape without the batch, kernel, stride, padding,
    groups, N) of each ``ptq_int8_conv`` call."""
    real = Q.ptq_int8_conv

    def record(x, qweight, *args, **kw):
        calls.append((tuple(x.shape[1:]), kw["kernel"], kw["stride"], kw["padding"],
                      kw.get("groups", 1), qweight.shape[0]))
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
        _int8_flips(f"{name} {draw}", i8, bf16, b, f32)
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


def _int8_flips(label: str, i8: torch.Tensor, bf16: torch.Tensor, b: int,
                centre: torch.Tensor, names=("int8", "bf16")) -> None:
    """Print int8 against bf16 (or the two paths ``names``): max|d| and the
    decisions at 0.487 that flip between them (the sigmoid of logit 0,
    centred on ``centre``'s batch median: random weights put every image on
    one side otherwise)."""
    shift = float(np.log(0.487 / 0.513)) - centre[:, 0].float().median()
    p_i8, p_bf16 = (torch.sigmoid(t[:, 0].float() + shift) for t in (i8, bf16))
    flips = (p_i8 > 0.487) != (p_bf16 > 0.487)
    a, r = names
    print(f"[int8] {label} b{b} {a} vs {r}: max|d|/max|ref| = {rel_err(i8, bf16):.3e}; "
          f"{int(flips.sum())} of {b} decisions flip at 0.487 (logit 0 centred, {r} p in "
          f"[{p_bf16.min().item():.4f}, {p_bf16.max().item():.4f}], max|p_{a} - p_{r}| = "
          f"{(p_i8 - p_bf16).abs().max().item():.2e})")


def phase_int8_models(card: str) -> None:
    """ConvNeXt@200 and GCViTTiny@224 at full width (``_model``'s weights)
    on the fused path at batch 256 under ``VIPTPU_INT8_KERNELS=1``, the
    int8 weights quantized from the f32 model's (``dyn_int8.attach``, as
    the engine does): the int8 blocks' launches of one forward, the logits
    within 5e-2 of max|ref| of the same model's bf16 kernel path, the
    decisions int8 and bf16 each flip at 0.487 against the plain f32
    forward under ``plain_kernels()`` (logit 0 centred on its batch median),
    and the int8 / bf16 forward ratio (CUDA events, in turns)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(12)
    for name, member in (("convnext_tiny_in22k", "convnext"), ("GCViTTiny", "gcvit")):
        xb = torch.rand((BATCH, *MEMBERS[name][0], 3), generator=gen, device="cuda")
        f32_model = _model(name, torch.float32, fused_block=True)
        state = {k: v.detach().clone() for k, v in f32_model.state_dict().items()}
        model = _model(name, torch.bfloat16, fused_block=True)
        blocks = dyn_int8.attach(model, state)
        del state
        with torch.inference_mode():
            with plain_kernels():
                ref = f32_model(xb)
            del f32_model
            torch.cuda.empty_cache()
            bf16 = model(xb)
            with knobs(VIPTPU_INT8_KERNELS="1"):
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                i8 = model(xb)
                torch.cuda.synchronize()
                launches = all_launches()
                peak = torch.cuda.max_memory_allocated() - base
                with mlp_chain():
                    torch.cuda.reset_peak_memory_stats()
                    i8_chain = model(xb)
                    torch.cuda.synchronize()
                    chain_peak = torch.cuda.max_memory_allocated() - base
        want = int8_forward_launches(1, (member,))
        expect_launches({n: launches[n] for n in want}, want, f"{name} int8 forward")
        # ConvNeXt's s1 hidden in f32 (the chain's fc1 output): (B 50 50, 4 96) at 200 px
        hidden = BATCH * (MEMBERS[name][0][0] // 4) ** 2 * 4 * 96 * 4
        print(f"[int8k] {name} b{BATCH} int8 forward: peak device memory above its input "
              f"{peak / 2 ** 20:.1f} MiB on the pair, {chain_peak / 2 ** 20:.1f} MiB on the chain"
              + (f" (ConvNeXt's s1 f32 hidden alone {hidden / 2 ** 20:.1f} MiB)"
                 if member == "convnext" else "")
              + f"; logits pair against chain max|d| {abs_err(i8, i8_chain):.3e} "
              f"({'equal' if torch.equal(i8, i8_chain) else 'not equal'}) [{card}]")
        if not torch.equal(i8, i8_chain):  # the pair is the chain's bits; the rest too
            raise AssertionError(f"{name}: the pair's logits differ from the chain's")
        if member == "convnext" and not chain_peak - peak >= hidden / 2:
            raise AssertionError(f"{name}: the pair's forward peaks at {peak} bytes, the chain's "
                                 f"at {chain_peak}: not an s1 hidden ({hidden}) apart")
        if i8.shape != bf16.shape or not torch.isfinite(i8).all():
            raise AssertionError(f"{name} int8 logits {tuple(i8.shape)} not finite")
        r = rel_err(i8, bf16)
        print(f"[int8k] {name} b{BATCH} int8 blocks ({blocks} quantized from f32) vs the bf16 "
              f"kernel path: max|d|/max|ref| = {r:.3e} (bound {MODEL_BOUND:g})")
        if not r <= MODEL_BOUND:
            raise AssertionError(f"{name} int8 logits disagree with the bf16 path: {r:.3e}")
        _int8_flips(name, i8, ref, BATCH, ref, names=("int8", "plain f32"))
        _int8_flips(name, bf16, ref, BATCH, ref, names=("bf16", "plain f32"))
        with torch.inference_mode():
            fwd = lambda: model(xb)  # noqa: E731
            b1 = cuda_ms(fwd, iters=3, warmup=1)
            with knobs(VIPTPU_INT8_KERNELS="1"):
                i1, i2 = cuda_ms(fwd, iters=3, warmup=1), cuda_ms(fwd, iters=3, warmup=1)
            b2 = cuda_ms(fwd, iters=3, warmup=1)
        print(f"[int8k] {name} batch-{BATCH} forward: bf16 {(b1 + b2) / 2:.2f} ms "
              f"({BATCH * 2000 / (b1 + b2):.1f} img/s), VIPTPU_INT8_KERNELS=1 {(i1 + i2) / 2:.2f} "
              f"ms ({BATCH * 2000 / (i1 + i2):.1f} img/s), int8 / bf16 {(i1 + i2) / (b1 + b2):.3f} "
              f"[{card}]")
        del model, xb, ref, bf16, i8, i8_chain
        torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_ptq_sites():
    """The int8 PTQ site (``ptq_int8_conv``) alone on its plain version; every
    other kernel as it is."""
    real = Q.ptq_int8_conv
    Q.ptq_int8_conv = Q.ptq_int8_conv_plain
    try:
        yield
    finally:
        Q.ptq_int8_conv = real


def phase_int8_other(name: str, card: str, profile: bool, state: dict = None) -> list:
    """int8 on a member beyond ResNetRS50 / ResNest50: ConvNeXt or GCViT
    (``_model``'s weights, the fused block path; ``state`` None) or an
    EfficientNet or ECA_NFNetL0 (``state``, its phase-6 f32 weights). The
    bf16 model and a second copy calibrated on 64 images of the batch-256
    input and quantized from the f32 weights: the calibrated, quantized and
    kernel-called sites per forward (at batch 2: GCViT's SE Linears take
    the batch as rows) all ``INT8_SITES[name]``; at batch 8 and 256 the int8
    kernel path within ``INT8_BOUND`` of max|ref| of the same model with
    its int8 sites alone on their plain version (the same integer sums and
    f32 epilogue), and within 5e-2 of it with every kernel plain (its other
    kernels, bf16, differ from their plain versions by rounding); int8
    against bf16 printed; the batch-256 bf16 and int8 forwards timed.
    Returns the int8 sites called in one forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size = MEMBERS[name][0] if name in MEMBERS else SIZES[name]
    width = MEMBERS[name][1] if name in MEMBERS else 1000
    if state is None:
        f32_model = _model(name, torch.float32, fused_block=True)
        state = {k: v.detach().clone() for k, v in f32_model.state_dict().items()}
        del f32_model
        build = lambda: _model(name, torch.bfloat16, fused_block=True)  # noqa: E731
    else:
        build = lambda: _member(name, torch.bfloat16, state)  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(7)
    x8 = torch.rand((8, *size, 3), generator=gen, device="cuda")
    xb = torch.rand((BATCH, *size, 3), generator=gen, device="cuda")
    bf16_model = build()
    int8_model = copy.deepcopy(bf16_model)
    scales = quant.calibrate(int8_model, [xb[:64]])
    report, calls = {}, []
    quant.quantized(int8_model, scales, report=report, weights=state)
    del state
    with torch.inference_mode(), recording_ptq_sites(calls):
        int8_model(x8[:2])
    groups = sum(c[4] > 1 for c in calls)
    print(f"[int8] {name}: {len(scales)} calibrated sites, {len(report['quantized_sites'])} "
          f"quantized, {len(calls)} kernel calls per forward ({groups} grouped) (JAX: "
          f"{INT8_SITES[name]})")
    if not len(scales) == len(report["quantized_sites"]) == len(calls) == INT8_SITES[name]:
        raise AssertionError(f"{name}'s int8 sites differ from the JAX pass's {INT8_SITES[name]}")
    for x in (x8, xb):
        b = x.shape[0]
        with torch.inference_mode():
            bf16, i8 = bf16_model(x), int8_model(x)
            with plain_ptq_sites():
                i8_sites_plain = int8_model(x)
            with plain_kernels():
                i8_plain = int8_model(x)
            torch.cuda.synchronize()
        for label, got in (("bf16", bf16), ("int8", i8)):
            if got.shape != (b, width) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {label} b{b}: output {tuple(got.shape)} not finite")
        for label, ref, bound in (("int8 sites plain", i8_sites_plain, INT8_BOUND),
                                  ("every kernel plain", i8_plain, MODEL_BOUND)):
            r = rel_err(i8, ref)
            print(f"[int8] {name} b{b} int8 kernel path vs {label}: max|d|/max|ref| = {r:.3e} "
                  f"(bound {bound:g}), max|ref| = {ref.float().abs().max().item():.3e}")
            if not r <= bound:
                raise AssertionError(f"{name} b{b} int8 kernel path vs {label}: {r:.3e}")
        _int8_flips(name, i8, bf16, b, bf16)
        del bf16, i8, i8_sites_plain, i8_plain
    with torch.inference_mode():
        fwd_b, fwd_i = (lambda: bf16_model(xb)), (lambda: int8_model(xb))
        b1, i1, i2, b2 = (cuda_ms(f, iters=3, warmup=1) for f in (fwd_b, fwd_i, fwd_i, fwd_b))
        print(f"[int8] {name} batch-{BATCH} forward: bf16 {(b1 + b2) / 2:.2f} ms "
              f"({BATCH * 2000 / (b1 + b2):.1f} img/s), int8 {(i1 + i2) / 2:.2f} ms "
              f"({BATCH * 2000 / (i1 + i2):.1f} img/s), int8 / bf16 {(i1 + i2) / (b1 + b2):.3f} "
              f"[{card}]")
        if profile:
            print_profile(f"{name} int8", fwd_i)
    del bf16_model, int8_model, x8, xb
    torch.cuda.empty_cache()
    return calls


def phase_layernorm_gc(card: str) -> None:
    """The LN kernel at EfficientNetV2T_GC's ``gc_ln`` widths (not multiples
    of the kernel's 16-byte vector but 32: its scalar path), recorded from
    one full-width bf16 forward at 200 x 200 (whose launches are counted),
    and at one odd width, on (256, 1, 1, C) rows in bf16: within 1e-2 of
    max|ref| of the plain version, timed beside it and ``F.layer_norm``.
    V2T_GC is no member of the manifest: its launches, times and bounds are
    printed on lines of their own and kept out of the LN kernel's record."""
    model, _ = create_model(GC_NAME, input_size=GC_SIZE, classifier_activation=None,
                            dtype=torch.bfloat16, seed=0)
    model = model.cuda()
    calls = []
    L.reset_launches()
    with torch.inference_mode(), recording_layer_norms(calls):
        out = model(torch.rand((2, *GC_SIZE, 3), device="cuda"))
        torch.cuda.synchronize()
    launches = L.LAUNCHES[LN]
    del model
    torch.cuda.empty_cache()
    widths = Counter(shape[-1] for shape, _, _ in calls)
    print(f"[kernels] {GC_NAME} {GC_SIZE[0]}x{GC_SIZE[1]} forward: {launches} {LN} launches, "
          f"widths {dict(sorted(widths.items()))} (expected {GC_LN_WIDTHS}); output "
          f"{tuple(out.shape)} finite {bool(torch.isfinite(out).all())}")
    if dict(widths) != GC_LN_WIDTHS or launches != sum(GC_LN_WIDTHS.values()) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"{GC_NAME}: LN widths {dict(widths)}, {launches} launches")
    gen = torch.Generator(device="cuda").manual_seed(13)
    eps = calls[0][2]
    own = new_stats()  # the check's error, apart from the record's
    per_forward = [0.0, 0.0, 0.0, 0.0]  # kernel, plain, library, bound: ms per forward
    for c, count in [*sorted(GC_LN_WIDTHS.items()), (GC_ODD_WIDTH, 0)]:
        x = (torch.rand((BATCH, 1, 1, c), generator=gen, device="cuda") * 4 - 2).to(torch.bfloat16)
        w = torch.rand((c,), generator=gen, device="cuda") + 0.5
        bb = torch.rand((c,), generator=gen, device="cuda") * 0.2 - 0.1
        out = L.layer_norm(x, w, bb, eps)
        torch.cuda.synchronize()
        label = f"{GC_NAME} gc_ln {tuple(x.shape)} x{count}" if count else f"odd width {c}"
        check({LN: (out, lambda: L.layer_norm_plain(x.float(), w, bb, eps))}, label, own)
        times = time_calls(lambda: L.layer_norm(x, w, bb, eps),
                           lambda: L.layer_norm_plain(x, w, bb, eps),
                           lambda: F.layer_norm(x.float(), (c,), w, bb, eps).to(x.dtype))
        nbytes, ops = 2 * x.numel() * x.element_size() + 2 * c * 4, 8 * x.numel()
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["f32"]) * 1e3
        print(f"[kernels] {LN:26s} {label} kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms, "
              f"library {times[2]:.4f} ms, bound {bound:.2e} ms per launch [{card}]")
        for i, t in enumerate((*times, bound)):
            per_forward[i] += count * t
    k_ms, p_ms, l_ms, b_ms = per_forward
    print(f"[kernels] {LN} per {GC_NAME} batch-{BATCH} forward ({launches} launches, not in the "
          f"record): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library {l_ms:.3f} ms, bound "
          f"{b_ms:.2e} ms; max|d| {own[LN]["max_abs_err"]:.3e} [{card}]")


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
    bf16 conv (a Linear site: ``F.linear``) of the same site for context (no
    one call computes the int8 site, so no library time); then, with
    ``tool``, the ``exp_ptq_int8`` tool's phase cuts."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    per_forward = Counter(calls)
    before = snapshot(stats)
    cudnn_total = int_mm_total = site_total = 0.0
    int_mm_refused = 0
    per_tensor = {"ms": 0.0, "codes": 0, "differ": 0}
    for b in (8, BATCH):
        for (shape, kernel, stride, padding, groups, n), count in per_forward.items():
            c = shape[-1]  # a conv's x (B, H, W, C), a Linear's (B, C) (GCViT's SE)
            x = torch.randn((b, *shape), generator=gen, device="cuda").to(torch.bfloat16)
            k = (kernel or 1) ** 2 * c // groups
            qw = Q.pack_weight(torch.randint(-127, 128, (k, n), generator=gen, device="cuda")
                               .to(torch.int8))
            cs = torch.rand((n,), generator=gen, device="cuda") * 1e-3
            inv = Q.f32_reciprocal(x.float().abs().max().item() / 127.0)
            kw = dict(kernel=kernel, stride=stride, padding=padding, groups=groups)
            gkw = dict(kw, out_dtype=torch.bfloat16)
            out = Q.ptq_int8_conv(x, qw, cs, None, inv, **kw)
            xq = Q.ptq_int8_quantize(x, inv)
            # the GEMM's A as the site gives it: x quantized by the pass, or x itself
            in_gemm = Q.quantizes_in_gemm(x.dtype, x.dtype, k=k, n=n, **kw)
            a, a_inv = (x, inv) if in_gemm else (xq, None)
            gemm = Q.ptq_int8_gemm(a, qw, cs, None, inv_s=a_inv, **gkw)
            torch.cuda.synchronize()
            label = (f"{name} b{b} {(b, *shape)} -> {n} "
                     + (f"k{kernel} s{stride}" if kernel else "Linear")
                     + (f" g{groups}" if groups > 1 else "") + f" x{count}"
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
                if kernel is None:  # a Linear site: cuBLAS's bf16 product
                    wl = torch.randn((n, c), generator=gen, device="cuda").to(torch.bfloat16)
                    cudnn = cuda_ms(lambda: F.linear(x, wl))
                else:
                    wc = torch.randn((n, c // groups, kernel, kernel), generator=gen,
                                     device="cuda").to(torch.bfloat16)
                    (pt, pb), (pl, pr) = Q.padding_pairs(padding)
                    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
                    cudnn = cuda_ms(lambda: F.conv2d(xc, wc, None, stride, 0, groups=groups))
                cudnn_total += count * cudnn
                rows = kernel in (None, 1) and groups == 1
                int_mm = None
                if rows:  # a 1 x 1 or Linear site is an (M, K) @ (K, N) product
                    xr = xq.view(-1, c)
                    wq = qw[:, :c].contiguous()  # (N, K): the column-major B cuBLASLt takes
                    try:  # a yardstick: cuBLASLt refuses some int8 shapes (N = 40, K = 96)
                        int_mm = cuda_ms(lambda: torch._int_mm(xr, wq.t()))
                        int_mm_total += count * int_mm
                    except RuntimeError as err:
                        int_mm_refused += count
                        print(f"[kernels] {'':26s} torch._int_mm refuses {label}: "
                              f"{str(err).splitlines()[0][:80]}")
                if not in_gemm:  # the pass: bf16 x read, int8 written
                    q_times = time_calls(lambda: Q.ptq_int8_quantize(x, inv),
                                         lambda: Q.ptq_int8_quantize_plain(x, inv))
                    q_bound = account(stats, QUANT, count, q_times, x.numel() * 3, x.numel(),
                                      "f32")
                    print_launch(QUANT, label, q_times, q_bound, card)
                    quantize_per_tensor_yardstick(x, inv, xq, count, per_tensor)
                a_bytes = x.numel() * a.element_size()  # int8 after the pass, else bf16
                g_bound = account(stats, PTQ, count, g_times, a_bytes + k * n + m * n * 2 + n * 4,
                                  2 * m * k * n, "int8")
                print_launch(PTQ, label, g_times, g_bound, card)
                print(f"[kernels] {'':26s} the site (both launches) {site:.3f} ms; bf16 "
                      f"{'conv' if kernel else 'F.linear'} of the same site {cudnn:.3f} ms"
                      + (f", torch._int_mm on its pre-quantized rows {int_mm:.3f} ms"
                         if int_mm is not None else ""))
            del x, qw, out, xq, gemm, a
            torch.cuda.empty_cache()
    print_per_forward(stats, before, (QUANT, PTQ), f"{name} batch-256 int8 forward "
                      f"({sum(per_forward.values())} sites)", card)
    PTQ_YARDSTICKS.update(sites=sum(per_forward.values()), cudnn=cudnn_total, int_mm=int_mm_total,
                          refused=int_mm_refused)
    print(f"[kernels] the {sum(per_forward.values())} int8 sites per {name} batch-256 forward: "
          f"both launches {site_total:.2f} ms; in bf16 convs / F.linear {cudnn_total:.2f} ms; the "
          f"1 x 1 and Linear sites as torch._int_mm on pre-quantized rows {int_mm_total:.2f} ms "
          f"(refused at {int_mm_refused}) [{card}]")
    print(f"[kernels] {QUANT} beside torch.quantize_per_tensor (f32 copy, qint8, scale 1 / "
          f"inv_s) at the {name} sites that run the pass: {per_tensor['ms']:.3f} ms per forward "
          f"(events), {per_tensor['differ']} of {per_tensor['codes']} codes differ; clamp "
          f"probe {quantize_clamp_probe()} [{card}]")
    if tool:
        exp_ptq_int8.main(["--iters", "10"])  # the site's phase cuts


# the PTQ site's yardsticks summed over the members phase_ptq_sites saw: their
# sites, cuDNN's bf16 convs (F.linear at a Linear site) and torch._int_mm at
# the 1 x 1 and Linear sites, ms per batch-256 forward
PTQ_YARDSTICKS = Counter()


def _quantize_per_tensor(x: torch.Tensor, inv: float) -> torch.Tensor:
    return torch.quantize_per_tensor(x.float(), 1.0 / inv, 0, torch.qint8).int_repr()


def quantize_per_tensor_yardstick(x, inv: float, xq, count: int, totals: dict) -> None:
    """``torch.quantize_per_tensor``, the one PyTorch call nearest the PTQ
    pass: its codes against the kernel's on the same x (it rounds half to
    even too, but takes f32 only and clamps to [-128, 127], the pass to
    [-127, 127]) and its time (CUDA events, as the pass's), ``count`` times
    into ``totals``."""
    codes = _quantize_per_tensor(x, inv)
    totals["differ"] += count * int((codes != xq).sum().item())
    totals["codes"] += count * xq.numel()
    totals["ms"] += count * cuda_ms(lambda: _quantize_per_tensor(x, inv))


def quantize_clamp_probe() -> str:
    """The pass and ``torch.quantize_per_tensor`` at inv_s 1 on values past
    the range and on half steps."""
    x = torch.tensor([-130.0, -127.6, 127.6, 0.5, 1.5, 2.5, -2.5, 3.0], device="cuda")
    return (f"x {x.tolist()}: pass {Q.ptq_int8_quantize(x, 1.0).tolist()}, "
            f"quantize_per_tensor {_quantize_per_tensor(x, 1.0).tolist()}")


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
                                       (kernel or 1) ** 2 * shape[-1] // groups, n, groups)
               for shape, kernel, stride, padding, groups, n in calls)


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


def phase_slice_seven(card: str, dw_sites: int, int8_sites: int, int8_passes: int,
                      all_sites: int, all_passes: int) -> dict:
    """The product contract: the seven members of ``ckpts/ckpts.json``
    (``MANIFEST``, checked against the file) through ``main_torch.main``,
    cold and warm: every kernel of the fused block families at each block,
    the LN kernel at each standalone LN, K9 at each of the ``dw_sites``
    stride-1 depthwise sites of one forward (GCViT's and both
    EfficientNets'), per batch, and no int8 kernel. Then warm with
    ``VIPTPU_INT8=ResNetRS50,ResNest50`` (the JAX package's ``INT8_AUTO``
    set): the same, and ``ptq_int8_conv`` at the ``int8_sites`` of both
    members and ``ptq_int8_quantize`` at the ``int8_passes`` of them that
    run the pass, per batch. Then with ``VIPTPU_INT8=all``: the fused-path
    launches of one forward more (the calibration forward of each member,
    before any site is swapped), ``ptq_int8_conv`` at the ``all_sites`` of
    the seven members and ``ptq_int8_quantize`` at the ``all_passes`` of
    them, per batch. Returns K9's launches in the cold run and the int8 kernels' in
    the ``all`` run."""
    with open(os.path.join(REPO, "ckpts", "ckpts.json")) as fh:
        if json.load(fh) != MANIFEST:
            raise AssertionError("MANIFEST is not ckpts/ckpts.json")
    batches = -(-N_IMAGES // BATCH)
    with csv_workspace(MANIFEST) as (input_csv, output_csv, times, names):
        cold_launches, cold, batch_c, _ = run_csv(input_csv, output_csv, names, times)
        warm_launches, warm, batch_w, _ = run_csv(input_csv, output_csv, names, times)
        with knobs(VIPTPU_INT8="ResNetRS50,ResNest50"):
            int8_launches, t_int8, batch_i, _ = run_csv(input_csv, output_csv, names, times)
        with knobs(VIPTPU_INT8="all"):
            all_launches_, t_all, batch_a, _ = run_csv(input_csv, output_csv, names, times)
    fused = seven_launches(batches, dw_sites)
    for label, launches in (("seven-member cold", cold_launches),
                            ("seven-member warm", warm_launches)):
        expect_launches(launches, {**fused, PTQ: 0, QUANT: 0}, f"{label} CSV->CSV")
    expect_launches(int8_launches, {**fused, PTQ: batches * int8_sites,
                                    QUANT: batches * int8_passes,
                                    **{n: 0 for n in SPIKE_KERNELS}},
                    "seven-member VIPTPU_INT8=ResNetRS50,ResNest50 CSV->CSV")
    expect_launches(all_launches_, {**seven_launches(batches + 1, dw_sites),
                                    PTQ: batches * all_sites,
                                    QUANT: batches * all_passes,
                                    **{n: 0 for n in SPIKE_KERNELS}},
                    "seven-member VIPTPU_INT8=all CSV->CSV")
    ms = lambda s: ", ".join(f"{t * 1000:.1f} ms" for t in s)  # noqa: E731
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, 7 members: cold {cold:.2f} s "
          f"({N_IMAGES / cold:.1f} img/s; per-batch e2e {ms(batch_c)}), warm {warm:.2f} s "
          f"({N_IMAGES / warm:.1f} img/s; per-batch e2e {ms(batch_w)}) [{card}]")
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, 7 members, "
          f"VIPTPU_INT8=ResNetRS50,ResNest50: {t_int8:.2f} s ({N_IMAGES / t_int8:.1f} img/s; "
          f"per-batch e2e {ms(batch_i)}) [{card}]")
    print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, 7 members, VIPTPU_INT8=all: "
          f"{t_all:.2f} s ({N_IMAGES / t_all:.1f} img/s; per-batch e2e {ms(batch_a)}) beside "
          f"bf16 warm {warm:.2f} s ({N_IMAGES / warm:.1f} img/s; per-batch e2e {ms(batch_w)}) "
          f"[{card}]")
    return {DW: cold_launches[DW], PTQ: all_launches_[PTQ], QUANT: all_launches_[QUANT]}


def phase_slice_int8_kernels(card: str, dw_sites: int, all_sites: int,
                             all_passes: int) -> dict:
    """``VIPTPU_INT8_KERNELS=1`` through ``main_torch.main``, every member
    with a one-output sigmoid head (:func:`binary_heads`): the two-member
    manifest (ConvNeXt, GCViT), then the seven members, each run between two
    runs of the same manifest without the knob (the first a warm-up, the
    second the yardstick); the seven also with the MLP on the chain the pair
    replaced (:func:`mlp_chain`, no decision may flip against the pair's
    run) and with ``VIPTPU_INT8=all``. Each must launch the int8 block kernels at each
    block of ConvNeXt and of GCViT's L2-L4, the bf16 ones at L1
    (:func:`int8_forward_launches`) and everything else as without the
    knob; its raw means within 5e-2 of the bf16 run's (decisions flipped
    printed); its img/s printed. Returns the int8 kernels' launches of the
    seven-member run."""
    batches = -(-N_IMAGES // BATCH)
    fused_two = {**{n: 0 for n in (ATTN, PTQ, QUANT)}, LN: batches * (CONVNEXT_LNS + GCVIT_LNS)}
    with binary_heads():  # each manifest's bf16 run first (warm-up) and last, in turns
        with csv_workspace(TWO) as (input_csv, output_csv, times, names):
            run_csv(input_csv, output_csv, names)
            with knobs(VIPTPU_INT8_KERNELS="1"):
                two, t_two, batch_2, two_int8 = run_csv(input_csv, output_csv, names, times)
            _, t_b2, _, two_bf16 = run_csv(input_csv, output_csv, names, times)
        expect_launches(two, {**fused_two, **int8_forward_launches(batches)},
                        "two-member VIPTPU_INT8_KERNELS=1 CSV->CSV")
        compare_raw("two members VIPTPU_INT8_KERNELS=1", two_int8, two_bf16, "bf16",
                    bound=MODEL_BOUND, tag="slice")
        with csv_workspace(MANIFEST) as (input_csv, output_csv, times, names):
            run_csv(input_csv, output_csv, names)
            with knobs(VIPTPU_INT8_KERNELS="1"):
                seven, t_seven, batch_s, seven_int8 = run_csv(input_csv, output_csv, names, times)
                with mlp_chain():  # the MLP on the chain the pair replaced: the yardstick run
                    chain, t_chain, batch_c, seven_chain = run_csv(input_csv, output_csv, names,
                                                                   times)
            with knobs(VIPTPU_INT8_KERNELS="1", VIPTPU_INT8="all"):
                both, t_both, batch_a, both_int8 = run_csv(input_csv, output_csv, names, times)
            _, t_bf16, batch_b, seven_bf16 = run_csv(input_csv, output_csv, names, times)
    expect_launches(seven, {**seven_launches(batches, dw_sites),
                            **int8_forward_launches(batches)},
                    "seven-member VIPTPU_INT8_KERNELS=1 CSV->CSV")
    expect_launches(both, {**seven_launches(batches + 1, dw_sites),
                           **int8_forward_launches(batches + 1),
                           PTQ: batches * all_sites, QUANT: batches * all_passes},
                    "seven-member VIPTPU_INT8_KERNELS=1 VIPTPU_INT8=all CSV->CSV")
    expect_launches(chain, {**seven_launches(batches, dw_sites),
                            **int8_forward_launches(batches, chain=True)},
                    "seven-member VIPTPU_INT8_KERNELS=1 CSV->CSV on the MLP chain")
    compare_raw("seven members VIPTPU_INT8_KERNELS=1", seven_int8, seven_bf16, "bf16",
                bound=MODEL_BOUND, tag="slice")
    compare_raw("seven members VIPTPU_INT8_KERNELS=1 (the MLP pair)", seven_int8, seven_chain,
                "the MLP chain", bound=None, tag="slice")
    flips = int(((seven_int8["raw"] > 0.487) != (seven_chain["raw"] > 0.487)).sum())
    if flips:
        raise AssertionError(f"the MLP pair flips {flips} decisions against the chain")
    compare_raw("seven members VIPTPU_INT8_KERNELS=1 VIPTPU_INT8=all", both_int8, seven_bf16,
                "bf16", bound=None, tag="slice")
    ms = lambda s: ", ".join(f"{t * 1000:.1f} ms" for t in s)  # noqa: E731
    for label, t, batch_t, ref in (("2 members", t_two, batch_2, t_b2),
                                   ("7 members", t_seven, batch_s, t_bf16),
                                   ("7 members, the MLP chain", t_chain, batch_c, t_bf16),
                                   ("7 members, VIPTPU_INT8=all", t_both, batch_a, t_bf16)):
        print(f"[slice] CSV->CSV {N_IMAGES} images, batch {BATCH}, {label}, "
              f"VIPTPU_INT8_KERNELS=1 (sigmoid heads): {t:.2f} s ({N_IMAGES / t:.1f} img/s; "
              f"per-batch e2e {ms(batch_t)}) beside bf16 {ref:.2f} s ({N_IMAGES / ref:.1f} img/s) "
              f"[{card}]")
    print(f"[slice] seven-member bf16 per-batch e2e {ms(batch_b)} [{card}]")
    print(f"[int8k] the MLP chain (yardstick, off the model path) in the seven-member "
          f"VIPTPU_INT8_KERNELS=1 CSV run on it: launches "
          f"{ {n: chain[n] for n in CHAIN_KERNELS + ('quantize_rows',)} }; on the pair's run "
          f"{ {n: seven[n] for n in CHAIN_KERNELS} } [{card}]")
    return {n: seven[n] for n in INT8_KERNELS}


def seven_launches(forwards: int, dw_sites: int) -> dict:
    """The launches ``forwards`` forwards of the seven members make on the
    fused block path, bf16: every fused-block kernel at each block, the LN
    kernel at each standalone LN, K9 at each of the ``dw_sites``; no
    unfused attention and no int8 kernel (PTQ or block)."""
    return {**{n: None for n in GCVIT_KERNELS}, "dwconv7x7_nhwc": forwards * CONVNEXT_BLOCKS,
            "ln_qkv": forwards * GCVIT_BLOCKS, "proj_scale_residual": forwards * GCVIT_BLOCKS,
            **{n: forwards * (CONVNEXT_BLOCKS + GCVIT_BLOCKS) for n in MLP_KERNELS},
            ATTN: 0, LN: forwards * (CONVNEXT_LNS + GCVIT_LNS), DW: forwards * dw_sites,
            PTQ: 0, QUANT: 0, **{n: 0 for n in INT8_KERNELS + CHAIN_KERNELS}}


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


# ---------------------------------------------------------------------------
# f32 compute on the card (VIPTPU_DTYPE=float32): the fused blocks' f32 modes
# (K1/K2, K4, K5, K6), and K8, K9 and K10 in f32
# ---------------------------------------------------------------------------
F32_LOGIT_BOUND = 2e-4  # of max(1, max|ref|): a member's f32 kernel path against plain f32
F32_PROB_BOUND = 1e-4  # a member's f32 probabilities against plain f32 and its unfused path
F32_TIE = 1e-4  # a decision may differ only for a score this close to 0.487
F32_TRAIN_BOUND, F32_TRAIN_COS = 1e-4, 0.9999  # one f32 step against the plain f32 step
F32_TRAIN_BATCH = 16
F32_TRAIN_LR = 1.0  # SGD at lr 1 moves each parameter by minus its gradient
THR = 0.487
FUSED_MEMBERS = ("GCViTTiny", "convnext_tiny_in22k")
# one seven-member f32 forward's launches: GCViT's 31 and ConvNeXt's 18 fused blocks on the
# f32 block kernels (the MLP pair in both), K9 at GCViT's 11, V2T's 27 and V1B4's 28
# stride-1 depthwise sites, the LNs outside the blocks (K8 f32 runs only on the unfused
# block: in training, or with VIPTPU_NO_FUSED_BLOCK)
F32_BLOCKS = {**{n: GCVIT_BLOCKS for n in GCVIT_F32},
              "dwconv7x7_nhwc_f32": CONVNEXT_BLOCKS,
              **{n + "_f32": GCVIT_BLOCKS + CONVNEXT_BLOCKS for n in MLP_KERNELS}}
F32_FORWARD = {**F32_BLOCKS, DW32: GCVIT_DW_SITES + sum(DW_SITES.values()),
               LN32: CONVNEXT_LNS + GCVIT_LNS}
# an f32 eval step's launches (the fused block), and an f32 training step's (the unfused
# block, forward only: the backwards are plain)
F32_EVAL_LAUNCHES = {"GCViTTiny": {**{n: GCVIT_BLOCKS for n in GCVIT_F32},
                                   **{n + "_f32": GCVIT_BLOCKS for n in MLP_KERNELS},
                                   DW32: GCVIT_DW_SITES, LN: GCVIT_LNS},
                     "convnext_tiny_in22k": {**{n: CONVNEXT_BLOCKS for n in CONVNEXT_F32},
                                             LN: CONVNEXT_LNS}}
F32_TRAIN_LAUNCHES = {"GCViTTiny": {ATTN32: GCVIT_BLOCKS, DW32: GCVIT_DW_SITES,
                                    LN: GCVIT_LNS + 2 * GCVIT_BLOCKS},
                      "convnext_tiny_in22k": {DW32: CONVNEXT_BLOCKS,
                                              LN: CONVNEXT_LNS + CONVNEXT_BLOCKS}}


@contextlib.contextmanager
def counting_plain(counts: Counter):
    """Count in ``counts`` the calls of every model kernel's plain version
    (``reference.MODEL_KERNELS``)."""
    saved = []
    for module, name in MODEL_KERNELS:
        real = getattr(module, name + "_plain")

        def counted(*args, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*args, **kw)

        saved.append((module, name + "_plain", real))
        setattr(module, name + "_plain", counted)
    try:
        yield
    finally:
        for module, attr, real in saved:
            setattr(module, attr, real)


@contextlib.contextmanager
def recording_tf32(seen: set):
    """Record in ``seen`` the (cuBLAS, cuDNN) TF32 flags at each LN call:
    the state the forward around it runs in."""
    real = L.layer_norm

    def record(x, weight, bias, eps):
        seen.add((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(x, weight, bias, eps)

    L.layer_norm = record
    try:
        yield
    finally:
        L.layer_norm = real


def f32_member(name: str, dim) -> torch.nn.Module:
    """Full-width ``name`` at ``dim`` in f32 as the engine builds it (GCViT
    and ConvNeXt on the auto block path: their fused blocks on the card),
    seeded weights, one output, logits out."""
    model, _ = create_model(name, input_size=tuple(dim), nb_classes=1, classifier_activation=None,
                            dtype=torch.float32, seed=0)
    return model.cuda().eval()


def f32_members(card: str, gen) -> tuple:
    """Each member of ``MANIFEST`` in f32: its batch-8 logits on the kernel
    path against ``plain_kernels()`` (TF32 off), within ``F32_LOGIT_BOUND``
    of max(1, max|ref|), its probabilities within ``F32_PROB_BOUND``, the
    decisions at 0.487 equal but within ``F32_TIE`` of it; GCViT's and
    ConvNeXt's (on their fused f32 blocks, only the f32 block kernels
    launched) also against their unfused f32 forward
    (``VIPTPU_NO_FUSED_BLOCK=1``) under the same bounds; its batch-256 f32
    forward timed (CUDA events, a warm-up and two runs; the fused members'
    fused and unfused forwards in turns, fused, unfused, unfused, fused).
    Returns each member's K9 sites and every LN call (shape without the
    batch, dtype, eps) of one forward."""
    sites, lns, forward_ms, unfused_ms = {}, Counter(), {}, {}
    for base, dim, _ in MANIFEST:
        name = engine.registry_name(base)
        model = f32_member(name, dim)
        x = torch.rand((8, *dim, 3), generator=gen, device="cuda")
        dw_calls, ln_calls = [], []
        with torch.inference_mode():
            with recording_depthwise(dw_calls), recording_layer_norms(ln_calls):
                model(x[:1])
            reset_launches()
            got = model(x)
            launches = all_launches()
            with plain_kernels():
                ref = model(x)
            refs = {"plain f32": ref}
            if name in FUSED_MEMBERS:
                with knobs(VIPTPU_NO_FUSED_BLOCK="1"):
                    refs["unfused f32"] = model(x)
        torch.cuda.synchronize()
        sites[name] = Counter(dw_calls)
        lns.update(ln_calls)
        top = ref.abs().max().item()
        # the block kernels launched, bf16 or f32, against one forward's f32 block launches
        blocks = {n: c for n, c in launches.items()
                  if c and n in BLOCK_F32 + CONVNEXT_KERNELS + GCVIT_KERNELS}
        want = {n: c for n, c in F32_EVAL_LAUNCHES.get(name, {}).items() if n in BLOCK_F32}
        line, bad = [], blocks != want
        for path, other in refs.items():
            d = (got - other).abs().max().item() / max(1.0, top)
            dp = (torch.sigmoid(got) - torch.sigmoid(other)).abs().max().item()
            p, p_ref = torch.sigmoid(got), torch.sigmoid(other)
            flips = int((((p > THR) != (p_ref > THR)) & ((p_ref - THR).abs() > F32_TIE)).sum())
            line.append(f"vs {path}: max|d| / max(1, max|ref|) = {d:.3e} (bound "
                        f"{F32_LOGIT_BOUND:g}), max|dp| = {dp:.3e} (bound {F32_PROB_BOUND:g}), "
                        f"decisions at {THR} that differ away from it: {flips}")
            bad = bad or not d <= F32_LOGIT_BOUND or not dp <= F32_PROB_BOUND or flips > 0
        print(f"[f32] {name} {dim[0]}x{dim[1]} b8, the f32 kernel path "
              f"{'; '.join(line)}; max|ref| {top:.3e}; block launches {blocks}; "
              f"{len(dw_calls)} K9 calls, {len(ln_calls)} LNs a forward [{card}]")
        if got.shape != (8, 1) or not torch.isfinite(got).all() or bad:
            raise AssertionError(f"{name}'s f32 kernel path disagrees with plain f32 or its "
                                 f"unfused path, or launched {blocks}")
        del got, ref, refs, want
        xb = torch.rand((BATCH, *dim, 3), generator=gen, device="cuda")
        with torch.inference_mode():
            if name in FUSED_MEMBERS:
                ms = {"fused": [], "unfused": []}
                for path in ("fused", "unfused", "unfused", "fused"):
                    with (knobs(VIPTPU_NO_FUSED_BLOCK="1") if path == "unfused"
                          else contextlib.nullcontext()):
                        ms[path].append(cuda_ms(lambda: model(xb), iters=2, warmup=1))
                forward_ms[name] = sum(ms["fused"]) / 2
                unfused_ms[name] = sum(ms["unfused"]) / 2
            else:
                forward_ms[name] = cuda_ms(lambda: model(xb), iters=2, warmup=1)
        del model, xb
        torch.cuda.empty_cache()
    print(f"[f32] batch-{BATCH} f32 forward on the f32 kernels (TF32 off), ms: " + ", ".join(
        f"{n} {t:.2f}" for n, t in forward_ms.items())
        + f"; seven members {sum(forward_ms.values()):.2f} [{card}]")
    print(f"[f32] batch-{BATCH} f32 forward, fused blocks vs unfused blocks "
          f"(VIPTPU_NO_FUSED_BLOCK=1), in turns: " + ", ".join(
              f"{n} {forward_ms[n]:.2f} vs {unfused_ms[n]:.2f} ms (fused / unfused "
              f"{forward_ms[n] / unfused_ms[n]:.3f})" for n in unfused_ms) + f" [{card}]")
    n_sites = sum(sum(c.values()) for c in sites.values())
    if n_sites != F32_FORWARD[DW32] or sum(lns.values()) != F32_FORWARD[LN32] or any(
            dtype != torch.float32 for _, dtype, _ in lns):
        raise AssertionError(f"the f32 forwards called K9 {n_sites} and the LN "
                             f"{sum(lns.values())} times, expected {F32_FORWARD}")
    return sites, lns


def f32_block_kernels(card: str, stats: dict, gen) -> None:
    """The six f32 block kernels against their plain versions in f32
    (``F32_KERNEL_BOUND``) at ConvNeXt's s1-s4 and GCViTTiny's L1-L4, batch
    8 (ragged row tiles) and 256, timed at 256 (CUDA events, in turns)
    beside the library: cuDNN's f32 depthwise conv, cuBLAS's f32 product
    alone (``F.linear``, TF32 off) for the GEMMs, SDPA in f32 for the
    attention; bounds at the f32 peak; per forward into the record."""
    before = snapshot(stats)
    for h, w, c, _ in STAGES:
        check_stage(run_stage(8, h, w, c, gen, torch.float32), (8, h, w, c), stats)
        torch.cuda.empty_cache()
    for h, w, c, nblocks in STAGES:
        p = run_stage(BATCH, h, w, c, gen, torch.float32)
        check_stage(p, (BATCH, h, w, c), stats)
        m, n = BATCH * h * w, 4 * c
        xc, wc = p["x"].permute(0, 3, 1, 2), p["dw"].permute(2, 0, 1).unsqueeze(1)
        calls = {  # name: (kernel, plain, library, bytes, f32 operations)
            "dwconv7x7_nhwc_f32": (
                lambda: K.dwconv7x7_nhwc(p["x"], p["dw"], p["dwb"]),
                lambda: K.dwconv7x7_nhwc_plain(p["x"], p["dw"], p["dwb"]),
                lambda: F.conv2d(xc, wc, p["dwb"], padding=3, groups=c),
                2 * m * c * 4 + 50 * c * 4, 2 * 49 * m * c),
            "ln_fc1_gelu_f32": (
                lambda: K.ln_fc1_gelu(p["d"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6),
                lambda: K.ln_fc1_gelu_plain(p["d"], p["lg"], p["lb"], p["w1"], p["b1"], 1e-6),
                lambda: F.linear(p["d"], p["w1"]),
                m * c * 4 + n * c * 4 + (n + 2 * c) * 4 + m * n * 4, 2 * m * c * n),
            "fc2_scale_residual_f32": (
                lambda: K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["ls"], p["x2"]),
                lambda: K.fc2_scale_residual_plain(p["hid"], p["w2"], p["b2"], p["ls"], p["x2"]),
                lambda: F.linear(p["hid"], p["w2"]),
                m * n * 4 + n * c * 4 + 2 * c * 4 + 2 * m * c * 4, 2 * m * n * c),
        }
        for name, (kern, plain, lib, nbytes, ops) in calls.items():
            times = time_calls(kern, plain, lib)
            bound = account(stats, name, nblocks, times, nbytes, ops, "f32")
            print_launch(name, f"({BATCH},{h},{w},{c})", times, bound, card)
        del p, calls, xc, wc
        torch.cuda.empty_cache()
    for level in LEVELS:
        run_check_level(8, level, gen, stats, torch.float32)
        torch.cuda.empty_cache()
    for level in LEVELS:
        grid, c, heads, ws, n_local, n_global = level
        p = run_check_level(BATCH, level, gen, stats, torch.float32)
        for name, (kern, plain, lib, nbytes, ops) in gcvit_calls(p, BATCH, c, heads).items():
            times = time_calls(kern, plain, lib)
            count = (n_local if name.endswith("local") else n_global if name.endswith("global")
                     else n_local + n_global)
            bound = account(stats, name.split(" ")[0], count, times, nbytes, ops, "f32")
            print_launch(name, f"({BATCH},{grid},{grid},{c}) w{ws}", times, bound, card)
        del p
        torch.cuda.empty_cache()
    print_per_forward(stats, before, BLOCK_F32,
                      "ConvNeXt + GCViTTiny batch-256 f32 forward (18 + 31 fused blocks)", card)


def f32_kernels(card: str, stats: dict, gen, sites: dict, lns: Counter) -> None:
    """The three f32 kernels of the unfused path and the blocks' surroundings
    against their plain versions at batch 8 and 256 (``F32_KERNEL_BOUND``),
    timed at 256: ``window_attention_bhnd_f32`` at GCViTTiny's L1-L4 (local
    and global query; events; library SDPA in f32 with the bias as a float
    mask; per batch-256 forward of GCViT's unfused block, the f32 training
    path), ``depthwise_conv_nhwc_f32`` at every recorded K9 site (kernel and
    cuDNN's f32 grouped conv by device time, plain by events) and
    ``layer_norm_f32`` at every recorded LN shape (kernel and
    ``F.layer_norm`` by device time); per seven-member f32 forward into the
    record."""
    before = snapshot(stats)
    u = lambda *shape: torch.rand(shape, generator=gen, device="cuda") * 2 - 1  # noqa: E731
    for b in (8, BATCH):
        for grid, c, heads, ws, n_local, n_global in LEVELS:
            n, nwin = ws * ws, (grid // ws) ** 2
            q, k, v = (u(b * nwin, heads, n, 32) for _ in range(3))
            qg = u(b, heads, n, 32).repeat_interleave(nwin, 0)
            bias, scale = u(heads, n, n), 32 ** -0.5
            outs = {kind: WA.window_attention(qq, k, v, bias, scale)
                    for kind, qq in (("local", q), ("global", qg))}
            torch.cuda.synchronize()
            check({f"{ATTN32} {kind}": (outs[kind], lambda qq=qq: WA.window_attention_plain(
                qq, k, v, bias, scale)) for kind, qq in (("local", q), ("global", qg))},
                f"b{b} {tuple(q.shape)}", stats, F32_KERNEL_BOUND)
            if b == BATCH:
                nbytes, ops = 4 * q.numel() * 4 + bias.numel() * 4, 4 * q.numel() * n
                for kind, qq, count in (("local", q, n_local), ("global", qg, n_global)):
                    times = time_calls(
                        lambda: WA.window_attention(qq, k, v, bias, scale),
                        lambda: WA.window_attention_plain(qq, k, v, bias, scale),
                        lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=bias,
                                                               scale=scale))
                    bound = account(stats, ATTN32, count, times, nbytes, ops, "f32")
                    print_launch(f"{ATTN32} {kind}", f"{tuple(qq.shape)} L{grid}x{grid}", times,
                                 bound, card)
            del q, k, v, qg, outs
    torch.cuda.empty_cache()
    for name, member_sites in sites.items():
        if not member_sites:  # ConvNeXt on its fused blocks, the members without a dw site
            continue
        dw_before = dict(stats[DW32])
        for b in (8, BATCH):
            for (shape, k, pad), count in member_sites.items():
                x = u(b, *shape)
                kern = u(k, k, shape[-1]) * 0.5
                out = D.depthwise_conv_nhwc(x, kern, padding=pad)
                torch.cuda.synchronize()
                label = f"{name} b{b} {(b, *shape)} k{k} pad {pad} x{count}"
                check({DW32: (out, lambda: D.depthwise_conv_nhwc_plain(x, kern, padding=pad))},
                      label, stats, F32_KERNEL_BOUND)
                if b == BATCH:
                    times = (device_ms(lambda: D.depthwise_conv_nhwc(x, kern, padding=pad)),
                             cuda_ms(lambda: D.depthwise_conv_nhwc_plain(x, kern, padding=pad),
                                     iters=2, warmup=1),
                             device_ms(lambda: depthwise_cudnn(x, kern, padding=pad)))
                    bound = account(stats, DW32, count, times,
                                    (x.numel() + out.numel() + kern.numel()) * 4,
                                    2 * k * k * out.numel(), "f32")
                    print_launch(DW32, label + " device", times, bound, card)
                del x, kern, out
        part = {key: stats[DW32][key] - (dw_before[key] or 0.0)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"[f32] {DW32} per {name} batch-256 f32 forward ({sum(member_sites.values())} "
              f"sites): kernel {part['ms']:.3f} ms, plain {part['plain_ms']:.2f} ms, cuDNN "
              f"{part['library_ms']:.3f} ms (device), bound {part['bound_ms']:.3f} ms [{card}]")
        torch.cuda.empty_cache()
    for b in (8, BATCH):
        for (shape, dtype, eps), count in lns.items():
            c = shape[-1]
            x = u(b, *shape) * 2
            w, bb = u(c) * 0.5 + 1.0, u(c) * 0.1
            out = L.layer_norm(x, w, bb, eps)
            torch.cuda.synchronize()
            label = f"{tuple(x.shape)} eps {eps:g} x{count}"
            check({LN32: (out, lambda: L.layer_norm_plain(x, w, bb, eps))}, label, stats,
                  F32_KERNEL_BOUND)
            if b == BATCH:
                times = time_calls(lambda: L.layer_norm(x, w, bb, eps),
                                   lambda: L.layer_norm_plain(x, w, bb, eps),
                                   lambda: F.layer_norm(x, (c,), w, bb, eps), device=True)
                bound = account(stats, LN32, count, times, 2 * x.numel() * 4 + 2 * c * 4,
                                8 * x.numel(), "f32")
                print_launch(LN32, label + " device", times, bound, card)
            del x, out
    torch.cuda.empty_cache()
    print_per_forward(stats, before, (ATTN32,), "GCViTTiny batch-256 f32 forward on the unfused "
                      "block (training)", card)
    print_per_forward(stats, before, (DW32, LN32), "seven-member batch-256 f32 forward", card)


def f32_csv(card: str) -> dict:
    """The seven members of ``ckpts/ckpts.json`` with one-output sigmoid
    heads through ``main_torch.main`` with ``VIPTPU_DTYPE=float32``, cold and
    warm, with both TF32 flags on (PyTorch's cuDNN default) before each run:
    the f32 kernels at each of their sites a batch (``F32_FORWARD``: GCViT
    and ConvNeXt on the six f32 block kernels), no other kernel (no bf16
    block kernel, no K8), no plain version called, the forwards with both
    flags off and the flags restored after, every LN call in f32 (so that
    each of the LN counter's launches is ``layer_norm_f32``'s); then the
    same CSV in bf16, the decisions the two dtypes flip printed (no gate).
    Returns the cold run's launches of the f32 kernels."""
    batches = -(-N_IMAGES // BATCH)
    want = {**{n: 0 for n in COUNTED}, **{n: batches * c for n, c in F32_BLOCKS.items()},
            DW32: batches * F32_FORWARD[DW32], LN: batches * F32_FORWARD[LN32]}
    plain, seen, runs = Counter(), set(), {}
    with csv_workspace(MANIFEST) as (input_csv, output_csv, times, names), binary_heads():
        for run in ("f32 cold", "f32 warm"):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            ln_calls = []
            with (knobs(VIPTPU_DTYPE="float32"), counting_plain(plain), recording_tf32(seen),
                  recording_layer_norms(ln_calls)):
                runs[run] = run_csv(input_csv, output_csv, names, times)
            after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            if after != (True, True):
                raise AssertionError(f"the f32 CSV run left the TF32 flags at {after}")
            expect_launches(runs[run][0], want, f"seven-member {run} CSV->CSV")
            dtypes = Counter(dtype for _, dtype, _ in ln_calls)
            if dtypes != {torch.float32: runs[run][0][LN]}:
                raise AssertionError(f"the {run} CSV's LN calls by dtype {dict(dtypes)} are not "
                                     f"its {runs[run][0][LN]} LN launches, all f32")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        runs["bf16"] = run_csv(input_csv, output_csv, names, times)
    if sum(plain.values()) or seen != {(False, False)}:
        raise AssertionError(f"the f32 runs called plain versions {dict(plain)} or ran a forward "
                             f"with TF32 flags {seen}")
    raw32, raw16 = runs["f32 warm"][3]["raw"], runs["bf16"][3]["raw"]
    flips = int(((raw32 > THR) != (raw16 > THR)).sum())
    ms = lambda s: ", ".join(f"{t * 1000:.1f} ms" for t in s)  # noqa: E731
    for run in ("f32 cold", "f32 warm", "bf16"):
        sec, batch_s = runs[run][1], runs[run][2]
        print(f"[f32] CSV->CSV {N_IMAGES} images, batch {BATCH}, 7 members (sigmoid heads), "
              f"{run}: {sec:.2f} s ({N_IMAGES / sec:.1f} img/s; per-batch e2e {ms(batch_s)}) "
              f"[{card}]")
    print(f"[f32] f32 vs bf16 on the seven-member CSV: {flips} of {N_IMAGES} decisions flip at "
          f"{THR}, max|d| of the ensemble means {np.abs(raw32 - raw16).max():.3e}, f32 cold vs "
          f"warm max|d| {np.abs(runs['f32 cold'][3]['raw'] - raw32).max():.1e}; plain calls "
          f"{sum(plain.values())}, TF32 flags in the forwards {sorted(seen)} [{card}]")
    cold = runs["f32 cold"][0]
    return {**{n: cold[n] for n in BLOCK_F32}, DW32: cold[DW32], LN32: cold[LN]}


@contextlib.contextmanager
def recording_gradients(seen: list):
    """Record in ``seen`` the (loss, gradients) of each ``value_and_grad``
    the trainer takes: the gradients of its own step's closure."""
    real = trainer_module.value_and_grad

    def record(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    trainer_module.value_and_grad = record
    try:
        yield
    finally:
        trainer_module.value_and_grad = real


def f32_trainer_run(name: str, x: torch.Tensor, y: torch.Tensor, plain: bool) -> dict:
    """A fresh f32 ``Trainer`` of ``name`` (``_train_model``'s seeded
    weights, drop rates 0, SGD at ``F32_TRAIN_LR``, no decay): its
    ``eval_step`` and then its ``train_step`` on the batch, both TF32 flags
    on before each call, on the kernels or, ``plain``, under
    ``plain_kernels()``. Returns each call's loss, launches and host
    seconds, the TF32 flags seen at the LN calls and left after each call,
    the gradients the step's own closure took and each parameter's move."""
    tr = Trainer(_train_model(name, torch.float32),
                 TrainConfig(loss="bce_timm", optimizer="sgd", weight_decay=0.0))
    if tr.model.cfg.fused_block is not None:
        raise AssertionError(f"{name}'s config forces a block path; the f32 check wants the auto")
    before = {k: p.detach().clone() for k, p in tr.params.items()}
    out, grads = {"flags": set(), "after": set()}, []
    calls = (("eval", lambda: tr.eval_step(x, y)[0]),
             ("step", lambda: tr.train_step(x, y, F32_TRAIN_LR)))
    with (plain_kernels() if plain else contextlib.nullcontext()), \
            recording_tf32(out["flags"]), recording_gradients(grads):
        for part, call in calls:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            reset_launches()
            t0 = time.perf_counter()
            out[part] = call().item()
            out[part + " s"] = time.perf_counter() - t0
            out[part + " launches"] = all_launches()
            out["after"].add((torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    (_, out["grads"]), = grads
    out["moves"] = {k: p.detach() - before[k] for k, p in tr.params.items()}
    del tr, before
    return out


def f32_train_step(card: str, name: str) -> dict:
    """``Trainer.eval_step`` and one ``Trainer.train_step`` of an f32
    ``name`` on the card (:func:`f32_trainer_run`) against the same calls
    of a second trainer under ``plain_kernels()``: inside each call both
    TF32 flags off, restored on after; the eval loss on the fused block
    (the auto path of an f32 model in eval mode), the step's loss (the
    unfused block) and the norm of the gradients its closure took within
    ``F32_TRAIN_BOUND`` (relative), their cosine >= ``F32_TRAIN_COS``; the
    step moved each parameter by minus its gradient (cosine >=
    ``F32_TRAIN_COS``, and against the plain step's moves); eval launched
    exactly ``F32_EVAL_LAUNCHES`` and the step ``F32_TRAIN_LAUNCHES`` (the
    backwards are plain), the plain trainer nothing. Returns the step's
    launches."""
    size = TRAIN_MEMBERS[name][0]
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.rand((F32_TRAIN_BATCH, *size, 3), generator=gen, device="cuda")
    y = (torch.rand((F32_TRAIN_BATCH, 1), generator=gen, device="cuda") > 0.5).float()
    got = f32_trainer_run(name, x, y, plain=False)
    torch.cuda.empty_cache()
    ref = f32_trainer_run(name, x, y, plain=True)
    torch.cuda.synchronize()
    flat = lambda d: torch.cat([d[k].flatten() for k in got["grads"]])  # noqa: E731
    g, g_ref = flat(got["grads"]), flat(ref["grads"])
    move, move_ref = flat(got["moves"]), flat(ref["moves"])
    rel = {part: abs(got[part] - ref[part]) / abs(ref[part]) for part in ("eval", "step")}
    norm_rel = abs(g.norm().item() / g_ref.norm().item() - 1)
    cos, move_cos, move_ref_cos = _cos(g, g_ref), _cos(move, -F32_TRAIN_LR * g), _cos(move,
                                                                                     move_ref)
    zero = {n: 0 for n in COUNTED}
    want = {"eval": {**zero, **F32_EVAL_LAUNCHES[name]},
            "step": {**zero, **F32_TRAIN_LAUNCHES[name]}}
    bad = {f"{who} {part}": {n: (run[part + " launches"][n], c) for n, c in w[part].items()
                             if run[part + " launches"][n] != c}
           for who, run, w in (("kernels", got, want), ("plain", ref, {"eval": zero, "step": zero}))
           for part in ("eval", "step")}
    bad = {k: v for k, v in bad.items() if v}
    flags = {who: (run["flags"], run["after"]) for who, run in (("kernels", got), ("plain", ref))}
    print(f"[f32] {name}: Trainer.eval_step + one Trainer.train_step (SGD, lr {F32_TRAIN_LR:g}), "
          f"batch {F32_TRAIN_BATCH}, drop rates 0, the f32 kernels vs plain f32: eval loss "
          f"{got['eval']:.6f} vs {ref['eval']:.6f} (rel {rel['eval']:.3e}); step loss "
          f"{got['step']:.6f} vs {ref['step']:.6f} (rel {rel['step']:.3e}); the closure's "
          f"gradient norm rel {norm_rel:.3e} (bounds {F32_TRAIN_BOUND:g}), cosine {cos:.7f}; "
          f"the moves vs -lr x gradient cosine {move_cos:.7f}, vs the plain step's moves "
          f"{move_ref_cos:.7f} (bounds {F32_TRAIN_COS}); TF32 flags (at the LNs, after) "
          f"{flags}; launches eval "
          f"{ {n: c for n, c in got['eval launches'].items() if c} }, step "
          f"{ {n: c for n, c in got['step launches'].items() if c} }; host s eval "
          f"{got['eval s']:.2f}, step {got['step s']:.2f} [{card}]")
    if (bad or any(f != ({(False, False)}, {(True, True)}) for f in flags.values())
            or not all(r <= F32_TRAIN_BOUND for r in rel.values())
            or not norm_rel <= F32_TRAIN_BOUND or g.norm().item() == 0
            or not min(cos, move_cos, move_ref_cos) >= F32_TRAIN_COS):
        raise AssertionError(f"the {name} f32 trainer disagrees with plain f32, ran with TF32 "
                             f"flags {flags} or launched (got, expected) {bad}")
    step = got["step launches"]
    del got, ref, g, g_ref, move, move_ref
    torch.cuda.empty_cache()
    return step


def phase_f32(card: str, stats: dict) -> dict:
    """f32 compute on the card: each member against plain f32 and the fused
    members against their unfused f32 forward (:func:`f32_members`), the
    six f32 block kernels (:func:`f32_block_kernels`) and the three f32
    kernels of the unfused path and around the blocks (:func:`f32_kernels`)
    at their shapes, the seven-member f32 CSV (:func:`f32_csv`, whose cold
    run's launches the record takes), one f32 training step of GCViTTiny and
    of ConvNeXt (:func:`f32_train_step`; K8 f32's launches in the record are
    GCViT's step's: the f32 serving path runs the fused block). Returns the
    f32 kernels' launches."""
    laps, t0 = {}, time.perf_counter()

    def lap(label: str) -> None:
        laps[label] = round(time.perf_counter() - t0 - sum(laps.values()), 1)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(23)
    sites, lns = f32_members(card, gen)
    lap("members")
    f32_block_kernels(card, stats, gen)
    lap("block kernels")
    f32_kernels(card, stats, gen, sites, lns)
    lap("kernels")
    launches = f32_csv(card)
    lap("CSV")
    for name in FUSED_MEMBERS:
        step = f32_train_step(card, name)
        if name == "GCViTTiny":
            launches[ATTN32] = step[ATTN32]
    lap("train steps")
    print(f"[f32] phase wall time {time.perf_counter() - t0:.1f} s, by part {laps} [{card}]")
    return launches


# ---------------------------------------------------------------------------
# the last modes (ROADMAP A15c): the int8 block kernels on f32 activations and
# GCViT's mixed GEMM dtypes (VIPTPU_GCVIT_MM)
# ---------------------------------------------------------------------------
A15C_RUNS = {  # run -> the knobs main.py serves it under
    "f32 int8": dict(VIPTPU_DTYPE="float32", VIPTPU_INT8_KERNELS="1"),
    "bf16 mm f32": dict(VIPTPU_GCVIT_MM="f32"),
    "f32 mm bf16": dict(VIPTPU_DTYPE="float32", VIPTPU_GCVIT_MM="bf16"),
    "bf16 int8 mm f32": dict(VIPTPU_INT8_KERNELS="1", VIPTPU_GCVIT_MM="f32"),
}
# every fused-block counter: a run may launch its own mode's and no other
BLOCK_COUNTERS = (CONVNEXT_KERNELS + GCVIT_KERNELS + BLOCK_F32 + INT8_KERNELS + CHAIN_KERNELS
                  + A15C + ("fc2_scale_residual_int8_f32", ATTN, ATTN32))


def a15c_forward(run: str) -> dict:
    """The fused-block launches of one ConvNeXt + GCViTTiny forward under
    ``run``'s knobs: ConvNeXt's 18 blocks and GCViT's 28 at C >= 128 on the
    int8 kernels where the run has them, GCViT's L1 (and every level
    without int8) on the run's mixed-mode kernels."""
    cx, gc, i8 = CONVNEXT_BLOCKS, GCVIT_BLOCKS, GCVIT_INT8_BLOCKS
    l1 = gc - i8
    if run == "f32 int8":
        return {"dwconv7x7_nhwc_f32": cx, "ln_fc1_rowmax_int8": cx + i8,
                "mlp_int8_scale_residual_f32": cx + i8, "ln_qkv_int8_f32": i8,
                "quantize_rows": i8, "proj_scale_residual_int8_f32": i8,
                "window_attention_f32": gc, "ln_qkv_f32": l1,
                "proj_scale_residual_f32": l1, "ln_fc1_gelu_f32": l1, "fc2_scale_residual_f32": l1}
    if run == "bf16 mm f32":
        return {**{n: cx for n in CONVNEXT_KERNELS}, "ln_fc1_gelu_f32": gc,
                **{f"{n}_mmf32": gc for n in MIXED_KERNELS}}
    if run == "f32 mm bf16":
        return {**{n: cx for n in CONVNEXT_F32}, "ln_fc1_gelu": gc,
                **{f"{n}_mmbf16": gc for n in MIXED_KERNELS}}
    return {"dwconv7x7_nhwc": cx, "ln_fc1_rowmax_int8": cx + i8,
            "mlp_int8_scale_residual": cx + i8, "ln_qkv_int8_mmf32": i8, "quantize_rows": i8,
            "proj_scale_residual_int8": i8, "window_attention_mmf32": gc, "ln_qkv_mmf32": l1,
            "proj_scale_residual_mmf32": l1, "ln_fc1_gelu_f32": l1,
            "fc2_scale_residual_mmf32": l1}


def a15c_bound(dtype: torch.dtype, mm: torch.dtype) -> float:
    """An f32 output of f32 GEMMs ``F32_KERNEL_BOUND``; a bf16 output, or any
    of bf16 GEMMs (operands rounded on chip), ``KERNEL_BOUND``."""
    return F32_KERNEL_BOUND if dtype == mm == torch.float32 else KERNEL_BOUND


def a15c_level(b: int, level: tuple, mode: str, gen, stats: dict) -> dict:
    """GCViT's five launches of one level in ``mode`` at batch ``b`` (local
    and global blocks), each against its plain version on the kernel
    before's output; returns the level's inputs and outputs."""
    act, mm = MIXED_MODES[mode]
    grid, c, heads, ws, _, _ = level
    p = gcvit_level_inputs(b, grid, c, heads, ws, gen, mm)
    p["x"], p["qg"] = p["x"].to(act), p["qg"].to(act)
    n, t = p["n"], lambda a: a.view(b, -1, c)
    args = (p["x"], p["lg"], p["lb"])
    p["qkv"] = G.ln_qkv(*args, p["wqkv"], p["bqkv"], 1e-5, mm_dtype=mm)
    p["kv"] = G.ln_qkv(*args, p["wqkv"][c:], p["bqkv"][c:], 1e-5, mm_dtype=mm)
    q, k, v = (t(a) for a in p["qkv"])
    kg, vg = (t(a) for a in p["kv"])
    attn = G.window_attention(q, k, v, p["bias"], n, p["scale"], mm_dtype=mm, out_dtype=act)
    attn_g = G.window_attention(p["qg"], kg, vg, p["bias"], n, p["scale"], True, mm_dtype=mm,
                                out_dtype=act)
    p["attn"] = attn.view(-1, c)
    p["r1"] = G.proj_scale_residual(p["attn"], p["wp"], p["bp"], p["g1"], p["x"], mm_dtype=mm)
    p["hid"] = K.ln_fc1_gelu(p["r1"], p["lg2"], p["lb2"], p["w1"], p["b1"], 1e-5, mm_dtype=mm)
    out = K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"], out_dtype=act)
    torch.cuda.synchronize()
    f32 = torch.float32
    for name, got, make_ref, bound in (
            (f"ln_qkv_{mode} local", torch.cat(p["qkv"], 1), lambda: torch.cat(G.ln_qkv_plain(
                *args, p["wqkv"], p["bqkv"], 1e-5, mm), 1), a15c_bound(f32, mm)),
            (f"ln_qkv_{mode} global", torch.cat(p["kv"], 1), lambda: torch.cat(G.ln_qkv_plain(
                *args, p["wqkv"][c:], p["bqkv"][c:], 1e-5, mm), 1), a15c_bound(f32, mm)),
            (f"window_attention_{mode} local", attn, lambda: G.window_attention_plain(
                q, k, v, p["bias"], n, p["scale"], False, mm, act), a15c_bound(act, mm)),
            (f"window_attention_{mode} global", attn_g, lambda: G.window_attention_plain(
                p["qg"], kg, vg, p["bias"], n, p["scale"], True, mm, act), a15c_bound(act, mm)),
            (f"proj_scale_residual_{mode}", p["r1"], lambda: G.proj_scale_residual_plain(
                p["attn"], p["wp"], p["bp"], p["g1"], p["x"], mm), a15c_bound(f32, mm)),
            (f"fc2_scale_residual_{mode}", out, lambda: K.fc2_scale_residual_plain(
                p["hid"], p["w2"], p["b2"], p["g2"], p["r1"], act), a15c_bound(act, mm))):
        check({name: (got, make_ref)}, f"b{b} {grid}x{grid}x{c} w{ws}", stats, bound)
    return p


def a15c_level_calls(p: dict, b: int, c: int, heads: int, mode: str) -> dict:
    """name -> (kernel, plain, library, bytes, operations) of the mode's
    four new launches of one level (``ln_qkv`` and the attention local and
    global); the library: cuBLAS's product in the mode's operand dtype (its
    operands cast to it beforehand, TF32 off), SDPA on the same tiles in
    that dtype (the global query repeated over the windows beforehand)."""
    act, mm = MIXED_MODES[mode]
    n, m = p["n"], p["m"]
    ea, em = torch.tensor([], dtype=act).element_size(), torch.tensor([], dtype=mm).element_size()
    t = lambda a: a.view(b, -1, c)  # noqa: E731
    hv = lambda a: a.reshape(-1, n, heads, 32).transpose(1, 2).to(mm)  # noqa: E731
    x_mm, a_mm, q_mm = p["x"].to(mm), p["attn"].to(mm), p["qg"].to(mm)
    q, k, v = (t(a) for a in p["qkv"])
    kg, vg = (t(a) for a in p["kv"])
    qh, kh, vh, kgh, vgh = hv(q), hv(k), hv(v), hv(kg), hv(vg)
    q_rep = hv(q_mm.repeat_interleave(m // (b * n), 0))
    mask = p["bias"].to(mm)
    w_kv, b_kv = p["wqkv"][c:], p["bqkv"][c:]
    act_b, qkv_b, weight = m * c * ea, m * c * 4, c * c * em  # one (M, C) in act / f32, C x C
    attn_ops, bias_b = 4 * m * n * c, heads * n * n * 4
    kind = "f32" if mm == torch.float32 else "bf16"
    args = (p["x"], p["lg"], p["lb"])
    return {
        f"ln_qkv_{mode} local": (
            lambda: G.ln_qkv(*args, p["wqkv"], p["bqkv"], 1e-5, mm_dtype=mm),
            lambda: G.ln_qkv_plain(*args, p["wqkv"], p["bqkv"], 1e-5, mm),
            lambda: F.linear(x_mm, p["wqkv"]), act_b + 3 * qkv_b + 3 * weight,
            2 * m * c * 3 * c, kind),
        f"ln_qkv_{mode} global": (
            lambda: G.ln_qkv(*args, w_kv, b_kv, 1e-5, mm_dtype=mm),
            lambda: G.ln_qkv_plain(*args, w_kv, b_kv, 1e-5, mm),
            lambda: F.linear(x_mm, w_kv), act_b + 2 * qkv_b + 2 * weight, 2 * m * c * 2 * c, kind),
        f"window_attention_{mode} local": (
            lambda: G.window_attention(q, k, v, p["bias"], n, p["scale"], mm_dtype=mm,
                                       out_dtype=act),
            lambda: G.window_attention_plain(q, k, v, p["bias"], n, p["scale"], False, mm, act),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=p["scale"]),
            3 * qkv_b + act_b + bias_b, attn_ops, kind),
        f"window_attention_{mode} global": (
            lambda: G.window_attention(p["qg"], kg, vg, p["bias"], n, p["scale"], True,
                                       mm_dtype=mm, out_dtype=act),
            lambda: G.window_attention_plain(p["qg"], kg, vg, p["bias"], n, p["scale"], True, mm,
                                             act),
            lambda: F.scaled_dot_product_attention(q_rep, kgh, vgh, attn_mask=mask,
                                                   scale=p["scale"]),
            2 * qkv_b + b * n * c * ea + act_b + bias_b, attn_ops, kind),
        f"proj_scale_residual_{mode}": (
            lambda: G.proj_scale_residual(p["attn"], p["wp"], p["bp"], p["g1"], p["x"],
                                          mm_dtype=mm),
            lambda: G.proj_scale_residual_plain(p["attn"], p["wp"], p["bp"], p["g1"], p["x"], mm),
            lambda: F.linear(a_mm, p["wp"]), 2 * act_b + weight + qkv_b, 2 * m * c * c, kind),
        f"fc2_scale_residual_{mode}": (
            lambda: K.fc2_scale_residual(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"],
                                         out_dtype=act),
            lambda: K.fc2_scale_residual_plain(p["hid"], p["w2"], p["b2"], p["g2"], p["r1"], act),
            lambda: F.linear(p["hid"], p["w2"]), 3 * m * c * em + 3 * weight + qkv_b + act_b,
            2 * m * 3 * c * c, kind),
    }


def a15c_kernels(card: str, stats: dict, gen) -> None:
    """Every new instantiation at batch 8 (ragged row tiles) and 256 against
    its plain version: the GCViT block's five kernels in both mixed modes at
    L1-L4 (``a15c_bound``), timed at 256 beside cuBLAS's product in the
    mode's operand dtype and SDPA; the int8 kernels' f32 modes at GCViT's
    L2-L4 (q, k, v from f32 and from bf16 x; proj on the f32 x) and the MLP
    pair's f32 pass 2 at ConvNeXt's s1-s4 and GCViT's L2-L4 (the LN GEMM
    1e-2, the rest bit for bit as in bf16), timed beside torch._int_mm with
    the quantize; per ConvNeXt + GCViT forward into the record."""
    before = snapshot(stats)
    for mode in MIXED_MODES:
        for b in (8, BATCH):
            for level in LEVELS:
                grid, c, heads, ws, n_local, n_global = level
                p = a15c_level(b, level, mode, gen, stats)
                if b == BATCH:
                    for name, (kern, plain, lib, nbytes, ops, kind) in a15c_level_calls(
                            p, b, c, heads, mode).items():
                        times = time_calls(kern, plain, lib)
                        count = (n_local if name.endswith("local") else n_global
                                 if name.endswith("global") else n_local + n_global)
                        bound = account(stats, name.split(" ")[0], count, times, nbytes, ops,
                                        kind)
                        print_launch(name, f"({b},{grid},{grid},{c}) w{ws}", times, bound, card)
                del p
                torch.cuda.empty_cache()
    f32, bf16 = torch.float32, torch.bfloat16
    apart = {"bf16": Counter(), "int_mm": Counter()}
    u = lambda *shape: torch.rand(shape, generator=gen, device="cuda") * 2 - 1  # noqa: E731
    for b in (8, BATCH):
        for grid, c, heads, ws, n_local, n_global in INT8_LEVELS:
            m = b * grid * grid
            x, attn, lg, lb = u(m, c), u(m, c), u(c) * 0.5 + 1.0, u(c) * 0.1
            qkv = dyn_int8.quantize_linear(u(3 * c, c) * c ** -0.5)
            proj = dyn_int8.quantize_linear(u(c, c) * c ** -0.5)
            bqkv, bp, g1 = u(3 * c) * 0.1, u(c) * 0.1, u(c) * 0.5 + 1.0
            a_q, a_s = B8.quantize_rows(attn)
            outs = {}
            for name, xx in (("ln_qkv_int8_f32", x), ("ln_qkv_int8_mmf32", x.to(bf16))):
                outs[name] = (torch.cat(B8.ln_qkv_int8(xx, lg, lb, qkv.q, qkv.s, bqkv, 1e-5, f32),
                                        1),
                              lambda xx=xx: torch.cat(B8.ln_qkv_int8_plain(
                                  xx, lg, lb, qkv.q, qkv.s, bqkv, 1e-5, f32), 1), False)
            outs["proj_scale_residual_int8_f32"] = (
                B8.proj_scale_residual_int8(a_q, a_s, proj.q, proj.s, bp, g1, x),
                lambda: B8.proj_scale_residual_int8_plain(a_q, a_s, proj.q, proj.s, bp, g1, x),
                True)
            torch.cuda.synchronize()
            label = f"b{b} ({m},{c}) L{grid}x{grid}"
            check_int8(label, stats, outs)
            if b == BATCH:
                x16 = x.to(bf16)
                run_int8_calls({
                    "ln_qkv_int8_f32": (
                        n_local + n_global,
                        lambda: B8.ln_qkv_int8(x, lg, lb, qkv.q, qkv.s, bqkv, 1e-5, f32),
                        lambda: B8.ln_qkv_int8_plain(x, lg, lb, qkv.q, qkv.s, bqkv, 1e-5, f32),
                        int_mm_yardstick(x, qkv.q), m * c * 4 * 4 + 3 * c * c + 6 * c * 4,
                        2 * m * c * 3 * c, "int8", None),
                    "ln_qkv_int8_mmf32": (
                        n_local + n_global,
                        lambda: B8.ln_qkv_int8(x16, lg, lb, qkv.q, qkv.s, bqkv, 1e-5, f32),
                        lambda: B8.ln_qkv_int8_plain(x16, lg, lb, qkv.q, qkv.s, bqkv, 1e-5, f32),
                        int_mm_yardstick(x16, qkv.q), m * c * (2 + 3 * 4) + 3 * c * c + 6 * c * 4,
                        2 * m * c * 3 * c, "int8", None),
                    "proj_scale_residual_int8_f32": (
                        n_local + n_global,
                        lambda: B8.proj_scale_residual_int8(a_q, a_s, proj.q, proj.s, bp, g1, x),
                        lambda: B8.proj_scale_residual_int8_plain(a_q, a_s, proj.q, proj.s, bp,
                                                                  g1, x),
                        int_mm_yardstick(attn, proj.q), m * c * (1 + 4 + 4) + m * 4 + c * c,
                        2 * m * c * c, "int8", None),
                }, label, stats, apart, card)
            del x, attn, a_q, a_s, outs
            torch.cuda.empty_cache()
    shapes = [(h * w, c, 4 * c, nb) for h, w, c, nb in STAGES] + [
        (grid * grid, c, 3 * c, n_local + n_global) for grid, c, _, _, n_local, n_global
        in INT8_LEVELS]
    for b in (8, BATCH):
        for rows, c, n, count in shapes:
            m = b * rows
            d, res, lg, lb = u(m, c), u(m, c), u(c) * 0.5 + 1.0, u(c) * 0.1
            fc1 = dyn_int8.quantize_linear(u(n, c) * c ** -0.5)
            fc2 = dyn_int8.quantize_linear(u(c, n) * n ** -0.5)
            b1, b2, gamma = u(n) * 0.1, u(c) * 0.1, u(c) * 0.5 + 1.0
            x_q, x_s, h_s = B8.ln_fc1_rowmax_int8(d, lg, lb, fc1.q, fc1.s, b1, 1e-6)
            pass2 = (x_q, x_s, h_s, fc1.q, fc1.s, b1, fc2.q, fc2.s, b2, gamma, res, f32)
            out = B8.mlp_int8_scale_residual(*pass2)
            torch.cuda.synchronize()
            label = f"b{b} ({m},{c}) N {n}"
            check_int8(label, stats, {"mlp_int8_scale_residual_f32": (
                out, lambda: B8.mlp_int8_scale_residual_plain(*pass2), False)})
            if b == BATCH:
                run_int8_calls({"mlp_int8_scale_residual_f32": (
                    count, lambda: B8.mlp_int8_scale_residual(*pass2),
                    lambda: B8.mlp_int8_scale_residual_plain(*pass2), None,
                    m * c + 3 * m * 4 + 2 * n * c + (2 * n + 3 * c) * 4 + 2 * m * c * 4,
                    *pair_floor("mlp_int8_scale_residual", 4 * m * c * n, m * n), None)},
                    label, stats, apart, card)
            del d, res, x_q, x_s, h_s, out, pass2
            torch.cuda.empty_cache()
    print_per_forward(stats, before, A15C,
                      "ConvNeXt + GCViTTiny batch-256 forward in the run that launches it", card)


def a15c_csv(card: str) -> dict:
    """The two-member (ConvNeXt + GCViT) and seven-member CSVs, every member
    with a one-output sigmoid head, through ``main_torch.main`` under each
    of ``A15C_RUNS`` (the seven members under the first three), cold then
    warm: the fused blocks launch the run's kernels at each block a batch
    and no other block kernel (:func:`a15c_forward`; the cold run), no plain
    version runs; the warm run against the same run under
    ``plain_kernels()`` (raw means within ``MODEL_BOUND`` with int8,
    ``SERVING_BOUND`` else; the decisions flipped at 0.487 and at the plain
    run's median printed). Returns the new kernels' launches of the
    two-member cold runs."""
    batches = -(-N_IMAGES // BATCH)
    launches, plain = {}, Counter()
    ms = lambda s: ", ".join(f"{t * 1000:.1f} ms" for t in s)  # noqa: E731
    with binary_heads():
        for manifest, label in ((TWO, "2 members"), (MANIFEST, "7 members")):
            with csv_workspace(manifest) as (input_csv, output_csv, times, names):
                for run, env in A15C_RUNS.items():
                    if manifest is MANIFEST and run == "bf16 int8 mm f32":
                        continue
                    with knobs(**env):
                        with counting_plain(plain):  # cold (launches checked), then warm
                            got, cold, _, _ = run_csv(input_csv, output_csv, names)
                            _, sec, batch_s, res = run_csv(input_csv, output_csv, names, times)
                        with plain_kernels():
                            _, sec_p, _, ref = run_csv(input_csv, output_csv, names)
                    want = {**{n: 0 for n in BLOCK_COUNTERS},
                            **{n: batches * v for n, v in a15c_forward(run).items()}}
                    expect_launches({n: got[n] for n in BLOCK_COUNTERS}, want,
                                    f"{label} {run} CSV->CSV")
                    compare_raw(f"{label} {run}", res, ref, "its plain run",
                                bound=MODEL_BOUND if "int8" in run else SERVING_BOUND, tag="a15c")
                    # the random heads put most means on one side of 0.487: flips at the plain
                    # run's median too, a threshold with half the images on each side
                    med = float(np.median(ref["raw"]))
                    flips = int(((res["raw"] > med) != (ref["raw"] > med)).sum())
                    print(f"[a15c] CSV->CSV {N_IMAGES} images, batch {BATCH}, {label}, {env}: "
                          f"cold {cold:.2f} s, warm {sec:.2f} s ({N_IMAGES / sec:.1f} img/s; "
                          f"per-batch e2e {ms(batch_s)}), plain run {sec_p:.2f} s; {flips} of "
                          f"{N_IMAGES} decisions flip against the plain run at its median raw "
                          f"mean {med:.6f} [{card}]")
                    if manifest is TWO:  # each kernel's from the first run of its mode
                        for n in A15C:
                            if got[n]:
                                launches.setdefault(n, got[n])
    if sum(plain.values()):
        raise AssertionError(f"the kernel runs called plain versions {dict(plain)}")
    return launches


def phase_a15c(card: str, stats: dict) -> dict:
    """The last modes on the card (:func:`a15c_kernels`, :func:`a15c_csv`);
    returns the new kernels' launches, each from the two-member CSV run that
    serves its mode."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(25)
    a15c_kernels(card, stats, gen)
    t1 = time.perf_counter()
    launches = a15c_csv(card)
    missing = [n for n in A15C if not launches.get(n)]
    if missing:
        raise AssertionError(f"no CSV run launched {missing}")
    print(f"[a15c] phase wall time {time.perf_counter() - t0:.1f} s (kernels {t1 - t0:.1f} s, "
          f"CSV runs {time.perf_counter() - t1:.1f} s) [{card}]")
    return launches


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


def compare_raw(label: str, got: dict, ref: dict, ref_label: str, bound=SERVING_BOUND,
                tag: str = "serving") -> None:
    """The max |d| of two runs' raw means (same sorted filenames), printed
    with the decisions they flip at 0.487; within ``bound`` unless None."""
    if list(got["filename"]) != list(ref["filename"]):
        raise AssertionError(f"{label} and {ref_label} scored other filenames")
    d = float(np.abs(got["raw"] - ref["raw"]).max())
    flips = int(((got["raw"] > 0.487) != (ref["raw"] > 0.487)).sum())
    print(f"[{tag}] raw means, {label} against {ref_label}: max|d| {d:.3e}, "
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
# the EfficientNets run K9 at their stride-1 depthwise sites; ResNetRS50's,
# ResNest50's and ECA_NFNetL0's steps run no kernel (cuDNN convs, BN in
# batch statistics, the standardized weights in the graph)
def _timm_name(path: tuple, bare_head: bool) -> str:
    """The timm module name of a ConvNeXt Flax module path."""
    top = path[0]
    if top in ("stem_conv", "stem_norm"):
        return "stem.0" if top == "stem_conv" else "stem.1"
    if top in ("head_norm", "head_fc"):
        return {"head_norm": "norm", "head_fc": "head"}[top] if bare_head else top.replace("_", ".")
    stage, block, which = re.fullmatch(r"stages_(\d+)_(?:blocks_(\d+)|downsample_(norm|conv))",
                                       top).groups()
    if which:
        return f"stages.{stage}.downsample.{0 if which == 'norm' else 1}"
    rest = [{"mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}.get(p, p) for p in path[1:]]
    return ".".join([f"stages.{stage}.blocks.{block}"] + rest)


def timm_convnext_state(tree: dict, bare_head: bool = False) -> dict:
    """A ConvNeXt Flax variables tree as a timm state dict of f32 tensors,
    the inverse of ``weights/torch_pt.py::map_convnext_torch``: kernels
    HWIO -> OIHW (the depthwise (7, 7, 1, C) -> (C, 1, 7, 7)), Dense
    (in, out) -> (out, in), a norm's gamma / beta -> weight / bias; the head
    as ``head.norm`` / ``head.fc``, or ``norm`` / ``head`` (``bare_head``)."""
    out = {}

    def walk(node: dict, path: tuple) -> None:
        for leaf, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (leaf,))
                continue
            value = np.asarray(value, np.float32)
            if leaf == "kernel":
                leaf, value = "weight", (np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4
                                         else value.T)
            elif leaf == "gamma" and "beta" in node:
                leaf = "weight"
            elif leaf == "beta":
                leaf = "bias"
            out[f"{_timm_name(path, bare_head)}.{leaf}"] = torch.tensor(value)

    for top, node in tree["params"].items():
        walk(node, (top,))
    return out


PTH_MEMBER = "convnext_tiny_in22k"


def phase_pth(card: str) -> None:
    """The timm ``.pth`` weight route at full width: the seeded
    ``_model`` weights of convnext_tiny_in22k@200, its 21,841-class head
    included, written as a timm state dict (``torch.save``), converted by
    ``load_weights`` and loaded by ``create_model(model_path=...)`` with one
    output. Every leaf but the swapped head equals the source's bit for bit
    (f32, and the served bf16 model against the source cast to bf16); the
    swapped head is the one-output model's own seeded init. The served model's
    batch-256 forward on the card, on the fused path, launches the ConvNeXt
    kernels at each of its 18 blocks and the LN kernel at its 5 LNs, and its
    logits equal those of the same weights loaded from ``.msgpack`` (max|d|
    = 0). Prints the host seconds to write, convert and load. Reads no h5
    and imports neither h5py nor TensorFlow."""
    before = {m for m in ("h5py", "tensorflow") if m in sys.modules}
    size, classes = MEMBERS[PTH_MEMBER]
    src = _model(PTH_MEMBER, torch.float32)
    tree = torch_to_flax(src)
    del src
    torch.cuda.empty_cache()
    source = flax_to_torch(tree)
    kw = dict(input_size=size, nb_classes=1, classifier_activation=None)
    head = tuple(k for k in source if k.startswith("head_fc."))
    with tempfile.TemporaryDirectory() as tmp:
        pth, msgpack = os.path.join(tmp, "fold0.pth"), os.path.join(tmp, "fold0.msgpack")
        t0 = time.perf_counter()
        torch.save(timm_convnext_state(tree), pth)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        converted = load_weights(pth, PTH_MEMBER)
        t_convert = time.perf_counter() - t0
        if converted["params"]["head_fc"]["kernel"].shape != (768, classes):
            raise AssertionError(f"the .pth head converted to "
                                 f"{converted['params']['head_fc']['kernel'].shape}")
        t0 = time.perf_counter()
        f32, _ = create_model(PTH_MEMBER, model_path=pth, **kw)
        t_f32 = time.perf_counter() - t0
        t0 = time.perf_counter()
        served, _ = create_model(PTH_MEMBER, model_path=pth, dtype=torch.bfloat16, **kw)
        t_served = time.perf_counter() - t0
        for label, model, dtype in (("f32", f32, torch.float32), ("bf16", served, torch.bfloat16)):
            state = model.state_dict()
            if set(state) != set(source):
                raise AssertionError(f"the {label} model's leaves are not the source's")
            # each leaf in the dtype the model holds it in (the fused kernels
            # take the depthwise taps and layer scales in f32)
            differ = [k for k in state if k not in head and not torch.equal(
                state[k], torch.from_numpy(source[k]).to(state[k].dtype))]
            fresh = create_model(PTH_MEMBER, dtype=dtype, **kw)[0].state_dict()
            kept = all(torch.equal(state[k], fresh[k]) for k in head)
            print(f"[pth] {PTH_MEMBER} {label} from .pth: {len(state) - len(head)} leaves, "
                  f"{len(differ)} differ from the source (bit for bit); head "
                  f"{tuple(state['head_fc.weight'].shape)} swapped from ({classes}, 768), the "
                  f"one-output init kept: {kept}")
            if differ or not kept or state["head_fc.weight"].shape != (1, 768):
                raise AssertionError(f"the {label} .pth load differs at {differ[:4]} or its "
                                     "head was not swapped")
        del f32, fresh
        save_variables(msgpack, tree)
        ref, _ = create_model(PTH_MEMBER, model_path=msgpack, dtype=torch.bfloat16, **kw)
    served, ref = served.cuda(), ref.cuda()
    x = torch.rand((BATCH, *size, 3), generator=torch.Generator(device="cuda").manual_seed(19),
                   device="cuda")
    want = {n: CONVNEXT_BLOCKS for n in CONVNEXT_KERNELS}
    want[LN] = CONVNEXT_LNS
    reset_launches()
    with torch.inference_mode():
        got = served(x)
        torch.cuda.synchronize()
        launches = all_launches()
        other = ref(x)
    torch.cuda.synchronize()
    d = abs_err(got, other)
    print(f"[pth] {PTH_MEMBER} batch-{BATCH} forward from .pth vs from .msgpack: max|d| = {d!r}, "
          f"max|logit| = {got.float().abs().max().item():.3e}; launches "
          f"{ {n: launches[n] for n in want} } (expected {want})")
    extra = {n: c for n, c in launches.items() if c and n not in want}
    if (got.shape != (BATCH, 1) or not torch.isfinite(got).all() or d != 0
            or any(launches[n] != c for n, c in want.items()) or extra):
        raise AssertionError(f"the .pth-loaded {PTH_MEMBER} forward differs from the .msgpack "
                             f"one ({d!r}) or launched {launches}")
    new = {m for m in ("h5py", "tensorflow") if m in sys.modules} - before
    if new:
        raise AssertionError(f"the .pth route imported {sorted(new)}")
    print(f"[pth] host seconds: write (torch.save) {t_write:.3f} s, convert (load_weights) "
          f"{t_convert:.3f} s, create_model(model_path=...) f32 {t_f32:.3f} s, bf16 "
          f"{t_served:.3f} s [{card}]")
    del served, ref
    torch.cuda.empty_cache()


TRAIN_MEMBERS = {
    "GCViTTiny": ((224, 224), {ATTN: GCVIT_BLOCKS, DW: GCVIT_DW_SITES,
                               LN: GCVIT_LNS + 2 * GCVIT_BLOCKS}),
    "convnext_tiny_in22k": ((200, 200), {DW: CONVNEXT_BLOCKS, LN: CONVNEXT_LNS + CONVNEXT_BLOCKS}),
    "ResNetRS50": ((200, 200), {}),
    "ResNest50": ((200, 200), {}),
    "EfficientNetV2T": ((200, 200), {DW: DW_SITES["EfficientNetV2T"]}),
    "EfficientNetV1B4": ((224, 224), {DW: DW_SITES["EfficientNetV1B4"]}),
    "ECA_NFNetL0": ((200, 200), {}),
}
# each member's launches in one eval forward of its served checkpoint
SERVED_LAUNCHES = {"GCViTTiny": {n: GCVIT_BLOCKS for n in GCVIT_KERNELS},
                   "convnext_tiny_in22k": {n: CONVNEXT_BLOCKS for n in CONVNEXT_KERNELS},
                   **{n: {DW: DW_SITES[n]} for n in EFFNETS}}
# members whose eight fit steps must end below their first loss (each run
# so far fell; the others' falls are printed)
FALLS_IN_FIT = ("GCViTTiny",)
# BN members: the registry's draw is compared first and printed only, then
# the damped one is held to the bounds (ECA_NFNetL0 has no BN: its registry
# draw is held to them)
DAMPED_MEMBERS = ("ResNetRS50", "ResNest50", "EfficientNetV2T", "EfficientNetV1B4")
# members trained on noise images with a colour cast each (U(0, 0.3) plus
# U(0, 0.7) per image and channel): images of one distribution pool to
# nearly one vector through random weights, and a BN over pooled features in
# batch statistics (ResNest50's sa_2_bn) divides their bf16 rounding by the
# batch's spread (ResNest50's damped draw: a cosine of 0.9458 on plain
# noise, 0.9969 with the casts). The others keep plain U(0, 1) noise, on
# which GCViT's eight fit steps fall (on the cast batch they did not).
CAST_MEMBERS = ("ResNest50", "EfficientNetV2T", "EfficientNetV1B4", "ECA_NFNetL0")
# the kernel step against the plain f32 step (phase 9 of the docstring)
TRAIN_LOSS_BOUND, TRAIN_NORM_BOUND = 2e-2, 5e-2
TRAIN_COS_BOUND, TRAIN_TENSOR_COS_BOUND = 0.99, 0.9
ZERO_GRADIENT = 1e-6  # of the plain f32 gradient's global norm: a tensor's true gradient is 0
# the short tools/train_flip.py run of phase 9 (the full run is the tool's defaults)
TRAIN_FLIP_ARGS = ["--members", "3", "--epochs", "1", "--steps", "40", "--n-eval", "512"]


def branch_end_bns(model: torch.nn.Module) -> list:
    """The module names of the last BN of each residual branch: ResNetRS50's
    ``batch_norm_3``, ResNest50's zero-gamma ``3_bn``, the EfficientNets'
    ``MB_pw_bn`` / ``fu_bn`` in the blocks that take the shortcut; none in
    an NFNet (no BN)."""
    if hasattr(model, "block_names"):  # ResNet-RS
        return [f"{b}.batch_norm_3" for b in model.block_names]
    blocks = getattr(model, "blocks", [])
    if blocks and hasattr(blocks[0], "shortcut"):  # EfficientNet
        return [s.name + ("fu_bn" if s.fused and not s.expand else "MB_pw_bn")
                for s in blocks if s.shortcut]
    if blocks and hasattr(blocks[0], "radix"):  # ResNest
        return [s.name + "3_bn" for s in blocks]
    return []


def _train_model(name: str, dtype: torch.dtype, damped: bool = True) -> torch.nn.Module:
    """A full-width member to compare one step on, one output, no
    activation, drop rates 0, the parameters in f32 whatever the compute
    dtype: ConvNeXt and GCViT with ``_model``'s seeded weights, the others
    with the registry's seeded init (the BNs normalise with the batch's
    statistics in training) and, ``damped``, the scale of each residual
    branch's last BN (:func:`branch_end_bns`) ~ U(0.1, 0.3), as
    ``_resnet_state`` damps it (ResNest50's, 0 at init, so that the
    gradient reaches the branches)."""
    if name in MEMBERS:
        return _model(name, dtype, nb_classes=1, drop_path_rate=0.0, param_dtype=torch.float32)
    zero = {f: 0.0 for f in ("drop_rate", "drop_connect_rate", "drop_path_rate")
            if hasattr(model_entry(name)[1], f)}
    model, _ = create_model(name, input_size=TRAIN_MEMBERS[name][0], nb_classes=1,
                            classifier_activation=None, dtype=dtype, seed=0,
                            param_dtype=torch.float32, **zero)
    if damped:
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for bn in branch_end_bns(model):
                p = model.get_submodule(bn).weight
                p.copy_(torch.rand(p.shape, generator=gen) * 0.2 + 0.1)
    return model.cuda()


def _trainable_model(name: str) -> torch.nn.Module:
    """A full-width member with the registry's seeded init and drop rates
    (the JAX train tools start from it: GCViT drop_path 0.2, ConvNeXt 0.1,
    ResNetRS50 head dropout 0.25; V2T head dropout 0.2, V1B4 drop-connect
    0.2 and dropout 0.4, ECA_NFNetL0 dropout 0.2, ResNest50 none), one
    output, no activation, bf16 compute, f32 parameters."""
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
    f32 step on the same batch (held to the bounds unless it is a BN
    member's undamped draw, which is printed only), and the kernel step's
    launches."""
    model = tr.model
    loss_fn = lambda: tr._loss(y, model(x).float())  # noqa: E731
    model.train()
    reset_launches()
    loss, grads = value_and_grad(loss_fn, tr.params)
    torch.cuda.synchronize()
    launches = all_launches()
    expected = TRAIN_MEMBERS[name][1]
    want = {n: expected.get(n, 0) for n in COUNTED}
    print(f"[train] {name}: launches in one training step (forward and backward): "
          f"{ {n: c for n, c in launches.items() if c} }")
    bad = {n: launches[n] for n in COUNTED if launches[n] != want[n]}
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
    # a tensor whose true gradient is 0 (a bias that a BN in batch
    # statistics subtracts again: ResNest50's sa_2_conv.bias, the BN shift
    # before a 1 x 1 conv and BN) has rounding for a gradient on both
    # paths; the largest the kernel path leaves in those is its rounding
    # floor, and a tensor whose plain f32 gradient is below it (V1B4's
    # stack_0_block0_MB_pw_bn.bias, which reaches the loss only through
    # the next depthwise conv's border) cannot be judged by its own cosine.
    # Both kinds stay in the global cosine and norm.
    norms = {k: ref_grads[k].norm() / ref_flat.norm() for k in grads}
    zero = [k for k in grads if norms[k] <= ZERO_GRADIENT]
    floor = max([(grads[k].norm() / ref_flat.norm()).item() for k in zero], default=0.0)
    per = {k: _cos(grads[k].flatten(), ref_grads[k].flatten()) for k in grads
           if norms[k] > max(ZERO_GRADIENT, floor)}
    below = [k for k in grads if k not in per and k not in zero]
    worst = min(per, key=per.get)
    zero_note = ""
    if zero:
        zero_note = (f"; {len(zero)} tensors with a zero true gradient (plain f32 at most "
                     f"{ZERO_GRADIENT:g} of the norm), the kernel path's rounding in them up to "
                     f"{floor:.2e} of it")
    if below:
        low = min(below, key=lambda k: _cos(grads[k].flatten(), ref_grads[k].flatten()))
        zero_note += (f"; {len(below)} tensors below that floor left out of the per-tensor "
                      f"cosine (worst {low}: {norms[low].item():.2e} of the norm, cosine "
                      f"{_cos(grads[low].flatten(), ref_grads[low].flatten()):.4f}, not gated)")
    table_norms = [grads[k].norm().item() for k in grads if k.endswith("bias_table")]
    tables = (f"; rel-pos tables' gradient norms {min(table_norms):.3e} .. "
              f"{max(table_norms):.3e}" if table_norms else "")
    draw = ("" if name not in DAMPED_MEMBERS else
            " damped" if damped else " undamped (printed only)")
    print(f"[train] {name}{draw}: one step, batch {TRAIN_BATCH}, drop rates 0, kernel path (bf16 "
          f"compute, f32 parameters) vs the plain f32 path: loss {loss.item():.6f} vs "
          f"{ref_loss.item():.6f} (rel {loss_rel:.3e}, bound {TRAIN_LOSS_BOUND:g}); gradient "
          f"global norm {flat.norm().item():.4e} vs {ref_flat.norm().item():.4e} (ratio "
          f"{norm_ratio:.4f}, bound 1 +- {TRAIN_NORM_BOUND:g}); cosine {cos:.6f} (bound "
          f"{TRAIN_COS_BOUND:g}); worst tensor {worst} cosine {per[worst]:.4f} (bound "
          f"{TRAIN_TENSOR_COS_BOUND:g}) of {len(per)}{zero_note}{tables} [{card}]")
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
    print(f"[train] {name}: batch-{TRAIN_BATCH} training step profile (device time)")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40 if profile else 20))
    sites = []
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof, recording_depthwise(sites):
        t0 = time.perf_counter()
        tr.train_step(x, y, 0.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000
    tr.opt_state = state
    dev = device_ms_of(prof)
    k9 = ""
    if sites:
        k9_dev, k9_ms = depthwise_backward_ms(sites, TRAIN_BATCH)
        k9 = (f"; K9's plain backward (depthwise_conv_nhwc_plain_grad) at its {len(sites)} "
              f"sites: {k9_dev:.2f} device ms ({k9_dev / dev:.1%} of the step's device time), "
              f"{k9_ms:.2f} ms by events")
    print(f"[train] {name}: one batch-{TRAIN_BATCH} step: {wall:.2f} ms by host clock, device "
          f"{dev:.2f} ms (CUDA-only profile; idle {idle_share(dev, wall)}){k9} [{card}]")


def depthwise_backward_ms(sites: list, batch: int) -> tuple:
    """(device ms by a CUDA-only profile, ms by events) of K9's plain
    backward, ``depthwise_conv_nhwc_plain_grad``, once at each recorded
    site (input shape without the batch, k, padding) on bf16 inputs, taps
    and output gradient at ``batch``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    gen = torch.Generator(device="cuda").manual_seed(5)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(  # noqa: E731
        torch.bfloat16)
    args = []
    for (h, w, c), k, pad in sites:
        (pt, pb), (pl, pr) = pad
        ho, wo = h + pt + pb - k + 1, w + pl + pr - k + 1
        args.append((rand(batch, h, w, c), rand(k, k, c), rand(batch, ho, wo, c), pad))

    def run():
        for xs, kern, dy, pad in args:
            D.depthwise_conv_nhwc_plain_grad(xs, kern, dy, padding=pad)

    ms = cuda_ms(run, iters=3, warmup=1)
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return device_ms_of(prof), ms


def phase_train(card: str, profile: bool, name: str) -> None:
    """Full-width ``name`` trained on the card: one kernel step against the
    plain f32 step and its launches, the step's parts timed, then
    ``Trainer.fit`` for eight AdamW steps, evaluation, checkpoint, resume
    and the trained weights served on the fused path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, _ = TRAIN_MEMBERS[name]
    gen = torch.Generator(device="cuda").manual_seed(3)
    if name in CAST_MEMBERS:
        cast = torch.rand((TRAIN_BATCH, 1, 1, 3), generator=gen, device="cuda") * 0.7
        x = torch.rand((TRAIN_BATCH, *size, 3), generator=gen, device="cuda") * 0.3 + cast
    else:
        x = torch.rand((TRAIN_BATCH, *size, 3), generator=gen, device="cuda")
    y = (torch.rand((TRAIN_BATCH, 1), generator=gen, device="cuda") > 0.5).float()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = TrainConfig(epochs=1, steps_per_epoch=TRAIN_STEPS, lr_base=3e-4,
                          lr_schedule="constant", optimizer="adamw", weight_decay=1e-4,
                          loss="bce_timm", monitor="loss", ckpt_dir=ckpt_dir,
                          basic_save_name="member", seed=0)
        if name in DAMPED_MEMBERS:  # the registry's draw first, printed only
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
        served = SERVED_LAUNCHES.get(name, {})
        print(f"[train] {name}: the checkpoint served by a fresh bf16 model on the fused path "
              f"vs the trained model's eval logits: max|d|/max|ref| = {r:.3e} (bound "
              f"{MODEL_BOUND:g}); launches of the two forwards "
              f"{ {n: launches[n] for n in served} } (expected "
              f"{ {n: 2 * c for n, c in served.items()} }) [{card}]")
        if not r <= MODEL_BOUND or any(launches[n] != 2 * c for n, c in served.items()):
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


DATA_TRAIN, DATA_VAL = 192, 64  # JPEGs of the task, two classes
DATA_SIDES = (160, 320)
DATA_BATCH, DATA_EPOCHS, DATA_STEPS = 64, 2, 3
DATA_SIZE = (224, 224)
DATA_AUG_TOL = 1e-4  # of [0, 1]: the CPU tests' bound
DATA_BOUNDARY_SHARE = 1e-3  # pixels an integer cast or a round may move
# one fused GCViTTiny forward (an eval batch): the five block kernels at
# every block, K9 at its stride-1 sites, K10 at its standalone LNs
GCVIT_FUSED_FORWARD = {**{n: GCVIT_BLOCKS for n in GCVIT_KERNELS + MLP_KERNELS},
                       DW: GCVIT_DW_SITES, LN: GCVIT_LNS}


def device_ms_of(prof) -> float:
    """The device time a CUDA-only profile recorded, in ms."""
    return sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages()) / 1000


def idle_share(device_ms: float, wall_ms: float) -> str:
    if not device_ms:
        return "not measured (no device time profiled)"
    return f"{1 - device_ms / wall_ms:.1%} (device {device_ms:.1f} ms of {wall_ms:.1f} ms)"


def write_task_dataset(root: str) -> str:
    """``DATA_TRAIN`` + ``DATA_VAL`` JPEGs of ``tools/train_flip.py``'s
    task (8 x 8 grey blocks and noise, the fakes with a faint 2 x 2
    checkerboard), sides drawn in ``DATA_SIDES`` and never square, and
    their custom JSON; returns the JSON's path."""
    import cv2

    from vip_cup_2022_tpu_torch.tools.train_flip import make_batch

    gen = torch.Generator().manual_seed(11)
    rng = np.random.RandomState(11)
    items = {"train": [], "validation": [], "info": {"num_classes": 2}}
    for split, n in (("train", DATA_TRAIN), ("validation", DATA_VAL)):
        for i in range(n):
            h, w = (int(v) for v in rng.randint(DATA_SIDES[0], DATA_SIDES[1], 2))
            w += h == w
            img, label = make_batch(gen, 1, (h, w), torch.device("cpu"))
            rgb = (img[0] * 255.0).round().to(torch.uint8).numpy()
            path = os.path.join(root, f"{split}_{i:03d}.jpg")
            if not cv2.imwrite(path, np.ascontiguousarray(rgb[:, :, ::-1]),
                               [cv2.IMWRITE_JPEG_QUALITY, 95]):
                raise RuntimeError(f"cv2 could not write {path}")
            items[split].append({"image": path, "label": int(label.item())})
    path = os.path.join(root, "data.json")
    with open(path, "w") as fh:
        json.dump(items, fh)
    return path


def check_augment_ops(card: str, x_u8: np.ndarray) -> None:
    """RandAugment, AutoAugment and the five device augment ops on one
    loader batch on the card against the same ops on the CPU with the same
    draws, each timed (CUDA events). The [0, 1] input is made once on the
    CPU, so both sides start from the same values."""
    x = torch.from_numpy(x_u8).float() / 255.0
    xd = x.cuda()
    b, h, w = x.shape[:3]
    g = torch.Generator().manual_seed(5)
    rand = RA.draw_rand_augment(g, b, (h, w), num_layers=2, magnitude=6.0, magnitude_std=0.5)
    auto = RA.draw_auto_augment(g, b, "v0")
    bgr, jitter, blur = AUG.draw_gate(g, b, 0.5), AUG.draw_jitter(g, b), AUG.draw_gate(g, b, 0.5)
    affine, (jpeg_gate, jpeg_q) = AUG.draw_affine(g, b), AUG.draw_jpeg_quality(g, b)
    ops = {  # name: (op, bound: "equal", "tol" or "boundary")
        "rand_augment m6 x2": (lambda t: RA.rand_augment(t, rand), "boundary"),
        "auto_augment v0": (lambda t: RA.auto_augment(t, auto, "v0"), "boundary"),
        "random_bgr": (lambda t: AUG.random_bgr(t, bgr), "equal"),
        "random_jitter": (lambda t: AUG.random_jitter(t, jitter), "tol"),
        "blur": (lambda t: AUG.blur(t, blur), "tol"),
        "shift_scale_shear_rotate": (lambda t: AUG.shift_scale_shear_rotate(t, affine), "tol"),
        "random_jpeg_quality": (lambda t: AUG.random_jpeg_quality(t, jpeg_gate, jpeg_q),
                                "boundary"),
    }
    for name, (op, bound) in ops.items():
        got = op(xd).cpu()
        want = op(x)
        d = (got - want).abs()
        off = int((d > DATA_AUG_TOL).sum())
        ms = cuda_ms(lambda: op(xd), iters=5, warmup=1)
        print(f"[train_data] {name} on {b} x {h} x {w}: {ms:.2f} ms a batch on the card; vs the "
              f"CPU on the same draws max|d| {d.max().item():.3e}, {off} of {d.numel()} pixels "
              f"beyond {DATA_AUG_TOL:g} [{card}]")
        ok = {"equal": torch.equal(got, want), "tol": off == 0,
              "boundary": off <= DATA_BOUNDARY_SHARE * d.numel()}[bound]
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"{name} on the card disagrees with the CPU ({bound})")


def phase_train_data(card: str) -> None:
    """GCViTTiny@224 trained and evaluated from JPEGs on disk through the
    port's data path (phase 10 of the docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        path = write_task_dataset(root)
        info = init_dataset(path, batch_size=DATA_BATCH, info_only=True)
        train_fn, val_fn, *_ = init_dataset(path, input_shape=DATA_SIZE, batch_size=DATA_BATCH)
        xv, yv = next(val_fn())
        print(f"[train_data] {DATA_TRAIN} + {DATA_VAL} JPEGs and their JSON written in "
              f"{time.perf_counter() - t0:.1f} s; init_dataset info (images, classes, steps, "
              f"channels) {info}; its validation batch {xv.dtype} {tuple(xv.shape)}")
        if info != (DATA_TRAIN, 2, DATA_TRAIN // DATA_BATCH, 3) or xv.shape != (
                DATA_BATCH, *DATA_SIZE, 3) or yv.shape != (DATA_BATCH, 2):
            raise AssertionError("init_dataset's JSON route gave another dataset")
        train, val, classes = loaders_from_custom_json(
            path, batch_size=DATA_BATCH, target_shape=DATA_SIZE, random_crop_min=0.08,
            random_erasing_prob=0.25)
        x_u8, _ = next(iter(train))
        check_augment_ops(card, x_u8)

        model, _ = create_model("GCViTTiny", input_size=DATA_SIZE, nb_classes=classes,
                                classifier_activation=None, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
        ckpt_dir = os.path.join(root, "ckpt")
        cfg = TrainConfig(epochs=DATA_EPOCHS, steps_per_epoch=DATA_STEPS, lr_base=3e-4,
                          lr_schedule="constant", optimizer="adamw", weight_decay=1e-4,
                          loss="bce_timm", monitor="val_loss", ckpt_dir=ckpt_dir,
                          basic_save_name="data", seed=0)
        tr = Trainer(model.cuda(), cfg)
        gen = torch.Generator().manual_seed(0)
        ms = {"loader": [], "augment": [], "validation": [], "checkpoint": []}
        losses, last = [], {}

        def train_iter():
            it = iter(train)
            while True:
                t = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    return
                ms["loader"].append((time.perf_counter() - t) * 1000)
                t = time.perf_counter()
                last["batch"] = post_process_batch(
                    batch[0], batch[1].argmax(-1), classes, train=True, rescale_mode="raw01",
                    magnitude=6, num_layers=2, generator=gen, device="cuda")
                ms["augment"].append((time.perf_counter() - t) * 1000)
                yield last["batch"]

        def val_iter():
            t = time.perf_counter()
            yield from val
            ms["validation"].append((time.perf_counter() - t) * 1000)

        train_step, save, evals = tr.train_step, tr._save, []

        def counted_step(images, labels, lr):
            losses.append(train_step(images, labels, lr))
            return losses[-1]

        def timed_save(tag):
            t = time.perf_counter()
            out = save(tag)
            ms["checkpoint"].append((time.perf_counter() - t) * 1000)
            return out

        tr.train_step, tr._save = counted_step, timed_save
        tr.eval_step = lambda *a, f=tr.eval_step: evals.append(1) or f(*a)
        from torch.profiler import ProfilerActivity, profile as torch_profile

        reset_launches()
        # the clocks inside the profile: its start and its teardown are not
        # the fit's
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            history = tr.fit(train_iter, val_iter, verbose=1)
            torch.cuda.synchronize()
            fit_ms = (time.perf_counter() - t0) * 1000
        launches = all_launches()
        steps, forwards = len(losses), len(evals)
        want = {n: 0 for n in COUNTED}
        for n, c in TRAIN_MEMBERS["GCViTTiny"][1].items():
            want[n] += steps * c
        for n, c in GCVIT_FUSED_FORWARD.items():
            want[n] += forwards * c
        print(f"[train_data] launches over the fit ({steps} steps, {forwards} validation "
              f"batches): { {n: c for n, c in launches.items() if c} }")
        val_batches = -(-DATA_VAL // DATA_BATCH)
        if steps != DATA_EPOCHS * DATA_STEPS or forwards != DATA_EPOCHS * val_batches:
            raise AssertionError(f"the fit ran {steps} steps and {forwards} validation batches")
        bad = {n: (launches[n], want[n]) for n in COUNTED if launches[n] != want[n]}
        if bad:
            raise AssertionError(f"the fit from disk launched (got, expected) {bad}")
        step_losses = [v.item() for v in losses]
        latest = os.path.join(ckpt_dir, "data_latest.msgpack")
        if (not all(np.isfinite(step_losses)) or len(history["loss"]) != DATA_EPOCHS
                or not os.path.isfile(latest)):
            raise AssertionError(f"the fit from disk gave losses {step_losses}, history "
                                 f"{history}, latest checkpoint {os.path.isfile(latest)}")
        fit_device = device_ms_of(prof)

        # steady state: three more batches from disk through the same step
        # (no validation, no checkpoint), profiled alone, each part's host
        # time apart
        parts = {"loader": [], "augment": [], "step": []}
        loader_it = iter(train)
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DATA_STEPS):
                t = [time.perf_counter()]
                images, onehot = next(loader_it)
                t.append(time.perf_counter())
                x, y = post_process_batch(images, onehot.argmax(-1), classes, train=True,
                                          rescale_mode="raw01", magnitude=6, num_layers=2,
                                          generator=gen, device="cuda")
                t.append(time.perf_counter())
                tr.train_step(x, y, cfg.lr_base)
                t.append(time.perf_counter())
                for part, a, b in zip(parts, t, t[1:]):
                    parts[part].append((b - a) * 1000)
            t = time.perf_counter()
            torch.cuda.synchronize()
            drain_ms = (time.perf_counter() - t) * 1000
            steady_ms = (time.perf_counter() - t0) * 1000 / DATA_STEPS
        steady_device = device_ms_of(prof)
        x_mem, y_mem = last["batch"]
        in_memory = cuda_ms(lambda: tr.train_step(x_mem, y_mem, 0.0), iters=3, warmup=1)
        med = lambda v: float(np.median(v))  # noqa: E731
        print(f"[train_data] GCViTTiny@224 Trainer.fit from disk, {DATA_EPOCHS} x {DATA_STEPS} "
              f"steps of {DATA_BATCH}: losses {', '.join(f'{v:.4f}' for v in step_losses)}; "
              f"history {history}; TrainLoader host ms a batch {med(ms['loader']):.1f} (median "
              f"of {len(ms['loader'])}), post_process_batch (RandAugment on the card) host ms "
              f"{med(ms['augment']):.1f}; fit wall {fit_ms:.1f} ms (the first step's warm-up "
              f"in it), of it validation {sum(ms['validation']):.1f} and checkpoints "
              f"{sum(ms['checkpoint']):.1f}; the card idle {idle_share(fit_device, fit_ms)} "
              f"over the fit [{card}]")
        split = ", ".join(f"{part} {np.mean(v):.1f}" for part, v in parts.items())
        print(f"[train_data] steady state, {DATA_STEPS} more batches from disk: "
              f"{steady_ms:.1f} ms a step ({DATA_BATCH * 1000 / steady_ms:.1f} img/s; host ms "
              f"a step: {split}, then {drain_ms:.1f} waiting for the card), the card idle "
              f"{idle_share(steady_device, steady_ms * DATA_STEPS)}; the same step on a batch "
              f"already on the card {in_memory:.1f} ms ({DATA_BATCH * 1000 / in_memory:.1f} "
              f"img/s) [{card}]")

        val_paths, val_labels = recognition_dataset_from_custom_json(path)["validation"]
        outs = []
        hook = tr.model.register_forward_hook(lambda m, i, o: outs.append(o.float()))
        reset_launches()
        t0 = time.perf_counter()
        result = evaluation(tr.model, val_paths, val_labels, classes, batch_size=DATA_BATCH,
                            target_shape=DATA_SIZE)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        hook.remove()
        launches = all_launches()
        ref, _ = create_model("GCViTTiny", input_size=DATA_SIZE, nb_classes=classes,
                              classifier_activation=None, dtype=torch.float32)
        transfer_weights(torch_to_flax(tr.model), ref, strict=True)
        ref = ref.cuda().eval()
        loader = EvalLoader(val_paths, val_labels, classes, DATA_BATCH, DATA_SIZE)
        with torch.no_grad(), plain_kernels():
            want = torch.cat([ref(torch.from_numpy(xb).cuda().float() / 255.0) for xb, _ in loader])
        got = torch.cat(outs)
        r = rel_err(got, want)
        print(f"[train_data] evaluation on the {DATA_VAL} validation JPEGs (fused path): "
              f"top-1 {result['top1']:.4f}, top-5 {result['top5']:.4f}, n {result['n']} in "
              f"{eval_s:.2f} s; its logits vs the same weights in f32 under plain_kernels(): "
              f"max|d|/max|ref| = {r:.3e} (bound {MODEL_BOUND:g}); launches "
              f"{ {n: c for n, c in launches.items() if c} } [{card}]")
        if (result["n"] != DATA_VAL or not r <= MODEL_BOUND or not torch.isfinite(got).all()
                or any(launches[n] != val_batches * c for n, c in GCVIT_FUSED_FORWARD.items())):
            raise AssertionError("evaluation on the card disagrees with the plain f32 path or "
                                 "did not run the fused kernels")

        combined = train_history.combine_hist_into_one(
            [os.path.join(ckpt_dir, "data_hist.json")])
        per_step = train_history.combine_hist_into_one(
            [{"loss": step_losses[:DATA_STEPS]}, {"loss": step_losses[DATA_STEPS:]}])["loss"]
        fitted = train_history.curve_fit(per_step, target_len=3, skip=1)
        print(f"[train_data] combine_hist_into_one of the history file: {combined}; curve_fit "
              f"of the {len(per_step)} step losses, 3 ahead: "
              f"{', '.join(f'{v:.4f}' for v in fitted)}")
        if combined != history or len(fitted) != len(per_step) + 3 or not all(
                np.isfinite(fitted)):
            raise AssertionError("the history tools gave another history")
        train.close()
        val.close()
    print(f"[train_data] phase wall time {time.perf_counter() - t_phase:.1f} s [{card}]")


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(label: str) -> None:  # the wall seconds since the last lap, printed at the end
        now = time.perf_counter()
        laps[label] = round(now - t_lap[0], 1)
        t_lap[0] = now

    card = phase_device()
    phase_build()
    lap("build")
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
    lap("kernels and tools")
    phase_int8_kernels(card, stats)
    lap("int8 block kernels")
    profile = "--profile" in argv
    phase_model("convnext_tiny_in22k", card, profile)
    dw_members = {"GCViTTiny": phase_model("GCViTTiny", card, profile, fused_block=True)}
    phase_model("GCViTTiny", card, profile, fused_block=False)
    states = {name: _effnet_state(name) for name in EFFNETS}
    states["ECA_NFNetL0"] = _nfnet_state()
    for name in EFFNETS:
        dw_members[name] = phase_member(name, card, profile, states[name])
    phase_depthwise_sites(card, stats, dw_members)
    phase_member("ECA_NFNetL0", card, profile, states["ECA_NFNetL0"])
    lap("models")
    calls = {}
    for name in INT8_RESNETS:
        calls[name] = phase_int8_member(name, card, profile)[0]
        phase_ptq_sites(card, stats, calls[name], name, tool=name == "ResNetRS50")
    lap("int8 ResNetRS50 and ResNest50")
    for name in INT8_SITES:
        if name not in calls:
            calls[name] = phase_int8_other(name, card, profile, states.pop(name, None))
            if name == "ECA_NFNetL0":  # its grouped sites apart, for their own line
                for part, grouped in (("grouped", True), ("ungrouped", False)):
                    phase_ptq_sites(card, stats, [c for c in calls[name] if (c[4] > 1) == grouped],
                                    f"{name} {part}", tool=False)
            else:
                phase_ptq_sites(card, stats, calls[name], name, tool=False)
    del states
    print(f"[kernels] the {PTQ_YARDSTICKS['sites']} int8 sites of a seven-member batch-256 "
          f"forward: in bf16 convs / F.linear {PTQ_YARDSTICKS['cudnn']:.2f} ms; the 1 x 1 and "
          f"Linear sites as torch._int_mm on pre-quantized rows {PTQ_YARDSTICKS['int_mm']:.2f} ms "
          f"(refused at {PTQ_YARDSTICKS['refused']}) [{card}]")
    phase_layernorm_gc(card)
    lap("int8 other members, their sites, gc_ln")
    phase_int8_models(card)
    lap("int8 block models")
    launches = {**phase_slice(card), **tool_launches, **spike_launches}
    phase_slice_int8(card, len(calls["ResNetRS50"]), pass_sites(calls["ResNetRS50"]))
    every = calls["ResNetRS50"] + calls["ResNest50"]
    every_member = [c for name in INT8_SITES for c in calls[name]]
    dw_sites = [site for sites, _ in dw_members.values() for site in sites]
    launches.update(phase_slice_seven(card, len(dw_sites), len(every), pass_sites(every),
                                      len(every_member), pass_sites(every_member)))
    lap("CSV slices")
    launches.update(phase_slice_int8_kernels(card, len(dw_sites), len(every_member),
                                             pass_sites(every_member)))
    lap("CSV slices int8 blocks")
    phase_serving(card, stats, dw_sites)
    lap("serving")
    phase_pth(card)
    lap("pth")
    launches.update(phase_f32(card, stats))
    lap("f32")
    launches.update(phase_a15c(card, stats))
    lap("a15c")
    for name in TRAIN_MEMBERS:
        phase_train(card, profile, name)
        lap(f"train {name}")
    phase_train_flip(card)
    lap("train_flip")
    phase_train_data(card)
    lap("train_data")
    record = [{"name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
               "launches": launches[n], "max_abs_err": stats[n]["max_abs_err"],
               "ms": stats[n]["ms"], "plain_ms": stats[n]["plain_ms"],
               "bound_ms": stats[n]["bound_ms"],
               "bound_by": "bytes" if stats[n]["bytes_ms"] >= stats[n]["ops_ms"] else "operations",
               "library_ms": stats[n]["library_ms"]} for n in RECORDED]
    print(f"[smoke] wall seconds by phase: {laps}")
    print(f"[smoke] wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
