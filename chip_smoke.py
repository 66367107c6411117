#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dfot_tpu_torch) on one NVIDIA Hopper GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds the port's CUDA kernels from ``dfot_tpu_torch/csrc`` with nvcc
   (one compile per source, all started together);
2. checks each kernel (B1 flash forward, B2 qkv_prep, B3 attn_out_collect,
   B4 flash backward dq, B5 flash backward dk/dv, B6 qkv_prep backward, B7
   attn_out_scatter, B8 ln_modulate, B9 its backward, B10 small-N attention)
   against its plain PyTorch version in bf16 on seeded inputs: B1-B7 at the
   DFoT_RE10K flagship shapes, B = 1 (the train step) and B = 2 (the
   window), at K600 @DiT/XL's (8, 16, 1280, 72 -> 128) with the true
   1/sqrt(72) scale and the true head dim passed to B1, B4 and B5, at the
   base-width U-ViT's level 3 (B, 4, 2048, 256), B = 1 and 2, and at a head
   dim of 160 padded to 256 (B = 1, 4 heads, 2048 tokens); B1, B4 and B5
   also at N = 192 (a multiple of 64 but not of their 128-row blocks),
   causal and not, at d = 64, 128, 72 -> 128, 256 and 160 -> 256; B8, B9 at
   the XL, DiT/B and factorized-DiT widths, and at tails (token counts no
   multiple of a block's tokens, the other width-exact widths, C = 1154 and
   2304, fp32), B9 twice on the same operands for the same bits; B3 and B7
   bit for bit, also at N = 1000 for every path head dim (B7 twice for the
   same bits), B3 timed on B1's output as B1 has just written it (F level 2
   and XL); B3, B7, B8 and B9 beside the device's contiguous copy of the
   same bytes; B10 at the axial and factorized
   shapes, the base axial U-ViT's (2048, 8, 256) and at N = 5 and 32, d =
   64, 128 and 256 (twice in fp32); B6 also at a tail shape (a token count
   no multiple of its tile, 9 heads), and twice on the same operands, which
   must give the same bits.
   It times both, the kernel warm and with a cold L2 (``cold_ms``: 256 MB
   written before each call), computes each kernel's bound (the least time
   the card could take; attention's operations at the true head dim, B3's
   and B6's bytes those the function needs) and, where one PyTorch call computes the
   same function, times that call as a yardstick (at XL on the unpadded
   heads of 72);
3. samples a small 3-step window of a narrow U-ViT on both routes with the
   same random stream and compares them;
4. runs one full-width flagship UViT3DPose forward (B = 2, T = 8, 256 px,
   seeded random bf16 weights) on the kernel route and on the plain route;
5. drives the sampling path: ``DFoTRollout.sample_sequence`` for the
   8-frame quick-start window (1 context frame, identity poses, vanilla
   history guidance at scale 4, 50 DDIM steps), with every kernel's launch
   count reset just before and read just after;
6. samples a shorter window under ``torch.profiler``: device time by
   kernel class and the device's idle share;
7. runs one full-width forward and backward (B = 1, fp32 master weights,
   bf16 compute) on the kernel route and on the plain route and compares
   the loss and the gradients of named parameters;
8. drives the training path: ``make_train_state`` + ``make_train_step`` of
   the flagship recipe, a warm-up step and then five steps on a seeded
   synthetic batch, launch counts reset just before and read just after,
   time per step and peak memory;
9. takes one more train step under ``torch.profiler``;
10. runs the long-video tasks (``predict_videos``, ``interpolate_videos``):
    the narrow model of step 3 over 72 frames from one (9 keyframes in 2
    sliding windows, two interpolation rounds of 8 chunks: 18 windows) on
    the kernel route, the plain route and the control; then, at full width
    and depth, the two-image interpolation of BASELINE.json config 2 (8
    frames, vanilla HG at 4.0, 50 DDIM steps, twice, both timed, the second
    counted: frames 0 and 7 must come back bit for bit)
    and config 3's rollout cut from 200 to 40 frames (bench.py's settings
    but a keyframe density of 0.25: 10 keyframes by stabilized vanilla HG
    in 2 sliding windows, one interpolation round of 9 one-chunk windows
    by vanilla HG at 1.5: 11 windows of 50 steps), each with its launch counts reset
    before and required after; the rollout's wall time, frames/s, phase
    split and peak memory, its keyframes held bit for bit against the
    keyframe pass's output, and its wall against 18 times step 5's window;
11. builds K600 @DiT/XL at full width and depth (DiT3D, hidden 1152, depth
    28, 16 heads of 72, 1280 tokens; its parameter count is printed) and
    runs a batch-8 forward and a forward + backward on the kernel route and
    the plain route;
12. drives the XL sampling path: one 50-step DDIM window of 8 videos of 5
    latent frames (2 context), launch counts reset before and required
    after, wall time and peak memory; then a shorter window under
    ``torch.profiler``;
13. drives the XL training path: a warm-up step and five ``train_step``s at
    batch 8 (every block checkpointed), launch counts required, time per
    step and peak memory; then one more step under ``torch.profiler``;
14. runs the factorized-attention DiT (hidden 384, 6 heads of 64, depth 12)
    on the Minecraft latent shape, batch 8, and the flagship U-ViT with
    axial transformer blocks at a cut depth: route checks forward and
    forward + backward, then one forward and one forward + backward with
    launch counts required (kernel B10 on both), and the same once more
    under ``torch.profiler``; the axial U-ViT's gradients also against an
    fp32 plain-route witness;
15. builds UViT3DPose at the backbone's own published widths
    (``uvit3d_pose_base``: channels 128-1024, 4 heads, so level 3 has heads
    of 256 over 2048 tokens) and runs steps 4-9 on it: a full-width
    forward (B = 2) with its control, a forward + backward (B = 1) with the
    zero-dq control, the 50-step 8-frame window with its launch counts
    required, a profiled 10-step window, six train steps with their launch
    counts required, a profiled step;
16. runs that model with axial blocks at level 3 at a cut depth: route
    checks, the fp32 gradient witness, launch counts (B10 at d = 256), a
    profile;
17. runs the README's RE10K validation through the port's entry point,
    ``dfot_tpu_torch.__main__.run(argv)`` (``python -m dfot_tpu_torch``),
    on the flagship at full width and depth: it writes a seeded random fp32
    UViT3DPose as an upstream-layout ``.ckpt`` under ``chiprun_out/``
    (deleted after), runs the command with ``load=`` that file, a batch of
    2 and one batch, the README's metric list as composed (fvd, is, fid,
    lpips, mse, ssim, psnr; no GIFs where PIL is absent), and requires the
    model's every parameter and buffer bit-equal to the file's, B1-B3
    launched 32 times per forward of the window's sampling plan, the 4
    context frames of the prediction bit-equal to the ground truth's, the
    composed list's names in ``metrics.jsonl`` (``fvd_uncalibrated``,
    ``is_uncalibrated``, ``fid_uncalibrated``, ``lpips_uncalibrated``: no
    metric weight files) with finite values, and the metric networks
    frozen on the card; it prints the phase's wall split (compose,
    checkpoint write, checkpoint load, model build, sampling, metrics, the
    metrics logger), the metrics' split by metric and its peak memory;
18. trains the flagship through the same entry point at full width, its
    depth cut to ``FLAGSHIP_CUT_DEPTH`` (``CUT_DEPTH_ARGV``; full depth
    until PR 19), and the composed batch of 8 (``experiment.tasks=[training]``,
    checkpoints and runs under ``build/train_loop``, removed after): a run
    warm-started from a seeded random ``.ckpt`` takes 6 steps (checkpoints
    every 2 kept to 2, mid-run validation every 3 on one batch of 2, step 5
    profiled), a second run resumes it by name (``load=`` its ``+name``) to
    step 8, a third validates the second's checkpoints (``val_all_ckpt``,
    batch 2, one batch); each run's launch counts reset before and required
    after (the steps, the mid-run forwards and the sampled windows), the
    kept directories the newest two, every restore and the newest
    checkpoint of each run bit for bit against the state it holds, the
    learning rates those of an unbroken run, finite losses, gradient norms
    and validation losses in ``metrics.jsonl``, the swept weights the
    checkpoint's EMA; it prints the step walls, peak memory, each
    checkpoint's snapshot and background write seconds, the restore, the
    mid-run validation and the profiled step's device time by class. Step 2
    also holds B1-B7 at the flagship's two sites at this batch, the plain
    attention one batch entry at a time;
19. builds FacMatDiT/L (factorized matrix attention, 257.8M) and
    FullMatDiT/XL at full width and depth on UCF-101's latents (16 frames
    of 8 x 8 x 32) through ``build_algorithm(load_config(argv))`` with
    seeded random weights: for FacMatDiT/L route checks forward and forward
    + backward at the validation batch of 32, the 50-step window at that
    batch (B8 and B10 from the spatial blocks, nothing from the matrix
    blocks) and a profiled 10-step one, five train steps at the training
    batch of 32 (every block checkpointed, B8, B9, B10) and a profiled
    one; for FullMatDiT/XL the window, a profiled 10-step one and one train
    step (B8 and B9 only in the final layer). Then the flagship's 8-frame
    vanilla-HG window with reconstruction guidance (a forward and a
    backward of the model each step, B1-B7): a 3-step window on the kernel
    route, the plain route and without the guidance gradient (the
    control), then the 50-step window with its launch counts, wall time
    against step 5's window and peak memory, and a profiled 10-step one.
    Last, the base-width axial U-ViT of step 16 on the sampling route's
    precomputed pose conditioning (level 3's pooled pose map) against the
    raw ray maps, with the level maps dropped as the control, B1-B3 and
    B10 launch counts required. Step 2 also holds B8, B9 and B10 at
    FacMatDiT/L's spatial shapes;
20. drives the latent path (``run_latent_paths``): the DMLab recipe's DC-AE
    f8c32 at its published widths on seeded random weights, a (2 x 16, 64,
    64, 3) batch encoded and decoded twice (the same bits) and held against
    the same weights on the CPU in fp32 (relative L2 1e-4), with the pixel
    shuffles in the wrong channel order as the control, timed with fp32
    and with TF32 convolutions; a DMLab-layout directory of seeded ``.npz``
    videos under ``build/latent/`` (360 clips of 16 frames: 11 batches of
    32 an epoch); the recipe trained through ``run(argv)`` at its composed
    batch of 32 with its 11 loader worker processes and the DC-AE encoding
    each batch online, 12 steps (the 12th in the second epoch), a mid-run
    validation every 6 decoding through the DC-AE, the step period, the
    encode, the train step and the wait for each batch timed, one step
    profiled in two parts (the encode; the DiT's forward, backward and
    update); ``experiment=video_latent_preprocessing`` on the directory,
    then 2 steps from its latents (``dataset.latent.type=pre_sample``), the
    first batch held against the online encoding of the same clips to the
    fp16 rounding; K600 @DiT/XL at full width, depth cut to 4, on a
    K600-layout directory of preprocessed ``.npz`` (17 frames, 128 px): 2
    steps at its composed batch of 16 with the VideoVAE encoding online,
    then one validation batch decoded and scored; B1-B9 required launched
    in each of the three training runs. Step 2 also holds B1-B7 at the
    DMLab site (32, 6, 256, 64) and B8, B9 at C = 384 over 32 x 256 tokens;
21. (``run_slice15_paths``) K600 @DiT/XL at full depth and the flagship
    (level 3 checkpointed) under the remat policies none, dots, attn and
    dots_attn: the loss and the gradients of named parameters under each
    against none at B = 2 (within ``GRAD_REL_TOL``), with the outputs the
    attn policy keeps scaled by 1.5 as the control; five train steps at
    batch 8 under each (a dots policy at the largest batch its kept
    outputs, counted before it runs, leave room for), the launch counts of
    the policy (B3 and B10 not run again under attn, as in the JAX jaxpr),
    step wall, peak memory, and one profiled step (device busy, B1, B2, B3
    ms). Then VAE training through ``run(argv)``
    (``experiment=video_latent_learning``): K600's VideoVAE and
    Minecraft's ImageVAE at full width on seeded directories in their
    layouts, at the recipes' batches (4, 8) or the largest their memory
    allows (from steps at 1 and 2 clips, printed), six steps, the
    adversarial term from the third; the card's first adversarial step
    against the CPU's in fp32 on one clip (1e-4; control: the step
    without the adversarial term), and the batch statistics a training
    forward folds into the discriminator's running statistics (1e-4;
    controls: torch's BatchNorm2d, momentum 0.9); each step's metrics and
    phase split, peak memory, ``metrics.jsonl`` and the checkpoint. Last,
    the TiTok-L and kl-f8 preprocessors at their published widths on seeded
    weights (kl-f8 through the hub-name path: a warning and random weights),
    encode ms a frame and the latents' shapes;
22. (``run_slice16_paths``) the other backbones through
    ``build_algorithm(load_config(argv))`` on seeded random weights:
    UNet3D (``algorithm/backbone=u_net3d``, UCF-101 pixels, 31.3M) on the
    kernel route against the plain route (forward; forward + backward with
    dq zeroed as the control), its 50-step window at batch 32 and train
    steps at the recipe's batch or the largest that fits; the difference
    DFoT (@DiffDiT/B on UCF-101 latents) on each merge, the same checks on
    the merged stream (the interleaved merge against the plain 3-D table
    over 2T frames as well), window and steps, and its FacMatDiT leaf;
    FAR-DiT (@FARDiT/B) and DiT1D (taichi's tokens) in bf16 against fp32
    on the card with a control each, window and steps, launching no
    kernel; UNet3D through ``run(argv)`` on a seeded DMLab-layout
    directory. Step 2 also holds B1, B4 and B5 at UNet3D's sites (heads of
    32 padded to 64, N = 256 and 64, causal and not) and B2 with the
    doubled table (its control: the plain table over 2T frames).

23. (``run_metric_paths``) the metric suite: I3D, InceptionV3 at 299 px,
    LPIPS, CLIP B/32 and L/14 and DINO B/16 on seeded weights, each on the
    card against the CPU in fp32 with TF32 off at the flagship
    validation's batch (1e-4 relative L2; controls: I3D's SAME padding made
    symmetric, a BatchNorm statistic of Inception's stem changed, LPIPS's
    first head and CLIP's and DINO's first norm scaled), and timed a call;
    K600's validation as composed (``[vbench, fvd, is, fid, lpips, mse,
    ssim, psnr]``) through ``run(argv)`` on phase 20's latent path (@DiT/XL
    at depth 4, batch 2, one batch); ``VideoMetric(["fvmd"])`` on two
    16-frame clips of the 40-frame rollout; the host's Frechet distances
    (``scipy.linalg.sqrtm`` at 2048 and 400 dimensions) in that validation,
    apart from the networks' passes.

24. (``run_a15c_paths``) RAFT, AMT-S, PIPs2 and MUSIQ at their published
    widths on seeded witness weights (output heads scaled so that flows and
    tracks move a few pixels), each on the card against the CPU in fp32
    with TF32 off at the shapes the metrics give it (RAFT: a video's 7
    pairs at 224^2, 20 iterations; AMT-S: its 3 even-frame pairs at 256^2;
    PIPs2: 16 frames at 256^2, 400 points, 16 iterations; MUSIQ: 16 frames
    at 256^2, three scales; ``A15C_CPU_REL_TOL``; controls: the correlation
    window's offsets swapped, AMT-S's transposed convolutions unflipped,
    MUSIQ's stem padded symmetrically), and timed a call; K600's validation
    as composed with the four networks' ``.npz`` files (the JAX registry's
    flattened trees) in ``metrics_weights_dir``: motion_smoothness through
    AMT-S and dynamic_degree through RAFT, logged without
    ``_uncalibrated``, imaging_quality through MUSIQ on its predictions,
    B1-B3 and B8 launched; ``VideoMetric(["fvmd"])`` tracking with PIPs2
    on the rollout's two clips.

25. (``run_ring_paths``) ring attention (``ops/ring_attention.py``) on a
    ``LocalRing`` of R = 2 and 4 virtual ranks at the flagship's two
    attention sites (B 2; N 8192, 9 heads of 64; N 2048, 9 of 128): forward
    and backward against the plain ring and against unsharded B1 + B4 + B5
    (``RING_REL_TOL``), the exact launches of one call (R of B1 as ring
    blocks, R each of B4 and B5), a control whose fold skips one hop, device
    times of the whole ring and of one hop's B1, B4, B5 and fold beside B1's
    bound and SDPA on the full N; the flagship's 50-step window with the
    sequence-parallel context on a ring of 2 against the unsharded window
    (``WINDOW_REL_TOL``, 800 ring blocks, no B2, B3); ``run(argv)`` in a
    child process with ``torchrun``'s environment of one process: a
    one-rank NCCL group, 2 flagship train steps and one validation batch;
    the window's and the run's flagship at full width, depth cut
    (``FLAGSHIP_CUT_DEPTH``).

26. (``run_slice20_paths``) Megatron tensor parallelism on the one card:
    :data:`TP_FLAGSHIP` processes sharing the H100 over a gloo group
    (:data:`TP_WORKER`; NCCL puts no two ranks on one card) run the cut
    flagship's 50-step window and 2 train steps at batch 8 with 3 of its 9
    heads a rank, K600 @DiT/XL's 2 train steps with 8 of 16 on two of
    them; each against the one-process run of the same seeds
    (``WINDOW_REL_TOL``; the losses ``GRAD_LOSS_TOL``, the gradient norms
    ``GRAD_REL_TOL``), each rank's launches equal to one process's, the
    share of the last step in gloo's all-reduces, peak memory a rank; the
    serving export (``tools/export_sampler.py``) of the cut flagship's step,
    its window run by ``--load`` in a fresh process against the in-process
    sampler (bit-equal, or its difference); the UCF-101 recipe (online DC-AE,
    64 px, batch 32, 11 loader workers) through ``run(argv)`` for 3 steps
    with and without its EDM ``AugmentPipe``, the host's wait a batch; the
    attention maps of K600 @DiT/XL (depth cut to 2) captured on the card
    against the CPU (:data:`CAPTURE_TOL`).

Steps 3, 4, 7, 10, 11, 14, 15, 16, 19, 20, 21, 22, 23, 24 and 25 also run controls (an attention that
ignores q and k; a backward whose dq is zero; a LayerNorm + modulate that skips the
normalisation; a LayerNorm backward without its row means), and step 2 holds
a faulty plain version of B1-B10 against each one's bounds (B3, B7: the
heads in reverse order; B6: dx without the norm's mean
term, table cotangents over half the (batch, head) items; B10 also: a
softmax that counts the keys that pad N = 5 or 8 to a 16-key tile); all fail
unless the bound rejects them. Any failed check
exits non-zero. The last two lines of standard output are the kernels' JSON
record and ``{"ok": true, "device": {...}}``. Details go to
``chip_smoke.json`` in ``OUT_DIR``, the seconds since the start of every
line logged to ``smoke_timeline.tsv`` beside it. Cut in depth for the
smoke's time: config 3's rollout, 200 frames (48 windows) to 40 (11 windows;
72 and 18 until PR 19);
the guided window's profile, 10 steps to 3; the remat sweep, 5 train steps
a policy to 3, and the sweep's flagship's depth (``FLAGSHIP_CUT_DEPTH``);
VAE training, 6 steps to 4, its card-vs-CPU clip to 64 x 64 pixels;
phase 25's ring window timed once each way, and its flagship's depth
(``FLAGSHIP_CUT_DEPTH``); phase 18's flagship, its depth too (since PR 20).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# (name, C source, TPU kernel it replaces)
KERNELS = (
    ("flash_fwd", "dfot_tpu_torch/csrc/flash_fwd.cu", "dfot_tpu/ops/attention.py:114"),
    ("qkv_prep", "dfot_tpu_torch/csrc/qkv_prep.cu", "dfot_tpu/ops/qkv_prep.py:115"),
    ("attn_out_collect", "dfot_tpu_torch/csrc/attn_out_collect.cu", "dfot_tpu/ops/qkv_prep.py:528"),
    ("flash_bwd_dq", "dfot_tpu_torch/csrc/flash_bwd.cu", "dfot_tpu/ops/attention.py:378"),
    ("flash_bwd_dkv", "dfot_tpu_torch/csrc/flash_bwd.cu", "dfot_tpu/ops/attention.py:500"),
    ("qkv_prep_bwd", "dfot_tpu_torch/csrc/qkv_prep_bwd.cu", "dfot_tpu/ops/qkv_prep.py:147"),
    ("attn_out_scatter", "dfot_tpu_torch/csrc/attn_out_scatter.cu", "dfot_tpu/ops/qkv_prep.py:534"),
    ("ln_modulate", "dfot_tpu_torch/csrc/ln_modulate.cu", "dfot_tpu/ops/ln_modulate.py:64"),
    ("ln_modulate_bwd", "dfot_tpu_torch/csrc/ln_modulate.cu", "dfot_tpu/ops/ln_modulate.py:72"),
    ("small_n_attn", "dfot_tpu_torch/csrc/small_n_attn.cu", "dfot_tpu/ops/attention.py:800"),
    # ring attention's per-hop block: B1 launched by ops/ring_attention.py
    # (B4, B5 in its backward); its launches are the ring's B1 launches
    ("ring_block", "dfot_tpu_torch/csrc/flash_fwd.cu", "dfot_tpu/ops/ring_attention.py:49"),
)
FORWARD_KERNELS = ("flash_fwd", "qkv_prep", "attn_out_collect")
ATTENTION_KERNELS = tuple(name for name, _, _ in KERNELS[:7])  # B1-B7
# the paths that are driven between a reset and a read of the launch counts
PATHS = ("window", "train", "xl_window", "xl_train", "factorized", "axial", "base_window",
         "base_train", "base_axial", "interp2", "rollout", "cli", "train_loop", "facmat_window",
         "facmat_train", "fullmat_window", "fullmat_train", "guided_window", "axial_precomputed",
         "latent_train", "latent_pre_sample", "k600_latent",
         *(f"{model}_remat_{policy}" for model in ("xl", "flagship")
           for policy in ("none", "dots", "attn", "dots_attn")),
         "unet3d_window", "unet3d_train", "diff_concat_window", "diff_concat_train",
         "diff_interleaved_window", "diff_interleaved_train", "diff_facmat_window",
         "diff_facmat_train", "far_window", "far_train", "dit1d_window", "dit1d_train",
         "unet3d_cli", "k600_metrics", "k600_a15c", "ring_window", "ring_cli",
         "tp_window", "tp_train", "tp_xl_train", "export", "ucf_train")
# the batch each path gives its kernels: the window runs the denoiser at
# B * NFE = 2, the train step at B = 1; the kernels line reports the forward
# kernels at the window's batch and the backward kernels at the train step's
BATCHES = (1, 2)
WINDOW_BATCH, TRAIN_BATCH = 2, 1
# the validation CLI samples CLI_BATCH videos a batch, and vanilla HG runs
# the denoiser on each twice (NFE 2), as the window does on its one video
CLI_BATCH = 2
CLI_DENOISER_BATCH = WINDOW_BATCH * CLI_BATCH
# the training loop trains at the composed recipe's batch (realestate10k_mini
# sets experiment.training.batch_size: 8); the plain attention's B x H x N x N
# fp32 scores run one batch entry at a time above PLAIN_MAX_BATCH (at B = 8,
# level 2, one such tensor is 19 GB)
TRAIN_LOOP_BATCH = 8
PLAIN_MAX_BATCH = 4
# published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12   # tensor cores, bf16
PEAK_FP32_FLOPS = 67e12    # outside the tensor cores
PEAK_BYTES = 3.35e12       # device memory, bytes/s
# flagship attention sites: (level, tokens N, heads, head dim)
SITES = ((2, 8192, 9, 64), (3, 2048, 9, 128))
# UViT3DPose at the backbone's own widths (uvit3d_pose_base): level 2 has 4
# heads of 128 over 8192 tokens, level 3 4 heads of 256 over 2048; its level
# 3 is the kernels' d = 256 site, at the window's batch and the train step's
BASE_SITE = (3, 2048, 4, 256)
# a head dim of 160, zero-padded to 256 (the true 1/sqrt(160) scale)
PADDED_SITE = (2048, 4, 160, 256)
# K600 @DiT/XL: batch of the window (before and after NFE expansion: its
# sampling is conditional, one evaluation a step) and of the train step;
# attention over N tokens of H heads of dim D, padded to DP inside B2
XL_BATCH = 8
XL_SITE = (1280, 16, 72, 128)
# the DMLab DC-AE recipe's DiT3D: batch 32, 16 latent frames of (8 / 2)^2
# patches (N = 256), 6 heads of 64, its RoPE grid (16, 4, 4)
DMLAB_BATCH = 32
DMLAB_SITE = (256, 6, 64)
# LayerNorm + modulate shapes (B, N, C): K600 @DiT/XL, Minecraft @DiT/B, and
# the spatial view (B * T, P, C) of the factorized DiT and of FacMatDiT/L at
# its batch of 32
LN_SHAPES = (("xl", (XL_BATCH, 1280, 1152)), ("dit_b", (8, 1024, 768)),
             ("factorized", (128, 16, 384)), ("facmat", (32 * 16, 16, 768)),
             ("dmlab", (DMLAB_BATCH, 256, 384)))
# small-N attention shapes (items Z = B * H, N, D): the axial U-ViT's temporal
# attention at levels 2 and 3 (B0 * tokens a frame * heads), the factorized
# DiT's temporal and spatial attention, five latent frames, the longest row,
# FacMatDiT/L's spatial attention (32 videos x 16 frames x 6 heads of 128)
SMALL_N_SHAPES = (("axial level2", (2 * 1024 * 9, 8, 64)), ("axial level3", (2 * 256 * 9, 8, 128)),
                  ("factorized", (8 * 16 * 6, 16, 64)), ("frames5", (8 * 256 * 6, 5, 64)),
                  ("rows32 d64", (768, 32, 64)), ("rows32 d128", (768, 32, 128)),
                  ("base axial level3", (2 * 256 * 4, 8, 256)), ("rows32 d256", (768, 32, 256)),
                  ("facmat spatial", (32 * 16 * 6, 16, 128)))
SMALL_N_MAIN = ("axial level2", "axial level3")
# row lengths whose keys B10 pads to a 16-key tile, where a control counts the pads
PAD_CONTROL_ROWS = (5, 8)
# B6's four fp32 table cotangents
TABLE_LABELS = ("dcos q", "dsin q", "dcos k", "dsin k")
# the fp32 instantiation where an item passes 48 KB of shared memory, and
# where it passes 96 KB (a block of its own)
SMALL_N_FP32_SHAPES = (("rows32 d128 fp32", (768, 32, 128)), ("rows32 d256 fp32", (768, 32, 256)))
# bf16 kernel route vs plain route, relative L2: about 3x the sound route's
# reading (7.5e-3, 6.6e-3) and 6-10x under the control's (0.20, 0.12),
# both at the random-weight law of dfot_tpu_torch/utils/weights.py
FORWARD_REL_TOL = 2e-2
WINDOW_REL_TOL = 2e-2
# forward + backward, kernel route vs plain route at B = 1: relative
# difference of the loss, relative L2 of each named parameter's gradient
GRAD_LOSS_TOL = 1e-3
GRAD_REL_TOL = 5e-2
# B8, B9, B10 against their plain versions, relative L2 of each output on its
# own, beside the max-abs bound: two sound bf16 results differ by one ulp
# (2^-8 to 2^-7 of the value) on a small share of the elements (read: up to
# 6.3e-5 in all); the mildest fault held against it (a variance without its
# mu^2 term, 2.2e-2; a dx without its row means, 4e-2 to 8e-2) reads 10x above
KERNEL_REL_L2_TOL = 2e-3
KERNEL_REL_L2_TOL_FP32 = 1e-5
# B1, B4 and B5 against their fp32 plain versions, relative L2 of O, dq, dk
# and dv: the kernels round P (and dS) to bf16 before the second products and
# the outputs to bf16 once, each a relative error of at most 2^-9, so a sound
# kernel reads a few 1e-3 (first readings: 1.4e-3 for O, 2.7e-3 for dk and
# dv); the faults held against it (the scale of a head twice as wide; dq or
# dk without its delta term) read 1e-1 and more
ATTN_REL_L2_TOL = 1e-2
# B2 against its plain version, relative L2 of q, k and v: the plain version
# rounds the two RoPE products and their sum to bf16, the kernel rounds once,
# so a sound kernel reads a few 1e-3 on q and k (first readings: 2.0e-3 to
# 2.7e-3; 0 on v, a copy); RoPE without its pair swap reads 0.5 and more,
# q, k without their norm 6e-2 to 9e-2 (random rows have an rms near 1)
PREP_REL_L2_TOL = 1e-2
# B6 at a tail shape: (B, N, H, d), N no multiple of any tile, H odd
PREP_TAIL_SITE = (3, 1000, 9, 64)
# B3 and B7 at token counts that are no multiple of any of their tiles:
# (B, H, N, d, dp)
COLLECT_TAIL_SITES = ((1, 3, 1000, 64, 64), (2, 3, 1000, 72, 128), (1, 3, 1000, 128, 128),
                      (2, 3, 1000, 160, 256), (1, 2, 1000, 256, 256), (3, 3, 1000, 72, 128))
# B8 and B9 at tails (shape, dtype name): token counts that are no multiple
# of a block's tokens, the other width-exact widths, a width that is no
# multiple of the 16-byte vector (pair kernel), one wider than the registers
# hold, and fp32 (the generic kernels) at the XL width
LN_TAIL_SHAPES = (((3, 7, 1152), "bf16"), ((1, 5, 384), "bf16"), ((3, 7, 896), "bf16"),
                  ((2, 3, 1024), "bf16"), ((1, 5, 2048), "bf16"), ((2, 5, 1154), "bf16"),
                  ((1, 3, 2304), "bf16"), ((3, 7, 1152), "fp32"), ((2, 5, 1154), "fp32"))
# B1, B4 and B5 at a row count that is a multiple of 64 but not of their
# 128-row blocks, causal and not: (N, head dim, padded head dim)
EDGE_SITES = ((192, 64, 64), (192, 128, 128), (192, 72, 128), (192, 256, 256), (192, 160, 256))
# UNet3D's spatial softmax attention (algorithm/backbone=u_net3d on
# ucf_101 at 64 px, its recipe's batch of 32 videos of 16 frames): heads of
# 32 padded to 64, at level 2 (16 x 16 tokens) and in the mid block (8 x 8):
# (label, B * T * heads, N, head dim, padded head dim); the kernels take the
# (B * T, heads) items as one row of B * T * heads
UNET3D_BATCH, UNET3D_FRAMES, UNET3D_HEADS = 32, 16, 4
UNET3D_SITES = (("level2", UNET3D_BATCH * UNET3D_FRAMES * UNET3D_HEADS, 256, 32, 64),
                ("mid", UNET3D_BATCH * UNET3D_FRAMES * UNET3D_HEADS, 64, 32, 64))
# @DiffDiT/B on UCF-101 latents: the training batch, T frames of P patches,
# heads of d; the video half of its merged 2T frames takes the packed route
DIFF_SITE = (32, 16, 16, 12, 64)
PROFILED_WINDOW_STEPS = 10
# the guided window's profile (a forward and a backward each step: 3900
# launches a step, whose processing took 45 s at 10 steps) and the remat
# sweep's train steps, cut for the smoke's time
GUIDED_PROFILE_STEPS = 3
TRAIN_STEPS = 5
REMAT_STEPS = 3
# the long-video tasks (BASELINE.json configs 2 and 3, bench.py's rollout):
# rollout settings, the long rollout's length, keyframe density and the plan
# it must give (keyframes, sliding windows, chunks a round), and the small
# rollout of the narrow model that holds the kernel route against the plain.
# The long rollout is config 3 cut from 200 frames (48 windows) to 40 (11
# windows; 72 and 18 until PR 19) for the smoke's time; a density of 0.25
# keeps its keyframe pass at two sliding windows, the second with generated
# context
ROLLOUT_SETTINGS = dict(external_cond_type="action", sliding_context_len=4,
                        interpolation_max_batch_size=1)
LONG_FRAMES, LONG_DENSITY, LONG_PLAN = 40, 0.25, (10, 2, [9])
SMALL_ROLLOUT_FRAMES, SMALL_ROLLOUT_DENSITY, SMALL_ROLLOUT_PLAN = 72, 0.125, (9, 2, [8, 8])
# the factorized DiT of configurations/algorithm/backbone/dit3d_factorized_attention.yaml
# on the Minecraft latent shape, and the axial U-ViT's depth (flagship widths)
FACTORIZED_BATCH = 8
AXIAL_BATCH = 2
AXIAL_DEPTH = dict(num_updown_blocks=(1, 1, 2), num_mid_blocks=4)
# the base-width U-ViT with axial blocks at level 3 (heads of 256), cut depth
BASE_AXIAL_DEPTH = dict(num_updown_blocks=(1, 1, 1), num_mid_blocks=4)
# device kernels by class for the profiled window: (class, name substrings),
# first match wins; anything else is eager elementwise work and copies
KERNEL_CLASSES = (
    ("B1 flash_fwd", ("flash_fwd_kernel",)),
    ("B2 qkv_prep", ("qkv_prep_kernel",)),
    ("B3 attn_out_collect", ("attn_out_collect_kernel",)),
    ("B4 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("B5 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("B6 qkv_prep_bwd", ("qkv_prep_bwd_kernel",)),
    ("B7 attn_out_scatter", ("attn_out_scatter_kernel",)),
    ("B8 ln_modulate", ("ln_modulate_fwd",)),
    ("B9 ln_modulate_bwd", ("ln_modulate_bwd",)),
    ("B10 small_n_attn", ("small_n_attn_kernel",)),
    ("optimizer, clipping, EMA (foreach)", ("multi_tensor_apply",)),
    ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN backward convolutions", ("dgrad", "wgrad", "bwd_data", "bwd_filter", "backward_data",
                                     "backward_filter")),
    ("cuDNN convolutions", ("fprop", "implicit_gemm", "convolve", "winograd")),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "cutlass")),
    ("GroupNorm (statistics, apply, backward)",
     ("RowwiseMoments", "GroupNorm", "group_norm", "ComputeInternalGradients",
      "ComputeBackwardFusedParams", "GammaBetaBackward")),
    ("avg-pool, nearest upsample", ("avg_pool", "upsample")),
)


class SmokeFailure(RuntimeError):
    pass


# (seconds since the first line, the line's start) of every line logged:
# main() writes them to OUT_DIR / "smoke_timeline.tsv", where the seconds
# of each part of a phase can be read
TIMELINE = []


def log(msg: str) -> None:
    if not TIMELINE:
        TIMELINE.append((time.perf_counter(), ""))
    TIMELINE.append((time.perf_counter(), msg[:120].replace("\n", " ")))
    print(msg, flush=True)


def write_timeline() -> None:
    t0 = TIMELINE[0][0] if TIMELINE else 0.0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "smoke_timeline.tsv").write_text(
        "".join(f"{t - t0:.1f}\t{msg}\n" for t, msg in TIMELINE[1:]))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


@functools.lru_cache(maxsize=None)
def _hold_operands():
    """Operands of the holding product and the time one product takes."""
    import torch

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(a)
    return a, out, _event_ms(lambda: torch.mm(a, a, out=out), 5)


def hold_device(ms: float = 10.0) -> None:
    """Queue about ``ms`` of matrix products, so that what the host queues
    next waits on the device and runs there back to back."""
    import torch

    a, out, each = _hold_operands()
    for _ in range(max(1, round(ms / each))):
        torch.mm(a, a, out=out)


def _event_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls. The calls are queued behind :func:`hold_device`, so a short
    kernel's time is the device's and not the rate at which the host (Python
    and ctypes) can launch it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    hold_device()
    return _event_ms(fn, reps)


@functools.lru_cache(maxsize=None)
def _flush_buffer():
    """256 MB to write between launches: five times the H100's 50 MB L2."""
    import torch

    return torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")


def cold_ms(fn, reps: int = 10) -> float:
    """Median device time of one call of ``fn`` in ms with a cold L2: before
    each call 256 MB are written, so its operands come from device memory,
    as a caller between other layers finds them; CUDA events around the call
    alone, queued behind :func:`hold_device`."""
    import torch

    fn()
    torch.cuda.synchronize()
    buf, times = _flush_buffer(), []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        hold_device(2.0)
        buf.fill_(1.0)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def after_ms(producer, consumer, reps: int = 10) -> float:
    """Median device time in ms of ``consumer(producer())``'s second half:
    CUDA events around the consumer alone, the first recorded as the
    producer ends, so the consumer finds the producer's output where the
    producer left it (in L2 where it fits), as on the model's path."""
    import torch

    consumer(producer())
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        hold_device(2.0)
        out = producer()
        start.record()
        consumer(out)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def host_us(fn, reps: int = 50) -> float:
    """Host time of one call of ``fn`` in microseconds: what the wrapper
    costs the host to enqueue its kernel (checks, tile plan, tensor maps,
    launch). The calls are queued behind :func:`hold_device`, so none waits
    on the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    hold_device(50.0)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate and its operations over the peak rate of their
    type."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def ref_tol(rel: float, *refs) -> float:
    """``rel`` times the references' largest magnitude, at least ``rel``."""
    return rel * max(1.0, max(float(r.float().abs().max()) for r in refs))


def readings(pairs, rel: float) -> list:
    """(label, max abs error, its bound, relative L2) for each (label, got,
    want): every tensor against the magnitude of its own reference."""
    return [(label, max_err(g, w), ref_tol(rel, w), rel_l2(g, w)) for label, g, w in pairs]


def ln_modulate_uncentred_variance(x, shift, scale, eps: float = 1e-6):
    """Control for B8: the variance is E[x^2], without the - mu^2."""
    import torch

    xf = x.float()
    yn = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return yn.to(x.dtype) * (1 + scale) + shift


def ln_backward_without_means(x, scale, g, eps: float = 1e-6, plain: bool = False):
    """Control for B9: dx without the two row means of the LayerNorm backward
    (the projections that keep dx orthogonal to 1 and to yn); dscale is sound."""
    from dfot_tpu_torch.ops import ln_modulate as L

    yn, rstd = L._normalized(x, eps)
    return (rstd * (g * (1 + scale)).float()).to(x.dtype), g * yn.to(x.dtype)


def attention_scaled_for_twice_the_width(q, k, v, causal: bool = False):
    """Control for B1 and B10: scores scaled by 1/sqrt(2 D), the scale of a
    head twice as wide (what a padded head dim would give). ``causal`` keeps
    the mask, so that only the scale is at fault."""
    import torch

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(2 * q.shape[-1])
    if causal:
        n = s.shape[-1]
        above = torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return torch.matmul(torch.softmax(s, -1), v.float()).to(q.dtype)


def attention_counting_pad_keys(q, k, v):
    """Control for B10: the softmax also counts the keys that pad the row to
    a 16-key tile, as keys of score 0 (and weight them by nothing): the fault
    a tensor-core kernel risks where it pads N = 5 or 8 keys."""
    import torch

    n = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = torch.cat([s, s.new_zeros(*s.shape[:-1], 16 - n)], -1)
    p = torch.softmax(s, -1)[..., :n]
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def prep_bwd_without_norm_mean(qkv, tabs, dq, dk, heads: int, head_dim: int, eps: float = 1e-6):
    """Control for B6: the q and k columns of dqkv with dx = r du, without
    the norm's - x r^3 mean(du x) term."""
    import torch
    from dfot_tpu_torch.ops import qkv_prep as Q

    B, N, _ = qkv.shape
    x = qkv.reshape(B, N, 3, heads, head_dim)
    out = []
    for i, dy in enumerate((dq, dk)):
        dy = dy[..., :head_dim].transpose(1, 2).float()
        c, s = (t.float()[None, :, None, :] for t in tabs[i])
        du = dy * c + Q.swap_pairs(dy * s)
        xf = x[:, :, i].float()
        out.append((torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * du).to(qkv.dtype))
    return torch.stack(out, dim=2).reshape(B, N, 2 * heads * head_dim)


def attention_ops(B: int, H: int, N: int, D: int, causal: bool = False) -> int:
    """Operations of attention's forward over B * H heads, two (N x N x D)
    products at 2 operations a multiply-add, at the true head dim D: the
    lanes a padded head adds are no work of the function. The backward's dq
    recomputes S and takes two more products (1.5 times this), its dk and dv
    three more (2 times). Causal counts the N (N + 1) / 2 pairs at or below
    the diagonal."""
    pairs = N * (N + 1) // 2 if causal else N * N
    return 4 * B * H * pairs * D


def per_entry(fn):
    """``fn`` (a plain attention formula or a control) on one batch entry at
    a time where the batch passes ``PLAIN_MAX_BATCH``, the results
    concatenated; every tensor argument of more than two dims is batch first."""
    import torch

    def run(*args, **kw):
        B = args[0].shape[0]
        if B <= PLAIN_MAX_BATCH:
            return fn(*args, **kw)
        outs = [fn(*(a[i:i + 1] if isinstance(a, torch.Tensor) and a.dim() > 2 else a
                     for a in args), **kw) for i in range(B)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    return run


def dkv_without_delta(q, k, v, do, lse, delta, causal, scale):
    """Control for B5: dk from dS = P dP, without the delta term."""
    import torch
    from dfot_tpu_torch.ops import attention as A

    return A._dkv_plain(q, k, v, do, lse, torch.zeros_like(delta), causal, scale)[0]


def dq_without_delta(q, k, v, do, lse, delta, causal, scale):
    """Control for B4: dq from dS = P dP, without the delta term."""
    import torch
    from dfot_tpu_torch.ops import attention as A

    return A._dq_plain(q, k, v, do, lse, torch.zeros_like(delta), causal, scale)


def prep_controls(qkv, tabs, heads, head_dim, d_out, norm, eps: float = 1e-6) -> dict:
    """Controls for B2, by label: q and k (v is a copy) of its plain version
    with RoPE's pair swap left out, and, where the norm is on, without it."""
    from dfot_tpu_torch.ops import qkv_prep as Q

    with patched(Q, "swap_pairs", lambda x, dim=-1: x):
        no_swap = Q._prep_plain(qkv, tabs, heads, head_dim, d_out, norm, eps)[:2]
    out = {"RoPE without the pair swap": no_swap}
    if norm:
        out["q, k without the norm"] = Q._prep_plain(qkv, tabs, heads, head_dim, d_out, False,
                                                     eps)[:2]
    return out


def check_kernels(record: dict) -> dict:
    """Each kernel against its plain version at the shapes the paths give it:
    B1-B7 at the flagship's two attention sites (the train step's batch and
    the window's) and at K600 @DiT/XL's (heads of 72 padded to 128, the true
    scale and head dim); B1 and B5 also at :data:`EDGE_SITES`; B8, B9 at the
    XL, DiT/B and factorized widths; B10 at the axial and factorized shapes
    and at N = 5 and 32. A site is ``main`` where the kernels line reports
    its times. Every output tensor is held on its own (:func:`readings`); B1,
    B2, B4, B5, B8, B9 and B10 also by relative L2, and their bounds must
    reject a faulty plain version of each; the pad lanes of B1, B2, B4 and B5
    must be zeros."""
    import torch
    import torch.nn.functional as F
    from dfot_tpu_torch.models.embeddings import make_rope_3d
    from dfot_tpu_torch.ops import attention as A, ln_modulate as L, qkv_prep as Q

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    results = {name: {"by_site": {}} for name, _, _ in KERNELS}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        results[name]["edge_sites"] = {}

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(bf16)

    def note(name, site, main, err, tol, kernel, plain_ms, bnd, library_ms=None, **extra):
        """Record a site: ``kernel`` (the wrapper's call) is timed warm
        (:func:`cuda_ms`) and with a cold L2 (:func:`cold_ms`)."""
        ms, cold = cuda_ms(kernel), cold_ms(kernel)
        results[name]["by_site"][site] = {
            "main": main, "max_abs_err": err, "tol": tol, "ms": ms, "cold_ms": cold,
            "plain_ms": plain_ms, "library_ms": library_ms, **bnd, **extra,
        }
        more = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        if "host_us" in extra:
            more += f"  host {extra['host_us']:.1f} us a call"
        if "copy_ms" in extra:
            more += f"  contiguous copy {extra['copy_ms']:.4f} (cold {extra['copy_cold_ms']:.4f})"
        log(f"  {name:17s} {site}: max_abs_err {err:.3e} (tol {tol:.3e})  kernel {ms:.4f} ms "
            f"(cold {cold:.4f})  plain {plain_ms:.4f} ms  bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}){more}")
        require(err <= tol, f"{name} at {site}: error {err} above {tol}")

    def hold(name, site, pairs, rel, l2_tol=None):
        """Every tensor within its own bounds; returns what :func:`note` takes
        of the tensor closest to its max-abs bound."""
        rows = readings(pairs, rel)
        for label, e, t, l2 in rows:
            require(e <= t, f"{name} at {site}: {label} off by {e} (tol {t})")
            require(l2_tol is None or l2 <= l2_tol,
                    f"{name} at {site}: {label} relative L2 {l2} above {l2_tol}")
        _, err, tol, _ = max(rows, key=lambda r: r[1] / r[2])
        extra = {} if l2_tol is None else {
            "rel_l2": {label: l2 for label, _, _, l2 in rows}, "rel_l2_tol": l2_tol}
        return err, tol, extra

    def rejected(name, site, fault, pairs, rel, l2_tol):
        """The bounds of :func:`hold` must fail the faulty result in ``pairs``."""
        rows = readings(pairs, rel)
        log(f"  {name:17s} {site}: control '{fault}': " + ", ".join(
            f"{label} max_abs_err {e:.3e} (tol {t:.3e}) rel L2 {l2:.3e} (tol {l2_tol})"
            for label, e, t, l2 in rows))
        require(any(e > t or l2 > l2_tol for _, e, t, l2 in rows),
                f"{name} at {site}: the bounds pass the control '{fault}'")
        return {fault: {label: {"max_abs_err": e, "tol": t, "rel_l2": l2}
                        for label, e, t, l2 in rows}}

    def prep_bwd_check(site, qkv, tabs, dys, H, D, norm):
        """B6 twice on the same operands, which must give the same bits (the
        table cotangents are summed in a fixed order), and against its plain
        version: dqkv within 2e-2 and each fp32 table cotangent within 5e-3
        of its reference's magnitude, all within PREP_REL_L2_TOL relative L2.
        Returns the result, the reference, dqkv's and the tables' readings."""
        got, again = (Q.qkv_prep_bwd(qkv, tabs, *dys, H, D, norm) for _ in range(2))
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"qkv_prep_bwd at {site}: two calls on the same operands differ")
        want = Q.qkv_prep_bwd(qkv, tabs, *dys, H, D, norm, plain=True)
        require(all(g.dtype == torch.float32 for g in got[1:]),
                "qkv_prep_bwd: table cotangents are not fp32")
        err, tol, extra = hold("qkv_prep_bwd", site, [("dqkv", got[0], want[0])], 2e-2,
                               PREP_REL_L2_TOL)
        err_t, tol_t, extra_t = hold("qkv_prep_bwd", site, zip(TABLE_LABELS, got[1:], want[1:]),
                                     5e-3, PREP_REL_L2_TOL)
        extra["rel_l2"].update(extra_t["rel_l2"])
        log(f"  qkv_prep_bwd tabs  {site}: max_abs_err {err_t:.3e} (tol {tol_t:.3e}); rel L2 "
            + ", ".join(f"{k} {v:.2e}" for k, v in extra["rel_l2"].items())
            + f" (tol {PREP_REL_L2_TOL}); two calls bit-identical")
        return got, want, err, tol, dict(extra, table_err=err_t, table_tol=tol_t)

    def flash_forward_check(site, B, H, N, D, DP, causal=False):
        """B1 on seeded peaked heads of D lanes zero-padded to DP: O within
        its max-abs and relative-L2 bounds, the LSE within 1e-3, the pad
        lanes zeros, and the bounds rejecting the scale of a head twice as
        wide. Returns the operands, O, the LSE and what :func:`note` takes."""
        scale = 1.0 / math.sqrt(D)
        q, k, v = (F.pad(t, (0, DP - D)) for t in
                   (rand(B, H, N, D, scale=1.7), rand(B, H, N, D, scale=1.7), rand(B, H, N, D)))
        o, lse = A.flash_attention(q, k, v, causal, scale, return_lse=True, head_dim=D)
        torch.cuda.synchronize()
        o_ref, lse_ref = per_entry(A.attention_reference)(q, k, v, causal, scale,
                                                          return_lse=True)
        err_l = max_err(lse, lse_ref)
        log(f"  flash_fwd lse     {site}: max_abs_err {err_l:.3e} (tol 1.000e-03)")
        require(err_l <= 1e-3, f"flash_fwd lse at {site}: error {err_l} above 1e-3")
        require(not bool(o[..., D:].any()), f"flash_fwd at {site}: pad lanes not zero")
        err, tol, extra = hold("flash_fwd", site, [("o", o, o_ref)], 1e-2, ATTN_REL_L2_TOL)
        wide = per_entry(attention_scaled_for_twice_the_width)(*(t[..., :D] for t in (q, k, v)),
                                                               causal)
        extra["controls"] = rejected("flash_fwd", site, "the scale of a head twice as wide",
                                     [("o", F.pad(wide, (0, DP - D)), o_ref)], 1e-2,
                                     ATTN_REL_L2_TOL)
        extra["lse_err"] = err_l
        return q, k, v, o, lse, err, tol, extra

    def flash_dkv_check(site, q, k, v, do, lse, delta, D, causal):
        """B5 (true head dim D) against its plain version on the same LSE and
        delta: dk and dv within their max-abs and relative-L2 bounds, the pad
        lanes zeros, and the bounds rejecting dk without its delta term."""
        scale = 1.0 / math.sqrt(D)
        dk, dv = A.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, head_dim=D)
        torch.cuda.synchronize()
        dk_ref, dv_ref = per_entry(A._dkv_plain)(q, k, v, do, lse, delta, causal, scale)
        require(not bool(dk[..., D:].any() or dv[..., D:].any()),
                f"flash_bwd_dkv at {site}: pad lanes not zero")
        err, tol, extra = hold("flash_bwd_dkv", site, (("dk", dk, dk_ref), ("dv", dv, dv_ref)),
                               2e-2, ATTN_REL_L2_TOL)
        extra["controls"] = rejected(
            "flash_bwd_dkv", site, "dk without the delta term",
            [("dk", per_entry(dkv_without_delta)(q, k, v, do, lse, delta, causal, scale), dk_ref)],
            2e-2,
            ATTN_REL_L2_TOL)
        return err, tol, extra

    def flash_dq_check(site, q, k, v, do, lse, delta, D, causal):
        """B4 (true head dim D) against its plain version on the same LSE and
        delta: dq within its max-abs and relative-L2 bounds, the pad lanes
        zeros, and the bounds rejecting dq without its delta term."""
        scale = 1.0 / math.sqrt(D)
        dq = A.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, head_dim=D)
        torch.cuda.synchronize()
        dq_ref = per_entry(A._dq_plain)(q, k, v, do, lse, delta, causal, scale)
        require(not bool(dq[..., D:].any()), f"flash_bwd_dq at {site}: pad lanes not zero")
        err, tol, extra = hold("flash_bwd_dq", site, [("dq", dq, dq_ref)], 2e-2, ATTN_REL_L2_TOL)
        extra["controls"] = rejected(
            "flash_bwd_dq", site, "dq without the delta term",
            [("dq", per_entry(dq_without_delta)(q, k, v, do, lse, delta, causal, scale), dq_ref)],
            2e-2,
            ATTN_REL_L2_TOL)
        return err, tol, extra

    def contiguous_copy(elems):
        """The device's own contiguous copy of ``elems`` bf16 values (the
        same bytes a copy kernel moves: read once, written once), warm and
        cold: what no kernel of a pure data movement can beat."""
        src = torch.empty(elems, dtype=bf16, device="cuda")
        dst = torch.empty_like(src)
        copy = lambda: dst.copy_(src)  # noqa: E731
        return {"copy_ms": cuda_ms(copy), "copy_cold_ms": cold_ms(copy)}

    def collect_check(site, o, D):
        """B3 against its plain version, bit for bit, and the exact check
        rejecting a collect that takes the heads in the wrong order (the
        last first). Returns B3's output."""
        got = Q.attn_out_collect(o, D)
        torch.cuda.synchronize()
        want = Q.reference_attn_out_collect(o, D)
        require(torch.equal(got, want), f"attn_out_collect at {site}: not an exact copy "
                f"(max_abs_err {max_err(got, want):.3e})")
        require(not torch.equal(Q.reference_attn_out_collect(o.flip(1), D), want),
                f"attn_out_collect at {site}: the exact check passes the heads in reverse order")
        return got

    def scatter_check(site, g, H, D, DP):
        """B7 twice on the same operands, which must give the same bits, and
        against its plain version bit for bit; the exact check must reject a
        scatter that takes the heads in the wrong order (the last first).
        Returns B7's output."""
        got, again = (Q.attn_out_scatter(g, H, D, DP) for _ in range(2))
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"attn_out_scatter at {site}: two calls differ")
        want = Q.reference_attn_out_scatter(g, H, D, DP)
        require(torch.equal(got, want), f"attn_out_scatter at {site}: not an exact copy "
                f"(max_abs_err {max_err(got, want):.3e})")
        B, N, _ = g.shape
        reversed_heads = g.reshape(B, N, H, D).flip(2).reshape(B, N, H * D)
        require(not torch.equal(Q.reference_attn_out_scatter(reversed_heads, H, D, DP), want),
                f"attn_out_scatter at {site}: the exact check passes the heads in reverse order")
        return got

    def ln_bwd_check(site, x, scale, g, rel, l2_tol):
        """B9 twice on the same operands, which must give the same bits, and
        dx and dscale each within their own bounds of the plain version (a
        shared bound would pass a wrong dx: dscale's values are several times
        dx's), which must reject dx without the row means."""
        (dx, dscale), again = (L.ln_modulate_bwd(x, scale, g) for _ in range(2))
        torch.cuda.synchronize()
        require(torch.equal(dx, again[0]) and torch.equal(dscale, again[1]),
                f"ln_modulate_bwd at {site}: two calls differ")
        dx_ref, dscale_ref = L.reference_ln_modulate_bwd(x, scale, g)
        err, tol, extra = hold("ln_modulate_bwd", site,
                               (("dx", dx, dx_ref), ("dscale", dscale, dscale_ref)), rel, l2_tol)
        extra["controls"] = rejected(
            "ln_modulate_bwd", site, "dx without the row means",
            [("dx", ln_backward_without_means(x, scale, g)[0], dx_ref)], rel, l2_tol)
        return err, tol, extra

    def attention_site(site, B, N, H, D, DP, rope_sizes, norm, fused_width, main,
                       in_path=False, backward=True):
        """B2, B6, B1, B4, B5, B3, B7 at one attention site (B2, B1 and B3
        alone where not ``backward``). ``main``: which kernels (forward,
        backward) report this site in the kernels line; ``in_path``: also
        time B3 on B1's output as it has just been written."""
        C = H * D
        is_main = lambda name: main[0] if name in FORWARD_KERNELS else main[1]
        # B2: packed qkv as the model passes it (for the U-ViT a strided slice
        # of the fused qkv+mlp projection), tables and norm scales as in the model
        fused = rand(B, N, fused_width * C)
        qkv = fused[..., : 3 * C]
        rope = make_rope_3d(D, rope_sizes)
        cos = torch.as_tensor(rope.cos, device="cuda")
        sin = torch.as_tensor(Q.signed_sin(rope.sin), device="cuda")
        scales = [(1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf16)
                  for _ in range(2)] if norm else [None, None]
        kw = dict(q_scale=scales[0], k_scale=scales[1], norm=norm, d_out=DP)
        got = Q.qkv_prep(qkv, H, D, cos, sin, **kw)
        torch.cuda.synchronize()
        want = Q.reference_qkv_prep(qkv, H, D, cos, sin, **kw)
        err, tol, extra = hold("qkv_prep", site, zip("qkv", got, want), 2e-2, PREP_REL_L2_TOL)
        require(all(not bool(g[..., D:].any()) for g in got), f"qkv_prep at {site}: pad lanes not zero")
        # times of the kernel and of its plain version alone, on tables
        # already folded (the fold is the same small torch ops on both routes)
        tabs = Q.fold_qk_tables(cos, sin, *scales, dtype=bf16)
        extra["controls"] = {}
        for fault, faulty in prep_controls(qkv, tabs, H, D, DP, norm).items():
            extra["controls"].update(rejected("qkv_prep", site, fault, zip("qk", faulty, want),
                                              2e-2, PREP_REL_L2_TOL))
        flat_tabs = [t for pair in tabs for t in pair]
        packed_bytes = B * N * 3 * C * 2
        note("qkv_prep", site, is_main("qkv_prep"), err, tol,
             lambda: Q._prep_cuda(qkv, tabs, H, D, DP, norm, 1e-6),
             cuda_ms(lambda: Q._prep_plain(qkv, tabs, H, D, DP, norm, 1e-6)),
             # per q/k element: square + sum, scale, two multiply-adds
             bound(7 * B * N * 2 * C, packed_bytes + nbytes(*flat_tabs, *got), PEAK_FP32_FLOPS),
             host_us=host_us(lambda: Q._prep_cuda(qkv, tabs, H, D, DP, norm, 1e-6)), **extra)

        if backward:
            # B6: the cotangents of q, k, v back to the packed layout
            dys = [rand(B, H, N, DP) for _ in range(3)]
            got, want, err, tol, extra = prep_bwd_check(site, qkv, tabs, dys, H, D, norm)
            extra["controls"] = {}
            if norm:
                extra["controls"].update(rejected(
                    "qkv_prep_bwd", site, "dx without the norm's r^3 mean(du x) term",
                    [("dq, dk", prep_bwd_without_norm_mean(qkv, tabs, dys[0], dys[1], H, D),
                      want[0][..., :2 * C])], 2e-2, PREP_REL_L2_TOL))
            half = [g.clone() for g in dys]
            for g in half:
                g.view(B * H, N, DP)[1::2] = 0  # the odd (batch, head) items left out
            extra["controls"].update(rejected(
                "qkv_prep_bwd", site, "table cotangents over half the (batch, head) items",
                list(zip(TABLE_LABELS, Q.qkv_prep_bwd(qkv, tabs, *half, H, D, norm, plain=True)[1:],
                         want[1:])), 5e-3, PREP_REL_L2_TOL))
            bwd = lambda: Q.qkv_prep_bwd(qkv, tabs, *dys, H, D, norm)  # noqa: E731
            note("qkv_prep_bwd", site, is_main("qkv_prep_bwd"), err, tol, bwd,
                 cuda_ms(lambda: Q.qkv_prep_bwd(qkv, tabs, *dys, H, D, norm, plain=True)),
                 # per q/k element: the forward's norm again, the rotation back,
                 # the norm's backward and two table products; the bytes the
                 # function needs: the q and k columns of the packed qkv, the
                 # tables, the d true lanes of the three cotangents, dqkv and the
                 # four fp32 table cotangents
                 bound(20 * B * N * 2 * C,
                       2 * B * N * C * 2 + nbytes(*flat_tabs) + 3 * B * H * N * D * 2
                       + nbytes(*got), PEAK_FP32_FLOPS),
                 host_us=host_us(bwd), **extra)
            del dys, half
        del fused, qkv, got, want

        # B1: peaked attention (score std ~3) so outputs are O(1); heads that
        # B2 pads have zero lanes D..DP, the scale and head dim of the true D
        scale = 1.0 / math.sqrt(D)
        q, k, v, o, lse, err, tol, extra = flash_forward_check(site, B, H, N, D, DP)
        # the yardstick: PyTorch's fused attention on unpadded heads
        qd, kd, vd = (t[..., :D].contiguous() for t in (q, k, v))
        ops = attention_ops(B, H, N, D)
        fwd = lambda: A.flash_attention(q, k, v, sm_scale=scale, head_dim=D)  # noqa: E731
        note("flash_fwd", site, is_main("flash_fwd"), err, tol, fwd,
             cuda_ms(lambda: per_entry(A.attention_reference)(q, k, v, sm_scale=scale), reps=3,
                     warmup=1),
             bound(ops, nbytes(q, k, v, o, lse), PEAK_BF16_FLOPS),
             cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, scale=scale)),
             host_us=host_us(fwd), **extra)

        if backward:
            # B4, B5 on the forward's saved results; the plain versions are
            # the explicit fp32 formulas on the same O and LSE
            do = F.pad(rand(B, H, N, D), (0, DP - D))
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            err_dq, tol_dq, extra_dq = flash_dq_check(site, q, k, v, do, lse, delta, D, False)
            err_dkv, tol_dkv, extra_dkv = flash_dkv_check(site, q, k, v, do, lse, delta, D, False)
            # the yardstick: the backward of PyTorch's fused attention on
            # unpadded heads, one call that gives dq, dk and dv (what B4 and B5
            # give together)
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (qd, kd, vd))
            ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            dod = do[..., :D].contiguous()
            sdpa_bwd = cuda_ms(
                lambda: torch.autograd.grad(ol, (ql, kl, vl), dod, retain_graph=True))
            del ol, ql, kl, vl, qd, kd, vd, dod
            # host_us: what the checks, the tile plan, the four tensor maps and
            # the launch cost the host a call (B1 encodes three maps)
            bwd_dq = lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, sm_scale=scale,  # noqa: E731
                                            head_dim=D)
            note("flash_bwd_dq", site, is_main("flash_bwd_dq"), err_dq, tol_dq, bwd_dq,
                 cuda_ms(lambda: per_entry(A._dq_plain)(q, k, v, do, lse, delta, False, scale),
                         reps=3, warmup=1),
                 bound(3 * ops // 2, nbytes(q, k, v, do, lse, delta) + nbytes(q), PEAK_BF16_FLOPS),
                 sdpa_bwd, library_covers="dq, dk and dv", host_us=host_us(bwd_dq), **extra_dq)
            bwd_dkv = lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, sm_scale=scale,  # noqa: E731
                                              head_dim=D)
            note("flash_bwd_dkv", site, is_main("flash_bwd_dkv"), err_dkv, tol_dkv, bwd_dkv,
                 cuda_ms(lambda: per_entry(A._dkv_plain)(q, k, v, do, lse, delta, False, scale),
                         reps=3, warmup=1),
                 bound(2 * ops, nbytes(q, k, v, do, lse, delta) + 2 * nbytes(k), PEAK_BF16_FLOPS),
                 sdpa_bwd, library_covers="dq, dk and dv", host_us=host_us(bwd_dkv), **extra_dkv)

        # B3 and B7: exact copies; PyTorch's strided copy is both the
        # plain version and the one library call. B3's bound counts the bytes
        # the function needs: the D true lanes of every head row and the output
        got = collect_check(site, o, D)
        plain = cuda_ms(lambda: Q.reference_attn_out_collect(o, D).contiguous())
        collect = lambda: Q.attn_out_collect(o, D)  # noqa: E731
        extra = {}
        if in_path:
            # in the window B3 reads what B1 has just written
            extra["in_path_ms"] = after_ms(fwd, lambda out: Q.attn_out_collect(out, D))
            log(f"  attn_out_collect  {site}: in path (right after B1, on its output) "
                f"{extra['in_path_ms']:.4f} ms")
        note("attn_out_collect", site, is_main("attn_out_collect"), 0.0, 0.0, collect, plain,
             bound(0, B * H * N * D * o.element_size() + nbytes(got), PEAK_FP32_FLOPS), plain,
             host_us=host_us(collect), **extra, **contiguous_copy(got.numel()))
        if backward:
            # B7: its bound and the device's copy count the D lanes it reads and
            # the DP lanes (pad lanes included) it writes
            g = rand(B, N, C)
            got = scatter_check(site, g, H, D, DP)
            plain = cuda_ms(lambda: Q.reference_attn_out_scatter(g, H, D, DP))
            scatter = lambda: Q.attn_out_scatter(g, H, D, DP)  # noqa: E731
            note("attn_out_scatter", site, is_main("attn_out_scatter"), 0.0, 0.0, scatter, plain,
                 bound(0, nbytes(g, got), PEAK_FP32_FLOPS), plain, host_us=host_us(scatter),
                 **contiguous_copy((g.numel() + got.numel()) // 2))

    def unet3d_site(site, BH, N, D, DP, causal):
        """B1, B4 and B5 at one UNet3D site (the items as heads of one batch
        entry): the checks and controls of the edge sites, each kernel timed
        warm and cold beside its plain version, its bound on the true lanes'
        bytes and PyTorch's fused attention on the unpadded heads."""
        scale = 1.0 / math.sqrt(D)
        q, k, v, o, lse, err, tol, extra = flash_forward_check(site, 1, BH, N, D, DP, causal)
        qd, kd, vd = (t[..., :D].contiguous() for t in (q, k, v))
        ops = attention_ops(1, BH, N, D, causal)
        lane = BH * N * D * 2  # one (items, N, D) bf16 tensor of true lanes
        fwd = lambda: A.flash_attention(q, k, v, causal, scale, head_dim=D)  # noqa: E731
        note("flash_fwd", site, False, err, tol, fwd,
             cuda_ms(lambda: A.attention_reference(q, k, v, causal, scale), reps=3, warmup=1),
             bound(ops, 4 * lane + nbytes(lse), PEAK_BF16_FLOPS),
             cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, is_causal=causal,
                                                            scale=scale)),
             padded_bytes=nbytes(q, k, v, o, lse), host_us=host_us(fwd), **extra)
        do = F.pad(rand(1, BH, N, D), (0, DP - D))
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        err_dq, tol_dq, extra_dq = flash_dq_check(site, q, k, v, do, lse, delta, D, causal)
        err_dkv, tol_dkv, extra_dkv = flash_dkv_check(site, q, k, v, do, lse, delta, D, causal)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (qd, kd, vd))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, scale=scale)
        dod = do[..., :D].contiguous()
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), dod, retain_graph=True))
        del ol, ql, kl, vl, qd, kd, vd, dod
        stats = nbytes(lse, delta)
        bwd_dq = lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale,  # noqa: E731
                                        head_dim=D)
        note("flash_bwd_dq", site, False, err_dq, tol_dq, bwd_dq,
             cuda_ms(lambda: A._dq_plain(q, k, v, do, lse, delta, causal, scale), reps=3,
                     warmup=1),
             bound(3 * ops // 2, 5 * lane + stats, PEAK_BF16_FLOPS), sdpa_bwd,
             library_covers="dq, dk and dv", padded_bytes=nbytes(q, k, v, do, lse, delta, q),
             host_us=host_us(bwd_dq), **extra_dq)
        bwd_dkv = lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale,  # noqa: E731
                                          head_dim=D)
        note("flash_bwd_dkv", site, False, err_dkv, tol_dkv, bwd_dkv,
             cuda_ms(lambda: A._dkv_plain(q, k, v, do, lse, delta, causal, scale), reps=3,
                     warmup=1),
             bound(2 * ops, 6 * lane + stats, PEAK_BF16_FLOPS), sdpa_bwd,
             library_covers="dq, dk and dv", padded_bytes=nbytes(q, k, v, do, lse, delta, k, v),
             host_us=host_us(bwd_dkv), **extra_dkv)

    for B in BATCHES:
        for level, N, H, D in SITES:
            side = int(math.isqrt(N // 8))
            attention_site(f"level{level} B={B} N={N} H={H} d={D}", B, N, H, D, D, (8, side, side),
                           True, 7, (B == WINDOW_BATCH, B == TRAIN_BATCH),
                           in_path=(level, B) == (2, WINDOW_BATCH))
    # the validation CLI's denoiser batch: the forward kernels only
    for level, N, H, D in SITES:
        side = int(math.isqrt(N // 8))
        attention_site(f"cli level{level} B={CLI_DENOISER_BATCH} N={N} H={H} d={D}",
                       CLI_DENOISER_BATCH, N, H, D, D, (8, side, side), True, 7, (False, False),
                       backward=False)
    # the training loop's batch: every attention kernel at both flagship sites
    for level, N, H, D in SITES:
        side = int(math.isqrt(N // 8))
        attention_site(f"train_loop level{level} B={TRAIN_LOOP_BATCH} N={N} H={H} d={D}",
                       TRAIN_LOOP_BATCH, N, H, D, D, (8, side, side), True, 7, (False, False))
    N, H, D, DP = XL_SITE
    attention_site(f"xl B={XL_BATCH} N={N} H={H} d={D}->{DP}", XL_BATCH, N, H, D, DP, (5, 16, 16),
                   False, 3, (False, False), in_path=True)
    # the DMLab latent recipe's train step (B1-B7 at its batch of 32)
    N, H, D = DMLAB_SITE
    attention_site(f"dmlab B={DMLAB_BATCH} N={N} H={H} d={D}", DMLAB_BATCH, N, H, D, D,
                   (16, 4, 4), False, 3, (False, False))
    # d = 256: the base-width U-ViT's level 3 at the window's batch and the
    # train step's, and a head of 160 padded to 256 (listed under other sites)
    level, N, H, D = BASE_SITE
    for B in BATCHES:
        attention_site(f"base level{level} B={B} N={N} H={H} d={D}", B, N, H, D, D, (8, 16, 16),
                       True, 7, (False, False))
    N, H, D, DP = PADDED_SITE
    attention_site(f"padded B={TRAIN_BATCH} N={N} H={H} d={D}->{DP}", TRAIN_BATCH, N, H, D, DP,
                   (8, 16, 16), True, 7, (False, False))

    # B1, B4 and B5 where the last 128-row block is half past N, causal and
    # not (no timing: these shapes are on no path)
    for N, D, DP in EDGE_SITES:
        for causal in (False, True):
            site = f"edge B=1 H=2 N={N} d={D}->{DP} causal={causal}"
            q, k, v, o, lse, err, tol, extra = flash_forward_check(site, 1, 2, N, D, DP, causal)
            results["flash_fwd"]["edge_sites"][site] = {"max_abs_err": err, "tol": tol, **extra}
            do = F.pad(rand(1, 2, N, D), (0, DP - D))
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            for name, check in (("flash_bwd_dq", flash_dq_check),
                                ("flash_bwd_dkv", flash_dkv_check)):
                err, tol, extra = check(site, q, k, v, do, lse, delta, D, causal)
                results[name]["edge_sites"][site] = {"max_abs_err": err, "tol": tol, **extra}
            log(f"  flash_fwd, flash_bwd_dq, flash_bwd_dkv {site}: within bounds, controls "
                f"rejected")

    # UNet3D's spatial attention: heads of 32 padded to 64, N = 256 and 64
    # (half a 128-row block), causal and not (the model calls it non-causal).
    # The bounds count the bytes of the 32 true lanes; ``padded_bytes`` what
    # the kernels move with the pad lanes
    for label, BH, N, D, DP in UNET3D_SITES:
        for causal in (False, True):
            unet3d_site(f"unet3d {label} BH={BH} N={N} d={D}->{DP} causal={causal}", BH, N, D,
                        DP, causal)

    # B2 with the difference DiT's doubled table: @DiffDiT/B's video half at
    # its training batch (32 x 16 frames of 4 x 4 patches, 12 heads of 64),
    # the interleaved merge's rows as the video half reads them (the first
    # T * P); the control: the plain 3-D table over 2T frames
    B, T, P, H, D = DIFF_SITE
    N = T * P
    site = f"difference B={B} N={N} H={H} d={D} doubled table"
    doubled = make_rope_3d(D, (T, 4, 4), double_merge="interleaved")
    plain = make_rope_3d(D, (2 * T, 4, 4))
    cos, sin, pcos, psin = (torch.as_tensor(a[:N], device="cuda") for a in (
        doubled.cos, Q.signed_sin(doubled.sin), plain.cos, Q.signed_sin(plain.sin)))
    qkv = rand(B, N, 3 * H * D)
    got = Q.qkv_prep(qkv, H, D, cos, sin, d_out=D)
    torch.cuda.synchronize()
    want = Q.reference_qkv_prep(qkv, H, D, cos, sin, d_out=D)
    err, tol, extra = hold("qkv_prep", site, zip("qkv", got, want), 2e-2, PREP_REL_L2_TOL)
    extra["controls"] = rejected("qkv_prep", site, "the plain 3-D table over 2T frames",
                                 zip("qk", Q.reference_qkv_prep(qkv, H, D, pcos, psin, d_out=D),
                                     want), 2e-2, PREP_REL_L2_TOL)
    results["qkv_prep"].setdefault("edge_sites", {})[site] = {"max_abs_err": err, "tol": tol,
                                                              **extra}
    log(f"  qkv_prep          {site}: max_abs_err {err:.3e} (tol {tol:.3e}), control rejected")
    del qkv, got, want

    # B3 and B7 at tails: a token count that is no multiple of any tile, at
    # every path head dim, padded or not (no timing: on no path)
    results["attn_out_collect"]["edge_sites"] = {}
    results["attn_out_scatter"]["edge_sites"] = {}
    for B, H, N, D, DP in COLLECT_TAIL_SITES:
        site = f"tail B={B} H={H} N={N} d={D}->{DP}"
        collect_check(site, rand(B, H, N, DP), D)
        scatter_check(site, rand(B, N, H * D), H, D, DP)
        for name in ("attn_out_collect", "attn_out_scatter"):
            results[name]["edge_sites"][site] = {"max_abs_err": 0.0, "tol": 0.0}
        log(f"  attn_out_collect, attn_out_scatter {site}: exact, reversed heads rejected")

    # B6 at a tail shape: a token count that is no multiple of its tile, an
    # odd head count, rows of a 7C-wide fused projection (no timing: on no path)
    B, N, H, D = PREP_TAIL_SITE
    site = f"tail B={B} N={N} H={H} d={D}"
    C = H * D
    qkv = rand(B, N, 7 * C)[..., :3 * C]
    rope = make_rope_3d(D, (1, 1, N))
    tabs = Q.fold_qk_tables(torch.as_tensor(rope.cos, device="cuda"),
                            torch.as_tensor(Q.signed_sin(rope.sin), device="cuda"),
                            *[(1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf16)
                              for _ in range(2)], dtype=bf16)
    dys = [rand(B, H, N, D) for _ in range(3)]
    _, _, err, tol, extra = prep_bwd_check(site, qkv, tabs, dys, H, D, True)
    results["qkv_prep_bwd"]["edge_sites"] = {site: {"max_abs_err": err, "tol": tol, **extra}}
    del qkv, dys

    # B8, B9: no one PyTorch call computes either, so no library yardstick.
    # dx and dscale are each held against their own reference (dscale's
    # values are several times dx's: a shared bound would pass a wrong dx)
    l2 = KERNEL_REL_L2_TOL
    results["ln_modulate"]["edge_sites"] = {}
    results["ln_modulate_bwd"]["edge_sites"] = {}
    for shape, dtype_name in LN_TAIL_SHAPES:
        site = f"tail {shape} {dtype_name}"
        fp32 = dtype_name == "fp32"
        dtype = torch.float32 if fp32 else bf16
        x = (2 * torch.randn(shape, generator=gen, device="cuda") + 0.5).to(dtype)
        shift = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        scale = (0.3 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
        before = L.ln_modulate.launches
        y = L.ln_modulate(x, shift, scale)
        torch.cuda.synchronize()
        require(L.ln_modulate.launches == before + 1, f"ln_modulate at {site}: not one launch")
        rel, tol_l2 = (2e-5, KERNEL_REL_L2_TOL_FP32) if fp32 else (2e-2, l2)
        y_ref = L.reference_ln_modulate(x, shift, scale)
        err, tol, extra = hold("ln_modulate", site, [("y", y, y_ref)], rel, tol_l2)
        extra["controls"] = rejected(
            "ln_modulate", site, "variance without the mean's square",
            [("y", ln_modulate_uncentred_variance(x, shift, scale), y_ref)], rel, tol_l2)
        results["ln_modulate"]["edge_sites"][site] = {"max_abs_err": err, "tol": tol, **extra}
        log(f"  ln_modulate       {site}: max_abs_err {err:.3e} (tol {tol:.3e}) rel L2 "
            f"{extra['rel_l2']['y']:.3e} (tol {tol_l2}), control rejected")
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        before = L.ln_modulate_bwd.launches
        err, tol, extra = ln_bwd_check(site, x, scale, g, rel, tol_l2)
        require(L.ln_modulate_bwd.launches == before + 2,
                f"ln_modulate_bwd at {site}: not one launch a call")
        results["ln_modulate_bwd"]["edge_sites"][site] = {"max_abs_err": err, "tol": tol, **extra}
        log(f"  ln_modulate_bwd   {site}: max_abs_err {err:.3e} (tol {tol:.3e}) rel L2 "
            + ", ".join(f"{k} {v:.3e}" for k, v in extra["rel_l2"].items())
            + f" (tol {tol_l2}), control rejected, two calls bit-identical")
    for label, shape in LN_SHAPES:
        site = f"{label} {shape}"
        x = (2 * torch.randn(shape, generator=gen, device="cuda") + 0.5).to(bf16)
        shift, scale, g = rand(*shape), rand(*shape, scale=0.3), rand(*shape)
        y = L.ln_modulate(x, shift, scale)
        torch.cuda.synchronize()
        y_ref = L.reference_ln_modulate(x, shift, scale)
        elems = x.numel()
        err, tol, extra = hold("ln_modulate", site, [("y", y, y_ref)], 2e-2, l2)
        extra["controls"] = rejected(
            "ln_modulate", site, "variance without the mean's square",
            [("y", ln_modulate_uncentred_variance(x, shift, scale), y_ref)], 2e-2, l2)
        fwd = lambda: L.ln_modulate(x, shift, scale)  # noqa: E731
        note("ln_modulate", site, label == "xl", err, tol, fwd,
             cuda_ms(lambda: L.reference_ln_modulate(x, shift, scale)),
             # per element: two statistics sums, normalize, modulate
             bound(8 * elems, nbytes(x, shift, scale, y), PEAK_FP32_FLOPS),
             host_us=host_us(fwd), **extra, **contiguous_copy(2 * elems))
        err, tol, extra = ln_bwd_check(site, x, scale, g, 2e-2, l2)
        bwd = lambda: L.ln_modulate_bwd(x, scale, g)  # noqa: E731
        note("ln_modulate_bwd", site, label == "xl", err, tol, bwd,
             cuda_ms(lambda: L.reference_ln_modulate_bwd(x, scale, g)),
             # the statistics again, gl and its two sums, dx, dscale; three
             # (tokens, C) tensors read, two written
             bound(16 * elems, 5 * nbytes(x), PEAK_FP32_FLOPS), host_us=host_us(bwd), **extra,
             **contiguous_copy(5 * elems // 2))
        del x, shift, scale, g, y, y_ref

    for label, (Z, N, D), dtype in (*((a, b, bf16) for a, b in SMALL_N_SHAPES),
                                    *((a, b, torch.float32) for a, b in SMALL_N_FP32_SHAPES)):
        site = f"{label} Z={Z} N={N} d={D}"
        fp32 = dtype == torch.float32
        rel, l2 = (2e-5, KERNEL_REL_L2_TOL_FP32) if fp32 else (2e-2, KERNEL_REL_L2_TOL)
        q, k, v = (t.to(dtype) for t in
                   (rand(1, Z, N, D, scale=1.5), rand(1, Z, N, D, scale=1.5), rand(1, Z, N, D)))
        fwd = lambda: A.small_n_attention(q, k, v)  # noqa: E731
        o = fwd()
        torch.cuda.synchronize()
        o_ref = A.small_n_attention_reference(q, k, v)
        err, tol, extra = hold("small_n_attn", site, [("o", o, o_ref)], rel, l2)
        extra["controls"] = rejected(
            "small_n_attn", site, "the scale of a head twice as wide",
            [("o", attention_scaled_for_twice_the_width(q, k, v), o_ref)], rel, l2)
        if N in PAD_CONTROL_ROWS:
            extra["controls"].update(rejected(
                "small_n_attn", site, f"a softmax that counts {16 - N} zero-score pad keys",
                [("o", attention_counting_pad_keys(q, k, v), o_ref)], rel, l2))
        note("small_n_attn", site, label in SMALL_N_MAIN, err, tol, fwd,
             cuda_ms(lambda: A.small_n_attention_reference(q, k, v)),
             bound(4 * Z * N * N * D, nbytes(q, k, v, o),
                   PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS),
             cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)), host_us=host_us(fwd),
             **extra)
        del q, k, v, o, o_ref
    record["kernel_checks"] = results
    _hold_operands.cache_clear()  # the later phases read peak memory
    _flush_buffer.cache_clear()
    return results


def kernel_summary(results: dict, launches: dict) -> list:
    """One record per kernel for the kernels line: errors are the largest
    over every site checked; times and bounds are summed over the kernel's
    ``main`` sites (B1-B7: the two flagship sites at the batch of the kernel's
    own path, the window's for the forward kernels and the train step's for
    the backward ones; B8, B9: the K600 @DiT/XL shape; B10: the axial U-ViT's
    two levels); every other site is listed under ``other_sites``."""
    out = []
    for name, src, rep in KERNELS:
        sites = results[name]["by_site"]
        mine = [r for r in sites.values() if r["main"]]
        bounds = {r["bound_by"] for r in mine}
        lib = [r["library_ms"] for r in mine]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in sites.values()),
            "ms": sum(r["ms"] for r in mine), "cold_ms": sum(r["cold_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": bounds.pop() if len(bounds) == 1 else "bytes",
            "library_ms": None if None in lib else sum(lib),
            "timed_at": " + ".join(s for s, r in sites.items() if r["main"]),
            "other_sites": {
                s: {k: r[k] for k in ("ms", "cold_ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}
                for s, r in sites.items() if not r["main"]},
        })
    return out


def flagship_inputs(fs, model, B: int, gen):
    """Seeded flagship-shaped inputs: token-layout x, noise input, pose
    conditioning (identity poses), and a cond mask with one dropped row."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import sampling_cond_transform
    from dfot_tpu_torch.diffusion.continuous import continuous_model_noise_input
    from dfot_tpu_torch.diffusion.core import make_schedule

    s = fs.spec
    T, R, p = s.max_temporal_length, fs.resolution, s.patch_size
    x = torch.randn(B, T, (R // p) ** 2, p * p * fs.x_channels, generator=gen, device="cuda")
    k = torch.randint(0, fs.dcfg.timesteps, (B, T), generator=gen, device="cuda")
    noise_in = continuous_model_noise_input(fs.dcfg, make_schedule(fs.dcfg, "cuda"), k)
    cond = sampling_cond_transform(model, fs.conditioning_type)(identity_poses(B, T, "cuda"))
    mask = torch.arange(B, device="cuda") % 2 == 1
    return x, noise_in, cond, mask


def identity_poses(B: int, T: int, device):
    """Valid (B, T, 16) camera vectors: unit intrinsics and identity pose."""
    import torch

    pose = torch.zeros(B, T, 16, device=device)
    pose[..., :4] = torch.tensor([1.0, 1.0, 0.5, 0.5], device=device)
    pose[..., 4] = pose[..., 9] = pose[..., 14] = 1.0
    return pose


def make_rollout(fs, model, dcfg, **cfg_kw):
    """The recipe's rollout on the card; ``cfg_kw``: further RolloutConfig
    fields (the long-video tasks' settings)."""
    from dfot_tpu_torch.algorithms.dfot_video import sampling_cond_transform
    from dfot_tpu_torch.diffusion.core import make_schedule
    from dfot_tpu_torch.models.uvit import patchify_tokens, unpatchify_tokens
    from dfot_tpu_torch.sampling import DFoTRollout, RolloutConfig

    p, R = fs.spec.patch_size, fs.resolution
    cfg = RolloutConfig(
        max_tokens=fs.spec.max_temporal_length,
        x_shape=(R, R, fs.x_channels),
        cond_transform=sampling_cond_transform(model, fs.conditioning_type),
        state_codec=(lambda x: patchify_tokens(x, p), lambda x: unpatchify_tokens(x, p, R, R)),
        **cfg_kw,
    )
    return DFoTRollout(cfg, dcfg, make_schedule(dcfg, "cuda"), model)


def run_window(ro, fs, seed: int, first=None):
    """The recipe's 8-frame window from one context frame: ``first`` (1,
    R, R, C), zeros if not given."""
    import numpy as np
    import torch

    T = fs.spec.max_temporal_length
    R = fs.resolution
    ctx = torch.zeros(1, T, R, R, fs.x_channels, device="cuda")
    if first is not None:
        ctx[:, 0] = first
    mask = np.zeros((1, T), dtype=np.int64)
    mask[:, 0] = 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return ro.sample_sequence(
        gen, 1, length=T, context=ctx, context_mask=mask,
        conditions=identity_poses(1, T, "cuda"), history_guidance=fs.history_guidance,
    )


def build_random_model(fs, seed: int, token_io: bool = True):
    """The recipe's model on the card with seeded random fp32 weights."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import build_model
    from dfot_tpu_torch.utils.weights import init_random_weights

    model = build_model(fs, token_io=token_io)
    init_random_weights(model, torch.Generator().manual_seed(seed))
    return model


def sampling_copy(fs, model):
    """A bf16, token-layout, eval-mode model on the weights of ``model``."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import build_model

    twin = build_model(fs, token_io=True)
    twin.load_state_dict(model.state_dict())
    return twin.to(torch.bfloat16).eval()


def uniform_attention(qkv, heads, head_dim, tables=None, **_):
    """Control: an attention that ignores q and k, so every query takes the
    mean of v. A bound on the kernel route that passes this is no check."""
    v = qkv[..., 2 * heads * head_dim:]
    return v.mean(1, keepdim=True).expand_as(v)


@contextlib.contextmanager
def control_attention():
    """Every transformer block uses :func:`uniform_attention` inside."""
    from dfot_tpu_torch.models import uvit

    real = uvit.attention_from_packed_qkv
    uvit.attention_from_packed_qkv = uniform_attention
    try:
        yield
    finally:
        uvit.attention_from_packed_qkv = real


@contextlib.contextmanager
def control_zero_dq():
    """Control for the backward: attention's dq is zero (the dk, dv half is
    sound), so no gradient reaches q: the loss is untouched, every
    ``q_norm.weight`` gradient vanishes and the fused projections lose their
    q rows' share. A gradient bound that passes this is no check."""
    import torch
    from dfot_tpu_torch.ops import attention as A

    real = A.flash_bwd_dq
    A.flash_bwd_dq = lambda q, *args, **kwargs: torch.zeros_like(q)
    try:
        yield
    finally:
        A.flash_bwd_dq = real


def mean_value_attention(q, k, v, **_):
    """The same control for the dispatcher's (B, H, N, D) layout."""
    return v.mean(-2, keepdim=True).expand_as(v)


def unnormalized_modulate(x, shift, scale, eps=None, plain=False):
    """Control: a LayerNorm + modulate that skips the normalisation."""
    return x * (1 + scale) + shift


@contextlib.contextmanager
def patched(module, name: str, replacement):
    """``module.name`` is ``replacement`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, real)


def control_ln_backward():
    """Every LayerNorm + modulate backward (kernel B9's place) loses the row
    means of its dx: :func:`ln_backward_without_means`."""
    from dfot_tpu_torch.ops import ln_modulate as L

    return patched(L, "ln_modulate_bwd", ln_backward_without_means)


def dit_controls() -> dict:
    """The controls of a DiT route check, by label: every block's attention
    ignores q and k; every LayerNorm + modulate skips the normalisation."""
    from dfot_tpu_torch.models import dit

    def no_qk():
        with patched(dit, "attention_from_packed_qkv", uniform_attention), \
                patched(dit, "attention", mean_value_attention):
            yield

    return {"attention ignoring q, k": contextlib.contextmanager(no_qk),
            "ln_modulate without the normalisation":
                lambda: patched(dit, "ln_modulate", unnormalized_modulate)}


def check_route(record: dict, key: str, what: str, tol: float, set_plain, run,
                controls: dict) -> None:
    """``run()`` on the kernel route, the plain route (``set_plain(True)``)
    and under every control (label -> context manager); the kernel route must
    be within ``tol`` (relative L2) of the plain route and no control may be."""
    import torch

    out_k = run()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out_k).all()), f"{what}: non-finite output")
    set_plain(True)
    try:
        out_p = run()
    finally:
        set_plain(False)
    err = rel_l2(out_k, out_p)
    ctrl = {}
    for label, control in controls.items():
        with control():
            ctrl[label] = rel_l2(run(), out_p)
    record[key] = {"rel_l2": err, "control_rel_l2": ctrl, "tol": tol, "shape": list(out_k.shape)}
    log(f"{what}, kernel vs plain route: rel L2 {err:.3e} (tol {tol}); controls: "
        + "; ".join(f"{label} {c:.3e}" for label, c in ctrl.items()))
    require(err <= tol, f"{what}: kernel route off by {err}")
    for label, c in ctrl.items():
        require(c > tol, f"{what}: the bound {tol} does not reject the control '{label}' ({c})")


def narrow_flagship():
    """The flagship recipe on a narrow model (heads of d = 64 and 128) at
    64 px, 3 DDIM steps, seeded random bf16 weights: (recipe, dcfg, model)."""
    import dataclasses

    import torch
    from dfot_tpu_torch.algorithms.dfot_video import flagship

    fs = flagship()
    spec = dataclasses.replace(
        fs.spec, channels=(32, 32, 64, 128), emb_channels=64, num_updown_blocks=(1, 1, 1),
        num_mid_blocks=1, num_heads=1,
    )
    fs = fs._replace(spec=spec, resolution=64)
    dcfg = dataclasses.replace(fs.dcfg, sampling_timesteps=3)
    return fs, dcfg, build_random_model(fs, seed=2).to(torch.bfloat16).eval()


def small_window_check(record: dict) -> None:
    """3-step window of the narrow model on the kernel route, the plain
    route and the control, same weights and random stream."""
    fs, dcfg, model = narrow_flagship()
    ro = make_rollout(fs, model, dcfg)
    check_route(record, "small_window", "small 3-step window", WINDOW_REL_TOL,
                model.use_plain_attention, lambda: run_window(ro, fs, seed=3),
                {"attention ignoring q, k": control_attention})


def rollout_plan(frames: int, density: float, max_tokens: int):
    """What the port's planners give a one-context-frame rollout: the
    keyframes, the keyframe pass's sliding windows and the interpolation
    rounds' chunk counts."""
    import numpy as np
    from dfot_tpu_torch.sampling import interpolation_plan, keyframe_indices, sliding_window_plan

    keys = keyframe_indices(density, frames, 1)
    windows = sliding_window_plan(1, len(keys), max_tokens,
                                  ROLLOUT_SETTINGS["sliding_context_len"])
    known = np.zeros(frames, dtype=bool)
    known[keys] = True
    return keys, windows, [len(r) for r in interpolation_plan(known, max_tokens)]


def check_plan(what: str, frames: int, density: float, max_tokens: int, expect) -> tuple:
    keys, windows, rounds = rollout_plan(frames, density, max_tokens)
    got = (len(keys), len(windows), rounds)
    log(f"{what} plan: {got[0]} keyframes in {got[1]} sliding windows (generated context "
        f"{[w.generated_context_len for w in windows]}), interpolation rounds of {rounds} "
        f"chunks: {got[1] + sum(rounds)} windows")
    require(got == expect, f"{what}: the planners give {got}, expected {expect}")
    require(any(w.generated_context_len for w in windows),
            f"{what}: no keyframe window has generated context (mask code 2)")
    return keys, got[1] + sum(rounds)


def seeded_image(fs, seed: int):
    """(1, R, R, C) uniform in [-1, 1] on the card."""
    import torch

    R = fs.resolution
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(1, R, R, fs.x_channels, generator=gen, device="cuda") * 2 - 1


def card_state() -> str:
    """The card's SM clock, its maximum, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def rollout_guidance(fs):
    """bench.py's rollout guidance: stabilized vanilla HG at 4.0 (level
    0.02) for the keyframes, vanilla at 1.5 for the interpolation."""
    from dfot_tpu_torch.guidance.history_guidance import HistoryGuidance

    k = fs.dcfg.timesteps
    return dict(prediction_hg=HistoryGuidance.stabilized_vanilla(4.0, 0.02, timesteps=k),
                interpolation_hg=HistoryGuidance.vanilla(1.5, timesteps=k))


def small_rollout_check(record: dict) -> None:
    """``predict_videos`` of the narrow model over 72 frames from one (9
    keyframes in 2 sliding windows, two interpolation rounds of 8 one-chunk
    windows) on the kernel route, the plain route and the control, same
    weights and random stream."""
    import torch

    fs, dcfg, model = narrow_flagship()
    n = SMALL_ROLLOUT_FRAMES
    _, n_windows = check_plan("small rollout", n, SMALL_ROLLOUT_DENSITY,
                              fs.spec.max_temporal_length, SMALL_ROLLOUT_PLAN)
    ro = make_rollout(fs, model, dcfg, keyframe_density=SMALL_ROLLOUT_DENSITY,
                      **ROLLOUT_SETTINGS)
    xs = torch.zeros(1, n, fs.resolution, fs.resolution, fs.x_channels, device="cuda")
    xs[:, 0] = seeded_image(fs, 90)
    poses = identity_poses(1, n, "cuda")

    def run():
        ro.stats = {"denoiser_evals_b1": 0, "windows": 0}
        out = ro.predict_videos(torch.Generator(device="cuda").manual_seed(91), xs, 1,
                                conditions=poses, **rollout_guidance(fs))
        require(ro.stats["windows"] == n_windows,
                f"small rollout: {ro.stats['windows']} windows, expected {n_windows}")
        return out

    check_route(record, "small_rollout", f"small {n}-frame rollout", WINDOW_REL_TOL,
                model.use_plain_attention, run, {"attention ignoring q, k": control_attention})


def train_batch(fs, B: int, seed: int) -> dict:
    """Seeded synthetic training batch on the card: videos in [-1, 1],
    identity camera vectors, every frame available."""
    import torch

    T, R = fs.spec.max_temporal_length, fs.resolution
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.rand(B, T, R, R, fs.x_channels, generator=gen, device="cuda") * 2 - 1
    return {"xs": xs, "conditions": identity_poses(B, T, "cuda"),
            "masks": torch.ones(B, T, dtype=torch.bool, device="cuda")}


# first, middle and last transformer block, a conv block of each end, and
# the q/k norm scales whose gradients come through the table cotangents
GRAD_PROBES = (
    "down_blocks.0.0.in_layers.2.weight",
    "down_blocks.2.0.fused_attn_mlp_proj.weight",
    "down_blocks.2.0.q_norm.weight",
    "mid_blocks.10.fused_attn_mlp_proj.weight",
    "mid_blocks.10.q_norm.weight",
    "mid_blocks.10.k_norm.weight",
    "up_blocks.0.3.attn_out.weight",
    "up_blocks.0.3.q_norm.weight",
    "up_blocks.2.3.out_rest.1.weight",
)


def gradient_routes(record: dict, key: str, what: str, model, set_plain, loss_fn, probes,
                    control=None, must_reject=()) -> None:
    """One forward and backward of ``loss_fn()`` (a scalar loss of ``model``;
    dropout off, checkpointed blocks recomputed) on the kernel route, the
    plain route and, if given, under ``control``: the loss and the gradients
    of the parameters named in ``probes``, each within ``GRAD_REL_TOL``. Under the
    control, a parameter of every suffix in ``must_reject`` must fall outside
    its gradient bound; a parameter the control cuts off has a zero gradient."""
    import torch

    params = dict(model.named_parameters())
    tols = dict.fromkeys(probes, GRAD_REL_TOL)

    def run():
        model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {
            n: (torch.zeros_like(params[n]) if params[n].grad is None
                else params[n].grad.detach().clone()) for n in probes}

    was_training = model.training
    model.eval()
    try:
        loss_k, grads_k = run()
        set_plain(True)
        try:
            loss_p, grads_p = run()
        finally:
            set_plain(False)
        if control is not None:
            with control():
                loss_c, grads_c = run()
    finally:
        model.train(was_training)
        model.zero_grad(set_to_none=True)

    require(math.isfinite(loss_k) and all(bool(torch.isfinite(g).all()) for g in grads_k.values()),
            f"{what}: non-finite loss or gradient")
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs = {n: rel_l2(grads_k[n], grads_p[n]) for n in probes}
    ctrl = {n: rel_l2(grads_c[n], grads_p[n]) for n in probes} if control is not None else {}
    record[key] = {
        "loss_kernel": loss_k, "loss_plain": loss_p,
        "loss_control": loss_c if control is not None else None,
        "loss_rel_err": loss_err, "loss_tol": GRAD_LOSS_TOL, "grad_tol": GRAD_REL_TOL,
        "grad_rel_l2": errs, "control_grad_rel_l2": ctrl,
    }
    log(f"{what}, kernel vs plain route: loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.3e}, "
        f"tol {GRAD_LOSS_TOL}); gradients, relative L2 (tol {GRAD_REL_TOL})"
        + (", sound route / control:" if control is not None else ":"))
    for n in probes:
        log(f"  {n:52s} {errs[n]:.3e}" + (f" / {ctrl[n]:.3e}" if control is not None else ""))
    require(loss_err <= GRAD_LOSS_TOL, f"{what}: loss off by {loss_err}")
    for n, e in errs.items():
        require(e <= tols[n], f"{what}: gradient of {n} off by {e} (tol {tols[n]})")
    rejected = [n for n, e in ctrl.items() if e > tols[n]]
    require(all(any(n.endswith(suffix) for n in rejected) for suffix in must_reject),
            f"{what}: the gradient bound {GRAD_REL_TOL} does not reject the control: {ctrl}")


def flagship_loss_fn(fs, model, B: int, seed: int):
    """The pose recipe's training loss of ``model`` on a seeded batch of B
    videos with fixed noise levels and noise, as a function without arguments."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import make_train_apply
    from dfot_tpu_torch.diffusion.continuous import (
        continuous_training_fields, continuous_v_loss,
    )

    apply = make_train_apply(fs)
    batch = train_batch(fs, B, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    t = torch.rand(batch["masks"].shape, generator=gen, device="cuda")
    noise = torch.randn(batch["xs"].shape, generator=gen, device="cuda")
    x_t, logsnr, alpha_t, sigma_t = continuous_training_fields(fs.dcfg, batch["xs"], t, noise)

    def loss_fn():
        out = apply(model, x_t, fs.dcfg.precond_scale * logsnr, batch["conditions"], None)
        _, loss = continuous_v_loss(fs.dcfg, out, x_t, noise, logsnr, alpha_t, sigma_t)
        return loss.mean()

    return loss_fn


def no_launches() -> dict:
    return {name: 0 for name, _, _ in KERNELS}


def _kept(policy) -> tuple:
    """The kernels whose output a remat policy keeps, so that a checkpointed
    block does not run them again: the ``attn`` policies keep the tensors
    the JAX models tag ``attn_out``, the outputs of B3 (the packed route) and
    of B10 (the small-N route); B2 and B1 run again under every policy, as
    in the JAX jaxpr (``tests/test_torch_port_remat.py`` holds the counts)."""
    return ("attn_out_collect", "small_n_attn") if policy in ("attn", "dots_attn") else ()


def expected_uvit_launches(fs, forwards: int = 0, train_steps: int = 0) -> dict:
    """Launches of ``forwards`` no-grad forwards and ``train_steps`` forward
    + backward passes (or train steps) of a recipe's U-ViT: every
    transformer block runs the three forward kernels once a pass, and once
    more in the backward where its level is checkpointed (but for what the
    recipe's remat policy keeps, :func:`_kept`); every block runs the four
    backward kernels once a backward; an axial block also runs B10 (its
    temporal attention) wherever it runs the forward kernels, and its
    backward is the plain formulas."""
    s = fs.spec
    blocks = recomputed = axial = axial_recomputed = 0
    for i, kind in enumerate(s.block_types):
        if kind == "ResBlock":
            continue
        n = s.num_mid_blocks if i == len(s.channels) - 1 else 2 * s.num_updown_blocks[i]
        again = n if s.use_checkpointing[i] else 0
        blocks, recomputed = blocks + n, recomputed + again
        if kind == "AxialTransformerBlock":
            axial, axial_recomputed = axial + n, axial_recomputed + again
    kept = _kept(s.remat_policy)
    out = no_launches()
    for name in ATTENTION_KERNELS:
        again = 0 if name in kept else recomputed
        out[name] = (forwards * blocks + train_steps * (blocks + again)
                     if name in FORWARD_KERNELS else train_steps * blocks)
    again = 0 if "small_n_attn" in kept else axial_recomputed
    out["small_n_attn"] = forwards * axial + train_steps * (axial + again)
    return out


def expected_dit_launches(spec, forwards: int = 0, train_steps: int = 0) -> dict:
    """Launches of a full-variant DiT with long rows: a forward runs B8 once
    per block (twice where the blocks have an MLP) and once in the final
    layer, and B2, B1, B3 once per block; a train step runs all that, the
    blocks' share twice under checkpointing (but for what the remat policy
    keeps, :func:`_kept`), and B9 and B4-B7 once for each."""
    per_block = 2 if spec.spatial_mlp_ratio else 1
    again = 2 if spec.use_gradient_checkpointing else 1
    ln_fwd, ln_train = per_block * spec.depth + 1, again * per_block * spec.depth + 1
    out = no_launches()
    out["ln_modulate"] = forwards * ln_fwd + train_steps * ln_train
    out["ln_modulate_bwd"] = train_steps * ln_fwd
    for name in ATTENTION_KERNELS:
        fwd = name in FORWARD_KERNELS
        runs = 1 if name in _kept(spec.remat_policy) else again
        out[name] = (forwards * spec.depth if fwd else 0) + train_steps * spec.depth * (
            runs if fwd else 1)
    return out


def require_launches(what: str, launches: dict, expect: dict) -> None:
    """Every kernel's launches on a path equal ``expect``; a path expected to
    launch kernels (every one but FAR-DiT's and DiT1D's) launched some."""
    for name, n in launches.items():
        require(n == expect[name], f"kernel {name}: {n} launches on {what}, expected {expect[name]}")
    require(any(launches.values()) or not any(expect.values()),
            f"no kernel was launched on {what}")


def run_train_path(record: dict, key: str, what: str, fs, model, batch: dict, probes,
                   expect: dict) -> dict:
    """A recipe's training path at full width: its train state and train
    step, then :func:`drive_train_steps`. The warm-up of the learning rate is
    cut to two steps so that the steps taken here move the weights by a
    visible amount (the recipes' 10000-step warm-up starts at rate 0)."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import make_train_state, make_train_step

    fs = fs._replace(train=fs.train._replace(num_warmup_steps=2))
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(fs, model)
    return drive_train_steps(record, key, what, model, state, make_train_step(fs), batch, probes,
                             expect, fs.train.num_warmup_steps, fs.train.grad_clip)


def drive_train_steps(record: dict, key: str, what: str, model, state, step, batch: dict,
                      probes, expect: dict, num_warmup_steps: int, grad_clip: float,
                      steps: int = TRAIN_STEPS) -> dict:
    """A warm-up step, then ``steps`` steps between a reset and a read of
    the launch counts, which must equal ``expect``; the parameters named in
    ``probes`` and their EMA must move."""
    import torch
    from dfot_tpu_torch import ops

    B = batch["xs"].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(10)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if n in probes}
    ema_before = {n: state.ema[n].clone() for n in before}

    state, warm = step(state, batch, gen)
    torch.cuda.synchronize()
    metrics, walls = [warm], []
    ops.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    parts = {k: [float(m[k]) for m in metrics] for k in metrics[0] if k not in ("loss", "grad_norm")}
    moved = {n: float((p.detach() - before[n]).abs().max())
             for n, p in model.named_parameters() if n in before}
    ema_moved = {n: float((state.ema[n] - ema_before[n]).abs().max()) for n in before}
    step_s = sum(walls) / len(walls)
    median_s = sorted(walls)[len(walls) // 2]
    record[key] = {
        "batch": B, "steps": steps, "step_wall_s": walls, "step_s_mean": step_s,
        "step_s_median": median_s, "steps_per_s": 1 / median_s, "loss": losses,
        "grad_norm": norms, **parts,
        "launches": launches,
        "peak_memory_bytes": peak, "param_max_change": moved, "ema_max_change": ema_moved,
        "lr_after": state.optimizer.lr, "num_warmup_steps": num_warmup_steps,
    }
    log(f"{what} B={B} (AdamW, clip {grad_clip}, EMA, bf16 "
        f"compute over fp32 weights): median {median_s * 1e3:.1f} ms per step, "
        f"{1 / median_s:.3f} steps/s, over {steps} steps "
        f"({', '.join(f'{w * 1e3:.1f}' for w in walls)}; mean {step_s * 1e3:.1f}), peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  loss {losses}  grad norm {norms}  launches {launches}")
    require(all(math.isfinite(v) for v in losses + norms), f"{what}: non-finite loss or norm")
    require(state.step == steps + 1, f"train state counts {state.step} steps")
    require(all(v > 0 for v in moved.values()), f"{what}: parameters unchanged: {moved}")
    require(all(v > 0 for v in ema_moved.values()), f"{what}: the EMA unchanged: {ema_moved}")
    require_launches(f"{steps} steps of the {what}", launches, expect)
    return {"state": state, "step": step, "batch": batch, "gen": gen, "launches": launches}


# ---------------------------------------------------------------------------
# the DiT family: K600 @DiT/XL, the factorized DiT, the axial U-ViT
# ---------------------------------------------------------------------------

def dit_grad_probes(depth: int, factorized: bool) -> tuple:
    """Parameters of the first, a middle and the last block, the patch
    embedding and the final layer."""
    mid, last = depth // 2, depth - 1
    if factorized:
        return (
            "dit_base.blocks.0.attn.qkv.weight",
            "dit_base.blocks.0.norm2.modulation.1.weight",
            f"dit_base.temporal_blocks.{mid}.attn.qkv.weight",
            f"dit_base.temporal_blocks.{mid}.norm1.modulation.1.weight",
            f"dit_base.temporal_blocks.{last}.mlp.fc1.weight",
            "dit_base.final_layer.linear.weight",
        )
    return (
        "patch_embedder.proj.weight",
        "dit_base.blocks.0.norm1.modulation.1.weight",
        "dit_base.blocks.0.attn.qkv.weight",
        f"dit_base.blocks.{mid}.norm1.modulation.1.weight",
        f"dit_base.blocks.{mid}.attn.qkv.weight",
        f"dit_base.blocks.{last}.attn.proj.weight",
        "dit_base.final_layer.norm_final.modulation.1.weight",
    )


# the temporal attention's projections read B10's output (out) or feed its
# inputs (proj) directly; its q/k norm scales are no probe: their gradients
# are sums of nearly cancelling terms (a softmax row's score cotangents sum
# to zero) through a backward that both routes share, so they tell two sound
# bf16 routes apart and say little about the kernel
AXIAL_GRAD_PROBES = (
    "down_blocks.2.0.fused_attn_mlp_proj.weight",
    "down_blocks.2.0.another_attn.proj.weight",
    "down_blocks.2.0.another_attn.out.weight",
    "mid_blocks.1.another_attn.proj.weight",
    "mid_blocks.1.another_attn.out.weight",
    "up_blocks.0.1.another_attn.out.weight",
)


# the temporal attention's q/k norm scales: no route probe (see above), but
# held by the fp32 witness (fp32_witness), where two bf16 routes once read
# 6.7e-2 apart
AXIAL_NORM_PROBES = (
    "down_blocks.2.0.another_attn.q_norm.weight",
    "mid_blocks.1.another_attn.q_norm.weight",
    "mid_blocks.1.another_attn.k_norm.weight",
    "up_blocks.0.1.another_attn.k_norm.weight",
)
# the base-width U-ViT: the flagship's probes at its block counts (16 mid blocks)
BASE_GRAD_PROBES = tuple(n.replace("mid_blocks.10.", "mid_blocks.8.") for n in GRAD_PROBES)
# its axial variant (axial blocks at level 3 only, 4 mid blocks)
BASE_AXIAL_GRAD_PROBES = (
    "down_blocks.2.0.fused_attn_mlp_proj.weight",
    "mid_blocks.1.fused_attn_mlp_proj.weight",
    "mid_blocks.1.another_attn.proj.weight",
    "mid_blocks.1.another_attn.out.weight",
    "mid_blocks.3.another_attn.out.weight",
)
BASE_AXIAL_NORM_PROBES = (
    "mid_blocks.0.another_attn.q_norm.weight",
    "mid_blocks.1.another_attn.q_norm.weight",
    "mid_blocks.1.another_attn.k_norm.weight",
    "mid_blocks.3.another_attn.k_norm.weight",
)


def latent_batch(shape, B: int, seed: int) -> dict:
    """Seeded synthetic latents (normalized latents are about N(0, 1)),
    every frame available."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"xs": torch.randn(B, *shape, generator=gen, device="cuda"),
            "masks": torch.ones(B, shape[0], dtype=torch.bool, device="cuda")}


def discrete_loss_fn(dcfg, apply, model, batch: dict, seed: int):
    """A discrete-diffusion recipe's training loss of ``model`` on ``batch``
    with fixed noise levels and noise, as a function without arguments."""
    import torch
    from dfot_tpu_torch.diffusion import core as dc

    sched = dc.make_schedule(dcfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randint(0, dcfg.timesteps, batch["masks"].shape, generator=gen, device="cuda")
    noise = torch.randn(batch["xs"].shape, generator=gen, device="cuda")
    noised, target = dc.training_targets(sched, dcfg, batch["xs"], k, noise)

    def loss_fn():
        out = apply(model, noised, k.float(), None, None)
        return dc.training_loss(sched, dcfg, out, target, k).mean()

    return loss_fn


def run_xl_window(ro, r, B: int, seed: int):
    """One window of the K600 recipe: B videos of 5 latent frames, the
    first 2 given as context, conditional sampling."""
    import numpy as np
    import torch

    T = r.max_tokens
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ctx = torch.randn(B, T, *r.resolution, r.x_channels, generator=gen, device="cuda")
    mask = np.zeros((B, T), dtype=np.int64)
    mask[:, : r.n_context_tokens] = 1
    return ro.sample_sequence(gen, B, length=T, context=ctx, context_mask=mask,
                              history_guidance=r.history_guidance)


def run_xl_paths(record: dict) -> dict:
    """K600 @DiT/XL at full width and depth: a forward and a forward +
    backward on the kernel route, the plain route and the controls; the
    50-step window and the train steps with their launch counts; one
    profiled window of fewer steps and one profiled train step."""
    import dataclasses

    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.algorithms.dfot_video import k600_dit_xl, make_train_apply
    from dfot_tpu_torch.diffusion.core import make_schedule
    from dfot_tpu_torch.sampling import DFoTRollout, RolloutConfig

    r = k600_dit_xl()
    s, B, T = r.spec, XL_BATCH, r.max_tokens
    x_shape = (T, *r.resolution, r.x_channels)
    t0 = time.perf_counter()
    train_model = build_random_model(r, seed=20, token_io=False)
    model = sampling_copy(r, train_model)
    n_params = sum(p.numel() for p in model.parameters())
    record["xl_model"] = {"parameters": n_params, "hidden_size": s.hidden_size, "depth": s.depth,
                          "num_heads": s.num_heads, "tokens": T * r.resolution[0] * r.resolution[1]}
    log(f"K600 @DiT/XL DiT3D: {n_params / 1e6:.1f}M parameters (hidden {s.hidden_size}, depth "
        f"{s.depth}, {s.num_heads} heads of {s.hidden_size // s.num_heads}, "
        f"{record['xl_model']['tokens']} tokens), seeded random weights, fp32 to train and a "
        f"bf16 copy to sample ({time.perf_counter() - t0:.1f} s)")

    batch = latent_batch(x_shape, B, seed=21)
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(22)
        k = torch.randint(0, r.dcfg.timesteps, (B, T), generator=gen, device="cuda").float()
        check_route(record, "xl_forward", f"XL full-width forward B={B}", FORWARD_REL_TOL,
                    model.use_plain_kernels, lambda: model(batch["xs"], k), dit_controls())
    gradient_routes(record, "xl_gradient_route", f"XL full-width forward + backward B={B}",
                    train_model, train_model.use_plain_kernels,
                    discrete_loss_fn(r.dcfg, make_train_apply(r), train_model, batch, 23),
                    dit_grad_probes(s.depth, False), control_ln_backward,
                    must_reject=("patch_embedder.proj.weight", "blocks.0.attn.qkv.weight"))

    # the sampling path
    def rollout(dcfg):
        cfg = RolloutConfig(max_tokens=T, x_shape=x_shape[1:])
        return DFoTRollout(cfg, dcfg, make_schedule(dcfg, "cuda"), model)

    ro = rollout(r.dcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    latents = run_xl_window(ro, r, B, seed=24)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window_launches = ops.launch_counts()
    evals = ro.stats["denoiser_evals_b1"] // B
    generated = B * (T - r.n_context_tokens)
    record["xl_window"] = {
        "batch": B, "wall_s": wall, "denoiser_evals": evals, "windows_per_s": 1 / wall,
        "latent_frames_per_s": generated / wall, "launches": window_launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "shape": list(latents.shape),
    }
    log(f"K600 @DiT/XL window: {B} videos x {T} latent frames ({r.n_context_tokens} context), "
        f"{r.dcfg.sampling_timesteps} DDIM steps = {evals} evaluations at batch {B}: {wall:.3f} s "
        f"wall, {generated / wall:.3f} generated latent frames/s; peak memory "
        f"{record['xl_window']['peak_memory_bytes'] / 2**30:.2f} GiB; launches {window_launches}")
    require(tuple(latents.shape) == (B, *x_shape), f"XL window shape {tuple(latents.shape)}")
    require(bool(torch.isfinite(latents).all()), "XL window: non-finite output")
    require(evals == r.dcfg.sampling_timesteps, f"XL window took {evals} evaluations")
    require_launches("the XL window", window_launches, expected_dit_launches(s, forwards=evals))
    del latents

    short = rollout(dataclasses.replace(r.dcfg, sampling_timesteps=PROFILED_WINDOW_STEPS))
    profiled(record, "xl_profile", f"{PROFILED_WINDOW_STEPS}-step XL window",
             lambda: run_xl_window(short, r, B, seed=25))
    del ro, short, model
    torch.cuda.empty_cache()

    # the training path
    trained = run_train_path(
        record, "xl_train", "K600 @DiT/XL train step", r, train_model, batch,
        dit_grad_probes(s.depth, False),
        expected_dit_launches(s, train_steps=TRAIN_STEPS))
    profiled(record, "xl_train_profile", "XL train step",
             lambda: trained["step"](trained["state"], trained["batch"], trained["gen"]),
             unprofiled_s=record["xl_train"]["step_s_median"])
    return {"xl_window": window_launches, "xl_train": trained["launches"]}


def run_factorized_path(record: dict) -> dict:
    """The factorized-attention DiT of the repo's backbone config (hidden
    384, 6 heads of 64, depth 12, an MLP in the spatial blocks) on the
    Minecraft latent shape (16, 8, 8, 32), patch 2: temporal attention over
    16 frames and spatial attention over 16 patches, both kernel B10. Route
    checks, then one forward and one forward + backward between a reset and
    a read of the launch counts."""
    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.algorithms.dfot_video import k600_dit_xl, make_train_apply
    from dfot_tpu_torch.models.dit import DiT3D, DiTSpec
    from dfot_tpu_torch.utils.weights import init_random_weights

    spec = DiTSpec(hidden_size=384, depth=12, num_heads=6, mlp_ratio=4.0, spatial_mlp_ratio=4.0,
                   variant="factorized_attention", pos_emb_type="sinusoidal_factorized",
                   patch_size=2, max_temporal_length=16, use_gradient_checkpointing=True)
    x_shape, B = (16, 8, 8, 32), FACTORIZED_BATCH
    with torch.device("cuda"):
        train_model = DiT3D(spec, x_shape[-1], x_shape[1:3])
        model = DiT3D(spec, x_shape[-1], x_shape[1:3])
    init_random_weights(train_model, torch.Generator().manual_seed(30))
    model.load_state_dict(train_model.state_dict())
    model = model.to(torch.bfloat16).eval()
    recipe = k600_dit_xl()  # its diffusion and its bf16 train apply; the model is ours
    batch = latent_batch(x_shape, B, seed=31)
    gen = torch.Generator(device="cuda").manual_seed(32)
    k = torch.randint(0, 1000, (B, x_shape[0]), generator=gen, device="cuda").float()
    loss_fn = discrete_loss_fn(recipe.dcfg, make_train_apply(recipe), train_model, batch, 33)

    with torch.no_grad():
        check_route(record, "factorized_forward", f"factorized DiT forward B={B}",
                    FORWARD_REL_TOL, model.use_plain_kernels, lambda: model(batch["xs"], k),
                    dit_controls())
    gradient_routes(record, "factorized_gradient_route",
                    f"factorized DiT forward + backward B={B}", train_model,
                    train_model.use_plain_kernels, loss_fn, dit_grad_probes(spec.depth, True),
                    control_ln_backward, must_reject=("blocks.0.attn.qkv.weight",))

    ops.reset_launch_counts()
    with torch.no_grad():
        out = model(batch["xs"], k)
    train_model.eval()
    loss_fn().backward()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    train_model.zero_grad(set_to_none=True)
    require(bool(torch.isfinite(out).all()), "factorized DiT: non-finite output")
    # a spatial and a temporal block, each with an MLP, run B8 four times and
    # B10 twice; the checkpointed forward + backward runs both twice
    ln_fwd, attn_fwd = 4 * spec.depth + 1, 2 * spec.depth
    expect = {**no_launches(), "ln_modulate": ln_fwd + (2 * 4 * spec.depth + 1),
              "ln_modulate_bwd": ln_fwd, "small_n_attn": attn_fwd + 2 * attn_fwd}
    record["factorized"] = {"batch": B, "launches": launches, "shape": list(out.shape)}
    log(f"factorized DiT path (one forward, one forward + backward): launches {launches}")
    require_launches("the factorized DiT path", launches, expect)

    def forward_and_backward():
        with torch.no_grad():
            model(batch["xs"], k)
        loss_fn().backward()
        train_model.zero_grad(set_to_none=True)

    profiled(record, "factorized_profile", "factorized DiT path", forward_and_backward)
    return launches


def run_axial_path(record: dict, fs, axial_levels, depth: dict, key: str, what: str, seeds,
                   probes, norm_probes) -> dict:
    """A pose recipe's U-ViT with ``AxialTransformerBlock`` on the
    transformer levels in ``axial_levels``, at the recipe's widths and the
    cut ``depth``: each axial block attends over a frame's tokens (B2 -> B1
    -> B3) and then over the 8 frames of each position, kernel B10 with
    B0 * tokens a frame * heads items. Route checks forward (B = 2) and
    forward + backward (B = 1, ``probes``), the fp32 gradient witness
    (``probes`` and the temporal q/k norm scales ``norm_probes``), then one
    forward and one forward + backward between a reset and a read of the
    launch counts. ``seeds``: the model's, the inputs' and the loss's."""
    import dataclasses

    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.algorithms.dfot_video import cond_transform
    from dfot_tpu_torch.diffusion.continuous import continuous_model_noise_input
    from dfot_tpu_torch.diffusion.core import make_schedule
    from dfot_tpu_torch.models import uvit

    s_model, s_inputs, s_loss = seeds
    block_types = tuple("AxialTransformerBlock" if i in axial_levels else kind
                        for i, kind in enumerate(fs.spec.block_types))
    spec = dataclasses.replace(fs.spec, block_types=block_types, **depth)
    fs = fs._replace(spec=spec)
    train_model = build_random_model(fs, seed=s_model, token_io=False)
    model = sampling_copy(fs, train_model)
    B, T, R, p = AXIAL_BATCH, spec.max_temporal_length, fs.resolution, spec.patch_size
    gen = torch.Generator(device="cuda").manual_seed(s_inputs)
    x = torch.randn(B, T, (R // p) ** 2, p * p * fs.x_channels, generator=gen, device="cuda")
    k = torch.randint(0, fs.dcfg.timesteps, (B, T), generator=gen, device="cuda")
    noise_in = continuous_model_noise_input(fs.dcfg, make_schedule(fs.dcfg, "cuda"), k)
    pose = cond_transform(fs, torch.bfloat16)(identity_poses(B, T, "cuda"))  # raw ray maps

    @contextlib.contextmanager
    def no_qk():
        with control_attention(), patched(uvit, "attention", mean_value_attention):
            yield

    with torch.no_grad():
        check_route(record, f"{key}_forward", f"{what} forward B={B}", FORWARD_REL_TOL,
                    model.use_plain_attention, lambda: model(x, noise_in, pose),
                    {"attention ignoring q, k": no_qk})
    loss_fn = flagship_loss_fn(fs, train_model, TRAIN_BATCH, s_loss)
    gradient_routes(record, f"{key}_gradient_route",
                    f"{what} forward + backward B={TRAIN_BATCH}", train_model,
                    train_model.use_plain_attention, loss_fn, probes, no_qk,
                    must_reject=("another_attn.proj.weight", "another_attn.out.weight"))
    fp32_witness(record, f"{key}_fp32_witness", what, fs, train_model, probes + norm_probes)

    ops.reset_launch_counts()
    with torch.no_grad():
        out = model(x, noise_in, pose)
    train_model.eval()
    loss_fn().backward()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    train_model.zero_grad(set_to_none=True)
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    # per axial block: the packed route once (spatial) and B10 once (temporal)
    expect = expected_uvit_launches(fs, forwards=1, train_steps=1)
    record[key] = {"batch_forward": B, "batch_backward": TRAIN_BATCH, "launches": launches,
                   "shape": list(out.shape)}
    log(f"{what} path (one forward, one forward + backward): launches {launches}")
    require_launches(f"the {what} path", launches, expect)

    def forward_and_backward():
        with torch.no_grad():
            model(x, noise_in, pose)
        loss_fn().backward()
        train_model.zero_grad(set_to_none=True)

    profiled(record, f"{key}_profile", f"{what} path", forward_and_backward)
    return launches


def fp32_witness(record: dict, key: str, what: str, fs, model, probes) -> None:
    """The gradients of ``probes`` (a pose recipe's loss at B = 1, dropout
    off) on the bf16 kernel route and the bf16 plain route, each held against
    an fp32 witness: the plain route with the recipe's precision set to fp32
    (no autocast; TF32 is off). Records each route's relative L2 to the
    witness and the two bf16 routes' to each other; the kernel route must be
    no further from the witness than twice the plain bf16 route or
    ``GRAD_REL_TOL``, whichever is larger."""
    import torch

    params = dict(model.named_parameters())
    fs32 = fs._replace(train=fs.train._replace(precision="fp32"))
    grads = {}
    was_training = model.training
    model.eval()
    try:
        for label, recipe, plain in (("bf16 kernel", fs, False), ("bf16 plain", fs, True),
                                     ("fp32 plain", fs32, True)):
            model.use_plain_attention(plain)
            model.zero_grad(set_to_none=True)
            flagship_loss_fn(recipe, model, TRAIN_BATCH, 42)().backward()
            torch.cuda.synchronize()
            grads[label] = {n: params[n].grad.detach().float().clone() for n in probes}
    finally:
        model.use_plain_attention(False)
        model.zero_grad(set_to_none=True)
        model.train(was_training)
    wit = grads["fp32 plain"]
    rel = {label: {n: rel_l2(grads[label][n], wit[n]) for n in probes}
           for label in ("bf16 kernel", "bf16 plain")}
    between = {n: rel_l2(grads["bf16 kernel"][n], grads["bf16 plain"][n]) for n in probes}
    record[key] = {"vs_fp32": rel, "kernel_vs_plain_bf16": between, "probes": list(probes)}
    log(f"{what}: gradients against the fp32 plain-route witness, relative L2 "
        f"(bf16 kernel route / bf16 plain route / kernel vs plain):")
    for n in probes:
        log(f"  {n:52s} {rel['bf16 kernel'][n]:.3e} / {rel['bf16 plain'][n]:.3e} / "
            f"{between[n]:.3e}")
    for n in probes:
        require(all(bool(torch.isfinite(g[n]).all()) for g in grads.values()),
                f"{what}: non-finite gradient of {n}")
        bound = max(2 * rel["bf16 plain"][n], GRAD_REL_TOL)
        require(rel["bf16 kernel"][n] <= bound,
                f"{what}: the kernel route's gradient of {n} is {rel['bf16 kernel'][n]} from "
                f"the fp32 witness (bound {bound})")


def run_uvit_paths(record: dict, fs, key: str, what: str, seeds, probes) -> dict:
    """A pose recipe's U-ViT at full width and depth (the flagship, or
    UViT3DPose at the backbone's own widths, whose level 3 has heads of
    256), seeded random weights, fp32 to train and a bf16 copy to sample: a
    forward (B = 2) on the kernel route, the plain route and the
    uniform-attention control; the 50-step 8-frame window with its launch
    counts required; a profiled 10-step window; a forward + backward
    (B = 1) against the plain route with the zero-dq control (``probes``);
    six train steps with their launch counts required; a profiled step.
    ``key`` prefixes the record's keys and the paths' names; ``seeds``: the
    model's, the forward's inputs', the window's, the profiled window's, the
    gradient check's and the train batch's."""
    import dataclasses

    import torch
    from dfot_tpu_torch import ops

    s_model, s_inputs, s_window, s_profile, s_grad, s_batch = seeds
    s = fs.spec
    t0 = time.perf_counter()
    train_model = build_random_model(fs, seed=s_model, token_io=False)
    model = sampling_copy(fs, train_model)
    n_params = sum(p.numel() for p in model.parameters())
    record[f"{key}model"] = {"parameters": n_params, "channels": list(s.channels),
                             "num_heads": s.num_heads,
                             "head_dims": [c // s.num_heads for c in s.channels[2:]]}
    log(f"{what} UViT3DPose: {n_params / 1e6:.1f}M parameters (channels {s.channels}, "
        f"{s.num_heads} heads: d = {s.channels[2] // s.num_heads} at level 2, "
        f"{s.channels[3] // s.num_heads} at level 3), seeded random weights, fp32 to train "
        f"and a bf16 copy to sample ({time.perf_counter() - t0:.1f} s)")
    with torch.no_grad():
        x, nl, cond, cmask = flagship_inputs(
            fs, model, WINDOW_BATCH, torch.Generator(device="cuda").manual_seed(s_inputs))
        check_route(record, f"{key}forward", f"{what} forward B={WINDOW_BATCH} T=8 256px",
                    FORWARD_REL_TOL, model.use_plain_attention, lambda: model(x, nl, cond, cmask),
                    {"attention ignoring q, k": control_attention})
        del x, nl, cond, cmask

    # the sampling path
    ro = make_rollout(fs, model, fs.dcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    video = run_window(ro, fs, seed=s_window)
    host_s = time.perf_counter() - t0  # when the host has queued the last step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window_launches = ops.launch_counts()
    T = s.max_temporal_length
    evals = ro.stats["denoiser_evals_b1"] // WINDOW_BATCH
    record[f"{key}window"] = {
        "wall_s": wall, "frames_per_s": (T - 1) / wall, "launches": window_launches,
        "host_queued_s": host_s,
        "denoiser_evals_b1": ro.stats["denoiser_evals_b1"], "denoiser_evals": evals,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "shape": list(video.shape),
    }
    log(f"{what} 8-frame window, 50 DDIM steps, vanilla HG 4.0: {wall:.3f} s wall (the host "
        f"had queued the last step at {host_s:.3f} s), {(T - 1) / wall:.4f} generated frames/s, "
        f"peak memory "
        f"{record[f'{key}window']['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
        f"{window_launches}")
    expect = (1, T, fs.resolution, fs.resolution, fs.x_channels)
    require(tuple(video.shape) == expect, f"{what} window shape {tuple(video.shape)} != {expect}")
    require(bool(torch.isfinite(video).all()), f"{what} window: non-finite output")
    require(evals == fs.dcfg.sampling_timesteps, f"{what} window took {evals} evaluations")
    # every transformer block runs the packed route once an evaluation
    require_launches(f"the {what} window", window_launches,
                     expected_uvit_launches(fs, forwards=evals))
    del video

    short = dataclasses.replace(fs.dcfg, sampling_timesteps=PROFILED_WINDOW_STEPS)
    ro_short = make_rollout(fs, model, short)
    profiled(record, f"{key}profile", f"{PROFILED_WINDOW_STEPS}-step {what} window",
             lambda: run_window(ro_short, fs, seed=s_profile))
    del ro, ro_short, model
    torch.cuda.empty_cache()

    # the training path
    gradient_routes(record, f"{key}gradient_route",
                    f"{what} forward + backward B={TRAIN_BATCH}", train_model,
                    train_model.use_plain_attention,
                    flagship_loss_fn(fs, train_model, TRAIN_BATCH, s_grad), probes,
                    control_zero_dq, ("q_norm.weight", "fused_attn_mlp_proj.weight"))
    trained = run_train_path(
        record, f"{key}train", f"{what} train step", fs, train_model,
        train_batch(fs, TRAIN_BATCH, seed=s_batch), probes,
        expected_uvit_launches(fs, train_steps=TRAIN_STEPS))
    profiled(record, f"{key}train_profile", f"{what} train step",
             lambda: trained["step"](trained["state"], trained["batch"], trained["gen"]),
             unprofiled_s=record[f"{key}train"]["step_s_median"])
    return {f"{key}window": window_launches, f"{key}train": trained["launches"]}


def run_long_video_paths(record: dict, fs) -> dict:
    """The flagship's long-video tasks at full width and depth on a bf16
    copy of seeded random weights. ``interp2`` (BASELINE.json config 2):
    ``interpolate_videos`` of frames 0 and 7 to an 8-frame video, vanilla HG
    at 4.0, one window. ``rollout`` (config 3 cut from 200 frames,
    bench.py's settings at a keyframe density of 0.25): one image to
    ``LONG_FRAMES`` frames by ``predict_videos``, keyframes in 2 sliding
    windows and interpolation rounds of one-chunk windows (``LONG_PLAN``),
    each of (B = 1, T = 8, NFE 2), 50 DDIM steps; wall time, frames/s, the
    phase split, peak memory, and the wall beyond the windows' count times
    the 8-frame window's
    (``record["window"]``, the same model shape earlier in the run)."""
    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.guidance.history_guidance import HistoryGuidance

    T, R, C = fs.spec.max_temporal_length, fs.resolution, fs.x_channels
    steps = fs.dcfg.sampling_timesteps
    model = sampling_copy(fs, build_random_model(fs, seed=0, token_io=False))
    gc.collect()
    out = {}

    def driven(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        video = run()
        torch.cuda.synchronize()
        return video, time.perf_counter() - t0, ops.launch_counts()

    # config 2: two-image interpolation, twice (one window's wall varies from
    # run to run); the second run counted
    ro = make_rollout(fs, model, fs.dcfg, external_cond_type="action")
    ctx = torch.zeros(1, T, R, R, C, device="cuda")
    ctx[:, 0], ctx[:, T - 1] = seeded_image(fs, 70), seeded_image(fs, 71)

    def interpolate():
        ro.stats = {"denoiser_evals_b1": 0, "windows": 0}
        return ro.interpolate_videos(
            torch.Generator(device="cuda").manual_seed(72), ctx,
            conditions=identity_poses(1, T, "cuda"),
            history_guidance=HistoryGuidance.vanilla(4.0, timesteps=fs.dcfg.timesteps))

    _, first_wall, _ = driven(interpolate)
    video, wall, launches = driven(interpolate)
    record["interp2"] = {"wall_s": wall, "first_wall_s": first_wall,
                         "frames_per_s": (T - 2) / wall, "launches": launches,
                         "stats": dict(ro.stats), "shape": list(video.shape),
                         "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    log(f"two-image interpolation (config 2), 8 frames, {steps} DDIM steps, vanilla HG 4.0: "
        f"{wall:.3f} s wall ({first_wall:.3f} s the run before), "
        f"{(T - 2) / wall:.4f} generated frames/s; launches {launches}")
    require(tuple(video.shape) == (1, T, R, R, C) and bool(torch.isfinite(video).all()),
            f"interpolation: shape {tuple(video.shape)} or non-finite values")
    require(torch.equal(video[:, [0, T - 1]], ctx[:, [0, T - 1]]),
            "interpolation: frames 0 and 7 do not come back bit for bit")
    require(ro.stats["windows"] == 1 and ro.stats["denoiser_evals_b1"] == 2 * steps,
            f"interpolation stats {ro.stats}")
    require_launches("the interpolation", launches, expected_uvit_launches(fs, forwards=steps))
    out["interp2"] = launches
    del video, ro

    # config 3's rollout, cut to LONG_FRAMES
    n = LONG_FRAMES
    keys, n_windows = check_plan(f"{n}-frame rollout", n, LONG_DENSITY, T, LONG_PLAN)
    ro = make_rollout(fs, model, fs.dcfg, keyframe_density=LONG_DENSITY, **ROLLOUT_SETTINGS)
    xs = torch.zeros(1, n, R, R, C, device="cuda")
    xs[:, 0] = seeded_image(fs, 80)
    poses = identity_poses(1, n, "cuda")
    keyframe_pass, phases = {}, []
    predict_sequence = ro.predict_sequence

    def capture_keyframes(*args, **kw):
        keyframe_pass["out"] = predict_sequence(*args, **kw)
        return keyframe_pass["out"]

    ro.predict_sequence = capture_keyframes
    # each window bracketed by CUDA events: its span on the device, the
    # device's idle gap before it, and the host's time in the call
    marks = []
    sample_sequence = ro.sample_sequence

    def timed_window(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        window = sample_sequence(*args, **kw)
        end.record()
        marks.append((start, end, time.perf_counter() - t0))
        return window

    ro.sample_sequence = timed_window
    t_start = [0.0]
    last = {"at_s": 0.0, "windows": 0, "build_s": 0.0, "wait_s": 0.0}

    def progress(phase, info):
        """Each phase's wall, windows and host-build and device-wait seconds."""
        now = {"at_s": time.perf_counter() - t_start[0], "windows": ro.stats["windows"],
               "build_s": ro.stats.get("interp_host_build_sec", 0.0),
               "wait_s": ro.stats.get("interp_device_wait_sec", 0.0)}
        phases.append({"phase": phase, "frames_known": info["frames_known"], "at_s": now["at_s"],
                       "wall_s": now["at_s"] - last["at_s"],
                       "windows": now["windows"] - last["windows"],
                       "host_build_s": now["build_s"] - last["build_s"],
                       "device_wait_s": now["wait_s"] - last["wait_s"]})
        last.update(now)

    ro.progress = progress

    def run():
        t_start[0] = time.perf_counter()
        return ro.predict_videos(torch.Generator(device="cuda").manual_seed(81), xs, 1,
                                 conditions=poses, **rollout_guidance(fs))

    state_before = card_state()
    video, wall, launches = driven(run)
    state_after = card_state()
    peak = torch.cuda.max_memory_allocated()
    window_wall = record["window"]["wall_s"]
    st = dict(ro.stats)
    spans = [a.elapsed_time(b) / 1e3 for a, b, _ in marks]
    gaps = [marks[i - 1][1].elapsed_time(marks[i][0]) / 1e3 for i in range(1, len(marks))]
    host = [h for _, _, h in marks]
    record["rollout"] = {
        "wall_s": wall, "frames_per_s": (n - 1) / wall, "launches": launches, "stats": st,
        "phases": phases, "peak_memory_bytes": peak, "shape": list(video.shape),
        "window_wall_s": window_wall, "windows_x_window_wall_s": n_windows * window_wall,
        "beyond_windows_s": wall - n_windows * window_wall,
        "beyond_windows_share": 1 - n_windows * window_wall / wall,
        "window_device_span_s": spans, "gap_before_window_s": gaps, "window_host_call_s": host,
        "card_before": state_before, "card_after": state_after,
    }
    log(f"{n}-frame rollout (config 3 cut from 200 frames), {steps} DDIM steps: {wall:.3f} s wall, "
        f"{(n - 1) / wall:.4f} generated frames/s, peak memory {peak / 2**30:.2f} GiB; "
        f"keyframes {st.get('keyframe_sec', 0.0):.3f} s, interpolation "
        f"{st.get('interp_sec', 0.0):.3f} s; {st['windows']} windows, "
        f"{st['denoiser_evals_b1']} evaluations ({st.get('keyframe_evals_b1')} keyframe)")
    for ph in phases:
        log(f"  {ph['phase']:12s} {ph['windows']:3d} windows: {ph['wall_s']:.3f} s wall, host "
            f"build {ph['host_build_s']:.4f} s, device wait {ph['device_wait_s']:.3f} s, "
            f"{ph['frames_known']} frames known")
    log(f"  windows on the device: {sum(spans):.3f} s in all, {min(spans):.3f}-{max(spans):.3f} s "
        f"each (median {sorted(spans)[len(spans) // 2]:.3f}); device idle between windows "
        f"{sum(gaps):.4f} s in all, at most {max(gaps):.4f} s; host time in a window's call "
        f"{min(host):.3f}-{max(host):.3f} s")
    log(f"  card (SM clock, its maximum, power, temperature) before: {state_before}; "
        f"after: {state_after}")
    log(f"  against {n_windows} x the 8-frame window's {window_wall:.3f} s = "
        f"{n_windows * window_wall:.3f} s: {wall - n_windows * window_wall:+.3f} s "
        f"({record['rollout']['beyond_windows_share']:+.2%} of the rollout's wall)")
    require(tuple(video.shape) == (1, n, R, R, C), f"rollout shape {tuple(video.shape)}")
    require(bool(torch.isfinite(video).all()), "rollout: non-finite frames")
    require(st["windows"] == n_windows and st["denoiser_evals_b1"] == n_windows * steps * 2
            and st["keyframe_evals_b1"] == LONG_PLAN[1] * steps * 2,
            f"rollout stats {st}: expected {n_windows} windows")
    require(torch.equal(video[:, 0], xs[:, 0]), "rollout: frame 0 is not the input")
    require(torch.equal(video[:, torch.as_tensor(keys, device="cuda")], keyframe_pass["out"]),
            "rollout: the keyframes differ from the keyframe pass's output")
    require(bool((video[0, 1:].abs().amax(dim=(1, 2, 3)) > 0).all()),
            "rollout: a generated frame is still all zeros")
    require_launches(f"the {n}-frame rollout", launches,
                     expected_uvit_launches(fs, forwards=n_windows * steps))
    out["rollout"] = launches
    CARRIED["rollout"] = video[:, :2 * FVMD_FRAMES].cpu()  # phase 23's FVMD clips
    del video, keyframe_pass, ro, model
    return out


def kernel_class(name: str) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise and copies"


def profiled(record: dict, key: str, what: str, run, unprofiled_s=None) -> None:
    """``run()`` under torch.profiler: device time by kernel class and the
    share of the wall time the device sat idle. The profiler slows the host,
    so with ``unprofiled_s`` (the same work's wall time without it) the idle
    share is also given against that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries that are kernels or copies: torch.optim's profiler
    # annotation ("Optimizer.step#AdamW.step") also shows up on the device
    # side and would count the optimizer's kernels twice
    averages = prof.key_averages()  # built once: it walks every event
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    by_class, top = {}, []
    for e in kernels:
        ms = e.self_device_time_total / 1e3
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        top.append({"kernel": e.key[:160], "class": cls, "ms": ms, "calls": e.count})
    busy = sum(by_class.values()) / 1e3
    host = sorted(
        (e for e in averages if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda e: -e.self_cpu_time_total)[:15]
    record[key] = {
        "wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall if busy else None,
        "device_launches": sum(e.count for e in kernels),
        "top_host_ops": [{"op": e.key[:80], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                          "calls": e.count} for e in host],
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels": sorted(top, key=lambda r: -r["ms"])[:30],
    }
    # the profiler's events refer to each other in cycles: free them here, or
    # the collector may do it inside a later timed step (without this the
    # first timed train step stalled for about a second)
    del prof, averages, kernels, host
    gc.collect()
    if not busy:
        log(f"profiled {what}: the profiler saw no device time (not measured)")
        return
    log(f"profiled {what}: {wall:.3f} s wall, {busy:.3f} s device busy in "
        f"{record[key]['device_launches']} launches, idle share {1 - busy / wall:.4f}")
    if unprofiled_s is not None:
        record[key]["unprofiled_wall_s"] = unprofiled_s
        record[key]["idle_share_unprofiled"] = 1 - busy / unprofiled_s
        log(f"  against the unprofiled {unprofiled_s:.3f} s: idle share "
            f"{1 - busy / unprofiled_s:.4f}")
    for cls, ms in record[key]["by_class_ms"].items():
        log(f"  {cls:40s} {ms:10.2f} ms  {ms / 1e3 / busy:7.2%}")


README_RE10K = [
    "+name=re10k", "dataset=realestate10k_mini", "algorithm=dfot_video_pose",
    "experiment=video_generation", "@diffusion/continuous", "experiment.tasks=[validation]",
    "load=pretrained:DFoT_RE10K.ckpt",
    "++algorithm.tasks.prediction.history_guidance.name=vanilla",
    "++algorithm.tasks.prediction.history_guidance.guidance_scale=4.0",
]
# the names the README's composed list [fvd, is, fid, lpips, mse, ssim, psnr]
# logs without metric weight files (realestate10k_video_generation.yaml:35)
README_METRIC_NAMES = ("mse", "psnr", "ssim", "lpips_uncalibrated", "fvd_uncalibrated",
                       "fid_uncalibrated", "is_uncalibrated")


def require_registry_on_card(registry, names, what: str, calibrated: bool = False) -> None:
    """The metric registry built ``names`` on the card, frozen, on its
    seeded fallback weights (``calibrated``: on the weight files')."""
    import torch

    for name in names:
        net = registry.networks.get(name)
        require(net is not None, f"{what}: the metric network {name} was not built")
        tensors = list(net.parameters()) + list(net.buffers())
        tensors += [m for ms in getattr(net, "matrices", {}).values() for m in ms]
        require(bool(tensors) and all(x.device.type == "cuda" for x in tensors)
                and not any(p.requires_grad for p in net.parameters()),
                f"{what}: the metric network {name} is not frozen on the card")
        require(registry.comparable.get(name) is calibrated,
                f"{what}: {name} is not comparable={calibrated} ({registry.comparable})")
    require(registry.device.type == "cuda", f"{what}: the metric registry is on {registry.device}")


def run_cli_validation(record: dict, smi: str) -> dict:
    """Phase 17: the README's RE10K validation through ``python -m
    dfot_tpu_torch``'s ``run(argv)``, on a seeded random flagship checkpoint
    in the upstream layout. Returns the launch counts of the run."""
    import importlib.util
    import shutil

    import numpy as np
    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.algorithms.dfot_video import flagship
    from dfot_tpu_torch.sampling.sampler import plan_sampling

    fs = flagship()
    log("the README's RE10K validation through python -m dfot_tpu_torch (flagship, full width):")
    t0 = time.perf_counter()
    model = build_random_model(fs, seed=70, token_io=False)
    state = {"diffusion_model.model." + k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    OUT_DIR.mkdir(exist_ok=True)
    ckpt = OUT_DIR / "cli_fixture.ckpt"
    out_dir = OUT_DIR / "cli"
    shutil.rmtree(out_dir, ignore_errors=True)
    pil = importlib.util.find_spec("PIL") is not None
    argv = README_RE10K + [
        f"load={ckpt}", f"output_dir={out_dir}",
        f"experiment.validation.batch_size={CLI_BATCH}", "experiment.validation.limit_batch=1",
    ] + ([] if pil else ["++algorithm.logging.max_num_videos=0"])
    try:
        torch.save({"state_dict": state}, ckpt)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        exp = run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = ops.launch_counts()
    finally:
        ckpt.unlink(missing_ok=True)
    peak = torch.cuda.max_memory_allocated()

    require(exp.algo.device.type == "cuda", "the CLI ran off the card")
    got = exp.algo.model.state_dict()
    require(sorted("diffusion_model.model." + k for k in got) == sorted(state),
            "the CLI's model has other keys than the checkpoint")
    unequal = [k for k, v in got.items()
               if not torch.equal(v.cpu(), state["diffusion_model.model." + k])]
    require(not unequal, f"{len(unequal)} tensors differ from the checkpoint's, e.g. {unequal[:3]}")

    # the window's sampling plan: 4 context frames of 8, vanilla HG
    mask = np.zeros((CLI_BATCH, fs.spec.max_temporal_length), np.int64)
    mask[:, :4] = 1
    d = fs.dcfg
    plan = plan_sampling(mask, fs.history_guidance, "full_sequence", d.timesteps,
                         d.sampling_timesteps, fs.spec.max_temporal_length)
    forwards = int(plan.num_steps - plan.renoise.sum() - plan.noop.sum())
    require(CLI_BATCH * plan.nfe == CLI_DENOISER_BATCH,
            f"the CLI's denoiser batch {CLI_BATCH} x {plan.nfe} is not the one the kernels "
            f"were checked at ({CLI_DENOISER_BATCH})")
    stats = exp.algo.rollout.stats
    require(stats["windows"] == 1 and stats["denoiser_evals_b1"] == forwards * CLI_BATCH * plan.nfe,
            f"the CLI sampled {stats} against the plan's {forwards} forwards of one window")
    require_launches("the CLI validation", launches, expected_uvit_launches(fs, forwards=forwards))

    videos = exp.last_videos
    pred, gt = videos["prediction"], videos["gt"]
    require(tuple(pred.shape) == (CLI_BATCH, 8, 256, 256, 3) and bool(torch.isfinite(pred).all()),
            f"prediction of shape {tuple(pred.shape)} with non-finite values")
    require(torch.equal(pred[:, :4], gt[:, :4]),
            "the prediction's context frames differ from the ground truth's")
    files = [p for p in out_dir.rglob("metrics.jsonl")]
    require(len(files) == 1, f"{len(files)} metrics.jsonl files under {out_dir}")
    lines = [json.loads(line) for line in files[0].read_text().splitlines()]
    metrics = {k: v for k, v in lines[-1].items() if k not in ("step", "time")}
    # the README's list as composed, every network on its seeded fallback
    keys = [f"validation/prediction/{m}" for m in README_METRIC_NAMES]
    require(list(metrics) == keys and all(math.isfinite(metrics[k]) for k in keys),
            f"metrics.jsonl holds {metrics}, not the composed list's {keys}")
    require_registry_on_card(exp._registry, ("i3d", "lpips", "inception"), "the README validation")

    t = exp.timings
    split = {"compose_s": t["compose_s"], "checkpoint_write_s": write_s,
             "checkpoint_load_s": t["checkpoint_load_s"], "model_build_s": t["model_build_s"],
             "sampling_s": t["sampling_s"], "metrics_s": t["metrics_s"], "logger_s": t["logger_s"]}
    record["cli"] = {
        "argv": argv, "nvidia_smi": smi, "pil": pil, "wall_s": wall, "split_s": split,
        "metrics_split_s": t["metrics_split_s"],
        "peak_memory_bytes": peak, "forwards": forwards, "nfe": plan.nfe,
        "launches": launches, "metrics": metrics, "run_dir": str(exp.output_dir),
        "videos": sorted(str(p.relative_to(out_dir)) for p in out_dir.rglob("*.gif")),
    }
    log(f"  {smi}; PIL {'present' if pil else 'absent: no GIFs (max_num_videos=0)'}")
    log(f"  run(argv): {wall:.3f} s wall, {forwards} forwards x {plan.nfe} NFE at batch "
        f"{CLI_BATCH}, launches B1 {launches['flash_fwd']}, B2 {launches['qkv_prep']}, "
        f"B3 {launches['attn_out_collect']}, peak {peak / 2**30:.2f} GiB")
    log("  split: " + ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in split.items()))
    log("  metrics split: " + ", ".join(f"{k} {v:.3f} s" for k, v in t["metrics_split_s"].items()))
    log("  metrics: " + ", ".join(f"{k.rsplit('/', 1)[1]} {v:.6g}" for k, v in metrics.items()))
    return launches


TRAIN_LOOP_STEPS, RESUME_STEPS, VAL_EVERY = 6, 8, 3


def _state_mismatch(got, want, where: str = "") -> list:
    """Where two state dicts differ (tensors compared on the card, bit for
    bit; everything else by value); empty where they are equal."""
    import torch

    if isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            return [where]
        g = got.detach().to("cuda")
        w = want.detach().to("cuda")
        return [] if g.dtype == w.dtype and torch.equal(g, w) else [where]
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [where]
        return [m for k in want for m in _state_mismatch(got[k], want[k], f"{where}/{k}")]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [where]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in _state_mismatch(g, w, f"{where}/{i}")]
    return [] if got == want else [where]


def _jsonl(run_dir: Path) -> list:
    files = list(run_dir.rglob("metrics.jsonl"))
    require(len(files) == 1, f"{len(files)} metrics.jsonl files under {run_dir}")
    return [json.loads(line) for line in files[0].read_text().splitlines()]


def run_cli_training(record: dict, smi: str) -> dict:
    """Phase 18: the flagship's training through ``python -m
    dfot_tpu_torch``'s ``run(argv)`` at the composed batch of 8: a run
    warm-started from a seeded random upstream ``.ckpt`` (6 steps,
    checkpoints every 2 kept to 2, mid-run validation every 3, a profiled
    step), its resume by run name to step 8, and a validation sweep of the
    resumed run's checkpoints. Returns the launch counts of the three runs."""
    import importlib.util
    import shutil
    import statistics

    import numpy as np
    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.algorithms import dfot_video as DV
    from dfot_tpu_torch.sampling.sampler import plan_sampling
    from dfot_tpu_torch.training import checkpoint as C
    from dfot_tpu_torch.training.optim import Optimizer, make_lr_schedule
    from dfot_tpu_torch.training.state import TrainState

    fs = cut_flagship()
    t_phase = time.perf_counter()
    log("the flagship's training through python -m dfot_tpu_torch (full width, depth cut to "
        f"{FLAGSHIP_CUT_DEPTH}, batch {TRAIN_LOOP_BATCH}):")
    # the runs and their checkpoints go under build/, not with the reports
    root = ROOT / "build" / "train_loop"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = root / "runs"
    pil = importlib.util.find_spec("PIL") is not None
    t0 = time.perf_counter()
    model = build_random_model(fs, seed=80, token_io=False)
    ckpt = root / "warm_start.ckpt"
    torch.save({"state_dict": {"diffusion_model.model." + k: v.detach().cpu()
                               for k, v in model.state_dict().items()}}, ckpt)
    del model
    write_s = time.perf_counter() - t0
    train_argv = [a if a != "experiment.tasks=[validation]" else "experiment.tasks=[training]"
                  for a in README_RE10K if not a.startswith(("load=", "+name="))] + [
        f"output_dir={out}", "experiment.training.checkpointing.every_n_train_steps=2",
        "++experiment.training.checkpointing.save_top_k=2",
        f"++experiment.validation.val_every_n_step={VAL_EVERY}",
        "experiment.validation.limit_batch=1", f"experiment.validation.batch_size={CLI_BATCH}",
        "++algorithm.logging.loss_freq=1", "algorithm.lr_scheduler.num_warmup_steps=2",
        "experiment.training.data.num_workers=0",
    ] + CUT_DEPTH_ARGV + ([] if pil else ["++algorithm.logging.max_num_videos=0"])
    argv1 = train_argv + ["+name=re10k_train", f"load={ckpt}",
                          f"experiment.training.max_steps={TRAIN_LOOP_STEPS}",
                          f"++experiment.training.profile_dir={root / 'profile'}",
                          "++experiment.training.profile_at_step=4"]
    argv2 = train_argv + ["+name=re10k_resume", "load=re10k_train",
                          f"experiment.training.max_steps={RESUME_STEPS}"]

    # every optimizer step's learning rate and wall (the step, synchronized),
    # and every restore held against the dict it was given (the comparison's
    # seconds are taken off the restore's)
    lrs, walls, restores = [], [], []
    real_step, real_load = Optimizer.step, TrainState.load_state_dict
    real_make = DV.DFoTVideoAlgo.make_train_step

    def recording_step(self):
        lrs.append(self.lr)
        return real_step(self)

    def checked_load(self, state):
        real_load(self, state)
        t = time.perf_counter()
        restores.append((_state_mismatch(self.state_dict(), state), time.perf_counter() - t))

    def timed_make(self, *args, **kw):
        step = real_make(self, *args, **kw)

        def timed(*a, **k):
            t = time.perf_counter()
            result = step(*a, **k)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            return result

        return timed

    def drive(name: str, argv: list) -> dict:
        """One run between a reset and a read of the launch counts; what the
        checks need of it, then the run is let go (its weights and state
        leave the card)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        exp = run(argv)
        C.wait_for_checkpoints()
        torch.cuda.synchronize()
        r = {"wall_s": time.perf_counter() - t, "launches": ops.launch_counts(),
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "saves": [dict(x) for x in exp.saves], "device": exp.algo.device.type,
             "batch": exp.cfg.experiment.training.batch_size, "run_dir": exp.output_dir,
             "ckpt_dir": exp.ckpt_dir, "timings": dict(exp.timings)}
        if exp.state is not None:
            r["step"] = exp.state.step
            r["scheduler_steps"] = exp.state.optimizer.scheduler.last_epoch
            # the state in memory against the newest checkpoint on disk
            t = time.perf_counter()
            saved = C.restore_checkpoint(C.latest_checkpoint(exp.ckpt_dir))
            r["mismatch"] = _state_mismatch(exp.state.state_dict(), saved)
            r["compare_s"] = time.perf_counter() - t
            del saved
        else:
            # the validated weights against the last swept checkpoint's EMA
            saved = C.restore_checkpoint(exp.load_path)
            r["mismatch"] = _state_mismatch(exp.algo.model.state_dict(),
                                            {**saved["params"], **saved["ema_params"]})
            r["forwards_b1"] = exp.algo.rollout.stats["denoiser_evals_b1"]
            del saved
        del exp
        gc.collect()
        torch.cuda.empty_cache()
        return r

    runs = {}
    try:
        with patched(Optimizer, "step", recording_step), \
                patched(TrainState, "load_state_dict", checked_load), \
                patched(DV.DFoTVideoAlgo, "make_train_step", timed_make):
            runs["train"] = drive("train", argv1)
            ckpt.unlink()
            runs["resume"] = drive("resume", argv2)
        argv3 = [a for a in README_RE10K if not a.startswith(("load=", "+name="))] + [
            "+name=re10k_sweep", f"output_dir={out}", f"load={runs['resume']['run_dir']}",
            "experiment.validation.val_all_ckpt=true",
            f"experiment.validation.batch_size={CLI_BATCH}", "experiment.validation.limit_batch=1",
            # for time: the composed list (phase 17 runs it) would score every
            # checkpoint of the sweep with its networks and matrix square roots
            "++algorithm.logging.metrics=[mse,ssim,psnr]",
        ] + CUT_DEPTH_ARGV + ([] if pil else ["++algorithm.logging.max_num_videos=0"])
        runs["sweep"] = drive("sweep", argv3)
        train, resume, sweep = runs["train"], runs["resume"], runs["sweep"]
        phase_s = time.perf_counter() - t_phase

        # -- every run on the card, the training runs at the composed batch
        for name, r in runs.items():
            require(r["device"] == "cuda", f"the {name} run ran off the card")
        require(train["batch"] == resume["batch"] == TRAIN_LOOP_BATCH,
                f"the training runs composed batch {train['batch']}, not {TRAIN_LOOP_BATCH}")

        # -- launches: the train steps, the mid-run validation forwards (one
        # batch at each of steps 3 and 6) and the swept checkpoints' windows
        mask = np.zeros((CLI_BATCH, fs.spec.max_temporal_length), np.int64)
        mask[:, :4] = 1
        d = fs.dcfg
        plan = plan_sampling(mask, fs.history_guidance, "full_sequence", d.timesteps,
                             d.sampling_timesteps, fs.spec.max_temporal_length)
        window = int(plan.num_steps - plan.renoise.sum() - plan.noop.sum())
        kept_sweep = sorted(os.listdir(resume["ckpt_dir"]))
        require_launches("the training run", train["launches"], expected_uvit_launches(
            fs, forwards=TRAIN_LOOP_STEPS // VAL_EVERY, train_steps=TRAIN_LOOP_STEPS))
        require_launches("the resumed run", resume["launches"], expected_uvit_launches(
            fs, train_steps=RESUME_STEPS - TRAIN_LOOP_STEPS))
        require_launches("the checkpoint sweep", sweep["launches"], expected_uvit_launches(
            fs, forwards=window * len(kept_sweep)))
        require(sweep["forwards_b1"] == window * len(kept_sweep) * CLI_BATCH * plan.nfe,
                f"the sweep sampled {sweep['forwards_b1']} denoiser rows")

        # -- the checkpoints: the newest save_top_k kept, the state bit for bit
        kept_train = sorted(os.listdir(train["ckpt_dir"]))
        require(kept_train == ["checkpoint_4", "checkpoint_6"],
                f"the training run kept {kept_train}")
        require(kept_sweep == [f"checkpoint_{RESUME_STEPS}"], f"the resumed run kept {kept_sweep}")
        require([x["step"] for x in train["saves"]] == [2, 4, 6]
                and [x["step"] for x in resume["saves"]] == [RESUME_STEPS],
                f"saves at {[x['step'] for x in train['saves'] + resume['saves']]}")
        for name in ("train", "resume"):
            require(not runs[name]["mismatch"], f"the {name} run's state differs from its newest "
                    f"checkpoint at {runs[name]['mismatch'][:5]}")
        require(len(restores) == 1 and not restores[0][0],
                f"the resume restored a state that differs from the saved one: {restores}")
        require(not sweep["mismatch"], f"the sweep validated other weights than the checkpoint's "
                f"EMA: {sweep['mismatch'][:5]}")
        require(train["step"] == TRAIN_LOOP_STEPS and resume["step"] == RESUME_STEPS
                and resume["scheduler_steps"] == RESUME_STEPS,
                f"steps {train['step']}, {resume['step']} ({resume['scheduler_steps']} scheduled)")
        schedule = make_lr_schedule("constant_with_warmup", fs.train.lr, 2)
        unbroken = [schedule(i) for i in range(RESUME_STEPS)]
        require(lrs == unbroken, f"learning rates {lrs}, an unbroken run's {unbroken}")

        # -- the logs: loss and grad_norm finite at every step, the mid-run
        # validation loss at steps 3 and 6, the denoising panel, the sweep
        lines = _jsonl(Path(train["run_dir"])) + _jsonl(Path(resume["run_dir"]))
        steps = {x["step"]: x for x in lines if "loss" in x}
        require(sorted(steps) == list(range(1, RESUME_STEPS + 1)) and all(
            math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"]) for x in steps.values()),
            f"loss lines at steps {sorted(steps)}")
        val = {x["step"]: x["validation/loss"] for x in lines if "validation/loss" in x}
        require(sorted(val) == [3, 6] and all(math.isfinite(v) for v in val.values()),
                f"validation/loss at {val}")
        vis = Path(train["run_dir"]) / "videos" / f"denoising_vis_step{VAL_EVERY}.gif"
        require(vis.exists() or not pil, f"{vis} is missing")
        swept = {k: v for x in _jsonl(Path(sweep["run_dir"])) for k, v in x.items()
                 if k.startswith("validation/step_")}
        want = [f"validation/step_{c.split('_')[1]}/prediction/{m}" for c in kept_sweep
                for m in ("mse", "psnr", "ssim")]
        require(sorted(swept) == sorted(want) and all(math.isfinite(v) for v in swept.values()),
                f"the sweep logged {swept}")

        # -- the profiled step (step 5, after 4): device time by kernel class
        kernels = json.loads((root / "profile" / "kernels.json").read_text())
        by_class = {}
        for k in kernels:
            by_class[kernel_class(k["kernel"])] = by_class.get(kernel_class(k["kernel"]), 0) + k["ms"]
        busy_ms = sum(by_class.values())
        require(busy_ms > 0 and any((root / "profile").glob("*.pt.trace.json")),
                "the profiled step left no trace with device time")
    finally:
        shutil.rmtree(root, ignore_errors=True)  # the runs and their checkpoints

    # walls: run 1's six steps, the resumed run's two; the median leaves out
    # each run's first step (a warm-up) and the profiled fifth
    step_walls = list(walls)
    clean = [w for i, w in enumerate(step_walls) if i not in (0, 4, TRAIN_LOOP_STEPS)]
    median = statistics.median(clean)
    saves = train["saves"] + resume["saves"]
    mid_val = train["timings"].get("mid_validation_s", 0.0) / len(val)
    by_class = dict(sorted(by_class.items(), key=lambda kv: -kv[1]))
    record["train_loop"] = {
        "nvidia_smi": smi, "argv": {"train": argv1, "resume": argv2, "sweep": argv3},
        "batch": TRAIN_LOOP_BATCH, "pil": pil, "phase_wall_s": phase_s,
        "fixture_write_s": write_s, "step_walls_s": step_walls, "step_median_s": median,
        "steps_per_s": 1 / median, "learning_rates": lrs,
        "checkpoints": saves,
        "restore_s": resume["timings"]["checkpoint_restore_s"] - restores[0][1],
        "restore_compare_s": restores[0][1],
        "mid_validation_s_each": mid_val, "validation_loss": val,
        "profiled_step": {"device_busy_ms": busy_ms, "by_class_ms": by_class,
                          "profiled_wall_s": walls[4], "top_kernels": kernels[:20]},
        "sweep_metrics": swept, "sweep_checkpoints": kept_sweep,
        **{name: {k: v for k, v in r.items() if k != "mismatch"} for name, r in runs.items()},
    }
    log(f"  {smi}; PIL {'present' if pil else 'absent'}")
    log(f"  train: {train['wall_s']:.3f} s wall, {TRAIN_LOOP_STEPS} steps at batch "
        f"{TRAIN_LOOP_BATCH}: median {median * 1e3:.1f} ms a step ({1 / median:.3f} steps/s; "
        f"walls {', '.join(f'{w * 1e3:.1f}' for w in step_walls)} ms), peak "
        f"{train['peak_memory_bytes'] / 2**30:.2f} GiB; resume {resume['wall_s']:.3f} s, sweep "
        f"{sweep['wall_s']:.3f} s, phase {phase_s:.3f} s")
    for x in saves:
        log(f"  checkpoint_{x['step']}: {x['bytes'] / 1e9:.2f} GB, snapshot {x['snapshot_s']:.3f} s, "
            f"background write {x['write_s']:.3f} s")
    log(f"  restore {record['train_loop']['restore_s']:.3f} s; mid-run validation "
        f"{mid_val:.3f} s each; validation/loss {val}; learning rates {lrs}")
    log(f"  profiled step: {walls[4]:.3f} s wall, {busy_ms:.1f} ms device busy; "
        + ", ".join(f"{c} {ms:.1f}" for c, ms in list(by_class.items())[:6]))
    log("  sweep: " + ", ".join(f"{k} {v:.6g}" for k, v in swept.items()))
    return {name: sum(r["launches"][name] for r in runs.values()) for name, _, _ in KERNELS}


# ---------------------------------------------------------------------------
# phase 19: the matrix-attention DiTs, reconstruction guidance, the axial
# U-ViT's precomputed pose maps
# ---------------------------------------------------------------------------

UCF_LATENT = ["+name=ucf", "dataset=ucf_101", "algorithm=dfot_video",
              "experiment=video_generation"]
FAC_MAT_L = UCF_LATENT + ["algorithm/backbone=dit3d_factorized_matrix", "@FacMatDiT/L"]
FULL_MAT_XL = UCF_LATENT + ["algorithm/backbone=dit3d_full_matrix", "@FullMatDiT/XL"]
# the configs' 500-step learning-rate warm-up starts at rate 0: cut to 2, so
# that the steps taken here move the weights
MATRIX_OVERRIDES = ["algorithm.lr_scheduler.num_warmup_steps=2"]
# reconstruction guidance on the flagship window: its weight, and the steps
# of the window held against the plain route (each a forward and a backward
# of the full model at the denoiser's batch of 2)
GUIDANCE_WEIGHT = 10.0
GUIDED_SHORT_STEPS = 3
# a guided window, kernel vs plain route, relative L2: each step adds a bf16
# gradient of the model (GRAD_REL_TOL's class) times sqrt(1 - alpha); the
# sound route read 1.74e-2, the window without the guidance gradient 0.49
GUIDED_WINDOW_REL_TOL = 5e-2


def autocast_apply(model, x, noise_levels, cond=None, cond_mask=None):
    """The model over fp32 weights under bf16 autocast, fp32 out: what a
    composed algorithm's sampler and train step run."""
    import torch

    with torch.autocast("cuda", dtype=torch.bfloat16):
        return model(x, noise_levels.float(), cond, cond_mask).float()


def build_matrix_algorithm(argv, seed: int):
    """``build_algorithm(load_config(argv))`` on the card, its model given
    seeded random weights (the configured init leaves every AdaLN gate at
    zero); with the composed config."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
    from dfot_tpu_torch.config import load_config
    from dfot_tpu_torch.utils.weights import init_random_weights

    cfg = load_config(argv + MATRIX_OVERRIDES)
    algo = build_algorithm(cfg)
    init_random_weights(algo.model, torch.Generator().manual_seed(seed))
    return algo, cfg


def expected_matrix_launches(spec, forwards: int = 0, train_steps: int = 0) -> dict:
    """Launches of a matrix-attention DiT: a matrix block launches none;
    each spatial block of the factorized variant runs B8 once per
    LayerNorm + modulate (twice with its MLP) and B10 once, the final layer
    B8 once; a train step runs the spatial blocks' share twice under
    checkpointing, and B9 once for each B8 of its forward."""
    spatial = spec.depth if spec.variant == "factorized_matrix_attention" else 0
    per_block = 2 if spec.spatial_mlp_ratio else 1
    again = 2 if spec.use_gradient_checkpointing else 1
    ln_fwd = per_block * spatial + 1
    out = no_launches()
    out["ln_modulate"] = forwards * ln_fwd + train_steps * (again * per_block * spatial + 1)
    out["ln_modulate_bwd"] = train_steps * ln_fwd
    out["small_n_attn"] = (forwards + again * train_steps) * spatial
    return out


def matrix_grad_probes(spec) -> tuple:
    """A spatial block's attention and MLP modulation (factorized), the
    middle and last matrix blocks' U and V factors and modulation, the final
    layer."""
    mid, last = spec.depth // 2, spec.depth - 1
    matrix = "temporal_blocks" if spec.variant == "factorized_matrix_attention" else "blocks"
    spatial = (("dit_base.blocks.0.attn.qkv.weight", "dit_base.blocks.0.norm2.modulation.1.weight")
               if matrix == "temporal_blocks" else ())
    return spatial + (
        f"dit_base.{matrix}.{mid}.attn.qkv_u",
        f"dit_base.{matrix}.{mid}.attn.qkv_v",
        f"dit_base.{matrix}.{mid}.norm1.modulation.1.weight",
        f"dit_base.{matrix}.{last}.attn.proj_v",
        f"dit_base.{matrix}.{last}.mlp.fc1.weight",
        "dit_base.final_layer.linear.weight",
    )


def run_matrix_window(algo, B: int, seed: int):
    """The composed config's validation window: B videos of max_tokens
    latent frames, no context (UCF-101 generates from nothing),
    conditional sampling, through ``algo.rollout.sample_sequence``."""
    import torch

    algo.rollout.stats = {"denoiser_evals_b1": 0, "windows": 0}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return algo.rollout.sample_sequence(gen, B, length=algo.max_tokens,
                                        history_guidance=algo.prediction_hg)


def matrix_window(record: dict, key: str, what: str, algo, B: int, seed: int,
                  expected=None, run=run_matrix_window) -> dict:
    """The 50-step window between a reset and a read of the launch counts,
    which must be ``expected(spec, forwards=...)`` (by default
    :func:`expected_matrix_launches`)."""
    import torch
    from dfot_tpu_torch import ops

    spec, T = algo.model.spec, algo.max_tokens
    expected = expected or expected_matrix_launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    video = run(algo, B, seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    rollout = getattr(algo, "merged_rollout", algo.rollout)
    evals = rollout.stats["denoiser_evals_b1"] // B
    record[key] = {
        "batch": B, "wall_s": wall, "denoiser_evals": evals, "latent_frames_per_s": B * T / wall,
        "launches": launches, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "shape": list(video.shape),
    }
    log(f"{what} window: {B} videos x {T} latent frames, {algo.dcfg.sampling_timesteps} DDIM "
        f"steps = {evals} evaluations at batch {B}: {wall:.3f} s wall, {B * T / wall:.2f} latent "
        f"frames/s; peak memory {record[key]['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
        f"{launches}")
    require(tuple(video.shape) == (B, T, *algo.x_shape),
            f"{what} window shape {tuple(video.shape)}")
    require(bool(torch.isfinite(video).all()), f"{what} window: non-finite output")
    require(evals == algo.dcfg.sampling_timesteps, f"{what} window took {evals} evaluations")
    require_launches(f"the {what} window", launches, expected(spec, forwards=evals))
    return launches


def matrix_train(record: dict, key: str, what: str, algo, cfg, seed: int, steps: int,
                 expected=None, probes=None, B=None) -> dict:
    """The composed config's train state and train step at its training
    batch (or ``B``; every block checkpointed as configured): a warm-up
    step, then ``steps`` steps with their launch counts required
    (``expected(spec, train_steps=...)``, by default
    :func:`expected_matrix_launches`) and the parameters named in ``probes``
    (by default :func:`matrix_grad_probes`) moved."""
    import torch

    e = cfg.experiment
    B = B or e.training.batch_size
    expected = expected or expected_matrix_launches
    torch.cuda.reset_peak_memory_stats()
    state = algo.make_train_state(grad_clip=e.training.optim.get("gradient_clip_val", 1.0) or 0.0)
    step = algo.make_train_step(ema_decay=e.ema.get("decay", 0.9999))
    batch = latent_batch((algo.max_tokens, *algo.x_shape), B, seed)
    spec = algo.model.spec
    return drive_train_steps(
        record, key, what, algo.model, state, step, batch, probes or matrix_grad_probes(spec),
        expected(spec, train_steps=steps),
        cfg.algorithm.lr_scheduler.num_warmup_steps, state.optimizer.grad_clip, steps)


def run_matrix_paths(record: dict) -> dict:
    """Phase 19 (a) and (b): FacMatDiT/L and FullMatDiT/XL at full width and
    depth on UCF-101's latents (16 frames of 8 x 8 x 32), each built by
    ``build_algorithm(load_config(argv))`` with seeded random weights.
    FacMatDiT/L: route checks forward and forward + backward at the
    validation batch, the 50-step window at the validation batch and a
    profiled 10-step one, five train steps at the training batch and a
    profiled one. FullMatDiT/XL: the window, a profiled 10-step one and one
    train step."""
    import torch

    out = {}
    algo, cfg = build_matrix_algorithm(FAC_MAT_L, seed=80)
    model, spec = algo.model, algo.model.spec
    n_params = sum(p.numel() for p in model.parameters())
    B = cfg.experiment.validation.batch_size
    record["facmat_model"] = {"parameters": n_params, **{
        k: getattr(spec, k) for k in ("hidden_size", "depth", "num_heads", "embed_col_dim",
                                      "embed_row_dim", "num_col_heads", "num_row_heads")}}
    log(f"FacMatDiT/L on UCF-101 latents {algo.x_shape}: {n_params / 1e6:.1f}M parameters "
        f"(hidden {spec.hidden_size}, depth {spec.depth}, {spec.num_heads} spatial heads of "
        f"{spec.hidden_size // spec.num_heads}; matrix heads {spec.num_col_heads} x "
        f"{spec.num_row_heads} of {spec.embed_col_dim // spec.num_col_heads} x "
        f"{spec.embed_row_dim // spec.num_row_heads}), seeded random fp32 weights under bf16 "
        f"autocast")

    batch = latent_batch((algo.max_tokens, *algo.x_shape), B, seed=81)
    gen = torch.Generator(device="cuda").manual_seed(82)
    k = torch.randint(0, algo.dcfg.timesteps, (B, algo.max_tokens), generator=gen, device="cuda")
    with torch.no_grad():
        check_route(record, "facmat_forward", f"FacMatDiT/L forward B={B}", FORWARD_REL_TOL,
                    model.use_plain_kernels, lambda: autocast_apply(model, batch["xs"], k),
                    dit_controls())
    gradient_routes(record, "facmat_gradient_route", f"FacMatDiT/L forward + backward B={B}",
                    model, model.use_plain_kernels,
                    discrete_loss_fn(algo.dcfg, autocast_apply, model, batch, 83),
                    matrix_grad_probes(spec), control_ln_backward,
                    must_reject=("blocks.0.attn.qkv.weight",))
    del batch

    out["facmat_window"] = matrix_window(record, "facmat_window", "FacMatDiT/L", algo, B, 84)
    short, _ = build_matrix_algorithm(
        FAC_MAT_L + [f"algorithm.diffusion.sampling_timesteps={PROFILED_WINDOW_STEPS}"], seed=80)
    short.model.load_state_dict(model.state_dict())
    profiled(record, "facmat_profile", f"{PROFILED_WINDOW_STEPS}-step FacMatDiT/L window",
             lambda: run_matrix_window(short, B, 85))
    del short
    torch.cuda.empty_cache()

    trained = matrix_train(record, "facmat_train", "FacMatDiT/L train step", algo, cfg, 86,
                           TRAIN_STEPS)
    out["facmat_train"] = trained["launches"]
    profiled(record, "facmat_train_profile", "FacMatDiT/L train step",
             lambda: trained["step"](trained["state"], trained["batch"], trained["gen"]),
             unprofiled_s=record["facmat_train"]["step_s_median"])
    del algo, model, trained
    gc.collect()
    torch.cuda.empty_cache()

    algo, cfg = build_matrix_algorithm(FULL_MAT_XL, seed=87)
    spec = algo.model.spec
    n_params = sum(p.numel() for p in algo.model.parameters())
    record["fullmat_model"] = {"parameters": n_params, "embed_col_dim": spec.embed_col_dim,
                               "num_row_heads": spec.num_row_heads}
    log(f"FullMatDiT/XL: {n_params / 1e6:.1f}M parameters, {spec.depth} matrix blocks (heads "
        f"{spec.num_col_heads} x {spec.num_row_heads} of {spec.embed_col_dim // spec.num_col_heads}"
        f" x {spec.embed_row_dim // spec.num_row_heads})")
    B = cfg.experiment.validation.batch_size
    out["fullmat_window"] = matrix_window(record, "fullmat_window", "FullMatDiT/XL", algo, B, 88)
    short, _ = build_matrix_algorithm(
        FULL_MAT_XL + [f"algorithm.diffusion.sampling_timesteps={PROFILED_WINDOW_STEPS}"], seed=87)
    short.model.load_state_dict(algo.model.state_dict())
    profiled(record, "fullmat_profile", f"{PROFILED_WINDOW_STEPS}-step FullMatDiT/XL window",
             lambda: run_matrix_window(short, B, 85))
    del short
    out["fullmat_train"] = matrix_train(record, "fullmat_train", "FullMatDiT/XL train step",
                                        algo, cfg, 89, 1)["launches"]
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_guided_window_paths(record: dict) -> dict:
    """Phase 19 (c): the flagship's 8-frame vanilla-HG window with
    reconstruction guidance (weight ``GUIDANCE_WEIGHT``) at full width and
    depth on seeded random bf16 weights, from a seeded context frame: a
    ``GUIDED_SHORT_STEPS``-step window on the kernel route, the plain route
    and with the guidance gradient dropped (the control); then the 50-step
    window with its launch counts (a forward and a backward of the model a
    step, B1-B7), wall time against phase 5's window and peak memory, and a
    profiled 10-step window."""
    import dataclasses

    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.algorithms.dfot_video import flagship

    fs = flagship()
    model = build_random_model(fs, seed=91).to(torch.bfloat16).eval()
    first = seeded_image(fs, 92)
    short = dataclasses.replace(fs.dcfg, sampling_timesteps=GUIDED_SHORT_STEPS)
    guided = make_rollout(fs, model, dataclasses.replace(
        short, reconstruction_guidance=GUIDANCE_WEIGHT))
    unguided = make_rollout(fs, model, short)
    current = [guided]

    @contextlib.contextmanager
    def gradient_dropped():
        current[0] = unguided
        try:
            yield
        finally:
            current[0] = guided

    check_route(record, "guided_small_window",
                f"flagship {GUIDED_SHORT_STEPS}-step window, reconstruction guidance "
                f"{GUIDANCE_WEIGHT}", GUIDED_WINDOW_REL_TOL, model.use_plain_attention,
                lambda: run_window(current[0], fs, seed=93, first=first),
                {"guidance gradient dropped": gradient_dropped})
    del guided, unguided

    ro = make_rollout(fs, model, dataclasses.replace(fs.dcfg,
                                                     reconstruction_guidance=GUIDANCE_WEIGHT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    video = run_window(ro, fs, seed=94, first=first)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    evals = ro.stats["denoiser_evals_b1"] // WINDOW_BATCH
    T = fs.spec.max_temporal_length
    unguided_s = record["window"]["wall_s"]
    record["guided_window"] = {
        "weight": GUIDANCE_WEIGHT, "wall_s": wall, "frames_per_s": (T - 1) / wall,
        "unguided_window_wall_s": unguided_s, "wall_ratio": wall / unguided_s,
        "launches": launches, "denoiser_evals": evals,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "shape": list(video.shape),
    }
    log(f"flagship 8-frame window with reconstruction guidance {GUIDANCE_WEIGHT}, 50 DDIM steps, "
        f"vanilla HG 4.0: {wall:.3f} s wall ({wall / unguided_s:.2f} x phase 5's "
        f"{unguided_s:.3f} s), peak memory "
        f"{record['guided_window']['peak_memory_bytes'] / 2**30:.2f} GiB; launches {launches}")
    require(tuple(video.shape) == (1, T, fs.resolution, fs.resolution, fs.x_channels),
            f"guided window shape {tuple(video.shape)}")
    require(bool(torch.isfinite(video).all()), "guided window: non-finite output")
    require(torch.equal(video[:, 0], first), "guided window: the context frame changed")
    require(evals == fs.dcfg.sampling_timesteps, f"guided window took {evals} evaluations")
    # every evaluation is a forward and a backward at the denoiser's batch,
    # the checkpointed level recomputed, as in a train step
    require_launches("the guided window", launches, expected_uvit_launches(fs, train_steps=evals))
    del ro, video
    ro = make_rollout(fs, model, dataclasses.replace(
        fs.dcfg, sampling_timesteps=GUIDED_PROFILE_STEPS,
        reconstruction_guidance=GUIDANCE_WEIGHT))
    profiled(record, "guided_profile", f"{GUIDED_PROFILE_STEPS}-step guided window",
             lambda: run_window(ro, fs, seed=95, first=first))
    del ro, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_axial_precomputed_path(record: dict) -> dict:
    """Phase 19 (d): the base-width U-ViT with axial blocks at level 3 at
    phase 16's cut depth, on seeded random bf16 weights: a forward (B = 2,
    one sample's pose dropped) on the sampling route's precomputed
    conditioning (every block's pose FiLM term, and level 3's pooled pose
    map) between a reset and a read of the launch counts, held against the
    same forward on the raw ray maps, with the level maps dropped as the
    control."""
    import dataclasses

    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.algorithms.dfot_video import (
        cond_transform, sampling_cond_transform, uvit3d_pose_base,
    )
    from dfot_tpu_torch.diffusion.continuous import continuous_model_noise_input
    from dfot_tpu_torch.diffusion.core import make_schedule

    fs = uvit3d_pose_base()
    block_types = tuple("AxialTransformerBlock" if i == 3 else kind
                        for i, kind in enumerate(fs.spec.block_types))
    fs = fs._replace(spec=dataclasses.replace(fs.spec, block_types=block_types,
                                              **BASE_AXIAL_DEPTH))
    model = build_random_model(fs, seed=95).to(torch.bfloat16).eval()
    B, T, R, p = AXIAL_BATCH, fs.spec.max_temporal_length, fs.resolution, fs.spec.patch_size
    gen = torch.Generator(device="cuda").manual_seed(96)
    x = torch.randn(B, T, (R // p) ** 2, p * p * fs.x_channels, generator=gen, device="cuda")
    k = torch.randint(0, fs.dcfg.timesteps, (B, T), generator=gen, device="cuda")
    noise_in = continuous_model_noise_input(fs.dcfg, make_schedule(fs.dcfg, "cuda"), k)
    poses = identity_poses(B, T, "cuda")
    mask = torch.arange(B, device="cuda") % 2 == 1
    with torch.no_grad():
        pre = sampling_cond_transform(model, fs.conditioning_type)(poses)
        require(set(pre["levels"]) == {"3"}, f"precomputed levels {sorted(pre['levels'])}")
        ops.reset_launch_counts()
        out = model(x, noise_in, pre, mask)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        raw = model(x, noise_in, cond_transform(fs, torch.bfloat16)(poses), mask)
        dropped = model(x, noise_in, {"mods": pre["mods"], "levels": {}}, mask)
    err, ctrl = rel_l2(out, raw), rel_l2(dropped, raw)
    record["axial_precomputed"] = {"rel_l2": err, "control_rel_l2": ctrl, "tol": FORWARD_REL_TOL,
                                   "launches": launches, "batch": B}
    log(f"base-width axial U-ViT, precomputed pose conditioning vs raw ray maps B={B}: rel L2 "
        f"{err:.3e} (tol {FORWARD_REL_TOL}); control, level maps dropped {ctrl:.3e}; launches "
        f"{launches}")
    require(bool(torch.isfinite(out).all()), "axial precomputed route: non-finite output")
    require(err <= FORWARD_REL_TOL, f"axial precomputed route off by {err}")
    require(ctrl > FORWARD_REL_TOL, f"the bound does not reject dropped level maps ({ctrl})")
    require_launches("the axial precomputed forward", launches,
                     expected_uvit_launches(fs, forwards=1))
    return launches


# ---------------------------------------------------------------------------
# phase 20: the latent path: the DC-AE, on-disk DMLab data in worker
# processes, online encoding, preprocessing and pre-sampled latents, and
# K600 @DiT/XL on the online VideoVAE
# ---------------------------------------------------------------------------

# the DMLab DC-AE recipe as composed (DiT3D full at hidden 384, depth 12, 6
# heads; batch 32; 11 loader workers; the DC-AE f8c32 of dc_ae_preprocessor.yaml)
DMLAB_ARGV = ["dataset=dmlab", "algorithm=dfot_video", "experiment=video_generation",
              "wandb.mode=disabled"]
# 24 training videos of 30 frames: 15 clips of 16 frames each, 360 clips, 11
# full batches of 32 an epoch (so the loader keeps all 11 workers); 4
# validation videos
DMLAB_VIDEOS = (("training", 24, 30), ("validation", 4, 20))
DMLAB_RES = 64
LATENT_STEPS = 12  # the 12th step is the first of the second epoch
LATENT_VAL_EVERY = 6
PRE_SAMPLE_STEPS = 2
# the DC-AE on the card in fp32 (TF32 off) against the same module on the
# CPU: relative L2 of the latents and of the decoded pixels
DCAE_CPU_REL_TOL = 1e-4
# K600 @DiT/XL at full width, the depth cut from 28 to 4; its composed
# training batch of 16 on a K600-layout directory of preprocessed .npz
K600_ARGV = ["dataset=kinetics_600", "algorithm=dfot_video", "experiment=video_generation",
             "@DiT/XL", "wandb.mode=disabled"]
K600_DEPTH = 4
K600_VIDEOS = (("training", 16, 17), ("validation", 2, 17))
K600_RES = 128
K600_STEPS = 2
LATENT_PATH_KERNELS = ATTENTION_KERNELS + ("ln_modulate", "ln_modulate_bwd")  # B1-B9


def init_vae_weights(module, generator) -> None:
    """Seeded random VAE weights: U(-1, 1) / sqrt(fan_in) kernels, norm
    weights 1 + U(-0.1, 0.1), biases U(-0.02, 0.02), BatchNorm statistics
    off their defaults (means U(-0.1, 0.1), variances U(0.5, 1.5))."""
    import torch

    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if not t.is_floating_point():
                continue
            u = torch.rand(t.shape, generator=generator) * 2 - 1
            if name.endswith("running_var"):
                v = 1 + 0.5 * u
            elif name.endswith("running_mean"):
                v = 0.1 * u
            elif t.ndim == 1 and name.endswith("weight"):
                v = 1 + 0.1 * u
            elif t.ndim == 1:
                v = 0.02 * u
            else:
                v = u / math.sqrt(t.shape[1] * math.prod(t.shape[2:]))
            t.copy_(v.to(t.dtype))


def unshuffle_channels_last_order(x, r: int = 2):
    """pixel_unshuffle with its output channels in (r, r, C) order: the
    wrong one (the control of the DC-AE check)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // r, r, W // r, r).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, C * r * r, H // r, W // r)


def write_npz_videos(root: Path, splits, res: int, seed: int, channels_first: bool = False,
                     actions: int = 0, raw_dir: bool = False) -> None:
    """Seeded videos of a drifting random image, one ``.npz`` each, under
    ``root/<split>/`` (DMLab: ``ep<i>/v<i>.npz`` with ``actions``) or, with
    ``raw_dir``, K600's ``<split>/v<i>.npz`` beside the preprocessed
    ``<split>_preprocessed_<res>_npz/v<i>.npz`` stored (T, C, H, W)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for split, n, length in splits:
        for i in range(n):
            base = rng.integers(0, 256, (res, res, 3)).astype(np.uint8)
            video = np.stack([np.roll(base, 2 * t, axis=1) for t in range(length)])
            if raw_dir:
                for d, v in ((root / split, video),
                             (root / f"{split}_preprocessed_{res}_npz", video.transpose(0, 3, 1, 2))):
                    d.mkdir(parents=True, exist_ok=True)
                    np.savez(d / f"v{i}.npz", video=v)
                continue
            d = root / split / f"ep{i}"
            d.mkdir(parents=True, exist_ok=True)
            arrays = {"video": video.transpose(0, 3, 1, 2) if channels_first else video}
            if actions:
                arrays["actions"] = rng.integers(0, actions, length)
            np.savez(d / f"v{i}.npz", **arrays)


class TimedLoader:
    """A training loader whose every ``next()`` is timed on the host clock
    (the time a step waits for its batch), with the worker processes' pids."""

    def __init__(self, loader, waits: list, pids: list):
        self.loader, self.waits, self.pids = loader, waits, pids

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t)
            pool = getattr(self.loader, "_pool", None)
            if pool is not None and not self.pids:
                self.pids.extend(w.pid for w in pool._iterator._workers)
            yield batch

    def close(self):
        self.loader.close()


def check_dcae(rec: dict, cfg, pth: Path) -> None:
    """(a) The recipe's DC-AE on the card: a seeded (2 x 16, 64, 64, 3)
    batch encoded and decoded twice (the same bits), against the same
    weights on the CPU in fp32, with a control (the pixel shuffles in the
    wrong channel order) that the bound must reject; timed in fp32 and with
    cuDNN's TF32 (PyTorch's default)."""
    import numpy as np
    import torch
    from dfot_tpu_torch.vae import dc_ae as DC
    from dfot_tpu_torch.vae.codec import LatentCodec

    cpu_vae = DC.DCAE(DC.DCAEConfig.from_config(cfg.algorithm.vae))
    init_vae_weights(cpu_vae, torch.Generator().manual_seed(200))
    torch.save(cpu_vae.state_dict(), pth)
    codec = LatentCodec(cfg.algorithm, cfg.dataset)
    require(codec.pretrained and codec.deterministic, "the DMLab codec is not the loaded DC-AE")
    n_params = sum(p.numel() for p in codec.vae.parameters())
    videos = np.random.default_rng(201).uniform(0, 1, (2, 16, DMLAB_RES, DMLAB_RES, 3)) \
        .astype(np.float32)
    x = torch.from_numpy(videos).cuda()
    z1 = codec.encode_video(x)
    y1 = codec.decode_video(z1)
    z2 = codec.encode_video(x)
    y2 = codec.decode_video(z2)
    torch.cuda.synchronize()
    require(torch.equal(z1, z2) and torch.equal(y1, y2),
            "the DC-AE on the card: two runs on the same batch differ")
    t = time.perf_counter()
    with torch.no_grad():
        frames = torch.from_numpy(videos).reshape(-1, DMLAB_RES, DMLAB_RES, 3) \
            .permute(0, 3, 1, 2) * 2 - 1
        zc = cpu_vae.encode(frames)
        yc = torch.clamp(cpu_vae.decode(zc) * 0.5 + 0.5, 0, 1)
    cpu_s = time.perf_counter() - t
    zc = zc.permute(0, 2, 3, 1).reshape(z1.shape)
    yc = yc.permute(0, 2, 3, 1).reshape(y1.shape)
    err_z, err_y = rel_l2(z1.cpu(), zc), rel_l2(y1.cpu(), yc)
    with patched(DC, "pixel_unshuffle", unshuffle_channels_last_order):
        bad = codec.encode_video(x)
    err_bad = rel_l2(bad.cpu(), zc)
    log(f"  DC-AE f8c32 ({n_params / 1e6:.1f}M): latents {tuple(z1.shape)}, card vs CPU fp32 "
        f"rel L2 {err_z:.3e} (latents), {err_y:.3e} (pixels), tol {DCAE_CPU_REL_TOL}; two runs "
        f"bit-identical; control (pixel shuffles in (r, r, C) order) {err_bad:.3e}; CPU "
        f"{cpu_s:.1f} s")
    require(err_z <= DCAE_CPU_REL_TOL and err_y <= DCAE_CPU_REL_TOL,
            f"the DC-AE on the card: {err_z}, {err_y} from the CPU's above {DCAE_CPU_REL_TOL}")
    require(err_bad > DCAE_CPU_REL_TOL, "the DC-AE bound passes the wrong channel order")
    timed = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            timed[tf32] = (cuda_ms(lambda: codec.encode_video(x), reps=3, warmup=1),
                           cuda_ms(lambda: codec.decode_video(z1), reps=3, warmup=1))
        finally:
            torch.backends.cudnn.allow_tf32 = False
    frames_n = x.shape[0] * x.shape[1]
    for tf32, (enc, dec) in timed.items():
        log(f"  DC-AE {'TF32' if tf32 else 'fp32'} convolutions: encode {enc:.2f} ms, decode "
            f"{dec:.2f} ms for {frames_n} frames ({enc / frames_n:.3f} + {dec / frames_n:.3f} "
            f"ms a frame)")
    rec["dcae"] = {"params": n_params, "latent_shape": list(z1.shape), "rel_l2_latents": err_z,
                   "rel_l2_pixels": err_y, "tol": DCAE_CPU_REL_TOL, "control_rel_l2": err_bad,
                   "cpu_reference_s": cpu_s, "frames": frames_n,
                   "encode_ms": {"fp32": timed[False][0], "tf32": timed[True][0]},
                   "decode_ms": {"fp32": timed[False][1], "tf32": timed[True][1]}}
    del codec, cpu_vae, x, z1, z2, y1, y2, bad


def run_latent_paths(record: dict, smi: str) -> dict:
    """Phase 20: the latent path through ``run(argv)``. (a) The DMLab
    recipe's DC-AE on the card against the CPU; (b) a DMLab-layout
    directory; (c) the recipe trained at batch 32 from it with its 11 loader
    workers and online encoding, across an epoch boundary, with a mid-run
    validation decoding through the DC-AE, and one step profiled in two
    parts (the encode, the DiT's forward and backward); (d) the
    preprocessing experiment on the directory, then the recipe trained from
    its latents (``pre_sample``), its first batch against the online
    encoding of the same clips; (e) K600 @DiT/XL (depth cut) trained at its
    batch of 16 on the online VideoVAE and validated (decoded). Returns the
    launch counts of the three training runs."""
    import importlib.util
    import shutil
    import statistics

    import numpy as np
    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.algorithms import dfot_video as DV
    from dfot_tpu_torch.config import load_config
    from dfot_tpu_torch.data.video_dataset import build_dataset
    from dfot_tpu_torch.experiments import video_generation as VG
    from dfot_tpu_torch.utils.weights import init_random_weights
    from dfot_tpu_torch.vae.codec import LatentCodec

    t_phase = time.perf_counter()
    rec = record["latent"] = {"nvidia_smi": smi}
    root = ROOT / "build" / "latent"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    data, pth, ckpt = root / "dmlab", root / "dcae.pth", root / "dit.ckpt"
    pil = importlib.util.find_spec("PIL") is not None
    base = DMLAB_ARGV + [f"dataset.save_dir={data}", f"algorithm.vae.pretrained_path={pth}",
                         "++algorithm.logging.loss_freq=1", f"output_dir={root / 'runs'}"] + (
        [] if pil else ["++algorithm.logging.max_num_videos=0"])
    cfg = load_config(["+name=dmlab"] + base)
    log(f"the latent path (DMLab DC-AE recipe: DiT3D hidden {cfg.algorithm.backbone.hidden_size}, "
        f"depth {cfg.algorithm.backbone.depth}, batch {cfg.experiment.training.batch_size}, "
        f"{cfg.experiment.training.data.num_workers} loader workers):")

    # (a) the DC-AE
    check_dcae(rec, cfg, pth)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the dataset, and the DiT's warm start
    t = time.perf_counter()
    write_npz_videos(data, DMLAB_VIDEOS, DMLAB_RES, 202, actions=3)
    algo = DV.build_algorithm(cfg, device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(203))
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in algo.model.state_dict().items()}}, ckpt)
    del algo
    rec["fixture_s"] = time.perf_counter() - t

    # (c) training with online encoding
    waits, pids, tokenize_s, step_ends, steps_s, batches = [], [], [], [], [], []
    real_make_loader, real_train_batch = VG.make_loader, VG.VideoGenerationExperiment._train_batch
    real_make_step = DV.DFoTVideoAlgo.make_train_step

    def timed_loader(*args, **kw):
        return TimedLoader(real_make_loader(*args, **kw), waits, pids)

    def timed_train_batch(self, batch):
        """The training batches' tokenization (the mid-run validation's
        batches, of another size, pass untimed)."""
        if len(batch["nonterminal"]) != self.cfg.experiment.training.batch_size:
            return real_train_batch(self, batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_train_batch(self, batch)
        torch.cuda.synchronize()
        tokenize_s.append(time.perf_counter() - t)
        batches[:] = [batch]
        return out

    def timed_make_step(self, *args, **kw):
        step = real_make_step(self, *args, **kw)

        def timed(*a, **k):
            t = time.perf_counter()
            result = step(*a, **k)
            torch.cuda.synchronize()
            steps_s.append(time.perf_counter() - t)
            step_ends.append(time.perf_counter())
            return result

        return timed

    def drive(name: str, argv: list, *patches):
        """One run between a reset and a read of the launch counts."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for module, attr, repl in patches:
                stack.enter_context(patched(module, attr, repl))
            exp = run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        missing = [n for n in LATENT_PATH_KERNELS if not launches[n]]
        log(f"  {name}: {wall:.2f} s, peak memory {peak / 2 ** 30:.2f} GiB, launches "
            + ", ".join(f"{n} {launches[n]}" for n in LATENT_PATH_KERNELS))
        require(not missing, f"{name}: kernels launched no time: {missing}")
        return exp, {"wall_s": wall, "launches": launches, "peak_memory_bytes": peak,
                     "timings": dict(exp.timings)}

    timing_patches = ((VG, "make_loader", timed_loader),
                      (VG.VideoGenerationExperiment, "_train_batch", timed_train_batch),
                      (DV.DFoTVideoAlgo, "make_train_step", timed_make_step))
    argv = ["+name=dmlab_train"] + base + [
        "experiment.tasks=[training]", f"load={ckpt}",
        f"experiment.training.max_steps={LATENT_STEPS}",
        f"experiment.validation.val_every_n_step={LATENT_VAL_EVERY}",
        "experiment.validation.limit_batch=1"]
    exp, r = drive("DMLab training (online DC-AE)", argv, *timing_patches)
    loader_batches = len(build_dataset(cfg.dataset, "training")) // DMLAB_BATCH
    require(exp.state.step == LATENT_STEPS and LATENT_STEPS > loader_batches,
            f"DMLab training: {exp.state.step} steps over {loader_batches} batches an epoch")
    require(len(pids) == cfg.experiment.training.data.num_workers and os.getpid() not in pids,
            f"DMLab training: loader worker processes {pids}")
    lines = _jsonl(Path(exp.output_dir))
    val = [x["validation/loss"] for x in lines if "validation/loss" in x]
    losses = [x["loss"] for x in lines if "loss" in x]
    # every LATENT_VAL_EVERY steps, and at the end of each finished epoch
    n_val = LATENT_STEPS // LATENT_VAL_EVERY + (LATENT_STEPS - 1) // loader_batches
    require(len(val) == n_val and len(losses) == LATENT_STEPS
            and all(np.isfinite(val + losses)),
            f"DMLab training: validation losses {val}, losses {losses}")
    periods = [b - a for a, b in zip(step_ends, step_ends[1:])]
    steady = periods[1:]  # the second step on (the first has the set-up's warm-up)
    r.update({"steps": LATENT_STEPS, "loader_batches_an_epoch": loader_batches,
              "loader_workers": list(pids), "step_period_s": periods,
              "train_step_s": list(steps_s), "tokenize_s": list(tokenize_s),
              "batch_wait_s": list(waits),
              "validation_losses": val, "losses": losses})
    log(f"  DMLab step period (synchronized) median {statistics.median(steady):.3f} s, range "
        f"{min(steady):.3f}-{max(steady):.3f} s over steps 3-{LATENT_STEPS}; of it the online "
        f"encode median {statistics.median(tokenize_s[2:]):.3f} s, the DiT train step "
        f"{statistics.median(steps_s[2:]):.3f} s, the wait for a batch "
        f"{statistics.median(waits[2:]) * 1e3:.2f} ms (first batch {waits[0]:.2f} s: the "
        f"{len(pids)} workers' start)")

    # one step profiled in two parts: the encode, then the DiT's step
    batch = batches[0]
    step_fn = exp.algo.make_train_step(ema_decay=cfg.experiment.ema.get("decay", 0.9999))
    gen = torch.Generator(device="cuda").manual_seed(0)
    holder = {}
    profiled(rec, "profile_encode", "the DMLab step's online encode",
             lambda: holder.update(tokens=exp._train_batch(batch)))
    profiled(rec, "profile_dit_step", "the DMLab step's DiT forward, backward and update",
             lambda: step_fn(exp.state, holder["tokens"], gen))
    enc = rec["profile_encode"]["device_busy_s"]
    dit = rec["profile_dit_step"]["device_busy_s"]
    r["encode_share_of_device_time"] = enc / (enc + dit)
    log(f"  the step's device time: encode {enc * 1e3:.1f} ms, DiT {dit * 1e3:.1f} ms: the "
        f"encode's share {enc / (enc + dit):.1%}")
    rec["train"] = r
    del exp, step_fn, holder, batch
    batches.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # (d) preprocessing, then the recipe from the latents on disk
    t = time.perf_counter()
    pre = run(["+name=dmlab_pre", "dataset=dmlab", "algorithm=dc_ae_preprocessor",
               "experiment=video_latent_preprocessing", "wandb.mode=disabled",
               f"dataset.save_dir={data}", f"algorithm.pretrained_path={pth}",
               f"output_dir={root / 'pre'}"])
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t
    latent_dir = Path(f"{data}_latent_{DMLAB_RES}")
    written = {split: sorted(os.listdir(latent_dir / split)) for split, _, _ in DMLAB_VIDEOS}
    for split, n, length in DMLAB_VIDEOS:
        require(written[split] == sorted([f"v{i}.npy" for i in range(n)]
                                         + ["data_mean.npy", "data_std.npy"]),
                f"preprocessing wrote {written[split]} for {split}")
        lat = np.load(latent_dir / split / "v0.npy")
        require(lat.dtype == np.float16 and lat.shape == (length, DMLAB_RES // 8,
                                                          DMLAB_RES // 8, 32)
                and np.isfinite(lat).all(), f"preprocessing: {split} latents {lat.shape}")
    require(pre.pretrained, "preprocessing: the DC-AE weights were not loaded")
    log(f"  preprocessing: {sum(n * length for _, n, length in DMLAB_VIDEOS)} frames encoded "
        f"in {pre_s:.2f} s")
    del pre
    first = []
    real_tokenize = VG.VideoGenerationExperiment._tokenize_batch

    def first_tokens(self, batch):
        out = real_tokenize(self, batch)
        if not first:
            first.append(out["xs"].float().cpu())
        return out

    argv = ["+name=dmlab_pre_sample"] + base + [
        "experiment.tasks=[training]", f"load={ckpt}", "dataset.latent.type=pre_sample",
        f"experiment.training.max_steps={PRE_SAMPLE_STEPS}",
        "experiment.validation.val_every_n_step=0"]
    exp, r2 = drive("DMLab training from pre-sampled latents", argv,
                    (VG.VideoGenerationExperiment, "_tokenize_batch", first_tokens))
    require(exp.state.step == PRE_SAMPLE_STEPS, "pre_sample training: steps")
    del exp
    # the online encoding of the same clips: the dataset's first 32, unshuffled
    online_ds = build_dataset(cfg.dataset, "training")
    videos = np.stack([online_ds[i]["videos"] for i in range(DMLAB_BATCH)])
    codec = LatentCodec(cfg.algorithm, cfg.dataset)
    online = codec.encode_video(torch.from_numpy(videos).cuda()).float().cpu()
    # one clip later: the control
    shifted = np.stack([online_ds[i + 1]["videos"] for i in range(DMLAB_BATCH)])
    control = codec.encode_video(torch.from_numpy(shifted).cuda()).float().cpu()
    pre_xs = first[0]
    top = online.abs().max().item()

    def off_fp16(got):
        """Elements off by more than fp16's rounding: 2^-11 of the value
        itself and, where the two fp32 encodes (other chunks of frames,
        other cuDNN algorithms) leave noise on values near zero, 2^-12 of
        the largest value."""
        excess = (got - online).abs() - (2.0 ** -11 * online.abs() + 2.0 ** -12 * top)
        return int((excess > 0).sum())

    diff = (pre_xs - online).abs()
    r2.update({"first_batch_max_abs_diff": diff.max().item(), "max_abs_latent": top,
               "first_batch_rel_l2": rel_l2(pre_xs, online),
               "elements_off": off_fp16(pre_xs), "control_elements_off": off_fp16(control),
               "preprocess_s": pre_s})
    log(f"  pre_sample first batch vs the online encoding of its clips: max |diff| "
        f"{r2['first_batch_max_abs_diff']:.3e} (max |latent| {top:.3f}), rel L2 "
        f"{r2['first_batch_rel_l2']:.3e}, {r2['elements_off']} elements past the fp16 bound; "
        f"control (the clips one later) {r2['control_elements_off']} of {online.numel()}")
    require(pre_xs.shape == online.shape and r2["elements_off"] == 0,
            "pre_sample latents: off the online encoding by more than fp16 rounding")
    require(r2["control_elements_off"] > 0, "pre_sample bound: passes the clips one later")
    rec["pre_sample"] = r2
    del codec, online_ds, videos, online, pre_xs, shifted, control
    first.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # (e) K600 @DiT/XL on the online VideoVAE
    k600 = root / "k600"
    write_npz_videos(k600, K600_VIDEOS, K600_RES, 204, raw_dir=True)
    tokenize_s.clear()
    steps_s.clear()
    kargv = ["+name=k600_latent"] + K600_ARGV + [
        f"dataset.save_dir={k600}", "++dataset.video_preprocessing=npz",
        f"dataset.subdataset_size={K600_VIDEOS[0][1]}", "algorithm.vae.pretrained_path=null",
        f"++algorithm.backbone.depth={K600_DEPTH}", "experiment.tasks=[training,validation]",
        f"experiment.training.max_steps={K600_STEPS}",
        "experiment.validation.val_every_n_epoch=0", "experiment.validation.batch_size=2",
        "experiment.validation.limit_batch=1",
        "++algorithm.logging.metrics=[mse,ssim,psnr]",  # for time: phase 23 runs K600's list
        "++algorithm.logging.max_num_videos=0", f"output_dir={root / 'k600_runs'}"]
    exp, r3 = drive("K600 @DiT/XL (depth 4) on the online VideoVAE", kargv,
                    *timing_patches[1:])
    kcfg = exp.cfg
    require(exp.state.step == K600_STEPS
            and kcfg.experiment.training.batch_size == 16
            and kcfg.algorithm.backbone.hidden_size == 1152, "K600: the recipe's batch and width")
    pred = exp.last_videos["prediction"]
    metrics = exp.last_metrics
    require(tuple(pred.shape) == (2, 17, K600_RES, K600_RES, 3) and bool(torch.isfinite(pred).all())
            and metrics and all(np.isfinite(list(metrics.values()))),
            f"K600 validation: decoded {tuple(pred.shape)}, metrics {metrics}")
    r3.update({"train_step_s": list(steps_s), "tokenize_s": list(tokenize_s),
               "metrics": metrics, "decoded_shape": list(pred.shape)})
    log(f"  K600: train steps {', '.join(f'{s:.3f}' for s in steps_s)} s, the online VideoVAE "
        f"encode of 16 x 17 frames {', '.join(f'{s:.3f}' for s in tokenize_s)} s; validation "
        f"decoded {tuple(pred.shape)}, " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    rec["k600"] = r3
    del exp, pred
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 20: {rec['seconds']:.1f} s")
    return {"latent_train": r["launches"], "latent_pre_sample": r2["launches"],
            "k600_latent": r3["launches"]}


# ---------------------------------------------------------------------------
# phase 21: selective rematerialization, VAE training, TiTok and kl-f8
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "dots", "attn", "dots_attn")
# the batch of the remat steps (the recipes': flagship 8 as realestate10k's
# training sets, K600 @DiT/XL 8 as phase 13's steps) and of the gradient check
REMAT_BATCH = 8
REMAT_GRAD_BATCH = 2
# a dots policy whose kept outputs would take the card past this share of its
# memory runs at the largest batch that stays under it
REMAT_MEMORY_SHARE = 0.95
# the control: under ``attn`` the kept B3 outputs come back scaled
REMAT_CONTROL_SCALE = 1.5
# where the control must show: the output projection of a checkpointed block,
# whose weight gradient reads the kept tensor
REMAT_CONTROL_PROBE = {"flagship": "mid_blocks.3.attn_out.weight",
                       "xl": "dit_base.blocks.14.attn.proj.weight"}
# the flagship of the remat sweep and of phase 25's window and run(argv):
# full width, depth cut for the smoke's time (one up and one down block a
# conv level, two at level 2, four mid blocks; both transformer levels stay,
# level 3 checkpointed as the recipe's); the sweep's probes
FLAGSHIP_CUT_DEPTH = dict(num_updown_blocks=(1, 1, 2), num_mid_blocks=4)
# the same cut as overrides of the composed recipe
CUT_DEPTH_ARGV = [
    "++algorithm.backbone.num_updown_blocks=[" + ",".join(
        str(n) for n in FLAGSHIP_CUT_DEPTH["num_updown_blocks"]) + "]",
    f"++algorithm.backbone.num_mid_blocks={FLAGSHIP_CUT_DEPTH['num_mid_blocks']}"]
REMAT_FLAGSHIP_PROBES = (
    "down_blocks.0.0.in_layers.2.weight",
    "down_blocks.2.0.fused_attn_mlp_proj.weight",
    "down_blocks.2.0.q_norm.weight",
    "mid_blocks.3.fused_attn_mlp_proj.weight",
    "mid_blocks.3.q_norm.weight",
    "mid_blocks.3.k_norm.weight",
    "up_blocks.0.2.attn_out.weight",
    "up_blocks.0.2.q_norm.weight",
    "up_blocks.2.1.out_rest.1.weight",
)
# VAE training through run(argv) on seeded directories in the recipes'
# layouts; the adversarial term from step VAE_DISC_START (0-based) on
VAE_DISC_START = 2
VAE_STEPS = 4  # cut from the recipe's run for time; the adversarial term runs from the third
VAE_RES = 128
K600_VAE_VIDEOS = (("training", 12, 17), ("validation", 2, 17))
MINECRAFT_VAE_VIDEOS = (("training", 12, 16), ("validation", 2, 16))
# the first step on the card against the CPU in fp32 (TF32 off), on one
# clip at full width with its frames and pixels cut (CPU time): relative error of every
# logged loss and relative L2 of the autoencoder's gradient, 1e-4 with a
# smooth (squared) reconstruction loss. The recipe's L1 loss has a gradient
# of sign(recon - x): an element where the two devices round recon - x to
# opposite signs moves the gradient of a 5-frame clip by up to 4e-3
# (readings 7.3e-6 to 1.2e-3). The adaptive weight divides by the norm of a
# discriminator gradient taken through batch-statistics BatchNorm, whose
# backward subtracts batch means (readings 5.4e-5 to 1.2e-3), and an
# adversarial step's gradient, which flows through that BatchNorm, carries
# both (2.1e-3 to 7.0e-3); the control reads 1.39 and more
VAE_CPU_REL_TOL = 1e-4
VAE_CPU_SIGN_TOL = 1e-2
VAE_CPU_WEIGHT_TOL = 1e-2
VAE_CPU_ADV_TOL = 5e-2
VAE_CPU_FRAMES = {"video": 5, "image": 2}
VAE_CPU_CROP = 64  # the clip's top-left 64 x 64 pixels, cut from 128 for CPU time
# the preprocessors at their published widths on seeded weights
PRE_RES = 256
# DMLab keeps the videos of max_frames (16) frames and more
PRE_VIDEOS = (("training", 2, 16), ("validation", 1, 16))


def set_remat_policy(model, policy: str) -> None:
    """The model's blocks recomputed under ``policy`` from now on."""
    import dataclasses

    owner = model.dit_base if hasattr(model, "dit_base") else model
    owner.spec = dataclasses.replace(owner.spec, remat_policy=policy)


@contextlib.contextmanager
def scaled_kept_outputs(policy: str, scale: float):
    """Control: every checkpoint's recompute gets the outputs ``policy`` kept
    multiplied by ``scale`` (the forward used them unscaled)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
    from dfot_tpu_torch.models import remat as R

    real = R.create_selective_checkpoint_contexts

    class Scale(TorchDispatchMode):
        def __init__(self, keep):
            super().__init__()
            self.keep = keep

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in self.keep and isinstance(out, torch.Tensor):
                with _disable_current_modes():  # the checkpoint sees no extra op
                    out = out * scale
            return out

    def contexts(policy_fn, *a, **kw):
        caching, cached = real(policy_fn, *a, **kw)
        keep = R.saved_ops(policy)

        @contextlib.contextmanager
        def recompute():
            with cached, Scale(keep):
                yield

        return caching, recompute()

    R.create_selective_checkpoint_contexts = contexts
    try:
        yield
    finally:
        R.create_selective_checkpoint_contexts = real


def remat_gradients(model, loss_fn, probes) -> tuple:
    """The loss and the probes' gradients of one forward and backward (eval
    mode: dropout off; checkpointed blocks recomputed)."""
    import torch

    params = dict(model.named_parameters())
    model.eval()
    try:
        model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: params[n].grad.detach().clone() for n in probes}
    finally:
        model.train()
        model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def kept_output_bytes(op, args) -> int:
    """Bytes of the output of an op a remat policy keeps: a linear's
    (``mm``, ``addmm``), B3's or B10's."""
    import torch

    x = args[0]
    if op == torch.ops.dfot.attn_out_collect.default:
        return x.shape[0] * x.shape[1] * x.shape[2] * args[1] * x.element_size()
    if op == torch.ops.dfot.small_n_attention.default:
        return x.numel() * x.element_size()
    a, b = args[-2:]
    return a.shape[0] * b.shape[1] * a.element_size()


def saved_bytes_per_sample(model, loss_fn, policy: str) -> int:
    """Bytes a policy keeps in one forward of ``loss_fn`` (whose batch is one
    sample), counted where the policy decides, before any is kept."""
    import torch
    from dfot_tpu_torch.models import remat as R

    kept = [0]
    real = R.remat_policy

    def counting(name):
        fn = real(name)

        def policy(ctx, op, *args, **kwargs):
            decision = fn(ctx, op, *args, **kwargs)
            if decision == R.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                kept[0] += kept_output_bytes(op, args)
            return decision

        return policy

    set_remat_policy(model, policy)
    with patched(R, "remat_policy", counting):
        loss = loss_fn()
    del loss
    torch.cuda.synchronize()
    return kept[0]


def run_remat_model(record: dict, key: str, what: str, r, model, batch_fn, loss_fn_at,
                    probes, expect_fn) -> dict:
    """One recipe under every remat policy: the gradient check against
    ``none`` (with the control), then the train steps at ``REMAT_BATCH`` (a
    dots policy at the largest batch its kept outputs leave room for), each
    with its launch counts, and one profiled step."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import make_train_state, make_train_step

    rec = record.setdefault("remat", {})[key] = {}
    loss_fn = loss_fn_at(REMAT_GRAD_BATCH)
    grads = {}
    for policy in REMAT_POLICIES:
        set_remat_policy(model, policy)
        grads[policy] = remat_gradients(model, loss_fn, probes)
    set_remat_policy(model, "attn")
    with scaled_kept_outputs("attn", REMAT_CONTROL_SCALE):
        control = remat_gradients(model, loss_fn, probes)
    loss0, g0 = grads["none"]
    checks = {}
    for policy, (loss, g) in [*grads.items(), ("control", control)]:
        checks[policy] = {"loss_rel_err": abs(loss - loss0) / abs(loss0),
                          "grad_rel_l2": {n: rel_l2(g[n], g0[n]) for n in probes}}
    rec["gradient_check"] = {"batch": REMAT_GRAD_BATCH, "tol": GRAD_REL_TOL,
                             "loss_tol": GRAD_LOSS_TOL, **checks}
    log(f"{what}: loss and gradients under each remat policy against none at B="
        f"{REMAT_GRAD_BATCH} (loss tol {GRAD_LOSS_TOL}, gradient relative L2 tol {GRAD_REL_TOL}):")
    for policy, c in checks.items():
        worst = max(c["grad_rel_l2"].values())
        log(f"  {policy:10s} loss {c['loss_rel_err']:.3e}  worst gradient {worst:.3e}")
        if policy != "control":
            require(c["loss_rel_err"] <= GRAD_LOSS_TOL and worst <= GRAD_REL_TOL,
                    f"{what} under {policy}: off none by {c}")
    probe = REMAT_CONTROL_PROBE[key]
    require(checks["control"]["grad_rel_l2"][probe] > GRAD_REL_TOL,
            f"{what}: the bound does not reject kept outputs scaled by {REMAT_CONTROL_SCALE}: "
            f"{checks['control']['grad_rel_l2']}")

    total = torch.cuda.get_device_properties(0).total_memory
    one = loss_fn_at(1)
    for policy in REMAT_POLICIES:
        set_remat_policy(model, policy)
        B = REMAT_BATCH
        if "dots" in policy:
            kept = saved_bytes_per_sample(model, one, policy)
            peak_none = rec["none"]["peak_memory_bytes"]
            fits = int((REMAT_MEMORY_SHARE * total) // (peak_none / REMAT_BATCH + kept))
            B = max(1, min(REMAT_BATCH, fits))
            log(f"{what} under {policy}: keeps {kept / 2**20:.1f} MiB a sample; predicted peak "
                f"at B={REMAT_BATCH} {(peak_none + REMAT_BATCH * kept) / 2**30:.2f} GiB of "
                f"{total / 2**30:.2f}: runs at B={B}")
        else:
            kept = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(r, model)
        step = make_train_step(r)
        expect = expect_fn(train_steps=REMAT_STEPS)
        out = drive_train_steps(rec, policy, f"{what} under remat {policy}", model, state, step,
                                batch_fn(B), probes, expect, r.train.num_warmup_steps,
                                r.train.grad_clip, steps=REMAT_STEPS)
        rec[policy]["kept_bytes_per_sample"] = kept
        profiled(rec, f"{policy}_profile", f"{what} train step under remat {policy}",
                 lambda: out["step"](out["state"], out["batch"], out["gen"]),
                 unprofiled_s=rec[policy]["step_s_median"])
        by = rec[f"{policy}_profile"]["by_class_ms"]
        rec[policy]["b1_b2_b3_ms"] = [by.get(c, 0.0) for c in
                                      ("B1 flash_fwd", "B2 qkv_prep", "B3 attn_out_collect")]
        rec[policy]["device_busy_s"] = rec[f"{policy}_profile"]["device_busy_s"]
        record.setdefault("remat_launches", {})[f"{key}_{policy}"] = out["launches"]
        del out, state, step
    set_remat_policy(model, r.spec.remat_policy)
    log(f"{what}, per policy: step wall (median of {REMAT_STEPS}), peak memory, device busy "
        f"in the profiled step, B1 / B2 / B3 ms a step:")
    for policy in REMAT_POLICIES:
        p = rec[policy]
        log(f"  {policy:10s} B={p['batch']}  {p['step_s_median'] * 1e3:8.1f} ms  "
            f"{p['peak_memory_bytes'] / 2**30:6.2f} GiB  {p['device_busy_s'] * 1e3:8.1f} ms  "
            + " / ".join(f"{ms:.2f}" for ms in p["b1_b2_b3_ms"]))
    return {f"{key}_remat_{policy}": record["remat_launches"][f"{key}_{policy}"]
            for policy in REMAT_POLICIES}


def run_remat_paths(record: dict) -> dict:
    """Phase 21 (a): K600 @DiT/XL at full depth and the flagship at full
    width, depth cut to :data:`FLAGSHIP_CUT_DEPTH` (level 3 checkpointed),
    under none, dots, attn and dots_attn."""
    import dataclasses

    from dfot_tpu_torch.algorithms.dfot_video import flagship, k600_dit_xl, make_train_apply

    # the recipes' 10000-step warm-up starts at rate 0: cut to 2 steps, as
    # the train paths of phases 8 and 13 do, so that the steps move the weights
    r = k600_dit_xl()
    r = r._replace(train=r.train._replace(num_warmup_steps=2))
    x_shape = (r.max_tokens, *r.resolution, r.x_channels)
    model = build_random_model(r, seed=70, token_io=False)
    out = run_remat_model(
        record, "xl", "K600 @DiT/XL", r, model, lambda B: latent_batch(x_shape, B, seed=71),
        lambda B: discrete_loss_fn(r.dcfg, make_train_apply(r), model,
                                   latent_batch(x_shape, B, seed=72), 73),
        dit_grad_probes(r.spec.depth, False) + (REMAT_CONTROL_PROBE["xl"],),
        lambda **kw: expected_dit_launches(model.dit_base.spec, **kw))
    del model
    gc.collect()
    import torch

    torch.cuda.empty_cache()
    fs = flagship()
    fs = fs._replace(spec=dataclasses.replace(fs.spec, **FLAGSHIP_CUT_DEPTH),
                     train=fs.train._replace(num_warmup_steps=2))
    model = build_random_model(fs, seed=74, token_io=False)
    out.update(run_remat_model(
        record, "flagship", "flagship (depth cut)", fs, model,
        lambda B: train_batch(fs, B, seed=75), lambda B: flagship_loss_fn(fs, model, B, 76),
        REMAT_FLAGSHIP_PROBES + (REMAT_CONTROL_PROBE["flagship"],),
        lambda **kw: expected_uvit_launches(fs._replace(spec=model.spec), **kw)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def write_minecraft_videos(root: Path, splits, res: int, seed: int) -> None:
    """Seeded videos in Minecraft's layout: ``<split>/v<i>.npy`` (T, H, W, C)
    uint8 with its actions in ``<split>/v<i>.npz``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for split, n, length in splits:
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            base = rng.integers(0, 256, (res, res, 3)).astype(np.uint8)
            video = np.stack([np.roll(base, 2 * t, axis=0) for t in range(length)])
            np.save(d / f"v{i}.npy", video)
            np.savez(d / f"v{i}.npz", actions=rng.integers(0, 4, length))


def vae_first_step_against_cpu(rec: dict, exp, videos, kind: str) -> None:
    """The card's first step against the CPU's in fp32 on one clip, from the
    same weights with the same posterior noise: with the reconstruction
    error squared (a smooth loss) its losses and autoencoder gradient within
    ``VAE_CPU_REL_TOL``; with the recipe's loss within ``VAE_CPU_SIGN_TOL``;
    on its first adversarial step within ``VAE_CPU_ADV_TOL``; the adaptive
    weight within ``VAE_CPU_WEIGHT_TOL``. Control: the CPU's adversarial step against the
    card's first."""
    import copy

    import torch
    from dfot_tpu_torch.vae import distribution as D
    from dfot_tpu_torch.vae.losses import BatchNorm

    clip = videos[:1, :VAE_CPU_FRAMES[kind], :VAE_CPU_CROP, :VAE_CPU_CROP]
    cpu = copy.copy(exp)
    cpu.device = torch.device("cpu")
    cpu.vae = copy.deepcopy(exp.vae).cpu()
    cpu.disc = copy.deepcopy(exp.disc).cpu()
    recipe = {k: v for k, v in exp.loss_cfg.items() if v is not None}
    noise = {}

    def pinned_sample(self, generator=None, eps=None):
        shape = tuple(self.mean.shape)
        if shape not in noise:
            noise[shape] = torch.randn(shape, generator=torch.Generator().manual_seed(230))
        return self.mean + self.std * noise[shape].to(self.mean.device)

    start = [copy.deepcopy(m.state_dict()) for m in (exp.vae, exp.disc)]
    runs = (("smooth", 0, {**recipe, "loss_type": "l2"}), ("first", 0, recipe),
            ("adversarial", VAE_DISC_START, recipe))
    results = {}
    with patched(D.DiagonalGaussian, "sample", pinned_sample):
        for e, x in ((exp, clip.cuda()), (cpu, clip)):
            for name, step, loss_cfg in runs:
                e.vae.load_state_dict(start[0])
                e.disc.load_state_dict(start[1])
                e.loss_cfg = loss_cfg
                e.prepare()
                metrics = {k: float(v) for k, v in e.train_step(x, step, []).items()}
                grad = torch.cat([p.grad.flatten().cpu() for p in e.vae.parameters()])
                results[(e.device.type, name)] = (metrics, grad)
    exp.loss_cfg = recipe

    check = {}
    for name, _, _ in runs:
        (got, g_got), (want, g_want) = results[("cuda", name)], results[("cpu", name)]
        check[name] = {"metric_rel_err": {k: abs(v - want[k]) / max(abs(want[k]), 1e-12)
                                          for k, v in got.items()},
                       "grad_rel_l2": rel_l2(g_got, g_want)}
    g_ctrl = rel_l2(results[("cpu", "adversarial")][1], results[("cuda", "first")][1])
    rec["cpu_check"] = {"frames": int(clip.shape[1]), **check, "control_grad_rel_l2": g_ctrl,
                        "tol": VAE_CPU_REL_TOL, "sign_tol": VAE_CPU_SIGN_TOL,
                        "adversarial_tol": VAE_CPU_ADV_TOL, "weight_tol": VAE_CPU_WEIGHT_TOL,
                        "cpu": results[("cpu", "first")][0]}
    log(f"  card vs CPU, fp32, 1 clip of {clip.shape[1]} frames (losses; AE gradient rel L2):")
    for name, c in check.items():
        log(f"    {name:11s} " + ", ".join(f"{k} {v:.2e}" for k, v in c["metric_rel_err"].items())
            + f"; gradient {c['grad_rel_l2']:.2e}")
    log(f"    control (the adversarial step against the first): {g_ctrl:.2e}; tol "
        f"{VAE_CPU_REL_TOL} (smooth), {VAE_CPU_SIGN_TOL} (the recipe's), {VAE_CPU_ADV_TOL} "
        f"(adversarial), d_weight {VAE_CPU_WEIGHT_TOL}")
    for name, c in check.items():
        tol = {"smooth": VAE_CPU_REL_TOL, "first": VAE_CPU_SIGN_TOL}.get(name, VAE_CPU_ADV_TOL)
        losses = {k: v for k, v in c["metric_rel_err"].items() if k != "d_weight"}
        require(all(v <= (VAE_CPU_REL_TOL if name != "adversarial" else VAE_CPU_WEIGHT_TOL)
                    for v in losses.values())
                and c["metric_rel_err"]["d_weight"] <= VAE_CPU_WEIGHT_TOL
                and c["grad_rel_l2"] <= tol,
                f"{kind} VAE {name} step off the CPU's: {c}")
    require(g_ctrl > 10 * VAE_CPU_SIGN_TOL, f"{kind} VAE step: the control passes ({g_ctrl})")

    # the discriminator's running statistics (ROADMAP.md C9): the batch
    # statistics one training forward of the clip's frames folds in, card
    # against CPU, within VAE_CPU_REL_TOL. Neither control moves d_weight or a
    # gradient (a training forward normalizes by the biased batch variance
    # in torch's BatchNorm2d too; the momentum enters only the running
    # statistics); each must miss here: torch's BatchNorm2d (the unbiased
    # batch variance, n / (n - 1)) and momentum 0.9
    def folded(e, x, make_bn=None):
        disc = copy.deepcopy(exp.disc).to(e.device)
        if make_bn is not None:
            for n in range(1, disc.n_layers + 1):
                bn = getattr(disc, f"bn{n}")
                setattr(disc, f"bn{n}", make_bn(bn.weight.numel()).to(e.device))
        disc.load_state_dict(start[1], strict=False)
        with torch.no_grad():
            disc(e._frames(e._layout(x) * 2.0 - 1.0), train=True)
        m = 0.99  # the port's (flax's) momentum
        out = {}
        for stat in ("mean", "var"):
            out[stat] = torch.cat([
                (getattr(getattr(disc, f"bn{n}"), f"running_{stat}").float().cpu()
                 - m * start[1][f"bn{n}.running_{stat}"].float().cpu()) / (1 - m)
                for n in range(1, disc.n_layers + 1)])
        return out

    want = folded(cpu, clip)
    got = folded(exp, clip.cuda())
    stats = {k: rel_l2(got[k], want[k]) for k in want}
    ctrl_stats = {}
    for label, make_bn in (("torch BatchNorm2d (unbiased variance)", TorchBatchNorm),
                           ("momentum 0.9", lambda c: BatchNorm(c, momentum=0.9))):
        c = folded(exp, clip.cuda(), make_bn)
        ctrl_stats[label] = {k: rel_l2(c[k], want[k]) for k in want}
    rec["cpu_check"]["running_stats"] = {"rel_l2": stats, "controls": ctrl_stats,
                                         "tol": VAE_CPU_REL_TOL}
    log(f"    discriminator statistics folded in (rel L2, tol {VAE_CPU_REL_TOL}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in stats.items()) + "; controls: "
        + "; ".join(f"{label} " + ", ".join(f"{k} {v:.2e}" for k, v in c.items())
                    for label, c in ctrl_stats.items()))
    require(all(v <= VAE_CPU_REL_TOL for v in stats.values()),
            f"{kind} VAE: the discriminator's statistics off the CPU's: {stats}")
    for label, c in ctrl_stats.items():
        require(max(c.values()) > VAE_CPU_REL_TOL,
                f"{kind} VAE: the statistics' bound passes the control '{label}': {c}")
    del cpu


def TorchBatchNorm(channels: int):
    """Control: torch's ``BatchNorm2d`` (it keeps the unbiased batch
    variance) at flax's momentum, called as the port's BatchNorm is."""
    import torch

    class _TorchBatchNorm(torch.nn.BatchNorm2d):
        def forward(self, x, train=False, update_stats=True):
            if train and not update_stats:
                return torch.nn.functional.batch_norm(x, None, None, self.weight, self.bias,
                                                      True, 0.0, self.eps)
            self.train(train)
            return super().forward(x)

    return _TorchBatchNorm(channels, momentum=0.01)


def run_vae_training(rec: dict, kind: str, argv: list, layout_ok) -> None:
    """One recipe's VAE training: the batch its memory allows (up to the
    recipe's, from two probing steps at 1 and 2 clips), the card's step
    against the CPU's, then ``run(argv)`` with every step's metrics and
    phases."""
    import statistics

    import numpy as np
    import torch
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.config import load_config
    from dfot_tpu_torch.data.loader import _collate
    from dfot_tpu_torch.data.video_dataset import build_dataset
    from dfot_tpu_torch.experiments import video_latent_learning as VL

    cfg = load_config(argv)
    recipe_batch = int(cfg.experiment.training.batch_size)
    exp = VL.VideoLatentLearningExperiment(cfg, str(ROOT / "build" / "vae_probe"), None, "cuda")
    n_params = sum(p.numel() for p in exp.vae.parameters())
    dataset = build_dataset(cfg.dataset, "training")
    videos = torch.as_tensor(_collate([dataset[i] for i in range(2)])["videos"])
    layout_ok(videos)
    peaks = []
    exp.prepare()
    for b in (1, 2):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        exp.train_step(videos[:b].cuda(), 0, [])
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    per_clip, fixed = peaks[1] - peaks[0], 2 * peaks[0] - peaks[1]
    total = torch.cuda.get_device_properties(0).total_memory
    B = max(1, min(recipe_batch, int((REMAT_MEMORY_SHARE * total - fixed) // per_clip)))
    log(f"  {n_params / 1e6:.1f}M-parameter VAE, clips {tuple(videos.shape[1:])}: "
        f"{per_clip / 2**30:.2f} GiB a clip over {fixed / 2**30:.2f} GiB (steps at 1 and 2 "
        f"clips); the recipe's batch {recipe_batch}, run at B={B}")
    vae_first_step_against_cpu(rec, exp, videos, "video" if exp.is_video else "image")
    del exp, dataset
    gc.collect()
    torch.cuda.empty_cache()

    steps = []
    real_step = VL.VideoLatentLearningExperiment.train_step

    def recording_step(self, v, step, marks):
        m = real_step(self, v, step, marks)
        steps.append({k: float(x) for k, x in m.items()})
        return m

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(VL.VideoLatentLearningExperiment, "train_step", recording_step):
        exp = run(argv + ([f"experiment.training.batch_size={B}"] if B != recipe_batch else []))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    walls, phases = exp.timings["step_wall_s"], exp.timings["phases_s"]
    later = walls[1:]
    rec.update({"batch": B, "recipe_batch": recipe_batch, "parameters": n_params,
                "frames_a_step": int(B * videos.shape[1]), "run_wall_s": wall,
                "step_wall_s": walls, "step_s_median": statistics.median(later),
                "phases_s": phases, "peak_memory_bytes": peak, "metrics": steps,
                "per_clip_bytes": per_clip, "fixed_bytes": fixed})
    mean = {k: statistics.mean(p[k] for p in phases[1:]) for k in phases[0]}
    log(f"  {len(walls)} steps at B={B} ({B * videos.shape[1]} frames a step): step wall "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, median after the first "
        f"{statistics.median(later):.3f} s; split (mean after the first): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in mean.items())
        + f"; peak memory {peak / 2**30:.2f} GiB")
    log("  d_weight by step " + ", ".join(f"{m['d_weight']:.4g}" for m in steps)
        + "; g_loss " + ", ".join(f"{m['g_loss']:.4g}" for m in steps))
    require(len(steps) == VAE_STEPS and all(np.isfinite(list(m.values())).all() for m in steps),
            f"{kind} VAE training: {steps}")
    require(all(m["d_total"] == 0 for m in steps[:VAE_DISC_START])
            and all(m["d_total"] > 0 and m["d_weight"] > 0 for m in steps[VAE_DISC_START:]),
            f"{kind} VAE training: the adversarial term before and after disc_start: {steps}")
    lines = _jsonl(Path(exp.output_dir))
    require([x["step"] for x in lines] == [1] and "d_weight" in lines[0],
            f"{kind} VAE training: metrics.jsonl {lines}")
    ckpt = Path(exp.output_dir) / "checkpoints" / f"checkpoint_{VAE_STEPS}" / "state.pt"
    require(ckpt.exists(), f"{kind} VAE training: no checkpoint at {ckpt}")
    del exp


def run_vae_preprocessing(rec: dict, name: str, argv: list) -> None:
    """A preprocessor through ``run(argv)``: the encode time a frame and the
    latent files' shapes."""
    import numpy as np
    import torch
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.experiments import video_latent_preprocessing as VP

    times, frames = [], []
    real = VP.VideoLatentPreprocessingExperiment._encode_video

    def timed(self, video, generator):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(self, video, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        frames.append(len(video))
        return out

    with patched(VP.VideoLatentPreprocessingExperiment, "_encode_video", timed):
        exp = run(argv)
    n_params = sum(p.numel() for p in exp.vae.parameters())
    data = Path(str(exp.cfg.dataset.save_dir) + f"_latent_{PRE_RES}")
    shapes = {f"{split}/{f.name}": list(np.load(f).shape)
              for split in ("training", "validation")
              for f in sorted((data / split).glob("v*.npy"))}
    ms = [1e3 * t / n for t, n in zip(times[1:], frames[1:])]
    rec.update({"parameters": n_params, "pretrained": exp.pretrained, "encode_s": times,
                "frames": frames, "encode_ms_a_frame": ms, "latent_shapes": shapes})
    log(f"  {name}: {n_params / 1e6:.1f}M parameters, seeded weights; encode "
        f"{', '.join(f'{m:.2f}' for m in ms)} ms a frame (after the first video); latents "
        + ", ".join(f"{k} {tuple(v)}" for k, v in list(shapes.items())[:2]))
    require(shapes and all(np.isfinite(np.load(f)).all() for f in data.rglob("v*.npy")),
            f"{name}: latents {shapes}")
    del exp


def run_slice15_paths(record: dict, smi: str) -> dict:
    """Phase 21: (a) the remat policies on K600 @DiT/XL and the flagship;
    (b) VAE training through ``run(argv)``: K600's VideoVAE and Minecraft's
    ImageVAE at full width on seeded directories in their layouts, the
    adversarial term from the third step on; (c) the TiTok-L and kl-f8
    preprocessors at their published widths."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    out = run_remat_paths(record)
    rec = record["vae"] = {"nvidia_smi": smi}
    root = ROOT / "build" / "vae"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    k600, mc = root / "k600", root / "minecraft"
    write_npz_videos(k600, K600_VAE_VIDEOS, VAE_RES, 210, raw_dir=True)
    write_minecraft_videos(mc, MINECRAFT_VAE_VIDEOS, VAE_RES, 211)
    common = ["experiment=video_latent_learning", "++dataset.latent.enabled=false",
              f"experiment.training.max_steps={VAE_STEPS}", "wandb.mode=disabled"]
    runs = (
        ("k600", "K600 VideoVAE", ["+name=k600_vae", "dataset=kinetics_600", "algorithm=video_vae",
                                   f"dataset.save_dir={k600}", "++dataset.video_preprocessing=npz",
                                   f"++algorithm.loss.disc_start={VAE_DISC_START}"],
         lambda v: require(tuple(v.shape[1:]) == (17, VAE_RES, VAE_RES, 3),
                           f"K600 clips {v.shape}")),
        ("minecraft", "Minecraft ImageVAE", ["+name=mc_vae", "dataset=minecraft",
                                             "algorithm=image_vae", f"dataset.save_dir={mc}",
                                             f"++algorithm.lossconfig.disc_start={VAE_DISC_START}"],
         lambda v: require(tuple(v.shape[1:]) == (16, VAE_RES, VAE_RES, 3),
                           f"Minecraft clips {v.shape}")),
    )
    for key, what, argv, layout_ok in runs:
        log(f"VAE training, {what} (experiment=video_latent_learning):")
        rec[key] = {}
        run_vae_training(rec[key], key, argv + common + [f"output_dir={root / 'runs'}"], layout_ok)
        gc.collect()
        torch.cuda.empty_cache()

    pre = root / "pre"
    write_npz_videos(pre, PRE_VIDEOS, PRE_RES, 212, actions=3)
    base = ["experiment=video_latent_preprocessing", "dataset=dmlab", f"dataset.resolution={PRE_RES}",
            "wandb.mode=disabled", f"output_dir={root / 'pre_runs'}"]
    for key, what, argv in (
            ("titok", "TiTok-L preprocessor", ["+name=titok", "algorithm=titok_kl_preprocessor"]),
            ("kl_f8", "kl-f8 preprocessor", ["+name=kl_f8", "algorithm=kl_autoencoder_preprocessor"])):
        data = root / f"pre_{key}"
        shutil.copytree(pre, data)
        rec[key] = {}
        run_vae_preprocessing(rec[key], what, argv + base + [f"dataset.save_dir={data}"])
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "vae_probe", ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 21: {rec['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: UNet3D, the difference DFoT, FAR-DiT and DiT1D (ROADMAP.md A14)
# ---------------------------------------------------------------------------

UNET3D_ARGV = UCF_LATENT + ["algorithm/backbone=u_net3d", "++dataset.latent.enabled=false"]
DIFF_ARGV = ["+name=ucf", "dataset=ucf_101", "algorithm=difference_dfot_video",
             "experiment=video_generation"]
DIFF_B_ARGV = DIFF_ARGV + ["@DiffDiT/B"]
DIFF_FACMAT_ARGV = DIFF_ARGV + ["algorithm/backbone=difference_dit3d_factorized_matrix"]
FAR_ARGV = UCF_LATENT + ["algorithm/backbone=far_dit", "@FARDiT/B"]
# taichi's (4, 1, 32) TiTok tokens as the observation shape: the composed
# recipe hands the algorithm (32, 32, 4) latents (ROADMAP.md C11)
DIT1D_ARGV = ["+name=taichi", "dataset=taichi", "algorithm=dfot_video",
              "experiment=video_generation", "algorithm/backbone=dit1d",
              "++dataset.latent.enabled=false", "dataset.observation_shape=[4,1,32]"]
PHASE22_TRAIN_STEPS = 2
# the forward + backward route checks' batch (videos)
PHASE22_GRAD_BATCH = 2
# bf16 under autocast on the card against the same model's fp32 forward on
# the card (TF32 off), relative L2: a full model's chain of bf16 roundings
# (a CPU rehearsal at reduced widths read 1.5e-2 and 2.0e-2); the controls
# read 0.33 (FAR-DiT without its causal bias) and 0.82 (DiT1D's reproduce
# blocks) there
FP32_REL_TOL = 1e-1
# the parameters each einsum model's train steps must move
PHASE22_PROBES = {
    "far": ("x_embedder.weight", "transformer_blocks.0.attn.to_q.weight",
            "transformer_blocks.6.mlp.net.2.weight", "transformer_blocks.11.norm1.linear.weight",
            "proj_out.weight"),
    "dit1d": ("x_embedder.weight", "blocks.0.attn.qkv.weight", "blocks.14.mlp.fc1.weight",
              "blocks.27.adaLN_modulation.1.weight", "final_layer.1.weight"),
}
# python -m dfot_tpu_torch on UNet3D from a seeded DMLab-layout directory
UNET3D_CLI_VIDEOS = (("training", 8, 20), ("validation", 2, 20))


def expected_unet3d_launches(algo):
    """Launches of the algorithm's UNet3D: each softmax spatial attention
    whose rows take the flash route (:func:`attention_route`; level i of a
    ``res``-pixel model has (res / 2^i)^2 tokens, the mid block those of the
    last level) runs B1 once a forward and B4, B5 once a backward (no
    checkpointing); the temporal and the linear attention launch none."""
    from dfot_tpu_torch.ops.attention import attention_route

    s, res = algo.model.spec, algo.x_shape[0]
    n = len(s.dim_mults)
    factors = {res // r for r in s.attn_resolutions}
    tokens = [(res >> (n - 1)) ** 2]  # the mid block's
    for i in range(n):
        # a level's down and up blocks: linear wherever configured but the deepest
        if 2 ** i in factors and not (s.use_linear_attn and i < n - 1):
            tokens += [(res >> i) ** 2] * 2
    sites = sum(attention_route(N, s.attn_dim_head) in ("flash", "padded_flash") for N in tokens)

    def expected(spec, forwards: int = 0, train_steps: int = 0) -> dict:
        out = no_launches()
        out["flash_fwd"] = sites * (forwards + train_steps)
        out["flash_bwd_dq"] = out["flash_bwd_dkv"] = sites * train_steps
        return out

    return expected


def expected_difference_launches(algo):
    """Launches of the difference DiT on the merged 2T frames: DiTBase runs
    the model's T frames as video and the other T as single-frame images
    (its joint image-video split, as the JAX model does). The full variant's
    video call takes the packed route (B2, B1, B3 a block; B4-B7 back), its
    image call rows of P tokens (B10 a block where :func:`attention_route`
    gives them to it, a plain backward), each call B8 a block and in its
    final layer (B9 back), the blocks' share twice under checkpointing. The
    factorized-matrix variant: twice the matrix DiT's
    (:func:`expected_matrix_launches`), its spatial rows of P tokens on B10
    where the route takes them (heads of 32 take the plain route)."""
    from dfot_tpu_torch.ops.attention import attention_route

    h, w, _ = algo.x_shape
    p = algo.model.spec.patch_size
    small_n = attention_route((h // p) * (w // p), algo.model.spec.hidden_size
                              // algo.model.spec.num_heads) == "small_n"

    def expected(spec, forwards: int = 0, train_steps: int = 0) -> dict:
        if spec.variant != "full":
            out = {k: 2 * v for k, v in
                   expected_matrix_launches(spec, forwards, train_steps).items()}
        else:
            d = spec.depth
            per_block = 2 if spec.spatial_mlp_ratio else 1
            again = 2 if spec.use_gradient_checkpointing else 1
            out = no_launches()
            out["ln_modulate"] = 2 * (forwards * (per_block * d + 1)
                                      + train_steps * (again * per_block * d + 1))
            out["ln_modulate_bwd"] = 2 * train_steps * (per_block * d + 1)
            for name in ATTENTION_KERNELS:
                out[name] = ((forwards + again * train_steps) * d if name in FORWARD_KERNELS
                             else train_steps * d)
            out["small_n_attn"] = (forwards + again * train_steps) * d
        if not small_n:
            out["small_n_attn"] = 0
        return out

    return expected


def expected_none(spec, forwards: int = 0, train_steps: int = 0) -> dict:
    """FAR-DiT and DiT1D: einsum attention, no kernel (none in JAX either)."""
    return no_launches()


def difference_window(algo, B: int, seed: int):
    """The difference DFoT's validation window: B videos of max_tokens
    frames generated from nothing (UCF-101 has no context) on the merged
    stream of twice the frames; the frames come back."""
    import torch

    algo.merged_rollout.stats = {"denoiser_evals_b1": 0, "windows": 0}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.zeros(B, algo.max_tokens, *algo.x_shape, device="cuda")
    return algo.sample_videos(gen, xs, n_context_tokens=0)["prediction"]


def fitting_batch(what: str, algo, cfg, seed: int) -> int:
    """The recipe's training batch, or the largest that stays under
    ``REMAT_MEMORY_SHARE`` of the card by two probing steps at 1 and 2
    videos (printed)."""
    import torch

    recipe = cfg.experiment.training.batch_size
    state = algo.make_train_state()
    step = algo.make_train_step()
    peaks = []
    for b in (1, 2):
        batch = latent_batch((algo.max_tokens, *algo.x_shape), b, seed)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch, torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    per, fixed = peaks[1] - peaks[0], 2 * peaks[0] - peaks[1]
    total = torch.cuda.get_device_properties(0).total_memory
    B = max(1, min(recipe, int((REMAT_MEMORY_SHARE * total - fixed) // max(per, 1))))
    log(f"  {what}: {per / 2**30:.3f} GiB a video over {fixed / 2**30:.2f} GiB (steps at 1 and 2 "
        f"videos); the recipe's batch {recipe}, run at B={B}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return B


def fp32_check(record: dict, key: str, what: str, model, run, controls: dict) -> None:
    """The model under bf16 autocast (``run(True)``) against its fp32
    forward on the card (``run(False)``), within FP32_REL_TOL; no control
    (label -> context manager, each under bf16) may be."""
    import torch

    with torch.no_grad():
        out_b, out_f = run(True), run(False)
        ctrl = {}
        for label, control in controls.items():
            with control():
                ctrl[label] = rel_l2(run(True), out_f)
    err = rel_l2(out_b, out_f)
    record[key] = {"rel_l2": err, "control_rel_l2": ctrl, "tol": FP32_REL_TOL,
                   "shape": list(out_b.shape)}
    log(f"{what}, bf16 vs fp32 on the card: rel L2 {err:.3e} (tol {FP32_REL_TOL}); controls: "
        + "; ".join(f"{label} {c:.3e}" for label, c in ctrl.items()))
    require(bool(torch.isfinite(out_b).all()), f"{what}: non-finite output")
    require(err <= FP32_REL_TOL, f"{what}: bf16 off fp32 by {err}")
    for label, c in ctrl.items():
        require(c > FP32_REL_TOL, f"{what}: the bound passes the control '{label}' ({c})")


def plain_rope_table(model, frames: int):
    """Control for the doubled table: every block of ``model``'s DiT rotates
    with the plain 3-D table over ``frames`` frames."""
    from dfot_tpu_torch.models.embeddings import RopeTables, make_rope_3d

    base = model.dit_base
    tables = RopeTables(make_rope_3d(base.spec.hidden_size // base.spec.num_heads,
                                     (frames,) + tuple(model.grid)))

    @contextlib.contextmanager
    def control():
        real = [b.attn.rope for b in base.blocks]
        for b in base.blocks:
            b.attn.rope = tables
        try:
            yield
        finally:
            for b, r in zip(base.blocks, real):
                b.attn.rope = r

    return control


def model_line(what: str, algo, record: dict, key: str) -> None:
    n_params = sum(p.numel() for p in algo.model.parameters())
    record[key] = {"parameters": n_params, "x_shape": list(algo.x_shape),
                   "max_tokens": algo.max_tokens}
    log(f"{what}: {n_params / 1e6:.2f}M parameters, tokens {algo.x_shape} x {algo.max_tokens} "
        f"frames, seeded random fp32 weights under bf16 autocast")


def run_unet3d_paths(record: dict) -> dict:
    """(a) UNet3D (``algorithm/backbone=u_net3d`` on ucf_101 pixels, 64 px,
    16 frames): the kernel route against the plain route, forward at the
    validation batch and forward + backward at PHASE22_GRAD_BATCH, with
    controls (attention scaled for heads of 64; dq zero); the 50-step window
    at the validation batch; train steps at the recipe's batch or the
    largest that fits."""
    import torch
    from dfot_tpu_torch.models import unet3d as U

    out = {}
    algo, cfg = build_matrix_algorithm(UNET3D_ARGV, seed=110)
    model = algo.model
    model_line("UNet3D (u_net3d on UCF-101 pixels)", algo, record, "unet3d_model")
    expected = expected_unet3d_launches(algo)
    B = cfg.experiment.validation.batch_size
    batch = latent_batch((algo.max_tokens, *algo.x_shape), B, seed=111)
    gen = torch.Generator(device="cuda").manual_seed(112)
    k = torch.randint(0, algo.dcfg.timesteps, (B, algo.max_tokens), generator=gen, device="cuda")
    wide = lambda q, k_, v, causal=False, plain=False: attention_scaled_for_twice_the_width(  # noqa: E731
        q, k_, v, causal)
    with torch.no_grad():
        check_route(record, "unet3d_forward", f"UNet3D forward B={B}", FORWARD_REL_TOL,
                    model.use_plain_kernels, lambda: autocast_apply(model, batch["xs"], k),
                    {"attention scaled for heads of 64": lambda: patched(U, "attention", wide)})
    del batch
    small = latent_batch((algo.max_tokens, *algo.x_shape), PHASE22_GRAD_BATCH, seed=113)
    probes = ("init_conv.weight", "down_blocks.2.0.2.wrapper.module.attn.to_qkv.weight",
              "mid_block.1.wrapper.module.attn.to_qkv.weight",
              "up_blocks.1.2.wrapper.module.attn.to_qkv.weight",
              "mid_block.2.wrapper.module.attn_block.attn.to_qkv.weight", "out.1.weight")
    gradient_routes(record, "unet3d_gradient_route",
                    f"UNet3D forward + backward B={PHASE22_GRAD_BATCH}", model,
                    model.use_plain_kernels,
                    discrete_loss_fn(algo.dcfg, autocast_apply, model, small, 114), probes,
                    control_zero_dq, must_reject=("wrapper.module.attn.to_qkv.weight",))
    out["unet3d_window"] = matrix_window(record, "unet3d_window", "UNet3D", algo, B, 115,
                                        expected=expected)
    Bt = fitting_batch("UNet3D train step", algo, cfg, 116)
    out["unet3d_train"] = matrix_train(record, "unet3d_train", "UNet3D train step", algo, cfg,
                                       117, PHASE22_TRAIN_STEPS, expected=expected,
                                       probes=probes, B=Bt)["launches"]
    record["unet3d_train"]["recipe_batch"] = cfg.experiment.training.batch_size
    del algo, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_difference_paths(record: dict) -> dict:
    """(b) The difference DFoT (``algorithm=difference_dfot_video`` on UCF-101
    latents, 8 x 8 x 32, patch 2): @DiffDiT/B with each merge, the kernel
    route against the plain route on the merged stream (forward, and forward
    + backward with dq zeroed as the control; the interleaved merge also
    against the plain 3-D table over the 2T frames), the window and train
    steps; the factorized-matrix leaf's window and one step."""
    import torch

    out = {}
    for merge in ("concat", "interleaved"):
        key = f"diff_{merge}"
        algo, cfg = build_matrix_algorithm(
            DIFF_B_ARGV + [f"++algorithm.backbone.merge_type={merge}"], seed=120)
        model, spec = algo.model, algo.model.spec
        model_line(f"difference DiT (@DiffDiT/B, {merge})", algo, record, f"{key}_model")
        B = cfg.experiment.validation.batch_size
        xs = latent_batch((algo.max_tokens, *algo.x_shape), B, seed=121)["xs"]
        merged = algo.merge(algo.differences(xs), xs)
        gen = torch.Generator(device="cuda").manual_seed(122)
        k = torch.randint(0, algo.dcfg.timesteps, merged.shape[:2], generator=gen, device="cuda")
        with torch.no_grad():
            check_route(record, f"{key}_forward", f"difference DiT ({merge}) forward B={B}",
                        FORWARD_REL_TOL, model.use_plain_kernels,
                        lambda: autocast_apply(model, merged, k), dit_controls())
            # the doubled table's control, on the first T merged frames (the
            # rest run as single-frame images, which read the table's first
            # P rows only): the plain 3-D table over 2T frames. The concat
            # merge's first T frames read the first copy, the plain table's
            # first T frames: the same rows, recorded and not required
            T = algo.max_tokens
            sound = autocast_apply(model, merged, k)[:, :T]
            with plain_rope_table(model, 2 * T)():
                ctrl = rel_l2(autocast_apply(model, merged, k)[:, :T], sound)
            record[f"{key}_forward"]["table_control_rel_l2"] = ctrl
            log(f"  the plain 3-D table over 2T frames in place of the doubled one, on the "
                f"first {T} merged frames: rel L2 {ctrl:.3e} (tol {FORWARD_REL_TOL})")
            require(merge == "concat" or ctrl > FORWARD_REL_TOL,
                    f"difference DiT ({merge}): the bound passes the plain table ({ctrl})")
        del xs, merged
        small = latent_batch((2 * algo.max_tokens, *algo.x_shape), PHASE22_GRAD_BATCH, seed=123)
        d = spec.depth
        probes = ("dit_base.blocks.0.attn.qkv.weight", f"dit_base.blocks.{d // 2}.attn.proj.weight",
                  f"dit_base.blocks.{d - 1}.norm1.modulation.1.weight",
                  "dit_base.final_layer.linear.weight")
        gradient_routes(record, f"{key}_gradient_route",
                        f"difference DiT ({merge}) forward + backward B={PHASE22_GRAD_BATCH}",
                        model, model.use_plain_kernels,
                        discrete_loss_fn(algo.dcfg, autocast_apply, model, small, 124), probes,
                        control_zero_dq, must_reject=("blocks.0.attn.qkv.weight",))
        out[f"{key}_window"] = matrix_window(record, f"{key}_window",
                                             f"difference DiT ({merge})", algo, B, 125,
                                             expected=expected_difference_launches(algo),
                                             run=difference_window)
        out[f"{key}_train"] = matrix_train(record, f"{key}_train",
                                           f"difference DiT ({merge}) train step", algo, cfg, 126,
                                           PHASE22_TRAIN_STEPS,
                                           expected=expected_difference_launches(algo),
                                           probes=probes)["launches"]
        log(f"  diff_loss {record[f'{key}_train']['diff_loss']}, xs_loss "
            f"{record[f'{key}_train']['xs_loss']}")
        del algo, model
        gc.collect()
        torch.cuda.empty_cache()

    algo, cfg = build_matrix_algorithm(DIFF_FACMAT_ARGV, seed=127)
    model_line("difference FacMatDiT (difference_dit3d_factorized_matrix, interleaved)", algo,
               record, "diff_facmat_model")
    B = cfg.experiment.validation.batch_size
    out["diff_facmat_window"] = matrix_window(record, "diff_facmat_window",
                                              "difference FacMatDiT", algo, B, 128,
                                              expected=expected_difference_launches(algo),
                                              run=difference_window)
    out["diff_facmat_train"] = matrix_train(record, "diff_facmat_train",
                                            "difference FacMatDiT train step", algo, cfg, 129, 1,
                                            expected=expected_difference_launches(algo))["launches"]
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_einsum_paths(record: dict) -> dict:
    """(c) FAR-DiT (@FARDiT/B on UCF-101 latents) and DiT1D (its published
    widths, 1152 wide, depth 28, on taichi's (4, 1, 32) tokens): each at
    bf16 against fp32 on the card with a control (FAR-DiT without its
    frame-causal bias; DiT1D with ``reproduce`` blocks in place of
    ``share_norm``), the window at the validation batch and train steps,
    launching no kernel."""
    import torch

    out = {}
    for key, what, argv, seed in (("far", "FAR-DiT (@FARDiT/B)", FAR_ARGV, 130),
                                  ("dit1d", "DiT1D (taichi tokens)", DIT1D_ARGV, 140)):
        algo, cfg = build_matrix_algorithm(argv, seed=seed)
        model = algo.model
        model_line(what, algo, record, f"{key}_model")
        B = cfg.experiment.validation.batch_size
        xs = latent_batch((algo.max_tokens, *algo.x_shape), min(B, 8), seed=seed + 1)["xs"]
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        k = torch.randint(0, algo.dcfg.timesteps, xs.shape[:2], generator=gen, device="cuda")

        def run(bf16, model=model, xs=xs, k=k):
            if bf16:
                return autocast_apply(model, xs, k)
            return model(xs, k.float()).float()

        if key == "far":
            controls = {"no frame-causal bias": lambda m=model: patched(
                m, "causal_bias", lambda T, P, device: torch.zeros((), device=device))}
        else:
            @contextlib.contextmanager
            def reproduce(m=model):
                for b in m.blocks:
                    b.merge_mode = "reproduce"
                try:
                    yield
                finally:
                    for b in m.blocks:
                        b.merge_mode = "share_norm"

            controls = {"reproduce blocks in place of share_norm": reproduce}
        fp32_check(record, f"{key}_fp32", f"{what} forward B={xs.shape[0]}", model, run, controls)
        del xs
        probes = PHASE22_PROBES[key]
        out[f"{key}_window"] = matrix_window(record, f"{key}_window", what, algo, B, seed + 3,
                                             expected=expected_none)
        out[f"{key}_train"] = matrix_train(record, f"{key}_train", f"{what} train step", algo, cfg,
                                           seed + 4, PHASE22_TRAIN_STEPS, expected=expected_none,
                                           probes=probes)["launches"]
        del algo, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_unet3d_cli(record: dict) -> dict:
    """(d) ``python -m dfot_tpu_torch`` on UNet3D: training and validation
    through ``run(argv)`` from a seeded DMLab-layout directory (64 px,
    actions), two steps, the launch counts reset before and read after."""
    import shutil

    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.__main__ import run

    root = ROOT / "build" / "unet3d_cli"
    shutil.rmtree(root, ignore_errors=True)
    write_npz_videos(root / "dmlab", UNET3D_CLI_VIDEOS, 64, 150, actions=3)
    argv = ["+name=unet3d_cli", "dataset=dmlab", "algorithm=dfot_video",
            "experiment=video_generation", "algorithm/backbone=u_net3d",
            f"dataset.save_dir={root / 'dmlab'}", "++dataset.latent.enabled=false",
            "experiment.tasks=[training,validation]", "experiment.training.max_steps=2",
            "experiment.training.batch_size=4", "experiment.training.data.num_workers=0",
            "++algorithm.logging.loss_freq=1", "experiment.validation.batch_size=2",
            "experiment.validation.limit_batch=1", "experiment.validation.data.num_workers=0",
            "algorithm.diffusion.sampling_timesteps=10", "++algorithm.logging.max_num_videos=0",
            "++algorithm.logging.metrics=[mse,ssim,psnr]",  # for time: phases 17, 23 run the lists
            "wandb.mode=disabled", f"output_dir={root / 'runs'}"]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    exp = run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    lines = _jsonl(Path(exp.output_dir))
    losses = [x["loss"] for x in lines if "loss" in x]
    metrics = {k: v for x in lines for k, v in x.items() if "/" in k}
    record["unet3d_cli"] = {"wall_s": wall, "losses": losses, "metrics": metrics,
                            "launches": launches, "steps": exp.state.step}
    log(f"python -m dfot_tpu_torch, UNet3D on DMLab pixels: {wall:.2f} s wall (2 train steps, "
        f"1 validation batch); losses {losses}; metrics {metrics}; launches {launches}")
    require(exp.state.step == 2 and len(losses) == 2 and all(map(math.isfinite, losses)),
            f"UNet3D CLI: steps {exp.state.step}, losses {losses}")
    require(metrics and all(map(math.isfinite, metrics.values())), f"UNet3D CLI: {metrics}")
    require(all(launches[n] > 0 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
            and not any(v for n, v in launches.items()
                        if n not in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
            f"UNet3D CLI: launches {launches}")
    del exp
    shutil.rmtree(root, ignore_errors=True)
    return launches


def run_slice16_paths(record: dict) -> dict:
    """Phase 22: UNet3D, the difference DFoT, FAR-DiT and DiT1D through
    ``build_algorithm(load_config(argv))`` at full width on seeded random
    weights, and UNet3D through ``python -m dfot_tpu_torch``."""
    import torch

    t_phase = time.perf_counter()
    out = run_unet3d_paths(record)
    out.update(run_difference_paths(record))
    out.update(run_einsum_paths(record))
    out["unet3d_cli"] = run_unet3d_cli(record)
    gc.collect()
    torch.cuda.empty_cache()
    record["phase22_seconds"] = time.perf_counter() - t_phase
    log(f"  phase 22: {record['phase22_seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 23: the metric suite (ROADMAP.md A15a and the weight-free A15b)
# ---------------------------------------------------------------------------

# each frozen network on the card against the same network on the CPU, fp32
# with TF32 off: relative L2 of the outputs (cuDNN's and the CPU's
# convolution algorithms sum in other orders)
METRIC_CPU_REL_TOL = 1e-4
# the flagship validation's videos: batch 2, 8 frames of 256 px
METRIC_VIDEOS = (CLI_BATCH, 8, 256, 256, 3)
# K600's composed list (kinetics_600_video_generation.yaml:25) and the names
# it logs without metric weight files
K600_METRICS = ("vbench", "fvd", "is", "fid", "lpips", "mse", "ssim", "psnr")
K600_METRIC_NAMES = ("mse", "psnr", "ssim", "lpips_uncalibrated", "fvd_uncalibrated",
                     "fid_uncalibrated", "is_uncalibrated")
VBENCH_DIM_NAMES = ("subject_consistency_uncalibrated", "background_consistency_uncalibrated",
                    "temporal_flickering", "motion_smoothness_uncalibrated",
                    "dynamic_degree_uncalibrated", "aesthetic_quality_uncalibrated",
                    "quality_score")
FVMD_FRAMES = 16
# tensors one phase hands to a later one (the JSON record holds none)
CARRIED: dict = {}


def witness_weights(net, seed: int):
    """Seeded weights under which a deep random network's output follows its
    input: the registry's fallback law with He-scaled conv and dense
    weights, norm scales 1 + 0.2 N, biases 0.02 N, running means 0.02 N,
    running variances U(0.5, 1.5)."""
    import torch
    from dfot_tpu_torch.metrics.registry import seeded_init

    g = torch.Generator().manual_seed(seed)
    seeded_init(net, g)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.ndim >= 2 and name.endswith("weight"):
                p.mul_(2**0.5)
            elif p.ndim == 1 and name.endswith("weight"):
                p.add_(0.2 * torch.randn(p.shape, generator=g))
            elif "bias" in name:
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
        for name, b in net.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.02 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    return net.eval().requires_grad_(False)


def symmetric_same_pads(sizes, kernel, strides):
    """The control of I3D's padding: k // 2 on both sides (``Conv3d(padding=3)``)."""
    return tuple(p for k in reversed(kernel) for p in (k // 2, k // 2))


def frozen_network_cases(frames):
    """name -> (CPU network, inputs on the CPU, forward, control): each
    network of the metric suite on seeded witness weights, its inputs made
    from the flagship validation's seeded frames as the registry makes them,
    and a control that changes the card's copy."""
    import torch
    from dfot_tpu_torch.metrics import encoders as E
    from dfot_tpu_torch.metrics import i3d as I
    from dfot_tpu_torch.metrics.inception import InceptionV3, inception_preprocess
    from dfot_tpu_torch.metrics.video_metric import VideoMetric
    from dfot_tpu_torch.vae.losses import LPIPS

    B, T = METRIC_VIDEOS[:2]
    flat = frames.reshape((B * T,) + tuple(frames.shape[2:]))
    shifted = torch.roll(flat, 3, dims=2)  # LPIPS pairs: each frame and itself moved

    def bn_stat(attr):
        def control(net):
            getattr(net, attr).bn.running_mean.add_(0.5)
        return control

    def scale(path):
        def control(net):
            module = net
            for part in path.split("."):
                module = getattr(module, part)
            module.weight.mul_(1.5)
        return control

    def i3d_control(net):
        I.same_pads = symmetric_same_pads

    return {
        "i3d": (witness_weights(I.I3D(), 230), (VideoMetric._pad_to_min_frames(frames, 9),),
                lambda net, x: torch.cat(net(x), dim=1), i3d_control),
        "inception": (witness_weights(InceptionV3(), 231), (inception_preprocess(flat),),
                      lambda net, x: net(x)[0], bn_stat("Conv2d_1a_3x3")),
        "lpips": (witness_weights(LPIPS(), 232),
                  (flat.permute(0, 3, 1, 2) * 2 - 1, shifted.permute(0, 3, 1, 2) * 2 - 1),
                  lambda net, a, b: net(a, b), scale("lin0")),
        "clip_b32": (witness_weights(E.CLIPVisionEncoder(E.CLIP_B32), 233),
                     (E.clip_preprocess(flat),), lambda net, x: net(x), scale("ln_pre")),
        "clip_l14": (witness_weights(E.CLIPVisionEncoder(E.CLIP_L14), 234),
                     (E.clip_preprocess(flat),), lambda net, x: net(x), scale("ln_pre")),
        "dino": (witness_weights(E.DINOEncoder(E.DINO_B16), 235), (E.dino_preprocess(flat),),
                 lambda net, x: net(x), scale("blocks.0.norm1")),
    }


def check_frozen_networks(rec: dict) -> None:
    """(a) Each frozen network on the card against the CPU, fp32 with TF32
    off, at the flagship validation's batch, and its control; (d) each
    network's time a call on the card."""
    import copy

    import torch
    from dfot_tpu_torch.metrics import i3d as I
    from dfot_tpu_torch.metrics.registry import frozen_math

    gen = torch.Generator().manual_seed(236)
    frames = torch.rand(METRIC_VIDEOS, generator=gen)
    cpu, card = torch.device("cpu"), torch.device("cuda")
    with frozen_math(cpu):
        cases = frozen_network_cases(frames)
    rec["networks"] = {}
    log(f"  frozen networks, card against CPU (fp32, TF32 off, relative L2 tol "
        f"{METRIC_CPU_REL_TOL:g}), inputs from {tuple(METRIC_VIDEOS)} seeded frames:")
    for name, (net, inputs, forward, control) in cases.items():
        t0 = time.perf_counter()
        with frozen_math(cpu):
            want = forward(net, *inputs)
        cpu_s = time.perf_counter() - t0
        dev = copy.deepcopy(net).to(card)
        require(all(p.device.type == "cuda" for p in dev.parameters()),
                f"{name}: parameters off the card")
        x = tuple(i.to(card) for i in inputs)
        with frozen_math(card):
            got = forward(dev, *x)
            ms = cuda_ms(lambda: forward(dev, *x), reps=3, warmup=1)
        err = rel_l2(got.cpu(), want)
        real_pads = I.same_pads
        try:
            with torch.no_grad():
                control(dev)
            with frozen_math(card):
                ctl = rel_l2(forward(dev, *x).cpu(), want)
        finally:
            I.same_pads = real_pads
        n_params = sum(p.numel() for p in net.parameters())
        rec["networks"][name] = {"rel_l2": err, "control_rel_l2": ctl, "card_ms": ms,
                                 "cpu_s": cpu_s, "params": n_params,
                                 "input_shapes": [list(i.shape) for i in inputs],
                                 "output_shape": list(got.shape)}
        log(f"    {name:10s} {n_params / 1e6:7.2f} M params, in {[tuple(i.shape) for i in inputs]}"
            f" out {tuple(got.shape)}: rel L2 {err:.2e}, control {ctl:.2e}; "
            f"{ms:.2f} ms a call on the card, {cpu_s:.2f} s on the CPU")
        require(bool(torch.isfinite(got).all()) and err <= METRIC_CPU_REL_TOL,
                f"{name} on the card is off the CPU by {err:.3e}")
        require(ctl > METRIC_CPU_REL_TOL, f"{name}: the control passes ({ctl:.3e})")
        del dev, x, got
    del cases
    gc.collect()
    torch.cuda.empty_cache()


def report_host_math(rec: dict) -> None:
    """(d) The host's Frechet distances (``scipy.linalg.sqrtm`` at FID's 2048
    and FVD's 400 dimensions) and Inception Score in K600's validation,
    apart from the networks' passes on the card."""
    split = rec["k600"]["metrics_split_s"]
    rec["host_math_s"] = {m: split[f"{m}_host"] for m in ("fid", "fvd", "is")}
    log(f"  host math at log(): FID's Frechet distance (2048^2 sqrtm) {split['fid_host']:.3f} s, "
        f"FVD's (400^2) {split['fvd_host']:.3f} s, IS {split['is_host']:.4f} s "
        f"({os.cpu_count()} host cores); the networks' passes: "
        + ", ".join(f"{m} {split[m]:.3f} s" for m in ("fvd", "fid", "lpips", "vbench")))


def run_k600_metrics(rec: dict, weights_dir=None, key: str = "k600"):
    """(b) K600's validation as composed, ``[vbench, fvd, is, fid, lpips,
    mse, ssim, psnr]``, through ``run(argv)`` on the latent path as phase 20
    sets it up (@DiT/XL at depth 4 on seeded random weights, the online
    VideoVAE, a K600-layout directory, batch 2, one batch); with
    ``weights_dir`` its ``algorithm.logging.metrics_weights_dir``, whose
    ``amt.npz`` and ``raft.npz`` VBench's motion_smoothness and
    dynamic_degree then score with. Returns the run's launch counts and
    the experiment."""
    import shutil

    import numpy as np
    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.algorithms import dfot_video as DV
    from dfot_tpu_torch.config import load_config
    from dfot_tpu_torch.utils.weights import init_random_weights

    root = ROOT / "build" / key
    shutil.rmtree(root, ignore_errors=True)
    data, ckpt = root / "k600", root / "dit.ckpt"
    write_npz_videos(data, K600_VIDEOS[1:], K600_RES, 238, raw_dir=True)
    weights = ([] if weights_dir is None
               else [f"++algorithm.logging.metrics_weights_dir={weights_dir}"])
    argv = ["+name=k600_metrics"] + K600_ARGV + weights + [
        f"dataset.save_dir={data}", "++dataset.video_preprocessing=npz",
        "algorithm.vae.pretrained_path=null", f"++algorithm.backbone.depth={K600_DEPTH}",
        "experiment.tasks=[validation]", "experiment.validation.batch_size=2",
        "experiment.validation.limit_batch=1", "++algorithm.logging.max_num_videos=0",
        f"output_dir={root / 'runs'}"]
    cfg = load_config(argv)
    require(tuple(cfg.algorithm.logging.metrics) == K600_METRICS,
            f"K600 composes the metrics {cfg.algorithm.logging.metrics}")
    algo = DV.build_algorithm(cfg, device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(239))
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in algo.model.state_dict().items()}}, ckpt)
    del algo
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    exp = run(argv + [f"load={ckpt}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    require(all(launches[k] > 0 for k in FORWARD_KERNELS + ("ln_modulate",)),
            f"K600's validation sampled off the kernels: {launches}")
    metrics = exp.last_metrics
    dims = VBENCH_DIM_NAMES if weights_dir is None else tuple(
        d.replace("_uncalibrated", "") if d.split("_un")[0] in A15C_VBENCH_DIMS else d
        for d in VBENCH_DIM_NAMES)
    keys = [f"validation/prediction/{m}" for m in K600_METRIC_NAMES] + [
        f"validation/prediction/vbench/{d}" for d in dims]
    require(list(metrics) == keys and all(np.isfinite(list(metrics.values()))),
            f"K600 validation logged {metrics}, not the composed list's {keys}")
    require_registry_on_card(exp._registry, ("i3d", "lpips", "inception", "clip_b32", "clip_l14",
                                             "dino", "laion"), "K600's validation")
    if weights_dir is not None:
        require_registry_on_card(exp._registry, ("amt", "raft"), "K600's validation",
                                 calibrated=True)
    pred = exp.last_videos["prediction"]
    t = exp.timings
    rec[key] = {"argv": argv, "wall_s": wall, "metrics": metrics, "launches": launches,
                   "sampling_s": t["sampling_s"], "metrics_s": t["metrics_s"],
                   "metrics_split_s": t["metrics_split_s"], "decoded_shape": list(pred.shape)}
    log(f"  K600 validation as composed (@DiT/XL depth {K600_DEPTH}, batch 2, decoded "
        f"{tuple(pred.shape)}): {wall:.2f} s wall, sampling {t['sampling_s']:.2f} s, metrics "
        f"{t['metrics_s']:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in
                                            t["metrics_split_s"].items()) + ")")
    log("    " + ", ".join(f"{k.split('prediction/', 1)[1]} {v:.5g}" for k, v in metrics.items()))
    del pred
    shutil.rmtree(root, ignore_errors=True)
    return launches, exp


def run_fvmd(rec: dict, clips, source: str) -> None:
    """(c) ``VideoMetric(["fvmd"])`` on two 16-frame clips (ground truth the
    first, prediction the second) on the card, and the clips' motion
    features with the tracker's resize on the card against the CPU."""
    import numpy as np
    import torch
    from dfot_tpu_torch.metrics.motion import motion_features
    from dfot_tpu_torch.metrics.registry import SharedMetricModelRegistry
    from dfot_tpu_torch.metrics.video_metric import VideoMetric

    gt, pred = (c.to("cuda") for c in clips)
    reg = SharedMetricModelRegistry()
    vm = VideoMetric(["fvmd"], reg)
    t0 = time.perf_counter()
    vm.update(pred, gt)
    out = vm.log("validation/prediction")
    wall = time.perf_counter() - t0
    feats_card = motion_features(gt, device="cuda")
    feats_cpu = motion_features(gt.cpu(), device="cpu")
    diff = float(np.abs(feats_card - feats_cpu).max())
    rec["fvmd"] = {"source": source, "shape": list(gt.shape), "metrics": out, "wall_s": wall,
                   "features_card_vs_cpu_max_abs": diff, "feature_shape": list(feats_card.shape)}
    log(f"  FVMD on two {tuple(gt.shape)} clips ({source}): {out}, {wall:.2f} s; the tracker's "
        f"features with the resize on the card against the CPU: max |diff| {diff:.3g}")
    require(list(out) == ["validation/prediction/fvmd_uncalibrated"]
            and math.isfinite(out["validation/prediction/fvmd_uncalibrated"]),
            f"FVMD logged {out}")
    require(reg.comparable == {"pips": False, "fvmd": False}, f"FVMD: {reg.comparable}")
    require(feats_card.shape == (1, 1024) and np.isfinite(feats_card).all(),
            f"FVMD features {feats_card.shape}")


def rollout_clips():
    """Two 16-frame clips of the long rollout (frames 0-15 and
    16-31), in [0, 1]."""
    video = CARRIED["rollout"]
    return tuple(((video[:, i:i + FVMD_FRAMES].float() + 1) / 2).clamp(0, 1)
                 for i in (0, FVMD_FRAMES))


def run_metric_paths(record: dict, clips=None, source: str = "the 40-frame rollout") -> dict:
    """Phase 23: the metric suite on the card. (a) I3D, InceptionV3 at 299,
    LPIPS, CLIP B/32 and L/14 and DINO B/16 against the CPU; (b) K600's
    validation as composed through ``run(argv)``; (c) FVMD on two 16-frame
    clips; (d) each network's time a call and the host's Frechet distances.
    Returns the launch counts of (b)."""
    import torch

    t_phase = time.perf_counter()
    rec = record["metrics"] = {}
    log("the metric suite (phase 23):")
    check_frozen_networks(rec)
    launches, _ = run_k600_metrics(rec)
    gc.collect()
    torch.cuda.empty_cache()
    run_fvmd(rec, clips if clips is not None else rollout_clips(), source)
    report_host_math(rec)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 23: {rec['seconds']:.1f} s")
    return {"k600_metrics": launches}


# phase 24: RAFT, AMT-S, PIPs2 and MUSIQ (A15c) on the card against the CPU,
# fp32 with TF32 off, relative L2 of the outputs. The feed-forward AMT-S and
# MUSIQ as phase 23's networks; RAFT's 20 and PIPs2's 16 refinement
# iterations carry the first pass's differences through clamped samplers,
# whose steps grow them (PIPs2 at 5 iterations on the CPU against JAX: 1e-7
# to 2e-5 by how far its points move): 1e-3.
A15C_CPU_REL_TOL = {"raft": 1e-3, "amt": 1e-4, "pips": 1e-3, "musiq": 1e-4}
A15C_NETS = tuple(A15C_CPU_REL_TOL)
# the witnesses' output heads scaled so that flows and tracks move a few
# pixels, as trained networks' do (with He-scaled heads PIPs2's points run
# off the image)
A15C_HEADS = {"raft": (("update_block.flow_head.conv2",), 0.1),
              "amt": (("convblock.2", "flow_head.2", "comb_block.2"), 0.1),
              "pips": (("delta_block.dense",), 0.05)}
A15C_VBENCH_DIMS = ("motion_smoothness", "dynamic_degree")
RAFT_RES = 224  # dynamic_degree's resize


def a15c_witness(name: str, seed: int):
    """The network ``name`` at its published widths and the registry's
    iterations on witness weights, its output heads scaled (``A15C_HEADS``)."""
    import torch
    from dfot_tpu_torch.metrics import amt, musiq, pips, raft
    from dfot_tpu_torch.metrics import registry as R

    net = {"raft": lambda: raft.RAFT(iters=R.RAFT_ITERS), "amt": amt.AMT_S,
           "pips": lambda: pips.Pips(iters=R.PIPS_ITERS), "musiq": musiq.MUSIQ}[name]()
    witness_weights(net, seed)
    heads, scale = A15C_HEADS.get(name, ((), 1.0))
    with torch.no_grad():
        for pname, p in net.named_parameters():
            if pname.endswith("weight") and any(pname.startswith(h) or f".{h}." in pname
                                                for h in heads):
                p.mul_(scale)
    return net


def tracker_points(resolution: int = 256, num_points: int = 400):
    """``motion_features``' query grid, (N, 2) xy."""
    import numpy as np

    side = int(round(np.sqrt(num_points)))
    lin = 8 + np.arange(side, dtype=np.float32) / (side - 1) * (resolution - 16)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def swapped_offsets(radius, device):
    """The control of the correlation window: offsets in (dx, dy) order."""
    import torch

    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx, dy], dim=-1)


def a15c_cases(frames, clip):
    """name -> (CPU network, inputs, control): RAFT on video 0's 7 pairs at
    224^2 in [0, 255], AMT-S on its 3 even-frame pairs at 256^2 (``embt``
    0.5), PIPs2 on a 16-frame clip at 256^2 with the tracker's 400 points,
    MUSIQ on the 16 frames at 256^2 (three scales). A control is a context
    that breaks the card's copy: the window offsets of RAFT and PIPs2 in
    (dx, dy) order, AMT-S's transposed convolutions unflipped, MUSIQ's stem
    padded (3, 3) and (1, 1) instead of flax's (2, 3) and (0, 1)."""
    import torch
    from dfot_tpu_torch.metrics import musiq as M
    from dfot_tpu_torch.metrics import pips as P
    from dfot_tpu_torch.metrics import raft as R
    from dfot_tpu_torch.metrics.resize import resize

    B, T = METRIC_VIDEOS[:2]
    v0 = resize(frames[0], (T, RAFT_RES, RAFT_RES, 3), "bilinear") * 255.0
    pts = torch.from_numpy(tracker_points())
    S = clip.shape[0]

    @contextlib.contextmanager
    def patched_attr(module, attr, value):
        real = getattr(module, attr)
        setattr(module, attr, value)
        try:
            yield
        finally:
            setattr(module, attr, real)

    @contextlib.contextmanager
    def unflipped(net):
        with torch.no_grad():
            for name, p in net.named_parameters():
                if name.endswith("convblock.2.weight"):
                    p.copy_(p.flip(2, 3))
        yield

    return {
        "raft": (a15c_witness("raft", 241), (v0[:-1], v0[1:]),
                 lambda net: patched_attr(R, "window_offsets", swapped_offsets)),
        "amt": (a15c_witness("amt", 242), (frames[0, 0:T - 2:2], frames[0, 2:T:2],
                                           torch.full((T // 2 - 1,), 0.5)), unflipped),
        "pips": (a15c_witness("pips", 243), (pts[None].expand(S, -1, -1).contiguous(),
                                             clip * 2.0 - 1.0),
                 lambda net: patched_attr(P, "window_offsets", swapped_offsets)),
        "musiq": (a15c_witness("musiq", 244), (frames.reshape((B * T,) + tuple(frames.shape[2:])),),
                  lambda net: patched_attr(M, "same_pads", symmetric_same_pads)),
    }


def check_a15c_networks(rec: dict, clip) -> None:
    """(a) Each A15c network on the card against the CPU and its control,
    and its time a call on the card."""
    import copy

    import torch
    from dfot_tpu_torch.metrics.registry import frozen_math

    frames = torch.rand(METRIC_VIDEOS, generator=torch.Generator().manual_seed(236))
    cpu, card = torch.device("cpu"), torch.device("cuda")
    with frozen_math(cpu):
        cases = a15c_cases(frames, clip)
    rec["networks"] = {}
    log("  A15c networks, card against CPU (fp32, TF32 off, relative L2 tol "
        + ", ".join(f"{k} {v:g}" for k, v in A15C_CPU_REL_TOL.items()) + "):")
    for name, (net, inputs, control) in cases.items():
        t0 = time.perf_counter()
        with frozen_math(cpu):
            want = net(*inputs)
        cpu_s = time.perf_counter() - t0
        dev = copy.deepcopy(net).to(card)
        require(all(p.device.type == "cuda" for p in dev.parameters()),
                f"{name}: parameters off the card")
        x = tuple(i.to(card) for i in inputs)
        with frozen_math(card):
            got = dev(*x)
            ms = cuda_ms(lambda: dev(*x), reps=3, warmup=1)
        err = rel_l2(got.cpu(), want)
        with frozen_math(card), control(dev):
            ctl = rel_l2(dev(*x).cpu(), want)
        n_params = sum(p.numel() for p in net.parameters())
        tol = A15C_CPU_REL_TOL[name]
        rec["networks"][name] = {"rel_l2": err, "control_rel_l2": ctl, "tol": tol, "card_ms": ms,
                                 "cpu_s": cpu_s, "params": n_params,
                                 "input_shapes": [list(i.shape) for i in inputs],
                                 "output_shape": list(got.shape)}
        log(f"    {name:6s} {n_params / 1e6:7.2f} M params, in {[tuple(i.shape) for i in inputs]} "
            f"out {tuple(got.shape)}: rel L2 {err:.2e}, control {ctl:.2e}; {ms:.2f} ms a call on "
            f"the card, {cpu_s:.2f} s on the CPU")
        require(bool(torch.isfinite(got).all()) and err <= tol,
                f"{name} on the card is off the CPU by {err:.3e}")
        require(ctl > tol, f"{name}: the control passes ({ctl:.3e})")
        del dev, x, got
    del cases
    gc.collect()
    torch.cuda.empty_cache()


def write_a15c_weights(directory: Path) -> None:
    """``raft.npz``, ``amt.npz``, ``pips.npz`` and ``musiq.npz`` of the
    witnesses, each the JAX registry's flattened flax tree."""
    import numpy as np
    from dfot_tpu_torch.utils.weights import _flatten, flax_tree_from_state_dict

    directory.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(A15C_NETS):
        tree = flax_tree_from_state_dict(name, a15c_witness(name, 241 + i).state_dict())
        np.savez(directory / f"{name}.npz", **_flatten(tree))


def run_k600_a15c(rec: dict, weights_dir: Path) -> dict:
    """(b) K600's validation as composed with the four weight files:
    motion_smoothness through AMT-S and dynamic_degree through RAFT, logged
    without ``_uncalibrated``; then imaging_quality through the run's MUSIQ
    on its predictions (``VideoMetric``'s VBench dimensions leave it out,
    as the JAX package's do, ``video_metric.py:27-31``)."""
    import numpy as np
    from dfot_tpu_torch.metrics.vbench import VBenchQuality

    launches, exp = run_k600_metrics(rec, weights_dir, key="k600_a15c")
    reg = exp._registry
    t0 = time.perf_counter()
    vb = VBenchQuality(("imaging_quality",), reg)
    vb.update(exp.last_videos["prediction"])
    iq = vb.log("validation/prediction/vbench")
    rec["k600_a15c"]["imaging_quality"] = {"metrics": iq, "wall_s": time.perf_counter() - t0}
    log(f"    imaging_quality through MUSIQ on the predictions: {iq}")
    require(list(iq) == ["validation/prediction/vbench/imaging_quality",
                         "validation/prediction/vbench/quality_score"]
            and all(np.isfinite(list(iq.values()))), f"imaging_quality logged {iq}")
    require_registry_on_card(reg, ("musiq",), "K600's imaging_quality", calibrated=True)
    require(all(launches[k] > 0 for k in FORWARD_KERNELS + ("ln_modulate",)),
            f"K600's validation with the A15c networks sampled off the kernels: {launches}")
    del exp
    return launches


def run_fvmd_pips(rec: dict, clips, source: str, weights_dir: Path) -> None:
    """(c) ``VideoMetric(["fvmd"])`` with ``pips.npz``: PIPs2 tracks on the
    card, and ``fvmd`` is logged without ``_uncalibrated``."""
    from dfot_tpu_torch.metrics.registry import SharedMetricModelRegistry
    from dfot_tpu_torch.metrics.video_metric import VideoMetric

    gt, pred = (c.to("cuda") for c in clips)
    reg = SharedMetricModelRegistry(str(weights_dir))
    vm = VideoMetric(["fvmd"], reg)
    t0 = time.perf_counter()
    vm.update(pred, gt)
    out = vm.log("validation/prediction")
    wall = time.perf_counter() - t0
    rec["fvmd_pips"] = {"source": source, "shape": list(gt.shape), "metrics": out, "wall_s": wall}
    log(f"  FVMD with PIPs2 on two {tuple(gt.shape)} clips ({source}): {out}, {wall:.2f} s")
    require(list(out) == ["validation/prediction/fvmd"]
            and math.isfinite(out["validation/prediction/fvmd"]), f"FVMD logged {out}")
    require(reg.comparable == {"pips": True, "fvmd": True}, f"FVMD: {reg.comparable}")
    require_registry_on_card(reg, ("pips",), "FVMD", calibrated=True)


def run_a15c_paths(record: dict, clips=None, source: str = "the 40-frame rollout") -> dict:
    """Phase 24: RAFT, AMT-S, PIPs2 and MUSIQ. (a) each network on the card
    against the CPU at the metrics' shapes; (b) K600's validation as composed
    with the four weight files; (c) FVMD with PIPs2. Returns the launch
    counts of (b)."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    rec = record["a15c"] = {}
    log("RAFT, AMT-S, PIPs2 and MUSIQ (phase 24):")
    clips = clips if clips is not None else rollout_clips()
    check_a15c_networks(rec, clips[0][0])
    weights_dir = ROOT / "build" / "a15c_weights"
    shutil.rmtree(weights_dir, ignore_errors=True)
    write_a15c_weights(weights_dir)
    launches = run_k600_a15c(rec, weights_dir)
    gc.collect()
    torch.cuda.empty_cache()
    run_fvmd_pips(rec, clips, source, weights_dir)
    shutil.rmtree(weights_dir, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 24: {rec['seconds']:.1f} s")
    return {"k600_a15c": launches}


# ---------------------------------------------------------------------------
# phase 25: ring attention, the sequence-parallel window, a one-rank NCCL run
# ---------------------------------------------------------------------------

# the flagship's two attention shapes (level 2, level 3) at the window's
# batch (B * NFE = 2), as (name, B, H, N, D)
RING_SITES = (("level2", 2, 9, 8192, 64), ("level3", 2, 9, 2048, 128))
RING_SIZES = (2, 4)
RING_MAIN_SIZE = 2  # the ring of the kernels line and of the window
RING_REL_TOL = 1e-2  # relative L2 of the ring against its plain version (B1's bound)
RING_CLI_STEPS = 2
RING_CLI_SAMPLING_STEPS = 10


def ring_inputs(B: int, H: int, N: int, D: int, seed: int):
    """Seeded peaked bf16 q, k, v (score std about 3) and an upstream
    gradient."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(scale):
        return (torch.randn(B, H, N, D, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    return rand(3.0 ** 0.5), rand(3.0 ** 0.5), rand(1.0), rand(1.0)


def ring_skipping_one_hop(q, k, v, ring):
    """Control: the ring's forward with the last hop's block left out of the
    fold (the kernels of the port, one fold fewer)."""
    import math

    from dfot_tpu_torch.ops import ring_attention as RA

    qs, ks, vs = (ring.shard(t) for t in (q, k, v))
    scale, d = 1.0 / math.sqrt(q.shape[-1]), q.shape[-1]
    o, lse = RA.block_attention(qs, ks, vs, scale, d, False)
    for hop in range(1, ring.size):
        ks, vs = ring.hop(ks, vs)
        if hop < ring.size - 1:
            o, lse = RA.fold_block(o, lse, *RA.block_attention(qs, ks, vs, scale, d, False))
    return ring.gather(o.to(q.dtype))


def ring_grads(fn, q, k, v, do):
    """(o, dq, dk, dv) of ``fn(q, k, v)`` against the upstream gradient."""
    import torch

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = fn(*leaves)
    return (o.detach(), *torch.autograd.grad(o, leaves, do))


def check_ring_kernels(record: dict, results: dict) -> None:
    """Ring attention on a LocalRing of R = 2 and 4 at the flagship's two
    attention shapes: forward and backward against the plain ring (the same
    ring over the plain attention and its backward formulas) and against
    unsharded B1 + B4 + B5, by relative L2 within :data:`RING_REL_TOL`; the
    exact launches of one call (R of B1 forward, R each of B4 and B5
    backward); a control whose fold skips one hop must miss the bound;
    device times of the whole ring (forward; forward + backward), of one hop
    (B1, B4, B5 on the merged R x B batch of N / R rows) and of the fold
    between hops, beside B1's bound at the hop shape and SDPA on the full N."""
    import math

    import torch
    import torch.nn.functional as F
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.ops import attention as A
    from dfot_tpu_torch.ops import ring_attention as RA

    rec = record.setdefault("ring", {})["kernels"] = {}
    results.setdefault("ring_block", {"by_site": {}})
    log(f"ring attention (LocalRing) at the flagship's attention shapes, bf16, relative L2 "
        f"tol {RING_REL_TOL}:")
    for i, (name, B, H, N, D) in enumerate(RING_SITES):
        q, k, v, do = ring_inputs(B, H, N, D, seed=250 + i)
        scale = 1.0 / math.sqrt(D)
        ops_full = attention_ops(B, H, N, D)
        unsharded = ring_grads(lambda a, b, c: A.flash_attention(a, b, c), q, k, v, do)
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        for R in RING_SIZES:
            ring = RA.LocalRing(R)
            site = f"{name} R={R} B={B} H={H} N={N} d={D}"
            ops.reset_launch_counts()
            got = ring_grads(lambda a, b, c: RA.sequence_parallel_attention(a, b, c, ring),
                             q, k, v, do)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            expect = dict(no_launches(), flash_fwd=R, ring_block=R, flash_bwd_dq=R,
                          flash_bwd_dkv=R)
            require_launches(f"one ring call at {site}", launches, expect)
            plain = ring_grads(
                lambda a, b, c: RA.sequence_parallel_attention(a, b, c, ring, plain=True),
                q, k, v, do)
            labels = ("o", "dq", "dk", "dv")
            vs_plain = {lb: rel_l2(g, w) for lb, g, w in zip(labels, got, plain)}
            vs_unsharded = {lb: rel_l2(g, w) for lb, g, w in zip(labels, got, unsharded)}
            control = rel_l2(ring_skipping_one_hop(q, k, v, ring), plain[0])
            require(max(vs_plain.values()) <= RING_REL_TOL,
                    f"ring at {site}: off its plain version by {vs_plain}")
            require(max(vs_unsharded.values()) <= RING_REL_TOL,
                    f"ring at {site}: off unsharded B1 + B4 + B5 by {vs_unsharded}")
            require(control > RING_REL_TOL,
                    f"ring at {site}: the bound does not reject a fold that skips one hop "
                    f"({control:.3e})")
            # device times: the whole ring, one hop's kernels, the fold
            fwd = lambda: RA.sequence_parallel_attention(q, k, v, ring)  # noqa: E731
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = RA.sequence_parallel_attention(*leaves, ring)
            ring_ms = cuda_ms(fwd)
            ring_train_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                                retain_graph=True)) + ring_ms
            qs, ks, vs, dos = (ring.shard(t) for t in (q, k, v, do))
            o_hop, lse_hop = A.flash_attention(qs, ks, vs, return_lse=True)
            delta = (dos.float() * o_hop.float()).sum(-1, keepdim=True)
            hop_b1 = cuda_ms(lambda: A.flash_attention(qs, ks, vs, return_lse=True))
            hop_b4 = cuda_ms(lambda: A.flash_bwd_dq(qs, ks, vs, dos, lse_hop, delta))
            hop_b5 = cuda_ms(lambda: A.flash_bwd_dkv(qs, ks, vs, dos, lse_hop, delta))
            acc, acc_lse = o_hop.float(), lse_hop
            fold_ms = cuda_ms(lambda: RA.fold_block(acc, acc_lse, acc, acc_lse))
            hop_bound = bound(attention_ops(R * B, H, N // R, D),
                              nbytes(qs, ks, vs, o_hop, lse_hop), PEAK_BF16_FLOPS)
            whole_bound = bound(ops_full, nbytes(q, k, v, q), PEAK_BF16_FLOPS)
            plain_ms = cuda_ms(
                lambda: RA.sequence_parallel_attention(q, k, v, ring, plain=True), reps=3,
                warmup=1)
            entry = {
                "R": R, "vs_plain": vs_plain, "vs_unsharded": vs_unsharded,
                "control_skip_one_hop": control, "launches": launches,
                "ring_ms": ring_ms, "ring_cold_ms": cold_ms(fwd),
                "ring_fwd_bwd_ms": ring_train_ms, "plain_ms": plain_ms,
                "hop_ms": {"B1": hop_b1, "B4": hop_b4, "B5": hop_b5, "fold": fold_ms},
                "hop_b1_bound": hop_bound, "bound": whole_bound, "sdpa_full_n_ms": sdpa,
            }
            rec[site] = entry
            log(f"  {site}: vs plain {max(vs_plain.values()):.3e}, vs unsharded "
                f"{max(vs_unsharded.values()):.3e}, control (one hop skipped) {control:.3e}; "
                f"ring {ring_ms:.4f} ms (cold {entry['ring_cold_ms']:.4f}), fwd+bwd "
                f"{ring_train_ms:.4f} ms, plain {plain_ms:.3f} ms; a hop: B1 {hop_b1:.4f} ms "
                f"(bound {hop_bound['bound_ms']:.4f}), B4 {hop_b4:.4f}, B5 {hop_b5:.4f}, fold "
                f"{fold_ms:.4f} ms; whole bound {whole_bound['bound_ms']:.4f} ms, SDPA on "
                f"N={N} {sdpa:.4f} ms")
            results["ring_block"]["by_site"][site] = {
                "main": R == RING_MAIN_SIZE, "max_abs_err": max_err(got[0], plain[0]),
                "ms": ring_ms, "cold_ms": entry["ring_cold_ms"], "plain_ms": plain_ms,
                "bound_ms": whole_bound["bound_ms"], "bound_by": whole_bound["bound_by"],
                "library_ms": sdpa,
            }
            del got, plain, leaves, out, qs, ks, vs, dos, o_hop, lse_hop, delta, acc, acc_lse
        del q, k, v, do, unsharded
        gc.collect()
        torch.cuda.empty_cache()


def run_ring_window(record: dict) -> dict:
    """The flagship's 8-frame, 50-step vanilla-HG window at full width, its
    depth cut to :data:`FLAGSHIP_CUT_DEPTH`, on a bf16 copy of seeded random weights, with the
    sequence-parallel context on a LocalRing of two ranks (every transformer
    level's attention takes the ring: 4096 and 1024 query rows a rank)
    against the same window unsharded, the same weights and noise: relative
    L2 within :data:`WINDOW_REL_TOL`, the ring's exact launches (B1 as
    ring blocks, two a block a forward; no B2, B3), wall times."""
    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.algorithms.dfot_video import flagship
    from dfot_tpu_torch.ops import attention as A
    from dfot_tpu_torch.ops import ring_attention as RA

    import dataclasses

    fs = flagship()
    fs = fs._replace(spec=dataclasses.replace(fs.spec, **FLAGSHIP_CUT_DEPTH))
    steps = fs.dcfg.sampling_timesteps
    model = sampling_copy(fs, build_random_model(fs, seed=90, token_io=False))
    ro = make_rollout(fs, model, fs.dcfg)
    first = seeded_image(fs, 91)
    run_window(ro, fs, seed=92, first=first)  # warm-up
    torch.cuda.synchronize()
    walls, videos, launches = {}, {}, {}
    for form in ("unsharded", "ring"):
        prior = A.set_sequence_parallel(RA.LocalRing(RING_MAIN_SIZE) if form == "ring" else None)
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            videos[form] = run_window(ro, fs, seed=93, first=first)
            torch.cuda.synchronize()
            walls.setdefault(form, []).append(time.perf_counter() - t0)
            launches[form] = ops.launch_counts()
        finally:
            A.set_sequence_parallel(prior)
    err = rel_l2(videos["ring"], videos["unsharded"])
    blocks = launches["unsharded"]["flash_fwd"] // steps  # transformer blocks a forward
    expect = dict(no_launches(), flash_fwd=steps * blocks * RING_MAIN_SIZE,
                  ring_block=steps * blocks * RING_MAIN_SIZE)
    require_launches("the ring window", launches["ring"], expect)
    require(err <= WINDOW_REL_TOL, f"the ring window is off the unsharded one by {err:.3e}")
    require(bool(torch.isfinite(videos["ring"]).all()), "the ring window is not finite")
    rec = record.setdefault("ring", {})["window"] = {
        "rel_l2_vs_unsharded": err, "tol": WINDOW_REL_TOL, "wall_s": walls,
        "launches": launches["ring"], "ring_size": RING_MAIN_SIZE}
    log(f"flagship 8-frame window (depth cut to {FLAGSHIP_CUT_DEPTH}), {steps} DDIM steps, vanilla "
        f"HG 4.0, sequence-parallel on a LocalRing of {RING_MAIN_SIZE}: relative L2 {err:.3e} "
        f"against the unsharded window "
        f"(tol {WINDOW_REL_TOL}); wall ring {', '.join(f'{w:.3f}' for w in walls['ring'])} s, "
        f"unsharded {', '.join(f'{w:.3f}' for w in walls['unsharded'])} s; launches "
        f"{launches['ring']}")
    del model, ro, videos
    return launches["ring"]


RING_CLI_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from dfot_tpu_torch import ops
from dfot_tpu_torch.__main__ import run
ops.reset_launch_counts()
exp = run(json.loads(sys.argv[2]))
torch.cuda.synchronize()
print(json.dumps({"launches": ops.launch_counts(), "metrics": exp.last_metrics,
                  "saves": [s["step"] for s in exp.saves],
                  "peak_bytes": torch.cuda.max_memory_allocated()}))
"""


def run_ring_cli(record: dict) -> dict:
    """``run(argv)`` in a child process with ``torchrun``'s environment of
    one process: the flagship (full width, depth cut to :data:`FLAGSHIP_CUT_DEPTH`,
    fresh seeded init) through a one-rank NCCL group and its (1, 1) mesh, 2 train steps at
    batch 2, then one validation batch with the sampling steps cut to
    :data:`RING_CLI_SAMPLING_STEPS`; the child prints the backend and world
    size."""
    import shutil
    import socket

    root = ROOT / "build" / "ring_cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    argv = [a for a in README_RE10K if not a.startswith(("load=", "experiment.tasks"))] + [
        "experiment.tasks=[training,validation]", f"output_dir={root}",
        f"experiment.training.max_steps={RING_CLI_STEPS}", "experiment.training.batch_size=2",
        "experiment.validation.limit_batch=1", f"experiment.validation.batch_size={CLI_BATCH}",
        f"algorithm.diffusion.sampling_timesteps={RING_CLI_SAMPLING_STEPS}",
        "experiment.training.data.num_workers=0", "++algorithm.logging.loss_freq=1",
        "++algorithm.logging.max_num_videos=0", "++algorithm.logging.metrics=[mse,psnr]",
        "wandb.mode=disabled"] + CUT_DEPTH_ARGV
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", RING_CLI_WORKER, str(ROOT), json.dumps(argv)],
                              env=env, capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"the one-rank NCCL run(argv) failed:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    group = next((ln for ln in lines if ln.startswith("process group:")), None)
    require(group == "process group: backend nccl, world size 1",
            f"the one-rank run did not report its NCCL group: {group!r}")
    info = json.loads(lines[-1])
    require(info["saves"] and info["saves"][-1] == RING_CLI_STEPS,
            f"the one-rank run saved {info['saves']}")
    require(bool(info["metrics"]) and all(math.isfinite(v) for v in info["metrics"].values()),
            f"the one-rank run's validation metrics: {info['metrics']}")
    require(info["launches"]["flash_bwd_dq"] > 0 and info["launches"]["flash_fwd"] > 0,
            f"the one-rank run launched {info['launches']}")
    record.setdefault("ring", {})["cli"] = {"wall_s": wall, **info, "group": group}
    log(f"python -m dfot_tpu_torch through a one-rank NCCL group ({group}): {wall:.1f} s wall "
        f"with the child's start, {RING_CLI_STEPS} train steps at batch 2 and one validation "
        f"batch of {RING_CLI_SAMPLING_STEPS} steps; metrics {info['metrics']}; peak "
        f"{info['peak_bytes'] / 2**30:.2f} GiB; launches {info['launches']}")
    return info["launches"]


def run_ring_paths(record: dict, results: dict) -> dict:
    """Phase 25: ring attention's kernels at the flagship's shapes, the
    flagship's window with the sequence-parallel context on a LocalRing, and
    ``run(argv)`` through a one-rank NCCL group."""
    t_phase = time.perf_counter()
    log("ring attention and the process-group layer (phase 25):")
    check_ring_kernels(record, results)
    out = {"ring_window": run_ring_window(record)}
    out["ring_cli"] = run_ring_cli(record)
    record["ring"]["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 25: {record['ring']['seconds']:.1f} s")
    return out


# phase 26: Megatron tensor parallelism, the serving export, the UCF-101
# recipe with its EDM AugmentPipe, attention capture
TP_FLAGSHIP = 3   # the flagship's 9 heads, 3 a rank
TP_XL = 2         # K600 @DiT/XL's 16 heads, 8 a rank
TP_TRAIN_STEPS = 2
TP_BATCH = TRAIN_LOOP_BATCH
# the UCF-101 recipe: 3 training steps at its batch of 32 from seeded 64 px
# clips (17 frames: one 16-frame clip each)
UCF_STEPS = 3
UCF_RES = 64
UCF_VIDEOS = (("training", 100, 17), ("validation", 2, 17))
# attention capture: K600 @DiT/XL at full width, its depth cut to 2, one
# denoiser forward at level int(0.1 T), card against CPU (fp32, absolute)
CAPTURE_DEPTH = 2
CAPTURE_TOL = 1e-3

TP_WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as CS
from dfot_tpu_torch.ops import _cuda

torch.cuda.set_device(0)  # every rank on the one card
_cuda.library()
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank, world_size=world)
out = CS.tp_rank_run(sys.argv[2])
dist.destroy_process_group()
print(json.dumps(out))
"""


def cut_flagship():
    """The flagship at full width, its depth cut to :data:`FLAGSHIP_CUT_DEPTH`."""
    import dataclasses

    from dfot_tpu_torch.algorithms.dfot_video import flagship

    fs = flagship()
    return fs._replace(spec=dataclasses.replace(fs.spec, **FLAGSHIP_CUT_DEPTH))


def train_steps(fs, model, batch: dict, group=None, reduce_timer=None) -> dict:
    """:data:`TP_TRAIN_STEPS` train steps of a recipe (its warm-up cut to 2,
    as :func:`run_train_path` does) on ``batch``, the model tensor-parallel
    over ``group`` if given: losses, gradient norms, walls, launches, peak
    memory and, with ``reduce_timer``, the seconds of the last step's
    all-reduces."""
    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.algorithms.dfot_video import make_train_state, make_train_step
    from dfot_tpu_torch.parallel import tensor as TT

    if group is not None:
        TT.apply_tensor_parallel(model, group)
    fs = fs._replace(train=fs.train._replace(num_warmup_steps=2))
    state, step = make_train_state(fs, model), make_train_step(fs)
    gen = torch.Generator(device="cuda").manual_seed(267)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, norms, walls, reduce_s = [], [], [], None
    for i in range(TP_TRAIN_STEPS):
        timed = reduce_timer is not None and i == TP_TRAIN_STEPS - 1
        ctx = patched(TT, "_all_reduce", reduce_timer) if timed else contextlib.nullcontext()
        if timed:
            reduce_timer.seconds = 0.0
        t0 = time.perf_counter()
        with ctx:
            state, m = step(state, batch, gen)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if timed:
            reduce_s = reduce_timer.seconds
    return {"loss": losses, "grad_norm": norms, "wall_s": walls, "launches": ops.launch_counts(),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "all_reduce_s": reduce_s}


def flagship_window(fs, model, go=None):
    """The cut flagship's 50-step vanilla-HG window on ``model`` (a bf16
    sampling copy) after a 2-step warm-up window (a fresh process's first
    window pays seconds of one-time costs): (video, wall, launches, peak
    memory). ``go``: a path to wait for before the warm-up."""
    import dataclasses

    import torch
    from dfot_tpu_torch import ops

    ro = make_rollout(fs, model, fs.dcfg)
    first = seeded_image(fs, 261)
    if go is not None:
        while not Path(go).exists():
            time.sleep(0.05)
    run_window(make_rollout(fs, model, dataclasses.replace(fs.dcfg, sampling_timesteps=2)), fs,
               seed=260, first=first)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    video = run_window(ro, fs, seed=262, first=first)
    torch.cuda.synchronize()
    return video, time.perf_counter() - t0, ops.launch_counts(), torch.cuda.max_memory_allocated()


def _all_reduce_timer():
    """A stand-in for ``parallel.tensor._all_reduce`` that adds the seconds
    of each reduce (the stream synchronized on both sides) to ``.seconds``."""
    import torch
    from dfot_tpu_torch.parallel import tensor as TT

    real = TT._all_reduce

    def timed(x, group):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(x, group)
        torch.cuda.synchronize()
        timed.seconds += time.perf_counter() - t
        return out

    timed.seconds = 0.0
    return timed


def tp_rank_run(out_dir: str) -> dict:
    """One rank of the tensor-parallel processes (:data:`TP_WORKER`): the
    cut flagship's window and train steps over all :data:`TP_FLAGSHIP`
    ranks, K600 @DiT/XL's train steps over the first :data:`TP_XL`; the
    same seeds as the one-process runs of :func:`run_tp_paths`, which the
    ranks wait for (``out_dir/go``) once their models are built."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from dfot_tpu_torch.algorithms.dfot_video import k600_dit_xl
    from dfot_tpu_torch.parallel import tensor as TT

    rank = dist.get_rank()
    xl_group = dist.new_group(list(range(TP_XL)))  # every rank takes part in making it
    fs = cut_flagship()
    out = {"rank": rank}
    model = sampling_copy(fs, build_random_model(fs, seed=260, token_io=False))
    TT.apply_tensor_parallel(model, dist.group.WORLD)
    out["heads"] = sorted({m.heads for m in model.modules() if hasattr(m, "heads")})
    video, wall, launches, peak = flagship_window(fs, model, Path(out_dir) / "go")
    out["window"] = {"wall_s": wall, "launches": launches, "peak_memory_bytes": peak}
    if rank == 0:
        np.save(Path(out_dir) / "tp_window.npy", video.float().cpu().numpy())
    del model, video
    torch.cuda.empty_cache()
    out["train"] = train_steps(fs, build_random_model(fs, seed=263, token_io=False),
                               train_batch(fs, TP_BATCH, 264), dist.group.WORLD,
                               _all_reduce_timer())
    torch.cuda.empty_cache()
    if rank < TP_XL:
        r = k600_dit_xl()
        out["xl_train"] = train_steps(
            r, build_random_model(r, seed=265, token_io=False),
            latent_batch((r.max_tokens, *r.resolution, r.x_channels), TP_BATCH, 266), xl_group,
            _all_reduce_timer())
    dist.barrier()
    return out


def run_tp_paths(record: dict) -> dict:
    """(a) Megatron tensor parallelism on the one card: :data:`TP_FLAGSHIP`
    processes over a gloo group (NCCL does not put two ranks on one card;
    gloo's all-reduce takes CUDA tensors) run the cut flagship's 50-step
    window and :data:`TP_TRAIN_STEPS` train steps at batch 8 with 3 of its 9
    heads a rank, and K600 @DiT/XL's train steps with 8 of 16 a rank on
    the first :data:`TP_XL`; each held to the one-process run of the same
    seeds (window: ``WINDOW_REL_TOL``; each step's loss ``GRAD_LOSS_TOL``,
    its gradient norm ``GRAD_REL_TOL``), each rank's launches equal to the
    one process's."""
    import socket

    import numpy as np
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import k600_dit_xl

    rec = record.setdefault("tp", {})
    fs = cut_flagship()
    out_dir = ROOT / "build" / "tp"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "go").unlink(missing_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # the ranks start (imports, the card, the models) while this process
    # runs the one-process references; they wait for ``go`` before the card
    # work that is timed
    t_ranks = time.perf_counter()
    procs = []
    for rank in range(TP_FLAGSHIP):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(TP_FLAGSHIP), LOCAL_RANK="0",
                   INIT=f"tcp://localhost:{port}")
        procs.append(subprocess.Popen([sys.executable, "-c", TP_WORKER, str(ROOT), str(out_dir)],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        t0 = time.perf_counter()
        one = {}
        model = sampling_copy(fs, build_random_model(fs, seed=260, token_io=False))
        video, wall, launches, peak = flagship_window(fs, model)
        one["window"] = {"wall_s": wall, "launches": launches, "peak_memory_bytes": peak}
        del model
        torch.cuda.empty_cache()
        one["train"] = train_steps(fs, build_random_model(fs, seed=263, token_io=False),
                                   train_batch(fs, TP_BATCH, 264))
        torch.cuda.empty_cache()
        r = k600_dit_xl()
        one["xl_train"] = train_steps(r, build_random_model(r, seed=265, token_io=False),
                                      latent_batch((r.max_tokens, *r.resolution, r.x_channels),
                                                   TP_BATCH, 266))
        gc.collect()
        torch.cuda.empty_cache()
        rec["one_process"] = one
        rec["one_process_s"] = time.perf_counter() - t0
        (out_dir / "go").write_text("go")
        for p in procs:
            stdout, stderr = p.communicate(timeout=900)
            require(p.returncode == 0, f"a tensor-parallel rank failed:\n{stderr[-3000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rec["ranks_s"] = time.perf_counter() - t_ranks
    rec["ranks"] = outs
    got = np.load(out_dir / "tp_window.npy")
    err = rel_l2(torch.as_tensor(got), video.float().cpu())
    rec["window_rel_l2"] = err
    require(err <= WINDOW_REL_TOL, f"the tensor-parallel window is off the one-process one by "
                                   f"{err:.3e} (tol {WINDOW_REL_TOL})")
    for rank in outs:
        require(rank["heads"] == [fs.spec.num_heads // TP_FLAGSHIP],
                f"rank {rank['rank']} holds heads {rank['heads']}")
        for path in ("window", "train", "xl_train"):
            if path not in rank:
                continue
            require(rank[path]["launches"] == one[path]["launches"],
                    f"rank {rank['rank']} {path}: launches {rank[path]['launches']} != the one "
                    f"process's {one[path]['launches']}")
            if path == "window":
                continue
            for name, tol in (("loss", GRAD_LOSS_TOL), ("grad_norm", GRAD_REL_TOL)):
                for i, (g, w) in enumerate(zip(rank[path][name], one[path][name])):
                    require(abs(g / w - 1) <= tol, f"rank {rank['rank']} {path} step {i}: {name} "
                                                   f"{g} against the one process's {w} (tol {tol})")
    r0 = outs[0]
    share = {p: r0[p]["all_reduce_s"] / r0[p]["wall_s"][-1] for p in ("train", "xl_train")}
    rec["all_reduce_share"] = share
    log(f"tensor parallelism over gloo, {TP_FLAGSHIP} processes on the one card "
        f"({rec['ranks_s']:.1f} s with their start; the one-process runs "
        f"{rec['one_process_s']:.1f} s):")
    log(f"  cut flagship window (3 of 9 heads a rank): relative L2 {err:.3e} against one process "
        f"(tol {WINDOW_REL_TOL}); wall {r0['window']['wall_s']:.3f} s against "
        f"{one['window']['wall_s']:.3f} s; launches at 3 heads {r0['window']['launches']}")
    for path, what in (("train", "cut flagship"), ("xl_train", "K600 @DiT/XL (8 of 16 heads)")):
        log(f"  {what} {TP_TRAIN_STEPS} train steps at batch {TP_BATCH}: loss "
            f"{r0[path]['loss']} against {one[path]['loss']}, grad norm {r0[path]['grad_norm']} "
            f"against {one[path]['grad_norm']}; step walls "
            f"{', '.join(f'{w:.3f}' for w in r0[path]['wall_s'])} s against "
            f"{', '.join(f'{w:.3f}' for w in one[path]['wall_s'])} s; all-reduce share of the "
            f"last step {share[path]:.3f}; launches {r0[path]['launches']}")
    log("  peak memory a rank (window, flagship step, XL step): " + "; ".join(
        f"rank {o['rank']} " + ", ".join(
            f"{o[p]['peak_memory_bytes'] / 2**30:.2f}" for p in ("window", "train", "xl_train")
            if p in o) + " GiB" for o in outs) + "; one process " + ", ".join(
        f"{one[p]['peak_memory_bytes'] / 2**30:.2f}" for p in ("window", "train", "xl_train"))
        + " GiB")
    return {"tp_window": r0["window"]["launches"], "tp_train": r0["train"]["launches"],
            "tp_xl_train": r0["xl_train"]["launches"]}


def start_export_path(record: dict) -> dict:
    """(b) The serving export (``tools/export_sampler.py``): the cut
    flagship's step exported (``torch.export``) and the in-process window
    sampler run on the same model; then ``--load`` started in a fresh child
    process (torch and the custom ops only), which runs the artifact's window
    while the tensor-parallel paths run (:func:`finish_export_path`)."""
    import shutil

    import torch
    from dfot_tpu_torch.tools import export_sampler as ES

    rec = record.setdefault("export", {})
    out_dir = ROOT / "build" / "export"
    shutil.rmtree(out_dir, ignore_errors=True)
    model, fs, plan, x_init, poses = ES.build(False, "cuda", FLAGSHIP_CUT_DEPTH)
    rec.update(ES.export_window(model, fs, plan, x_init, poses, str(out_dir),
                                {k: list(v) if isinstance(v, tuple) else v
                                 for k, v in FLAGSHIP_CUT_DEPTH.items()}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        want = ES.in_process_window(model, fs, plan, x_init, poses)
    torch.cuda.synchronize()
    rec["in_process_s"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    saved = out_dir / "loaded.npy"
    proc = subprocess.Popen([sys.executable, "-m", "dfot_tpu_torch.tools.export_sampler",
                             "--load", str(out_dir), "--save", str(saved), "--device", "cuda"],
                            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return {"proc": proc, "want": want.float().cpu(), "saved": saved}


def finish_export_path(record: dict, started: dict) -> dict:
    """The ``--load`` child's window against the in-process one: bit-equal,
    or its difference within ``WINDOW_REL_TOL``."""
    import numpy as np
    import torch

    rec = record["export"]
    proc = started["proc"]
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    require(proc.returncode == 0, f"--load failed:\n{stderr[-3000:]}")
    rec.update(json.loads(stdout.strip().splitlines()[-1]))
    got, want = torch.as_tensor(np.load(started["saved"])), started["want"]
    rec["bit_equal"] = bool(torch.equal(got, want))
    rec["max_abs_diff"] = float((got - want).abs().max())
    rec["rel_l2"] = rel_l2(got, want)
    require(tuple(got.shape) == tuple(want.shape), f"--load window shape {tuple(got.shape)}")
    require(rec["rel_l2"] <= WINDOW_REL_TOL, f"the exported window is off the in-process one by "
                                             f"{rec['rel_l2']:.3e}")
    require(any(rec["launches"].values()), "the exported window launched no kernel")
    log(f"serving export of the cut flagship's step: exported in {rec['export_s']:.1f} s "
        f"({rec['artifact_bytes'] / 2**20:.1f} MiB); --load in a fresh process beside the "
        f"tensor-parallel ranks: {rec['load_s']:.1f} s to load, {rec['run_s']:.3f} s the window "
        f"(in process {rec['in_process_s']:.3f} s): "
        + ("bit-equal to the in-process window" if rec["bit_equal"] else
           f"max |diff| {rec['max_abs_diff']:.3e}, relative L2 {rec['rel_l2']:.3e} against the "
           f"in-process window (the exported graph's ops on the card: tol {WINDOW_REL_TOL})")
        + f"; launches {rec['launches']}")
    return {"export": rec["launches"]}


def write_ucf101(root: Path, res: int, seed: int) -> None:
    """A seeded UCF-101-layout directory of drifting random images:
    ``<split>03.json`` and ``<split>/<class>_preprocessed_<res>_npz/v_<i>.npz``
    ((T, C, H, W) uint8)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for split, n, length in UCF_VIDEOS:
        index = []
        for i in range(n):
            cls = f"Class{i % 4}"
            index.append({"video_path": f"datasets/ucf101/{split}/{cls}/v_{i}.avi",
                          "label": i % 4})
            base = rng.integers(0, 256, (res, res, 3)).astype(np.uint8)
            video = np.stack([np.roll(base, 2 * t, axis=1) for t in range(length)])
            d = root / split / f"{cls}_preprocessed_{res}_npz"
            d.mkdir(parents=True, exist_ok=True)
            np.savez(d / f"v_{i}.npz", video=video.transpose(0, 3, 1, 2))
        (root / f"{split}03.json").write_text(json.dumps(index))


def run_ucf_path(record: dict) -> dict:
    """(c) The UCF-101 recipe (``dataset=ucf_101``: online DC-AE tokens at 64
    px, batch 32, the EDM ``AugmentPipe`` on every training clip in the
    loader workers) through ``run(argv)``: :data:`UCF_STEPS` steps from a
    seeded directory, the host's wait for each batch beside the same run
    with ``dataset.augmentation=null``."""
    import shutil
    import statistics

    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.experiments import video_generation as VG

    rec = record.setdefault("ucf", {})
    root = ROOT / "build" / "ucf"
    shutil.rmtree(root, ignore_errors=True)
    write_ucf101(root / "ucf-101", UCF_RES, 270)
    argv = ["+name=ucf", "dataset=ucf_101", "algorithm=dfot_video", "experiment=video_generation",
            f"dataset.save_dir={root / 'ucf-101'}", "experiment.tasks=[training]",
            f"experiment.training.max_steps={UCF_STEPS}", "++algorithm.logging.loss_freq=1",
            "wandb.mode=disabled", f"output_dir={root / 'runs'}"]
    real_make_loader = VG.make_loader
    launches = None
    try:
        for form, extra in (("augmented", []), ("plain", ["dataset.augmentation=null"])):
            waits, pids = [], []

            def timed_loader(*args, **kw):
                return TimedLoader(real_make_loader(*args, **kw), waits, pids)

            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with patched(VG, "make_loader", timed_loader):
                exp = run(argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if form == "augmented":
                launches = ops.launch_counts()
                cfg = exp.cfg
                require(bool(cfg.dataset.augmentation) and exp.algo.is_latent,
                        "the UCF-101 run lacks its augmentation or its latents")
            require(exp.state.step == UCF_STEPS, f"the UCF-101 {form} run took {exp.state.step} "
                                                 f"steps")
            rec[form] = {"wall_s": wall, "waits_s": waits, "workers": len(pids),
                         "later_waits_median_s": statistics.median(waits[1:]) if waits[1:] else None}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(any(launches.values()), "the UCF-101 run launched no kernel")
    c = cfg.experiment.training
    log(f"UCF-101 recipe through python -m dfot_tpu_torch ({UCF_STEPS} steps at batch "
        f"{c.batch_size}, {UCF_RES} px, online DC-AE, {c.data.num_workers} loader workers): "
        + "; ".join(f"{form} {rec[form]['wall_s']:.1f} s, the host's wait a batch "
                    + ", ".join(f"{w:.3f}" for w in rec[form]["waits_s"]) + " s"
                    for form in ("augmented", "plain")) + f"; launches {launches}")
    return {"ucf_train": launches}


def run_capture_path(record: dict) -> dict:
    """(d) Attention capture (``utils/attn_capture.py``): K600 @DiT/XL at full
    width, depth cut to :data:`CAPTURE_DEPTH`, fp32, one denoiser forward of
    a noised seeded latent at level int(0.1 T) with capture on, on the card
    and on the CPU on the same weights: every (B, H, N, N) map within
    :data:`CAPTURE_TOL`."""
    import dataclasses
    import importlib.util

    import torch
    from dfot_tpu_torch.algorithms.dfot_video import build_model, k600_dit_xl
    from dfot_tpu_torch.diffusion import core as dc
    from dfot_tpu_torch.utils.attn_capture import capture_attention_maps

    r = k600_dit_xl()
    r = r._replace(spec=dataclasses.replace(r.spec, depth=CAPTURE_DEPTH))
    card = build_random_model(r, seed=280, token_io=False).eval()
    cpu = build_model(r, token_io=False, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    T = r.max_tokens
    gen = torch.Generator().manual_seed(281)
    xs = torch.randn(1, T, *r.resolution, r.x_channels, generator=gen)
    level = int(r.dcfg.timesteps * 0.1)
    k = torch.full((1, T), level, dtype=torch.long)
    sched = dc.make_schedule(r.dcfg, "cpu")
    x_t = dc.q_sample(sched, xs, k, torch.randn(xs.shape, generator=gen).clamp(-20, 20))
    t0 = time.perf_counter()
    _, maps_card = capture_attention_maps(card, x_t.cuda(), k.float().cuda())
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    _, maps_cpu = capture_attention_maps(cpu, x_t, k.float())
    require(maps_card and sorted(maps_card) == sorted(maps_cpu), "captured maps differ in keys")
    worst = max(float(abs(maps_card[n] - maps_cpu[n]).max()) for n in maps_cpu)
    rec = record["capture"] = {"maps": sorted(maps_card), "max_abs_diff": worst,
                               "tol": CAPTURE_TOL, "card_s": card_s,
                               "shape": list(next(iter(maps_card.values())).shape)}
    require(worst <= CAPTURE_TOL, f"captured maps, card against CPU: {worst:.3e}")
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"attention capture, K600 @DiT/XL (depth cut to {CAPTURE_DEPTH}), level {level}: "
        f"{len(maps_card)} maps {rec['shape']}, card against CPU max |diff| {worst:.3e} "
        f"(tol {CAPTURE_TOL}), {card_s:.2f} s on the card")
    log("  matplotlib is " + ("present" if has_mpl else "absent") + " on this machine: the "
        "heatmap PNGs are rendered and held to the JAX package's in the CPU tests "
        "(tests/test_torch_port_aux.py)")
    del card, cpu
    return {}


def run_slice20_paths(record: dict) -> dict:
    """Phase 26: tensor parallelism on the one card, the serving export, the
    UCF-101 recipe with its AugmentPipe, attention capture."""
    import torch

    t_phase = time.perf_counter()
    log("tensor parallelism, the serving export, UCF-101, attention capture (phase 26):")
    # the export's --load child loads (host work) and runs its window while
    # the tensor-parallel ranks start
    export = start_export_path(record)
    out = run_tp_paths(record)
    out.update(finish_export_path(record, export))
    gc.collect()
    torch.cuda.empty_cache()
    out.update(run_ucf_path(record))
    gc.collect()
    torch.cuda.empty_cache()
    out.update(run_capture_path(record))
    record["phase26_s"] = time.perf_counter() - t_phase
    log(f"  phase 26: {record['phase26_s']:.1f} s")
    return out


def main() -> int:
    # the allocator grows segments in place instead of caching fixed blocks:
    # the flagship's dots step at batch 8 (74.5 GiB predicted) fits only
    # without the fixed blocks' fragmentation (7.6 GiB reserved and unused)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import dfot_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}", file=sys.stderr)
        return 2
    from dfot_tpu_torch.ops import _cuda

    # stated numerics: fp32 matmuls and convolutions in full fp32 (the plain
    # attention's reference products); the models compute in bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"tf32": {"matmul": False, "cudnn": False}}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    record["nvidia_smi"] = smi
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t_start = time.perf_counter()
    _cuda.library()
    record["build"] = {"seconds_total": time.perf_counter() - t_start, **_cuda.build_info}
    log(f"kernel build: {record['build']['seconds_total']:.2f} s "
        f"(nvcc {_cuda.build_info['seconds']:.2f} s) -> {_cuda.build_info['path']}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "nvcc_build.log").write_text(_cuda.build_info["log"])

    laps = record.setdefault("phase_seconds", {})
    t_lap = [time.perf_counter()]

    def lap(label: str) -> None:
        """The seconds since the previous lap, logged and recorded."""
        now = time.perf_counter()
        laps[label] = now - t_lap[0]
        log(f"  [{label}: {laps[label]:.1f} s]")
        t_lap[0] = now

    try:
        log("kernels vs plain versions at the shapes of the paths (bf16):")
        results = check_kernels(record)
        lap("kernel checks")
        from dfot_tpu_torch.algorithms.dfot_video import flagship, uvit3d_pose_base

        small_window_check(record)
        by_path = run_uvit_paths(record, flagship(), "", "flagship", (0, 4, 5, 6, 7, 9),
                                 GRAD_PROBES)
        lap("flagship paths")
        gc.collect()
        torch.cuda.empty_cache()

        # the long-video tasks
        small_rollout_check(record)
        by_path.update(run_long_video_paths(record, flagship()))
        lap("long-video paths")
        gc.collect()
        torch.cuda.empty_cache()

        # the DiT family
        by_path.update(run_xl_paths(record))
        gc.collect()
        torch.cuda.empty_cache()
        by_path["factorized"] = run_factorized_path(record)
        by_path["axial"] = run_axial_path(
            record, flagship(), (2, 3), AXIAL_DEPTH, "axial", "axial U-ViT", (40, 41, 42),
            AXIAL_GRAD_PROBES, AXIAL_NORM_PROBES)
        lap("DiT family and axial U-ViT")
        gc.collect()
        torch.cuda.empty_cache()

        # UViT3DPose at the backbone's own widths: heads of 256 at level 3
        by_path.update(run_uvit_paths(record, uvit3d_pose_base(), "base_", "base-width",
                                      (50, 51, 52, 53, 54, 55), BASE_GRAD_PROBES))
        gc.collect()
        torch.cuda.empty_cache()
        by_path["base_axial"] = run_axial_path(
            record, uvit3d_pose_base(), (3,), BASE_AXIAL_DEPTH, "base_axial",
            "base-width axial U-ViT", (60, 61, 62), BASE_AXIAL_GRAD_PROBES,
            BASE_AXIAL_NORM_PROBES)
        lap("base widths")
        gc.collect()
        torch.cuda.empty_cache()

        # the validation entry point
        by_path["cli"] = run_cli_validation(record, smi)
        lap("phase 17")
        gc.collect()
        torch.cuda.empty_cache()

        # the training entry point
        by_path["train_loop"] = run_cli_training(record, smi)
        lap("phase 18")
        gc.collect()
        torch.cuda.empty_cache()

        # the matrix-attention DiTs, reconstruction guidance, axial pose maps
        by_path.update(run_matrix_paths(record))
        by_path["guided_window"] = run_guided_window_paths(record)
        by_path["axial_precomputed"] = run_axial_precomputed_path(record)
        lap("phase 19")
        gc.collect()
        torch.cuda.empty_cache()

        # the latent path: on-disk data, the VAEs, preprocessing
        by_path.update(run_latent_paths(record, smi))
        lap("phase 20")
        gc.collect()
        torch.cuda.empty_cache()

        # selective remat, VAE training, TiTok and kl-f8 preprocessing
        by_path.update(run_slice15_paths(record, smi))
        lap("phase 21")
        gc.collect()
        torch.cuda.empty_cache()

        # UNet3D, the difference DFoT, FAR-DiT and DiT1D
        by_path.update(run_slice16_paths(record))
        lap("phase 22")
        gc.collect()
        torch.cuda.empty_cache()

        # the metric suite
        by_path.update(run_metric_paths(record))
        lap("phase 23")
        gc.collect()
        torch.cuda.empty_cache()

        # RAFT, AMT-S, PIPs2 and MUSIQ
        by_path.update(run_a15c_paths(record))
        lap("phase 24")
        gc.collect()
        torch.cuda.empty_cache()

        # ring attention, the sequence-parallel window, a one-rank NCCL run
        by_path.update(run_ring_paths(record, results))
        lap("phase 25")
        gc.collect()
        torch.cuda.empty_cache()

        # tensor parallelism, the serving export, UCF-101, attention capture
        by_path.update(run_slice20_paths(record))
        lap("phase 26")
        for name, _, _ in KERNELS:
            require(any(by_path[path].get(name, 0) for path in PATHS),
                    f"kernel {name} was launched on no path")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
        write_timeline()
        return 1
    write_timeline()
    record["seconds_total"] = time.perf_counter() - t_start
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"chip_smoke: all phases passed in {record['seconds_total']:.1f} s")

    launches = {name: {path: by_path[path].get(name, 0) for path in PATHS}
                for name, _, _ in KERNELS}
    log(smi)
    log(json.dumps({"kernels": kernel_summary(results, launches)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
