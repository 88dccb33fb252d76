#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`pigeon_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--requests N]

Phases, one line each, any failure raises:

1. device  - the card's name and power limit (nvidia-smi);
2. build   - kernels K1, K2, K3, K3′, K4, K5, K6, K7, K8, K9 and K10
             and the tuning kernels V1-V5 and V6-V10 (two sources), one
             nvcc for each source, all started together, sm_90a, and the
             native JPEG decoder (g++, where libjpeg's headers exist)
             from the checkout's sources, with nvcc's register, spill and
             wgmma-serialisation (C7513/C7514) lines and the HGMMA count
             of the SASS of the wgmma kernels K1, K2, K3, K3′, K4, K5, K6,
             K7, K8 and K9 and of the two tuning sources, whose V6-V10
             and V1-V5 run K3's and K4's wgmma kernels (cuobjdump; a
             source without HGMMA fails the phase, and so does an HMMA in
             the forward's), and the HGMMA and MUFU.EX2 counts of each
             kernel of V4-V9 (a V5 or V7 kernel without MUFU.EX2 fails
             it: its exps were deleted; so do a V6, V8 or V9 kernel with
             one, or a V6 kernel with another HGMMA count than K3's, or a
             V7, V8 or V9 kernel with another than K3's less 16); the
             K10 instances the main path's and the check shape launch
             must spill nothing, and K10's SASS must hold no atomic;
3. kernel  - each kernel against its plain PyTorch version on the same
             inputs, with median CUDA-event times of both:
             K1 at the serving shape x (4, 577, 1024) bf16, H=16, and at
             the training shape (32 views), max abs error over max
             magnitude <= 2e-2 at each (its kernels record is the serving
             shape's), and its plain version with the value bias dropped
             or the softmax scale of 32-wide heads must miss by more than
             twice that; TFLOP/s, the device ms of its two
             stages (projection GEMM, K3's streaming forward;
             torch.profiler) and, as a yardstick timed only, three
             F.linear and PyTorch's fused attention on the same values;
             K2 at the training shape x (32, 577, 1024) bf16, H=16, each
             of dx/dq/dk/dv's max abs error over its max magnitude
             <= 2e-2; TFLOP/s on the TPU kernel's 341 GFLOP, the device
             ms of its three stages (projection GEMM, K4's attention
             passes, dx GEMM; torch.profiler) and, as a yardstick timed
             only, the composition of three F.linear, PyTorch's fused
             attention backward and one matmul for dx;
             K10 at labels (8, 2) x cells (2203, 2) (the main path's
             shape: its kernels record), (256, 2) (the check shape), and
             (1, 1), (3, 5), (300, 2203), (500, 2203) and (4, 2203)
             ([evaluate]'s last batch), tau 75 km, max
             abs error <= 2e-5 (the repo's bound for the smoothing
             kernel), every row's maximum exactly 1.0 and the same bits
             in two calls, one line a shape; at the first two the
             wrapper's, the bare C call's and the device's ms
             (torch.profiler), the host's enqueue time a call, the plain
             version's ms and the bound;
             K3 at the calibration shape q/k/v (80, 577, 16, 64) bf16, at
             the ``flash`` training shape (32 views) and at the serving
             shape (4 views), max abs error <= 3e-2 at each (its kernels
             record is the calibration shape's); TFLOP/s on its two walks;
             K8 at the int8 serving shape x (4, 577, 1024) bf16, H=16,
             int8 weights quantized from seeded f32 ones, max abs error
             <= 3e-2 and <= 2e-2 of the output's magnitude (K1's bound),
             its plain version with the value bias dropped missing by
             more than twice that; the device ms of its two stages
             (int8 projection GEMM, streaming forward) and, as a
             yardstick timed only, `quantize_static`, three static
             `QuantLinear` products and PyTorch's fused attention
             (`tuning.int8_qkv_composition`);
             K4 at the ``flash`` training shape q/k/v/g (32, 577, 16, 64)
             bf16, each of dq/dk/dv's max abs error over its max
             magnitude <= 2e-2 (K2's bound), and its statistics workspace
             (m, den, r) against the plain statistics pass
             (`flash_attention_backward_stats_reference`), each within
             1e-4 of its magnitude; TFLOP/s counted on the TPU kernel's
             five walks (``walks=5``; the kernel runs seven);
             K5 at the serving shape, raw x (4, 577, 1024) bf16 with f32
             LN parameters, and at the training shape, max abs error over
             max magnitude <= 2e-2 at each; the device ms of its three
             stages (LN1, projection GEMM, streaming forward) and K1's
             yardstick after F.layer_norm;
             K9 at the training shape x (32, 577, 1024), I=4096, and at
             the serving shape (4 views), max abs error over max
             magnitude <= 2e-2 at each, timed with its bound at both, the
             device ms of its three stages (LN2, fc1, fc2) and, as a
             yardstick timed only, the composition in library calls
             (`fused_mlp.ln_mlp_composition`); for K5 and K9 the plain
             version with the LN parameters dropped must miss by more
             than twice the limit, so the check can fail a kernel that
             drops them;
             K6 at the serving shape, raw x (4, 577, 1024), and at the
             training shape (32, 577, 1024), max abs error over max
             magnitude <= 2e-2 (K5's bound) at each, with the same
             dropped-LN guard, timed with its bound at both, the device
             ms of its four stages (LN1, projection GEMM, streaming
             forward, out-projection GEMM) and, as a yardstick timed
             only, F.layer_norm, K1's composition, F.linear and the
             residual;
             K7 at the int8 serving shape, raw x (4, 577, 1024), max abs
             error <= 1.5 out-projection LSBs (ao * max(so) * 127) + 3e-2
             and under 0.5% of elements off by more than 3e-2, with the
             dropped-LN guard on that bound; the device ms of its four
             stages (LN1 + quantize, int8 projection GEMM, streaming
             forward + requantize, int8 out-projection GEMM) and, as a
             yardstick timed only, the Flax-form LayerNorm, K8's
             composition, the quantize, a static `QuantLinear`
             out-projection and the residual
             (`tuning.int8_block_composition`);
             K3′ at K3's shape, max abs error <= 3e-2, K3 timed on the
             same inputs beside it; TFLOP/s on its two walks;
             PyTorch's scaled_dot_product_attention forward at K3's shape
             (K3's and K3′'s yardstick) and its backward at K4's are timed
             as yardsticks, never on a path;
             K1, K3 and K8 at [evaluate]'s batch of 8 images, which no
             other phase launches them at, within their bounds above
             (errors only);
             [eltwise] the inference forward's element-wise kernels
             (`kernels/eltwise.py`) at 8 and 512 x 577 rows (D 1024, I
             4096), and LN, SwiGLU and scale-add + LN at the DINOv2
             cell's 128 x 1,374 rows (D 1536, I 4096), one launch a call,
             sums and SwiGLU bit for bit, quick-GELU within one ulp, LN
             within `ln_within_one_ulp`, each with a planted fault that
             must fail (the two DINOv2 kernels timed with their bytes
             bounds: their kernels records); K1 at the DINOv2 shape (128,
             1374, 1536), 24 heads, within K1's bound, timed;
4. serve   - the PIGEON preset at full ViT-L/14-336 width (24 layers,
             D=1024, 2203 geocells from --seed) with a seeded prototype
             bank and hedging, started by the ``serve`` command's own
             `start_server` on a loopback port; panorama requests built
             from the repo's PNG fixtures must each return 200 with
             coordinates in range, launch K1 exactly 24 times, and land
             on a bank or prototype location; the embedding of the kernel
             forward must match the plain-attention forward (cosine >=
             0.999);
5. serve_int8 - the same model, assets and command with ``--quant
             --calib-images`` on the repo's 20 PNG fixtures (80 views):
             the calibration forward must launch K3 exactly once per layer
             (24) and K1 never; each request K8 24 times and K1 and K3
             never; answers as in ``serve``; the int8 embedding within
             cosine >= 0.99 of the bf16 route's on the same weights and
             panorama; then 3 int8 forwards on the ``flash`` route
             (``serve --quant`` under ``PIGEON_ATTN_IMPL=flash``: static
             int8 projections, K3 24 times, K8 and K1 never), its
             embedding within cosine >= 0.99 of the bf16 route's; the
             request median, forward times, set-up time (quantize and
             calibration included) and peak memory; then the same command
             under ``PIGEON_QUANT_ATTN_IMPL=flash_fused_block``: the
             calibration K3 24 times, each request K7 24 times and K8, K1
             and K3 never, the embedding within cosine >= 0.99 of bf16's;
6. serve_routes - the same assets and command under
             ``PIGEON_ATTN_IMPL=flash_fused_mlp``: each request 200 on a
             bank or prototype location, launching K5 and K9 24 times
             each and K1 and K3 never; then one panorama's serving forward
             under ``flash`` (K3 24 times a forward) and
             ``flash_fused_ln`` (K5 24 times) and ``flash`` under
             ``PIGEON_FLASH_FWD=online`` (K3′ 24 times, K3 never); then
             requests under ``PIGEON_ATTN_IMPL=flash_fused_block``, each
             launching K6 and K9 24 times and K1, K3 and K5 never; each
             route's embedding within cosine >= 0.999 of the
             ``flash_fused`` route's;
7. evaluate - the same preset, width, cells, bank and prototypes, single
             image: a seeded reference-layout SuperGuessr state dict
             (``base_model.*`` + ``cell_layer``, bf16, 0.57 GiB) as
             ``--base``; the ``evaluate`` command's own ``main`` on the
             repo's ``sample20`` benchmark (20 PNGs, batch 8: 3 batches,
             the last of 4) with refinement (the ``im2gps3k`` preset,
             50 candidates) must launch K1 72 times and K10 3 times
             (every other kernel never), and write finite metrics with
             the JAX suite's keys for these inputs; ``evaluate --quant``
             (calibrated on the first 8 images, margin 1.0) K3 24 times
             in the calibration, K8 72 times, K10 3 times, K1 never;
             ``predict --images`` over the 20 PNGs K1 72 times, 20 CSV
             rows in range, each on a bank or prototype location; then,
             outside the counts, a model the CLI builds from the same
             arguments: its patch embed and last layer's q_proj equal to
             the file's tensors, the first batch's embeddings on the
             kernel route within cosine >= 0.999 of the plain route's and
             the int8 tower's within 0.99 of bf16's, and the eval loop
             alone (decode, forward, loss, refiner, metrics; 3 runs after
             a warm-up) timed on each; each run's seconds, images/s and
             peak memory;
7a. serve_batch - the ``[serve]`` model, assets and command with
             ``--serve-batch 8`` (buckets 1, 2, 4, 8, each warmed at
             start-up: K1 24 x 5), bf16 and then ``--quant`` on a
             synthetic calibration batch (K3 24, K8 24 x 5 at start-up):
             8 client threads post 4 rounds of concurrent panoramas, each
             a 200 on a bank or prototype location; fewer batches than
             requests, K1 (K8) exactly 24 a batch; the same clients on the
             serialised path of the same server; each panorama's row of
             one coalesced batch within cosine >= 0.999 (int8 0.99) of it
             served alone; the latency median and maximum, the fills and
             images/s of both paths, and the forward at fills 3, 5, 7
             against bucket 8 (the padded rows' cost);
7b. export - ``export --platforms cuda,cpu`` (a symbolic batch, the
             plain route; bf16, then ``--quant``) through the CLI's own
             ``main`` (no kernel launched); ``serve --artifact`` on the
             card answers 5 requests as ``[serve]``'s, launching no
             kernel, its program calling no ``pigeon::`` operator; each
             embedding within cosine >= 0.999 and the top-k
             probabilities within 2e-3 of live ``serve`` under
             ``PIGEON_ATTN_IMPL=xla`` (``PIGEON_QUANT_ATTN_IMPL=xla``) on
             the same weights; export and load seconds, artifact MiB;
7c. landmarks - ``serve --landmarks --hedge`` (the PIGEOTTO preset,
             single images) with ``[serve]``'s dataset and a second,
             4,096-row landmark one listed comma-separated: the bank holds
             both's rows, a landmark prototype addresses the rows after
             the first bank's, 5 requests each a 200 on a location of
             either and K1 24 times;
8. train   - the ``finetune`` command's own functions on the same preset
             and width (panorama, multi-task, heading; 2203 seeded cells;
             32 train and 8 val panoramas from the PNG fixtures, seeded
             labels), batch 8 panoramas, remat ``attn_kernel``: one epoch
             of 4 steps and an eval pass must launch K1 24 x 5, K2 24 x 4
             and K10 5 times, keep finite losses and write the best
             checkpoint; on the first batch every trainable gradient of
             the kernel route (K1 + K2 + K10) must match the plain route
             (plain attention under autograd, plain smoothing) with cosine
             >= 0.999 and the loss parts within 1e-2 relative; then step
             times, the peak memory under ``attn_kernel`` and ``none``,
             and ``--resume`` continuing from the checkpoint's step;
9. train_routes - the ``[train]`` preset, width and batch under remat
             ``attn_kernel`` on ``flash``, ``flash_fused_ln``,
             ``flash_fused_mlp``, ``flash_fused`` with
             ``PIGEON_FUSED_BWD=xla``, ``flash_fused_block`` and ``flash``
             with ``PIGEON_FLASH_FWD=online``: first-batch gradients
             within cosine >= 0.999 of the plain route's, then 2 steps and
             an eval batch
             with finite losses and the exact launch counts that
             `check_train_routes` states; step time, images/s and peak
             memory per route;
10. train_durable - the rest of ``finetune`` at the ``[train]`` preset,
             width and batch (`check_train_durable` states each check and
             its bounds): one step under each remat policy (``none``,
             ``full``, ``attn_out``, ``attn_kernel``, ``attn_slim`` on
             ``flash_fused``; ``attn_kernel``, ``attn_slim``, ``attn_out``
             on ``flash_fused_block``) with exact launches, gradients
             within cosine >= 0.999 of ``none``'s, step time and peak
             memory; a `train_model` run rolled back once from a NaN
             label row; ``finetune`` stopped by SIGTERM and resumed bit
             for bit; an async checkpoint written during the next steps;
             a profiler window that names K1's and K2's kernels;
             ``finetune -m`` on two metadata files without the
             multi-task columns through the GeoAugmentor; two steps of a
             hierarchical panorama head;
10a. scale_out - the scale-out of ``finetune`` and ``evaluate`` at the
             ``[train]`` preset and width (24 layers), 16 + 8 + 8
             panoramas at a global batch of 8 (2 steps): first K1, K2
             and K8 at x (32, 577, 1024) with P = 512 and 256 (ViT-L's
             local heads at tp = 2 and 4) against their plain versions
             within K1's, K2's and K8's limits, each timed beside its
             plain version and library composition (`check_local_heads`);
             then the one-process run (K1 72, K2 48, K10 3), and
             `torchrun --nproc-per-node 1` over NCCL with ``--fsdp`` and
             with ``--tp 1`` (each rank's exact launches, step ms and
             peak GiB; its DCP checkpoint read back here, its parameters
             against the one-process run's by `params_agree`, and
             ``evaluate -t`` on it: K1 24, K10 1); then two ranks sharing
             the card over gloo (`rig_rank`): DDP and ``--tp 2``, 2 steps
             each (K1 48, K2 48, K10 2 a rank; parameters against the
             one-process run's), ``evaluate --quant --tp 2`` (K8 24 a
             rank, on 8 heads), and ``--fsdp`` in ranks of their own
             (where gloo lacks what FSDP2 needs, the line says so); and
             with two cards or more ``--fsdp`` at 2 ranks over NCCL;
11. embed  - the same width on the ``[train]`` phase's 32 + 8 panoramas
             and 2203 cells, batch 8, through the CLI's own ``main``:
             ``embed --panorama`` with a seeded HF CLIP ``--base`` file
             (K1 24 x 5, banks (32, 4, 1024) and (8, 4, 1024) with their
             indices), ``embed --quant`` (K3 24 in the calibration, K8
             24 x 5, K1 never; every row within cosine >= 0.99 of bf16's),
             ``embed --embedder vit`` with a seeded HF ViT file (K1 24 x
             5, K9 never), ``finetune --embeddings --panorama`` on the
             bf16 banks for 2 epochs (K10 (4 + 1) x 2, K1 and K2 never,
             finite losses, a checkpoint); each bf16 bank's first batch
             within cosine >= 0.999 a row of the plain route on a model
             the CLI builds; the head's first-step gradients on K10
             within 0.999 of plain smoothing; then, outside the counts,
             K1 at the sweep's batch (512, 577, 1024) and K8 at the int8
             sweep's (48) against their plain versions on the first and
             last 8 rows (K1's bounds), timed; the sweep's images/s over
             1024 single fixture images (bf16 at 512, int8 at 48; median
             of 3 after a warm-up, decoding included) with peak memory
             and its split (the input pipeline alone; a batch's copy to
             the card and its forward, each synchronised); and the
             head-only train step at the preset's batch of 256
             (K10 at (256, 2203) once a step);
11a. pretrain - the ``pretrain`` command's own ``main`` at full width
             (ViT-L/14-336 vision, ViT-L/14 text, `HashTokenizer` at
             49,408 ids) on 513 captioned ``o``/``v``/``l`` items over
             the PNG fixtures: 16 micro-batches of the preset's 32 and 8
             an update (two updates), remat ``attn_kernel``: K1 24 a
             forward (16 steps and the retrieval probe's 4 + 4 batches),
             K2 24 a step, finite losses, the first micro-batch's vision
             gradient (one vector) within cosine >= 0.999 of the plain
             route's on the same batch, its worst tensor's cosine and
             both routes' cosines against the plain route in f32 beside
             it, a checkpoint of step 16; micro-step ms,
             images/s, peak memory, the retrieval accuracy before and
             after;
11b. zeroshot - K1 at ViT-B/32's shape, (8, 50, 768) and (4, 50, 768)
             with 12 heads (one partial 128-row tile), against its plain
             version with K1's bound and fault guard, timed at 8 beside
             the plain version and the library composition; then
             ``evaluate --zeroshot --model vit-b32 -b`` (a seeded bf16
             HF CLIP B/32 state dict) on ``sample20`` at batch 8 through
             the CLI's ``main``: K1 12 a batch (36), finite metrics with
             the suite's keys;
11c. geocell_ladder - the offline artifact ladder through the CLI's
             own ``main`` on a seeded world of 4,096 training and 512
             held-out rows around 36 sites in three synthetic countries
             (the PNG fixtures as images) with an admin-2 GeoJSON:
             ``geocells --load`` (the PIGEON preset's 30/60 cells, host
             only: no launch), ``embed`` at full width, batch 512 (K1 24
             a batch), ``prototypes --geocells`` (host only), ``evaluate
             -t --prototypes --embeddings --metadata`` refined at batch
             64 (K1 24 and K10 1 a batch); each command's seconds, the
             cell count and size range, the prototype count, whether
             scikit-learn is importable; every training row in its cell
             or at the nearest one, the C++ OPTICS graph equal to the
             numpy one on three cells, the stored xi case's labels
             (`tests/test_torch_geokernels.py`), finite metrics;
11d. pipeline - the GPipe schedule at pp = 2, M = 4 over two gloo
             ranks sharing the card (12 layers a stage, ViT-L/14-336 at
             full width, 16 images): the tower's output within 2e-2 of
             its magnitude of one process's, two train steps of the whole
             model with loss and grad_norm within 5e-3 of one process's,
             each rank's K1, K2 and K10 launches exactly as predicted;
11e. embed_dinov2 - (run after [embed]) ``embed --model
             dinov2-g14-reg`` (ViT-g/14-reg4 at 518 px, 40 layers, seeded by the CLI) through the CLI's
             own ``main`` on the same 32 + 8 panoramas, batch 8: K1 and
             `swiglu_bf16` 40 and `scale_add_layer_norm_bf16` 80 a
             batch, `layer_norm_bf16` once, nothing else of the bf16
             routes or CLIP's element-wise kernels; banks (32, 4, 1536)
             and (8, 4, 1536); the first batch within cosine >= 0.999 a
             row of the plain route on a model the CLI builds;
12. variants - the tuning drivers `scripts/bench_torch_attn_bwd.py`,
             `bench_torch_attn_fwd_diag.py` and
             `bench_torch_attn_qkv_fused.py` through their own ``run`` at
             the TPU scripts' flagship shape (32 views, S = 577, H = 16;
             x (32, 577, 1024)), 3 windows of 3 calls: every variant
             checked against its plain version (`check_variants` states
             the bounds) and timed beside it and the SDPA yardstick; the
             tuning kernels V1-V10 launched there. The kernels line's
             launches of K1-K10 and K3′ stay those of phases 4-11b. Then,
             from the same driver runs, V10's ms beside K3′'s and V1's,
             split4's (V2 + V3), V4's and V5's beside K4's, and V1's,
             V2's, V3's, V4's, V5's and K4's device ms by pass
             (statistics, gradient, dq, V2's dq rows, V5's dl sweep;
             torch.profiler, by each wrapper's tag; a pass a wrapper does
             not launch must show none), with V2's and V3's wrapper and
             bare C call ms, then K4's gradient pass minus V4's and K4's
             statistics pass minus V5's, after the launches are read;
             then V6's-V9's ms beside K3's, and K3's, V6's-V9's and
             V10's device ms (torch.profiler, by tag: V6 casts for the
             softmax chain, V7 drops the P V product, V8 and V9 are the
             score walk alone), then K3's minus V6's-V9's, and V7's and
             V6's minus V9's.

The second-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script fails before printing any result.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import csv
import dataclasses
import functools
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
#: Each kernel: its CUDA source and the TPU kernel body it replaces.
KERNELS = {
    "fused_qkv_attention": (
        "pigeon_tpu_torch/csrc/fused_qkv_attention.cu",
        "pigeon_tpu/kernels/flash_attention.py:311"),
    "fused_qkv_attention_bwd": (
        "pigeon_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
        "pigeon_tpu/kernels/flash_attention.py:375"),
    "smooth_labels": (
        "pigeon_tpu_torch/csrc/smooth_labels.cu",
        "pigeon_tpu/kernels/geodesy.py:53"),
    "flash_attention": (
        "pigeon_tpu_torch/csrc/flash_attention.cu",
        "pigeon_tpu/kernels/flash_attention.py:56"),
    "fused_qkv_attention_int8": (
        "pigeon_tpu_torch/csrc/fused_qkv_attention_int8.cu",
        "pigeon_tpu/kernels/flash_attention.py:950"),
    "flash_attention_bwd": (
        "pigeon_tpu_torch/csrc/flash_attention_bwd.cu",
        "pigeon_tpu/kernels/flash_attention.py:166"),
    "fused_ln_qkv_attention": (
        "pigeon_tpu_torch/csrc/fused_ln_qkv_attention.cu",
        "pigeon_tpu/kernels/flash_attention.py:594"),
    "fused_mlp": (
        "pigeon_tpu_torch/csrc/fused_mlp.cu",
        "pigeon_tpu/kernels/fused_mlp.py:67"),
    "fused_block_attention": (
        "pigeon_tpu_torch/csrc/fused_block_attention.cu",
        "pigeon_tpu/kernels/flash_attention.py:694"),
    "fused_block_attention_int8": (
        "pigeon_tpu_torch/csrc/fused_block_attention_int8.cu",
        "pigeon_tpu/kernels/flash_attention.py:844"),
    "flash_attention_online": (
        "pigeon_tpu_torch/csrc/flash_attention_online.cu",
        "pigeon_tpu/kernels/flash_attention.py:94"),
    "bwd_r_from_o": (
        "pigeon_tpu_torch/csrc/attention_bwd_variants.cu",
        "scripts/bench_attn_bwd.py:58"),
    "attention_dq": (
        "pigeon_tpu_torch/csrc/attention_bwd_variants.cu",
        "scripts/bench_attn_bwd.py:109"),
    "attention_dkv": (
        "pigeon_tpu_torch/csrc/attention_bwd_variants.cu",
        "scripts/bench_attn_bwd.py:128"),
    "bwd_dots_only": (
        "pigeon_tpu_torch/csrc/attention_bwd_variants.cu",
        "scripts/bench_attn_bwd.py:171"),
    "bwd_vpu_only": (
        "pigeon_tpu_torch/csrc/attention_bwd_variants.cu",
        "scripts/bench_attn_bwd.py:194"),
    "fwd_dots_only": (
        "pigeon_tpu_torch/csrc/attention_fwd_variants.cu",
        "scripts/bench_attn_fwd_diag.py:47"),
    "fwd_softmax_only": (
        "pigeon_tpu_torch/csrc/attention_fwd_variants.cu",
        "scripts/bench_attn_fwd_diag.py:58"),
    "fwd_qk_only": (
        "pigeon_tpu_torch/csrc/attention_fwd_variants.cu",
        "scripts/bench_attn_fwd_diag.py:69"),
    "fwd_qk_chunked": (
        "pigeon_tpu_torch/csrc/attention_fwd_variants.cu",
        "scripts/bench_attn_fwd_diag.py:92"),
    "flash_attention_online_c256": (
        "pigeon_tpu_torch/csrc/attention_fwd_variants.cu",
        "scripts/bench_attn_fwd_diag.py:107"),
    "swiglu_bf16": (
        "pigeon_tpu_torch/csrc/eltwise.cu",
        "pigeon_tpu_torch/kernels/eltwise.py:131"),
    "scale_add_layer_norm_bf16": (
        "pigeon_tpu_torch/csrc/eltwise.cu",
        "pigeon_tpu_torch/kernels/eltwise.py:144"),
}
#: The sources whose products run on wgmma (the build phase counts their
#: HGMMA instructions).
WGMMA_SOURCES = ("flash_attention", "flash_attention_bwd",
                 "fused_qkv_attention_bwd", "flash_attention_online",
                 "fused_qkv_attention", "fused_ln_qkv_attention",
                 "fused_block_attention", "fused_mlp",
                 "fused_qkv_attention_int8", "fused_block_attention_int8",
                 "attention_fwd_variants", "attention_bwd_variants")
#: K2's stages by the tag in their kernels' names (`csrc/
#: fused_qkv_attention_bwd.cu`), for [kernel]'s device-time split.
K2_STAGES = (("projection", "K2Projection"), ("attention", "K2Attention"),
             ("dx", "K2Dx"))
#: K2's time in its WMMA design (four launches), H100 80GB HBM3 at 700 W
#: (PERF.md), printed beside the wgmma design's.
K2_WMMA_MS = "5.31-5.39"
#: K1's and K5's stages by the tags in their kernels' names (`csrc/
#: fused_qkv_attention.cu`, `fused_ln_qkv_attention.cu`).
K1_STAGES = (("projection", "K1Projection"), ("attention", "K1Attention"))
K5_STAGES = (("layer_norm", "K5LayerNorm"), ("projection", "K5Projection"),
             ("attention", "K5Attention"))
#: K1's and K5's times by views in their resident-block WMMA design, H100
#: 80GB HBM3 at 700 W (PERF.md; K5 at 32 views from the route profile's
#: 93.8 ms over 24 launches), printed beside the wgmma design's.
K1_WMMA_MS = {4: "0.905-0.934", 32: "3.725-3.768"}
K5_WMMA_MS = {4: "1.014-1.058", 32: "3.91"}
#: K6's and K9's stages by the tags in their kernels' names (`csrc/
#: fused_block_attention.cu`, `fused_mlp.cu`).
K6_STAGES = (("layer_norm", "K6LayerNorm"), ("projection", "K6Projection"),
             ("attention", "K6Attention"),
             ("out_projection", "K6OutProjection"))
K9_STAGES = (("layer_norm", "K9LayerNorm"), ("fc1", "K9Fc1"),
             ("fc2", "K9Fc2"))
#: K6's and K9's times by views in their WMMA design (K6 the resident
#: block and a tiled out-projection, K9 two tiled GEMMs), H100 80GB HBM3
#: at 700 W (PERF.md), printed beside the wgmma design's.
K6_WMMA_MS = {4: "1.067-1.204", 32: "4.146-4.495"}
K9_WMMA_MS = {4: "0.461-0.511", 32: "2.279-2.479"}
#: K8's and K7's stages by the tags in their kernels' names (`csrc/
#: fused_qkv_attention_int8.cu`, `fused_block_attention_int8.cu`).
K8_STAGES = (("projection", "K8Projection"), ("attention", "K8Attention"))
K7_STAGES = (("layer_norm", "K7LayerNorm"), ("projection", "K7Projection"),
             ("attention", "K7Attention"),
             ("out_projection", "K7OutProjection"))
#: K8's and K7's times at 4 views in their resident-block WMMA designs,
#: H100 80GB HBM3 at 700 W (PERF.md), printed beside the wgmma design's.
K8_WMMA_MS, K7_WMMA_MS = "0.61-0.81", "0.706-0.741"
#: The tuning drivers run by [variants], in order: the ports of
#: `scripts/bench_attn_bwd.py`, `bench_attn_fwd_diag.py` and
#: `bench_attn_qkv_fused.py`.
DRIVERS = ("bench_torch_attn_bwd", "bench_torch_attn_fwd_diag",
           "bench_torch_attn_qkv_fused")
#: Each tuning kernel's work at (B, S, H, 64), counted from its TPU body:
#: S x S x 64 bf16 products, f32 operations on each S x S score element
#: (where the diagnostic is about them), (B, S, H, 64) bf16 tensors read
#: or written, (B, H, S) f32 side outputs.
VARIANT_WORK = {
    "bwd_r_from_o": (6, 0, 7, 0),
    "attention_dq": (3, 0, 5, 0),
    "attention_dkv": (4, 0, 6, 0),
    "bwd_dots_only": (5, 0, 7, 0),
    "bwd_vpu_only": (1, 10, 6, 1),
    "fwd_dots_only": (2, 0, 4, 0),
    "fwd_softmax_only": (1, 5, 4, 0),
    "fwd_qk_only": (1, 0, 4, 1),
    "fwd_qk_chunked": (1, 1, 4, 0),
    "flash_attention_online_c256": (2, 0, 4, 0),
}
#: The yardstick each tuning kernel's ``library_ms`` takes: the one
#: PyTorch call that computes the same function, or its composition in
#: library calls, where there is one (the drivers time both).
VARIANT_LIBRARY = {"bwd_r_from_o": "sdpa_backward",
                   "attention_dq": "sdpa_backward",
                   "attention_dkv": "sdpa_backward",
                   "bwd_dots_only": "dots_only_composition",
                   "fwd_dots_only": "fwd_dots_only_composition",
                   "fwd_softmax_only": "fwd_softmax_only_composition",
                   "fwd_qk_only": "fwd_qk_only_composition",
                   "fwd_qk_chunked": "fwd_qk_chunked_composition",
                   "flash_attention_online_c256": "sdpa_forward"}
#: [variants]: each driver's windows and calls a window.
VARIANT_ITERS, VARIANT_WINDOWS = 3, 3
#: [variants]: the tuning kernels on K3's and K4's wgmma kernels, each
#: beside the K kernel whose design it shares, by the drivers' variant
#: names: V10 (256-key steps) beside K3′ (128), V1, split4 (V2 + V3), V4
#: and V5 beside K4, V6-V9 beside K3.
VARIANT_PAIRS = (("online_softmax_p4_c256", "online_softmax_p4_c128"),
                 ("r_from_o_pack2", "base_pack2"),
                 ("split4", "base_pack2"),
                 ("diag_dots_only_p2", "base_pack2"),
                 ("diag_vpu_only_p2", "base_pack2"),
                 ("diag_dots_only_p4", "base_fwd_pack4"),
                 ("diag_softmax_only_p4", "base_fwd_pack4"),
                 ("diag_qk_only_p4", "base_fwd_pack4"),
                 ("diag_qk_chunked_p4", "base_fwd_pack4"))
#: The attention backward's passes by their kernels' names
#: (`csrc/flash_bwd_sm90.cuh`; V1's statistics pass is its own, V2's dq
#: rows and V5's dl sweep are theirs alone), and each wrapper's tag and
#: the passes it launches, for [variants]' device-time split: a listed
#: pass must show device time under the tag, an unlisted one none.
BWD_PASSES = (("statistics", "bwd_stats"), ("gradient", "bwd_grad"),
              ("dq", "bwd_dq"), ("dq_rows", "bwd_rows"),
              ("dl_sweep", "bwd_dl_sweep"))
BWD_TAGS = (("bwd_r_from_o", "V1Attention", ("statistics", "gradient", "dq")),
            ("attention_dq", "V2Attention", ("statistics", "dq_rows")),
            ("attention_dkv", "V3Attention", ("statistics", "gradient")),
            ("bwd_dots_only", "V4Attention", ("gradient", "dq")),
            ("bwd_vpu_only", "V5Attention", ("statistics", "dl_sweep")),
            ("flash_attention_bwd", "K4Attention",
             ("statistics", "gradient", "dq")))
#: [variants]: each diagnostic's pass against K4's same pass, device ms
#: (K4's minus the diagnostic's): the exps' share of K4's gradient pass
#: (V4 runs it with casts for the softmax chain) and the dp product's
#: share of K4's statistics pass (V5 runs it without G V^T).
BWD_DIFFS = (("gradient", "bwd_dots_only"), ("statistics", "bwd_vpu_only"))
#: [variants]: the forward's one pass, K3's streaming forward
#: (`csrc/flash_fwd_sm90.cuh`), by each wrapper's tag, as the backward's
#: passes: K3, V6 (casts for the softmax chain), V7 (no P V product), V8
#: and V9 (the score walk alone, under a row-sum chain) and V10 (256-key
#: steps); then K3's minus each diagnostic's (`FWD_DIFFS`): what the
#: softmax chain costs K3, what the P V walk costs it, and what it spends
#: beyond its score walk; then each diagnostic's minus the score walk's
#: (`FWD_WALK_DIFFS`, V7's and V6's minus V9's): the softmax chain on one
#: walk, which nothing overlaps, and the P V walk without a chain.
FWD_PASSES = (("forward", "flash_attention_kernel_wgmma"),)
FWD_TAGS = (("flash_attention", "K3Forward", ("forward",)),
            ("fwd_dots_only", "V6Attention", ("forward",)),
            ("fwd_softmax_only", "V7Attention", ("forward",)),
            ("fwd_qk_only", "V8Attention", ("forward",)),
            ("fwd_qk_chunked", "V9Attention", ("forward",)),
            ("flash_attention_online_c256", "V10OnlineForward", ("forward",)))
FWD_DIFFS = (("forward", "fwd_dots_only"), ("forward", "fwd_softmax_only"),
             ("forward", "fwd_qk_only"), ("forward", "fwd_qk_chunked"))
FWD_WALK_DIFFS = (("fwd_softmax_only", "fwd_qk_chunked"),
                  ("fwd_dots_only", "fwd_qk_chunked"))
#: [sass]: the tuning kernels whose every kernel's HGMMA and MUFU.EX2
#: counts the build phase prints, by tag; the diagnostics whose kernels
#: must each keep MUFU.EX2 (their exps are the measured work); those
#: whose kernels must have none (their exps were cast away).
SASS_TAGS = ("V4Attention", "V5Attention", "V6Attention", "V7Attention",
             "V8Attention", "V9Attention")
SASS_EXPS = ("V5Attention", "V7Attention")
SASS_NO_EXPS = ("V6Attention", "V8Attention", "V9Attention")
#: Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates at
#: 700 W): operations per second by operand type, and device-memory
#: bytes per second. A kernel's bound is the largest of its bytes over the
#: memory rate and its operations of each type over that type's rate (the
#: tensor cores and the f32 CUDA cores run at the same time).
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
#: K1 against its plain version, max abs error over the output's max
#: magnitude (K5's bound): a bf16 output one ulp apart is up to 2^-7 of it,
#: q/k/v are rounded to bf16 from f32 sums taken in another order, and p
#: against the running max over 128-key chunks, the plain version's against
#: the exact row max. An absolute bound would not do: averaged over 577
#: keys the outputs are ~0.03.
K1_TOL = 2e-2
#: K2 against its plain version, each output's max abs error over its
#: max magnitude: the two round u and dl to bf16 from f32 values summed
#: in another order, so one operand of each product may sit one bf16 ulp
#: (2^-8 relative) apart, and the sums over 577 keys and 3072 projection
#: columns carry that through.
K2_TOL = 2e-2
K10_TOL = 2e-5
K3_TOL = 3e-2
#: K8 against its plain version: max abs error (the repo's bf16 attention
#: bound), and over the output's max magnitude K1's bound, K8 being K1's
#: stages on int8 operands (q/k/v equal bit for bit, p rounded against
#: the running max): the absolute bound alone could not see a streaming
#: error on outputs of ~0.03.
K8_TOL = 3e-2
#: K4 against its plain version, each output's max abs error over its max
#: magnitude: the backward K2 runs after its projection, so K2's bound.
K4_TOL = 2e-2
#: K4's statistics workspace (m, den, r) against the plain statistics
#: pass, each row's max abs error over its max magnitude: the same f32
#: sums over 128-key chunks in another order, exp2 with log2(e) folded
#: into the scale.
K4_STATS_TOL = 1e-4
#: K5 against its plain version, max abs error over the output's max
#: magnitude: a bf16 output one ulp apart is up to 2^-7 of it, and q/k/v
#: and p are rounded to bf16 from f32 sums taken in another order.
K5_TOL = 2e-2
#: K9 against its plain version, max abs error over the output's max
#: magnitude: h is rounded to bf16 from f32 sums taken in another order,
#: and fc2 sums 4096 of them.
K9_TOL = 2e-2
#: K6 against its plain version, max abs error over the output's max
#: magnitude: K5's bound (the attention output is K5's, rounded to bf16
#: from sums taken in another order, before the f32 out-projection).
K6_TOL = 2e-2
#: K7 against its plain version, absolute: a requantize flip (one ulp of
#: LN or of the attention at a round() boundary) moves an output by up to
#: one out-projection LSB, ``ao * max(so) * 127``; past that, bf16
#: rounding. At most this share of elements may be off by more than the
#: additive term.
K7_ABS, K7_SHARE = 3e-2, 5e-3
K3_ONLINE_TOL = 3e-2
#: The int8 route's embedding against the bf16 route's, same weights.
INT8_COSINE = 0.99
#: The inference forward's element-wise kernels (`kernels/eltwise.py`).
ELTWISE_KERNELS = ("layer_norm_bf16", "add_layer_norm_bf16",
                   "quick_gelu_bf16")
#: Their backwards, which training launches.
ELTWISE_BACKWARDS = ("layer_norm_bwd_bf16", "add_layer_norm_bwd_bf16",
                     "quick_gelu_bwd_bf16")
#: [eltwise], [embed_dinov2]: DINOv2 ViT-g/14-reg4 at 518 px, as the
#: benchmark's DINOv2 cell runs it: images a batch, tokens an image
#: (CLS, 4 registers, 37 x 37 patches), width, SwiGLU width, heads, layers.
DINOV2_BATCH, DINOV2_SEQ, DINOV2_D = 128, 1374, 1536
DINOV2_I, DINOV2_H, DINOV2_LAYERS = 4096, 24, 40
#: [serve]: the served embedding (the element-wise kernels) against the
#: eager chain's forward of the same model (`eager_chain`), relative L2
#: error: the benchmark's embedding limit.
ELTWISE_EMBED_TOL = 0.012
#: Every other bf16 route's embedding against the ``flash_fused`` one's,
#: and every route's trainable gradients against the plain route's.
ROUTE_COSINE = 0.999
NUM_CELLS = 2203
BANK_ROWS = 16384
#: [evaluate]: the benchmark (its 20 images in 3 batches, the last of 4)
#: and the seed offset of the ``--base`` file's weights.
EVAL_BENCHMARK, EVAL_IMAGES, EVAL_BATCH = "sample20", 20, 8
BASE_SEED = 1
#: [evaluate]: timed runs of the eval loop alone, each model.
EVAL_LOOP_RUNS = 3
TRAIN_ROWS, VAL_ROWS, TRAIN_BATCH = 32, 8, 8
#: K10's shapes, labels x cells: the main path's (every train step and
#: eval batch but [evaluate]'s last), the check shape, one cell, fewer
#: cells than a cluster's CTAs, 300 labels, a ragged last row tile of 8
#: rows (500 = 62 x 8 + 4), and [evaluate]'s last batch; the first two
#: are timed.
K10_TIMED = ((TRAIN_BATCH, NUM_CELLS), (256, NUM_CELLS))
K10_SHAPES = (*K10_TIMED, (1, 1), (3, 5), (300, NUM_CELLS),
              (500, NUM_CELLS),
              (EVAL_IMAGES % EVAL_BATCH, NUM_CELLS))
#: [train_routes]: each route takes this many steps and one eval batch.
ROUTE_STEPS = 2
#: [embed]: the sweep's timed batches (bf16: the preset's sweep batch;
#: int8: `default_batch`'s), the single fixture images each timed run
#: embeds (two bf16 batches), its timed runs, and the head-only train
#: step's timed steps.
EMBED_BATCH, EMBED_BATCH_INT8 = 512, 48
EMBED_TIMED_IMAGES, EMBED_TIMED_RUNS, HEAD_STEPS = 1024, 3, 20


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def bound(ops: dict, nbytes: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel that does ``ops`` (count
    by operand type) and must move ``nbytes`` (each input read once, each
    output written once)."""
    ops_ms = max(n / PEAK_OPS[kind] for kind, n in ops.items()) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_errors(got, want, names) -> dict:
    """Each output's max abs error over its max magnitude; raises on a
    value that is not finite."""
    import torch

    errs = {}
    for name, a, w in zip(names, got, want):
        if not bool(torch.isfinite(a.float()).all()):
            raise RuntimeError(f"{name} is not finite")
        errs[name] = ((a.float() - w.float()).abs().max()
                      / w.float().abs().max()).item()
    return errs


def max_abs(got, want) -> float:
    return max((a.float() - w.float()).abs().max().item()
               for a, w in zip(got, want))


def median_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event-timed calls of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def check_kernel(seed: int) -> dict:
    """K1 against its plain version at the serving shape (4 views) and
    the training shape (32 views); the record is the serving shape's."""
    records = {b: check_kernel_at(seed, b) for b in (4, 32)}
    return records[4]


def check_qkv_fault_shows(reference, args, want, tol: float):
    """K1's plain version ``reference`` with the value bias dropped, and
    with the scores scaled as for heads of 32 (q times sqrt(2)), must miss
    ``want`` by more than twice ``tol``: the check can fail a kernel that
    drops a bias or mis-scales the softmax."""
    import torch

    x, wq, wk, wv, bq, bk, bv, h = args
    sq2 = [(t.float() * 2 ** 0.5).bfloat16() for t in (wq, bq)]
    for label, wrong in (
            ("value bias", (x, wq, wk, wv, bq, bk, torch.zeros_like(bv), h)),
            ("softmax scale", (x, sq2[0], wk, wv, sq2[1], bk, bv, h))):
        miss = rel_errors([reference(*wrong)], [want], (label,))[label]
        if not miss > 2 * tol:
            raise RuntimeError(f"K1's check cannot see a wrong {label}: it "
                               f"moves the output by {miss} of its "
                               f"magnitude, limit {tol}")


def check_kernel_at(seed: int, b: int) -> dict:
    """K1 at ``b`` views of (577, 1024), H=16: error, the fault guard,
    times, its stages' device time and the library composition's time."""
    import torch

    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.tuning import qkv_composition, qkv_operands

    s, d, h = 577, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, ws, bs = qkv_operands(gen, b, s, d, raw=False)
    got = k1.fused_qkv_attention(x, *ws, *bs, h)
    want = k1.fused_qkv_attention_reference(x, *ws, *bs, h)
    torch.cuda.synchronize()
    rel = rel_errors([got], [want], ("out",))["out"]
    if not rel <= K1_TOL:
        raise RuntimeError(f"K1 disagrees with its plain version at {b} "
                           f"views: max abs error over max magnitude {rel} "
                           f"(limit {K1_TOL})")
    check_qkv_fault_shows(k1.fused_qkv_attention_reference,
                          (x, *ws, *bs, h), want, K1_TOL)
    err = max_abs([got], [want])
    del want
    ms = median_ms(lambda: k1.fused_qkv_attention(x, *ws, *bs, h))
    stages = device_ms_by_mark(
        lambda: k1.fused_qkv_attention(x, *ws, *bs, h), K1_STAGES)
    plain_ms = median_ms(lambda: k1.fused_qkv_attention_reference(
        x, *ws, *bs, h), runs=10)
    composition_ms = median_ms(lambda: qkv_composition(x, ws, bs, h))
    # 2*B*S*D*P for each projection, 2*B*H*S*S*dh for QK^T and for PV.
    flop = 3 * 2 * b * s * d * d + 2 * 2 * b * h * s * s * 64
    gflop = flop / 1e9
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"bf16": flop}, nbytes(x, *ws, *bs, got)),
           "library_ms": None}
    phase("kernel", name="fused_qkv_attention", shape=f"({b},{s},{d})",
          heads=h, out_err=round(rel, 6), tol=K1_TOL, max_abs_err=err,
          ms=ms, wmma_design_ms=K1_WMMA_MS[b],
          **{f"{n}_device_ms": round(v, 4) for n, v in stages.items()},
          plain_ms=plain_ms, bound_ms=rec["bound_ms"],
          composition_ms=composition_ms, gflop=round(gflop, 1),
          tflops=round(gflop / ms, 1),
          plain_tflops=round(gflop / plain_ms, 1))
    return rec


def device_ms_by_mark(fn, marks, calls: int = 5, expect=()) -> dict:
    """Self device milliseconds a call of ``fn`` spends in the kernels
    whose names hold each ``(label, mark)``'s mark (a string, or a tuple
    of strings a name must all hold), and in the rest (``other``), from
    `torch.profiler` over ``calls`` calls. Each kernel counts its mean
    over the launches the profiler recorded, times its launches a call
    (at least one): late in a long process the profiler may drop some
    kernels' records (seen on the H100: 2-4 of 5), which a sum over
    ``calls`` would read as less device time, or all of a window's
    records (seen there too, in three windows of 5 calls in a row), so
    it profiles up to six windows, each of twice the calls of the last,
    until every label in ``expect`` shows device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(6):
        window_calls = calls << window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(window_calls):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys([label for label, _ in marks] + ["other"], 0.0)
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            if not us or not evt.count:
                continue
            label = next((lb for lb, mark in marks
                          if all(m in evt.key for m in
                                 ((mark,) if isinstance(mark, str)
                                  else mark))), "other")
            out[label] += (us / evt.count
                           * max(1, round(evt.count / window_calls)) / 1e3)
        if all(out[label] > 0 for label in expect):
            break
    if window:
        phase("profiler", windows=window + 1, expect=",".join(expect))
    return out


def check_backward_kernel(seed: int) -> dict:
    """K2 against its plain version at the training shape (8 panoramas
    = 32 views), its stages' device time, and the composition of library
    calls for the same three stages timed beside it."""
    import torch

    from pigeon_tpu_torch.kernels import fused_qkv_attention as k

    b, s, d, h = 32, 577, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.nn.functional.layer_norm(
        torch.randn(b, s, d, generator=gen, device="cuda"), (d,)).bfloat16()
    ws = [(torch.randn(d, d, generator=gen, device="cuda") * 0.02).bfloat16()
          for _ in range(3)]
    bs = [(torch.randn(d, generator=gen, device="cuda") * 0.02).bfloat16()
          for _ in range(3)]
    g = (torch.randn(b, s, d, generator=gen, device="cuda") * 0.01) \
        .bfloat16()
    got = k.fused_qkv_attention_backward(x, *ws, *bs, g, h)
    want = k.fused_qkv_attention_backward_reference(x, *ws, *bs, g, h)
    torch.cuda.synchronize()
    errs = rel_errors(got, want, ("dx", "dq", "dk", "dv"))
    if not max(errs.values()) <= K2_TOL:
        raise RuntimeError(f"K2 disagrees with its plain version: {errs} "
                           f"(max abs error over max magnitude, limit "
                           f"{K2_TOL})")
    err = max_abs(got, want)
    del want
    ms = median_ms(lambda: k.fused_qkv_attention_backward(
        x, *ws, *bs, g, h))
    stages = device_ms_by_mark(
        lambda: k.fused_qkv_attention_backward(x, *ws, *bs, g, h),
        K2_STAGES)
    plain_ms = median_ms(lambda: k.fused_qkv_attention_backward_reference(
        x, *ws, *bs, g, h), runs=10)
    # The yardstick, timed only and never on a path: the same three stages
    # as library calls. The attention backward runs on a graph built once
    # from q/k/v projected beforehand (its forward is not K2's work).
    heads = (b, s, h, 64)
    leaves = [torch.nn.functional.linear(x, w, bb).view(heads)
              .transpose(1, 2).detach().requires_grad_()
              for w, bb in zip(ws, bs)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves)
    gt = g.view(heads).transpose(1, 2)
    w_all = torch.cat(ws, 0)

    def composition():
        for w, bb in zip(ws, bs):
            torch.nn.functional.linear(x, w, bb)
        grads = torch.autograd.grad(out, leaves, gt, retain_graph=True)
        return torch.cat([t.transpose(1, 2).reshape(b, s, d)
                          for t in grads], -1) @ w_all

    composition_ms = median_ms(composition)
    del out, leaves
    # The TPU kernel's work: the projections and dx (2 x 2*B*S*D*3P) and
    # five S x S x dh products a head (scores, dv, dp, dq, dk). The kernel
    # walks seven (K4's statistics pass takes the scores and dp again).
    flop = 2 * 2 * b * s * d * 3 * d + 5 * 2 * b * h * s * s * 64
    gflop = flop / 1e9
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"bf16": flop}, nbytes(x, *ws, *bs, g, *got)),
           "library_ms": None}
    phase("kernel", name="fused_qkv_attention_bwd", shape=f"({b},{s},{d})",
          heads=h, **{f"{n}_err": round(e, 6) for n, e in errs.items()},
          tol=K2_TOL, max_abs_err=err, ms=ms, wmma_design_ms=K2_WMMA_MS,
          **{f"{n}_device_ms": round(v, 4) for n, v in stages.items()},
          plain_ms=plain_ms, bound_ms=rec["bound_ms"],
          composition_ms=composition_ms, gflop=round(gflop, 1),
          tflops=round(gflop / ms, 1),
          plain_tflops=round(gflop / plain_ms, 1))
    return rec


def check_smoothing_kernel(seed: int) -> dict:
    """K10 against its plain version at every shape of `K10_SHAPES`, timed
    at `K10_TIMED`. The kernels record is the (TRAIN_BATCH, NUM_CELLS)
    one: every launch of [train], [train_routes] and [train_durable] is at
    that shape."""
    records = {(b, c): check_smoothing_kernel_at(seed, b, c)
               for b, c in K10_SHAPES}
    return records[(TRAIN_BATCH, NUM_CELLS)]


def replay_c_call(lib, name: str, fn):
    """Run ``fn`` once, recording the arguments of its one call of
    ``lib.<name>``; returns ``fn``'s result (keep it: the call wrote into
    it) and a function that makes the same C call again, the bare call
    without the wrapper's Python."""
    from unittest import mock

    real, calls = getattr(lib, name), []

    def record(*args):
        calls.append(args)
        return real(*args)

    with mock.patch.object(lib, name, record):
        kept = fn()
    if len(calls) != 1:
        raise RuntimeError(f"{name} called {len(calls)} times, not once")
    return kept, functools.partial(real, *calls[0])


def check_smoothing_kernel_at(seed: int, b: int, c: int) -> dict | None:
    """K10 at labels (b, 2) x cells (c, 2): error, every row's maximum
    exactly 1.0 and the same bits in two calls; at `K10_TIMED` also the
    wrapper's, the bare C call's and the device's ms (torch.profiler),
    the host's enqueue time a call and the plain version's ms."""
    import torch

    from pigeon_tpu_torch.kernels import geodesy

    gen = torch.Generator(device="cuda").manual_seed(seed + b + c)

    def points(n):
        return torch.stack([
            torch.rand(n, generator=gen, device="cuda") * 360 - 180,
            torch.rand(n, generator=gen, device="cuda") * 135 - 60], -1)

    labels, cells = points(b), points(c)

    def kernel():
        return geodesy.smooth_labels_from_points(labels, cells, 75.0)

    got, again = kernel(), kernel()
    want = geodesy.smooth_labels_reference(labels, cells, 75.0)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    row_max = got.max(-1).values
    same_bits = torch.equal(got.view(torch.int32), again.view(torch.int32))
    if (not err <= K10_TOL or not bool((row_max == 1.0).all())
            or not same_bits):
        raise RuntimeError(f"K10 disagrees with its plain version at "
                           f"({b}, {c}): max abs error {err} (limit "
                           f"{K10_TOL}), row maxima {row_max.min().item()}"
                           f"..{row_max.max().item()}, same bits in two "
                           f"calls: {same_bits}")
    # ~25 f32 operations a (label, cell) pair, a transcendental counted
    # as one: the haversine, the row minimum and exp((dmin - d) / tau).
    work = bound({"f32": 25 * b * c}, nbytes(labels, cells, got))
    fields = {"shape": f"({b},{c})", "tau_km": 75.0, "max_abs_err": err,
              "tol": K10_TOL, "same_bits": same_bits}
    if (b, c) not in K10_TIMED:
        phase("kernel", name="smooth_labels", **fields)
        return None
    ms = median_ms(kernel)
    kept, bare = replay_c_call(geodesy.load(), "pigeon_smooth_labels",
                               kernel)
    bare_ms = median_ms(bare)
    device = device_ms_by_mark(kernel, [("kernel", "smooth_labels")],
                               calls=20, expect=("kernel",))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        kernel()
    enqueue_us = (time.perf_counter() - t0) / 1000 * 1e6
    torch.cuda.synchronize()
    plain_ms = median_ms(lambda: geodesy.smooth_labels_reference(
        labels, cells, 75.0))
    del kept
    phase("kernel", name="smooth_labels", **fields, ms=ms, bare_ms=bare_ms,
          device_ms=round(device["kernel"], 5),
          other_device_ms=round(device["other"], 5),
          enqueue_us=round(enqueue_us, 2), plain_ms=plain_ms,
          bound_ms=work["bound_ms"], bound_by=work["bound_by"])
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **work,
            "library_ms": None}


def check_attention_kernel(seed: int) -> dict:
    """K3 against its plain version at the calibration shape of ``serve
    --quant --calib-images`` over the 20 fixtures (80 views), at the
    ``flash`` training shape (32 views) and at the serving shape (4
    views); the record is the calibration shape's."""
    from pigeon_tpu_torch.kernels import attention as k3

    records = {b: check_attention_kernel_at(k3, seed, b) for b in (80, 32, 4)}
    return records[80]


def check_attention_kernel_at(k3, seed: int, b: int) -> dict:
    """K3 at ``b`` views of (577, 16, 64)."""
    import torch

    s, h, dh = 577, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    got = k3.flash_attention(q, k, v)
    want = k3.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    del want
    if not finite or not err <= K3_TOL:
        raise RuntimeError(f"K3 disagrees with its plain version at {b} "
                           f"views: max abs error {err} (limit {K3_TOL}), "
                           f"finite={finite}")
    ms = median_ms(lambda: k3.flash_attention(q, k, v))
    plain_ms = median_ms(lambda: k3.flash_attention_reference(q, k, v),
                         runs=10)
    # The yardstick, never on a path: PyTorch's fused attention on the
    # same values in its (B, H, S, dh) layout.
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = median_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
    # 2*B*H*S*S*dh for QK^T and for PV: the two walks the kernel runs.
    flop = 2 * 2 * b * h * s * s * dh
    gflop = flop / 1e9
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"bf16": flop}, nbytes(q, k, v, got)),
           "library_ms": library_ms}
    phase("kernel", name="flash_attention", shape=f"({b},{s},{h},{dh})",
          max_abs_err=err, tol=K3_TOL, ms=ms, plain_ms=plain_ms,
          bound_ms=rec["bound_ms"], sdpa_ms=library_ms, walks=2,
          tflops=round(gflop / ms, 1),
          plain_tflops=round(gflop / plain_ms, 1))
    return rec


def check_int8_kernel(seed: int) -> dict:
    """K8 against its plain version at the int8 serving shape: error, the
    dropped-value-bias guard, times, its stages' device time and the
    library composition's time."""
    import torch

    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.tuning import int8_packs, int8_qkv_composition

    b, s, d, h = 4, 577, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.nn.functional.layer_norm(
        torch.randn(b, s, d, generator=gen, device="cuda"), (d,)).bfloat16()
    act_scale = x.float().abs().max() * 1.1 / 127
    packs = int8_packs(gen, d, (0.02,) * 3)
    ops = [t for pack in packs for t in pack]
    got = k8.fused_qkv_attention_int8(x, act_scale, *ops, h)
    want = k8.fused_qkv_attention_int8_reference(x, act_scale, *ops, h)
    torch.cuda.synchronize()
    rel = rel_errors([got], [want], ("out",))["out"]
    err = max_abs([got], [want])
    if not (err <= K8_TOL and rel <= K1_TOL):
        raise RuntimeError(f"K8 disagrees with its plain version: max abs "
                           f"error {err} (limit {K8_TOL}), over the "
                           f"output's magnitude {rel} (limit {K1_TOL})")
    # The plain version with the value bias dropped must miss by more than
    # twice the relative limit: the check can fail a kernel that drops it.
    wrong = ops[:8] + [torch.zeros_like(ops[8])]
    miss = rel_errors([k8.fused_qkv_attention_int8_reference(
        x, act_scale, *wrong, h)], [want], ("value bias",))["value bias"]
    if not miss > 2 * K1_TOL:
        raise RuntimeError(f"K8's check cannot see a dropped value bias: it "
                           f"moves the output by {miss} of its magnitude, "
                           f"limit {K1_TOL}")
    del want
    ms = median_ms(lambda: k8.fused_qkv_attention_int8(x, act_scale, *ops,
                                                        h))
    stages = device_ms_by_mark(
        lambda: k8.fused_qkv_attention_int8(x, act_scale, *ops, h),
        K8_STAGES)
    plain_ms = median_ms(lambda: k8.fused_qkv_attention_int8_reference(
        x, act_scale, *ops, h))
    composition_ms = median_ms(lambda: int8_qkv_composition(
        x, act_scale, packs, h))
    # 2*B*S*D*P int8 operations for each projection, 2*B*H*S*S*dh bf16
    # for QK^T and for PV.
    int8_ops, bf16_ops = 3 * 2 * b * s * d * d, 2 * 2 * b * h * s * s * 64
    gop = (int8_ops + bf16_ops) / 1e9
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"int8": int8_ops, "bf16": bf16_ops},
                   nbytes(x, *ops, got)),
           "library_ms": None}
    phase("kernel", name="fused_qkv_attention_int8", shape=f"({b},{s},{d})",
          heads=h, out_err=round(rel, 6), tol=K1_TOL, max_abs_err=err,
          abs_tol=K8_TOL, value_bias_miss=round(miss, 4), ms=ms,
          wmma_design_ms=K8_WMMA_MS,
          **{f"{n}_device_ms": round(v, 4) for n, v in stages.items()},
          plain_ms=plain_ms, bound_ms=rec["bound_ms"],
          composition_ms=composition_ms, tops=round(gop / ms, 1),
          plain_tops=round(gop / plain_ms, 1))
    return rec


def check_eval_shapes(seed: int) -> None:
    """K1, K3 and K8 against their plain versions at [evaluate]'s batch of
    `EVAL_BATCH` images, which no other phase launches them at (its ragged
    last batch of 4 is the serving shape), with their bounds: K1 2e-2 of
    the output's magnitude, K3 3e-2, K8 3e-2 and 2e-2 of the magnitude.
    Errors only; the kernels' records stay at their own shapes."""
    import torch

    from pigeon_tpu_torch.kernels import attention as k3
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.tuning import int8_packs, qkv_operands

    b, s, d, h = EVAL_BATCH, 577, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, ws, bs = qkv_operands(gen, b, s, d, raw=False)
    k1_rel = rel_errors([k1.fused_qkv_attention(x, *ws, *bs, h)],
                        [k1.fused_qkv_attention_reference(x, *ws, *bs, h)],
                        ("out",))["out"]
    q, k, v = (torch.randn(b, s, h, 64, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    k3_err = max_abs([k3.flash_attention(q, k, v)],
                     [k3.flash_attention_reference(q, k, v)])
    act_scale = x.float().abs().max() * 1.1 / 127
    ops = [t for pack in int8_packs(gen, d, (0.02,) * 3) for t in pack]
    got = k8.fused_qkv_attention_int8(x, act_scale, *ops, h)
    want = k8.fused_qkv_attention_int8_reference(x, act_scale, *ops, h)
    k8_rel = rel_errors([got], [want], ("out",))["out"]
    k8_err = max_abs([got], [want])
    if not (k1_rel <= K1_TOL and k3_err <= K3_TOL and k8_err <= K8_TOL
            and k8_rel <= K1_TOL):
        raise RuntimeError(
            f"at {b} views: K1 {k1_rel} of its magnitude (limit {K1_TOL}), "
            f"K3 {k3_err} (limit {K3_TOL}), K8 {k8_err} (limit {K8_TOL}) "
            f"and {k8_rel} of its magnitude (limit {K1_TOL})")
    phase("kernel", shapes="evaluate", views=b, k1_out_err=round(k1_rel, 6),
          k3_max_abs_err=k3_err, k8_max_abs_err=k8_err,
          k8_out_err=round(k8_rel, 6))


def check_attention_backward_kernel(seed: int) -> dict:
    """K4 against its plain version at the ``flash`` route's training
    shape (8 panoramas = 32 views), with PyTorch's fused attention
    backward timed beside it."""
    import torch

    from pigeon_tpu_torch.kernels import attention as k4

    b, s, h, dh = 32, 577, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    g = (torch.randn(b, s, h, dh, generator=gen, device="cuda") * 0.01) \
        .bfloat16()
    got = k4.flash_attention_backward(q, k, v, g)
    want = k4.flash_attention_backward_reference(q, k, v, g)
    torch.cuda.synchronize()
    errs = rel_errors(got, want, ("dq", "dk", "dv"))
    if not max(errs.values()) <= K4_TOL:
        raise RuntimeError(f"K4 disagrees with its plain version: {errs} "
                           f"(max abs error over max magnitude, limit "
                           f"{K4_TOL})")
    err = max_abs(got, want)
    del want
    # The statistics pass's workspace against the plain pass.
    ws = k4.backward_workspaces(q)
    k4.flash_attention_backward_into(q, k, v, g, ws)
    want_stats = k4.flash_attention_backward_stats_reference(q, k, v, g)
    torch.cuda.synchronize()
    stats_errs = rel_errors(ws.stats, want_stats, ("m", "den", "r"))
    if not max(stats_errs.values()) <= K4_STATS_TOL:
        raise RuntimeError(f"K4's statistics disagree with the plain pass: "
                           f"{stats_errs} (max abs error over max "
                           f"magnitude, limit {K4_STATS_TOL})")
    del ws, want_stats
    ms = median_ms(lambda: k4.flash_attention_backward(q, k, v, g))
    plain_ms = median_ms(lambda: k4.flash_attention_backward_reference(
        q, k, v, g), runs=10)
    # The yardstick, never on a path: the backward of PyTorch's fused
    # attention on the same values in its (B, H, S, dh) layout.
    leaves = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves)
    gt = g.transpose(1, 2).contiguous()
    library_ms = median_ms(lambda: torch.autograd.grad(
        out, leaves, gt, retain_graph=True))
    del out, leaves
    # The TPU kernel's five S x S x dh products a head: the scores, dv,
    # dp, dq and dk. The rate is counted on those; the kernel itself walks
    # seven (its statistics pass takes the scores and dp once more).
    flop = 5 * 2 * b * h * s * s * dh
    gflop = flop / 1e9
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"bf16": flop}, nbytes(q, k, v, g, *got)),
           "library_ms": library_ms}
    phase("kernel", name="flash_attention_bwd", shape=f"({b},{s},{h},{dh})",
          **{f"{n}_err": round(e, 6) for n, e in errs.items()},
          tol=K4_TOL,
          **{f"stats_{n}_err": f"{e:.3g}" for n, e in stats_errs.items()},
          stats_tol=K4_STATS_TOL, max_abs_err=err, ms=ms, plain_ms=plain_ms,
          bound_ms=rec["bound_ms"], sdpa_bwd_ms=library_ms, walks=5,
          kernel_walks=7, tflops=round(gflop / ms, 1),
          plain_tflops=round(gflop / plain_ms, 1))
    return rec


def ln_params(d: int, gen):
    """A LayerNorm's f32 scale and bias, seeded, spread as widely as a
    trained CLIP's (scale 1 +- 0.5, bias +- 0.5), so that a kernel that
    drops either one is far off."""
    import torch

    return (1 + 0.5 * torch.randn(d, generator=gen, device="cuda"),
            0.5 * torch.randn(d, generator=gen, device="cuda"))


def check_ln_fault_shows(name: str, reference, args, want, tol: float):
    """The plain version ``reference`` with the LayerNorm's scale and bias
    (``args[1:3]``) dropped must miss ``want`` by more than twice ``tol``:
    the check can fail a kernel that drops them."""
    import torch

    x, ls, lb = args[:3]
    for label, params in (("scale", (torch.ones_like(ls), lb)),
                          ("bias", (ls, torch.zeros_like(lb)))):
        wrong = reference(x, *params, *args[3:])
        miss = rel_errors([wrong], [want], (label,))[label]
        if not miss > 2 * tol:
            raise RuntimeError(f"{name}'s check cannot see a dropped LN "
                               f"{label}: it moves the output by {miss} of "
                               f"its magnitude, limit {tol}")


def check_ln_kernel(seed: int) -> dict:
    """K5 against its plain version on a raw (un-normalised) layer input
    at the serving shape (4 views) and the training shape (32 views); the
    record is the serving shape's."""
    records = {b: check_ln_kernel_at(seed, b) for b in (4, 32)}
    return records[4]


def check_ln_kernel_at(seed: int, b: int) -> dict:
    """K5 at ``b`` views of raw x (577, 1024), H=16: error, the dropped-LN
    guard, times, its stages' device time and the library composition's
    time."""
    import torch

    from pigeon_tpu_torch.kernels import fused_ln_qkv_attention as k5
    from pigeon_tpu_torch.tuning import qkv_composition, qkv_operands

    s, d, h = 577, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ls, lb = ln_params(d, gen)
    x, ws, bs = qkv_operands(gen, b, s, d, raw=True)
    args = (x, ls, lb, *ws, *bs, h, 1e-5)
    got = k5.fused_ln_qkv_attention(*args)
    want = k5.fused_ln_qkv_attention_reference(*args)
    torch.cuda.synchronize()
    rel = rel_errors([got], [want], ("out",))["out"]
    if not rel <= K5_TOL:
        raise RuntimeError(f"K5 disagrees with its plain version at {b} "
                           f"views: max abs error over max magnitude {rel} "
                           f"(limit {K5_TOL})")
    check_ln_fault_shows("K5", k5.fused_ln_qkv_attention_reference, args,
                         want, K5_TOL)
    err = max_abs([got], [want])
    del want
    ms = median_ms(lambda: k5.fused_ln_qkv_attention(*args))
    stages = device_ms_by_mark(lambda: k5.fused_ln_qkv_attention(*args),
                               K5_STAGES)
    plain_ms = median_ms(lambda: k5.fused_ln_qkv_attention_reference(*args),
                         runs=10)
    ln = (ls.bfloat16(), lb.bfloat16())
    composition_ms = median_ms(lambda: qkv_composition(
        torch.nn.functional.layer_norm(x, (d,), *ln), ws, bs, h))
    # K1's products, and ~7 f32 operations an element of x for the
    # LayerNorm (two sums, centre, scale, shift).
    flop = 3 * 2 * b * s * d * d + 2 * 2 * b * h * s * s * 64
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"bf16": flop, "f32": 7 * x.numel()},
                   nbytes(x, ls, lb, *ws, *bs, got)),
           "library_ms": None}
    phase("kernel", name="fused_ln_qkv_attention", shape=f"({b},{s},{d})",
          heads=h, out_err=round(rel, 6), tol=K5_TOL, max_abs_err=err,
          ms=ms, wmma_design_ms=K5_WMMA_MS[b],
          **{f"{n}_device_ms": round(v, 4) for n, v in stages.items()},
          plain_ms=plain_ms, bound_ms=rec["bound_ms"],
          composition_ms=composition_ms, tflops=round(flop / 1e9 / ms, 1),
          plain_tflops=round(flop / 1e9 / plain_ms, 1))
    return rec


def check_mlp_kernel(seed: int) -> dict:
    """K9 against its plain version at the training shape (32 views) and
    the serving shape (4 views), ViT-L/14's MLP (D=1024, I=4096); the
    record is the training shape's."""
    records = {b: check_mlp_kernel_at(seed, b) for b in (32, 4)}
    return records[32]


def check_mlp_kernel_at(seed: int, b: int) -> dict:
    """K9 at ``b`` views of x (577, 1024), I=4096: error, the dropped-LN
    guard, times, its stages' device time and the library composition's
    time."""
    import torch

    from pigeon_tpu_torch.kernels import fused_mlp as k9
    from pigeon_tpu_torch.tuning import mlp_operands

    s, d, inter = 577, 1024, 4096
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = (*mlp_operands(gen, b, s, d, inter), 1e-5)
    got = k9.fused_ln_mlp(*args)
    want = k9.fused_ln_mlp_reference(*args)
    torch.cuda.synchronize()
    rel = rel_errors([got], [want], ("out",))["out"]
    if not rel <= K9_TOL:
        raise RuntimeError(f"K9 disagrees with its plain version at {b} "
                           f"views: max abs error over max magnitude {rel} "
                           f"(limit {K9_TOL})")
    check_ln_fault_shows("K9", k9.fused_ln_mlp_reference, args, want,
                         K9_TOL)
    err = max_abs([got], [want])
    del want
    # What one call adds to device memory: its output and the xn (M, D)
    # and h (M, I) bf16 workspaces.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k9.fused_ln_mlp(*args)
    call_peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    ms = median_ms(lambda: k9.fused_ln_mlp(*args))
    stages = device_ms_by_mark(lambda: k9.fused_ln_mlp(*args), K9_STAGES)
    plain_ms = median_ms(lambda: k9.fused_ln_mlp_reference(*args), runs=10)
    composition_ms = median_ms(lambda: k9.ln_mlp_composition(*args))
    m = b * s
    # Two products of 2*M*D*I; in f32 ~7 operations an element of x for
    # the LayerNorm, ~6 an element of h for the bias and quick-GELU, and 2
    # an output element for b2 and the residual.
    flop = 2 * 2 * m * d * inter
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"bf16": flop, "f32": 9 * m * d + 6 * m * inter},
                   nbytes(*args[:7], got)),
           "library_ms": None}
    phase("kernel", name="fused_mlp", shape=f"({b},{s},{d})", inter=inter,
          out_err=round(rel, 6), tol=K9_TOL, max_abs_err=err, ms=ms,
          wmma_design_ms=K9_WMMA_MS[b],
          **{f"{n}_device_ms": round(v, 4) for n, v in stages.items()},
          plain_ms=plain_ms, bound_ms=rec["bound_ms"],
          composition_ms=composition_ms, tflops=round(flop / 1e9 / ms, 1),
          plain_tflops=round(flop / 1e9 / plain_ms, 1),
          workspace_mib=round(m * (d + inter) * 2 / 2**20, 1),
          call_peak_mib=round(call_peak_mib, 1))
    return rec


def check_block_kernel(seed: int) -> dict:
    """K6 against its plain version on a raw layer input at the serving
    shape (4 views) and the training shape (32 views); the record is the
    serving shape's."""
    records = {b: check_block_kernel_at(seed, b) for b in (4, 32)}
    return records[4]


def check_block_kernel_at(seed: int, b: int) -> dict:
    """K6 at ``b`` views of raw x (577, 1024), H=16: error, the dropped-LN
    guard, times, its stages' device time and the library composition's
    time."""
    import torch

    from pigeon_tpu_torch.kernels import fused_block_attention as k6
    from pigeon_tpu_torch.tuning import block_composition

    s, d, h = 577, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ls, lb = ln_params(d, gen)
    # Weights that give the attention half a share of the output near the
    # residual's, so that a dropped LN parameter shows.
    ws = [(torch.randn(d, d, generator=gen, device="cuda") * std).bfloat16()
          for std in (0.05, 0.05, 0.05, 0.1)]
    bs = [(torch.randn(d, generator=gen, device="cuda") * 0.02).bfloat16()
          for _ in range(4)]
    x = (torch.randn(b, s, d, generator=gen, device="cuda") * 3 + 1) \
        .bfloat16()
    args = (x, ls, lb, *ws[:3], *bs[:3], ws[3], bs[3], h, 1e-5)
    got = k6.fused_block_attention(*args)
    want = k6.fused_block_attention_reference(*args)
    torch.cuda.synchronize()
    rel = rel_errors([got], [want], ("out",))["out"]
    if not rel <= K6_TOL:
        raise RuntimeError(f"K6 disagrees with its plain version at {b} "
                           f"views: max abs error over max magnitude {rel} "
                           f"(limit {K6_TOL})")
    check_ln_fault_shows("K6", k6.fused_block_attention_reference, args,
                         want, K6_TOL)
    err = max_abs([got], [want])
    del want
    ms = median_ms(lambda: k6.fused_block_attention(*args))
    stages = device_ms_by_mark(lambda: k6.fused_block_attention(*args),
                               K6_STAGES)
    plain_ms = median_ms(lambda: k6.fused_block_attention_reference(*args),
                         runs=10)
    ln = (ls.bfloat16(), lb.bfloat16())
    composition_ms = median_ms(lambda: block_composition(
        x, ln, ws[:3], bs[:3], ws[3], bs[3], h))
    # K1's products and the out-projection's 2*B*S*D*D; ~7 f32 operations
    # an element of x for the LayerNorm and 2 an output for bo and x.
    flop = 4 * 2 * b * s * d * d + 2 * 2 * b * h * s * s * 64
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"bf16": flop, "f32": 9 * x.numel()},
                   nbytes(x, ls, lb, *ws, *bs, got)),
           "library_ms": None}
    phase("kernel", name="fused_block_attention", shape=f"({b},{s},{d})",
          heads=h, out_err=round(rel, 6), tol=K6_TOL, max_abs_err=err,
          ms=ms, wmma_design_ms=K6_WMMA_MS[b],
          **{f"{n}_device_ms": round(v, 4) for n, v in stages.items()},
          plain_ms=plain_ms, bound_ms=rec["bound_ms"],
          composition_ms=composition_ms, tflops=round(flop / 1e9 / ms, 1),
          plain_tflops=round(flop / 1e9 / plain_ms, 1))
    return rec


def check_block_int8_kernel(seed: int) -> dict:
    """K7 against its plain version at the int8 serving shape, on a raw
    layer input, int8 weights quantized from seeded f32 ones."""
    import torch

    from pigeon_tpu_torch.kernels import fused_block_attention_int8 as k7
    from pigeon_tpu_torch.kernels.fused_ln_qkv_attention import (
        flax_layer_norm_f32,
    )
    from pigeon_tpu_torch.tuning import int8_block_composition, int8_packs

    b, s, d, h = 4, 577, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # Outputs stay under ~4, where a bf16 ulp (<= 1/64) is under K7_ABS.
    x = (torch.randn(b, s, d, generator=gen, device="cuda") * 0.5 + 0.5) \
        .bfloat16()
    ls, lb = ln_params(d, gen)
    # Scales that give the attention half a share of the output as large
    # as the residual's, so that a dropped LN parameter shows.
    packs = int8_packs(gen, d, (0.05, 0.05, 0.03, 0.02))
    a_qkv = flax_layer_norm_f32(x, ls, lb, 1e-5).abs().max() * 1.1 / 127
    ao = torch.tensor(5.5 / 127, device="cuda")   # ~max |o| / 127
    args = (x, ls, lb, a_qkv, *packs[0], *packs[1], *packs[2], ao, *packs[3],
            h, 1e-5)
    got = k7.fused_block_attention_int8(*args)
    want = k7.fused_block_attention_int8_reference(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        raise RuntimeError("K7's output is not finite")
    lsb = (ao * packs[3][1].max() * 127).item()
    limit = 1.5 * lsb + K7_ABS
    diff = (got.float() - want.float()).abs()
    err, share = diff.max().item(), (diff > K7_ABS).float().mean().item()
    if not (err <= limit and share < K7_SHARE):
        raise RuntimeError(f"K7 disagrees with its plain version: max abs "
                           f"error {err} (limit {limit}), {share} of "
                           f"elements off by more than {K7_ABS} (limit "
                           f"{K7_SHARE})")
    for label, params in (("scale", (torch.ones_like(ls), lb)),
                          ("bias", (ls, torch.zeros_like(lb)))):
        miss = max_abs([k7.fused_block_attention_int8_reference(
            x, *params, *args[3:])], [want])
        if not miss > 2 * limit:
            raise RuntimeError(f"K7's check cannot see a dropped LN {label}: "
                               f"it moves the output by {miss}, limit "
                               f"{limit}")
    ms = median_ms(lambda: k7.fused_block_attention_int8(*args))
    stages = device_ms_by_mark(lambda: k7.fused_block_attention_int8(*args),
                               K7_STAGES)
    plain_ms = median_ms(lambda: k7.fused_block_attention_int8_reference(
        *args))
    composition_ms = median_ms(lambda: int8_block_composition(
        x, ls, lb, 1e-5, a_qkv, packs, ao, h))
    # 2*B*S*D*D int8 operations for each of the four projections,
    # 2*B*H*S*S*dh bf16 for QK^T and for PV.
    int8_ops, bf16_ops = 4 * 2 * b * s * d * d, 2 * 2 * b * h * s * s * 64
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"int8": int8_ops, "bf16": bf16_ops},
                   nbytes(x, ls, lb, *(t for p in packs for t in p), got)),
           "library_ms": None}
    phase("kernel", name="fused_block_attention_int8", shape=f"({b},{s},{d})",
          heads=h, max_abs_err=err, tol=limit, lsb=lsb,
          share_over_abs=share, share_tol=K7_SHARE, ms=ms,
          wmma_design_ms=K7_WMMA_MS,
          **{f"{n}_device_ms": round(v, 4) for n, v in stages.items()},
          plain_ms=plain_ms, bound_ms=rec["bound_ms"],
          composition_ms=composition_ms,
          tops=round((int8_ops + bf16_ops) / 1e9 / ms, 1))
    return rec


def check_online_kernel(seed: int) -> dict:
    """K3′ against its plain version at K3's shape (80 views), with
    PyTorch's fused attention timed beside it."""
    import torch

    from pigeon_tpu_torch.kernels import attention as k3

    b, s, h, dh = 80, 577, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    got = k3.flash_attention_online(q, k, v)
    want = k3.flash_attention_online_reference(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    del want
    if not finite or not err <= K3_ONLINE_TOL:
        raise RuntimeError(f"K3′ disagrees with its plain version: max abs "
                           f"error {err} (limit {K3_ONLINE_TOL}), "
                           f"finite={finite}")
    ms = median_ms(lambda: k3.flash_attention_online(q, k, v))
    # K3 runs the same streaming kernel: its time on the same inputs.
    k3_ms = median_ms(lambda: k3.flash_attention(q, k, v))
    plain_ms = median_ms(lambda: k3.flash_attention_online_reference(q, k, v),
                         runs=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = median_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
    # 2*B*H*S*S*dh for QK^T and for PV: the two walks the kernel runs.
    flop = 2 * 2 * b * h * s * s * dh
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound({"bf16": flop}, nbytes(q, k, v, got)),
           "library_ms": library_ms}
    phase("kernel", name="flash_attention_online",
          shape=f"({b},{s},{h},{dh})", max_abs_err=err, tol=K3_ONLINE_TOL,
          ms=ms, k3_ms=k3_ms, over_k3=round(ms / k3_ms, 3),
          plain_ms=plain_ms, bound_ms=rec["bound_ms"], sdpa_ms=library_ms,
          walks=2, tflops=round(flop / 1e9 / ms, 1),
          plain_tflops=round(flop / 1e9 / plain_ms, 1))
    return rec


def check_eltwise_kernels(seed: int) -> dict:
    """The inference forward's one-pass kernels (`kernels/eltwise.py`)
    against their plain versions at a serving batch (8 x 577 tokens) and
    the ViT-L/14-336 sweep's (512 x 577), D=1024 and I=4096, held as
    `tests/test_torch_eltwise.py` holds them: the residual sum bit for
    bit, quick-GELU within one bf16 ulp, each LayerNorm output within one
    ulp give or take four f32 ulps of its terms (that file's
    `ln_within_one_ulp`), one launch a call; the plain version with the
    LayerNorm's scale or bias dropped must fail the LayerNorm check. Then
    the backwards (`check_eltwise_backward`) and DINOv2's
    (`check_dinov2_eltwise`, `check_dinov2_k1`). Returns the records of
    DINOv2's two kernels."""
    import importlib.util

    import torch

    from pigeon_tpu_torch.kernels import eltwise

    path = os.path.join(HERE, "tests", "test_torch_eltwise.py")
    spec = importlib.util.spec_from_file_location("eltwise_tolerances", path)
    tol = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tol)
    kernels = [getattr(eltwise, name) for name in ELTWISE_KERNELS]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, inter, eps = 1024, 4096, tol.EPS
    for b in (8, 512):
        rows = b * 577
        before = [k.launches for k in kernels]
        x = (torch.randn(rows, d, generator=gen, device="cuda") * 3 + 1) \
            .bfloat16()
        a = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
        w, bias = ln_params(d, gen)
        ln = eltwise.layer_norm_bf16(x, w, bias, eps)
        s, ln2 = eltwise.add_layer_norm_bf16(x, a, w, bias, eps)
        h = (torch.randn(rows, inter, generator=gen, device="cuda") * 4) \
            .bfloat16()
        gelu = eltwise.quick_gelu_bf16(h)
        torch.cuda.synchronize()
        counts = [k.launches - n for k, n in zip(kernels, before)]
        if counts != [1, 1, 1]:
            raise RuntimeError(f"{dict(zip(ELTWISE_KERNELS, counts))} "
                               f"launches for one call of each at {b} views")
        if not torch.equal(s, x + a):
            raise RuntimeError(f"add_layer_norm_bf16's sum is not x + a at "
                               f"{b} views")
        for name, got, inp in (("layer_norm_bf16", ln, x),
                               ("add_layer_norm_bf16", ln2, s)):
            check_ln_output(tol, name, got, inp, w, bias, f"{b} views")
        del ln, ln2, s, a
        ulps = tol.ulps_apart(gelu, eltwise.quick_gelu(h))
        gelu_max, gelu_off = ulps.max().item(), int((ulps > 0).sum())
        if gelu_max > 1:
            raise RuntimeError(f"quick_gelu_bf16 is {gelu_max} bf16 ulps "
                               f"from its plain version at {b} views")
        phase("eltwise", views=b, rows=rows, d=d, inter=inter,
              ln_within_1ulp=True, sum_exact=True,
              gelu_max_ulps=gelu_max, gelu_elements_off=gelu_off)
        del x, h, gelu, ulps
        torch.cuda.empty_cache()
    check_eltwise_backward(tol, gen)
    records = check_dinov2_eltwise(tol, gen)
    check_dinov2_k1(seed)
    return records


def check_eltwise_backward(tol, gen) -> None:
    """The backward kernels of `kernels/eltwise.py` at the finetune cell's
    rows (512 x 577; D 1024, I 4096), one launch a call, held as
    `tests/test_torch_eltwise.py` holds them against their plain versions
    (the operations eager autograd runs) on the forward's statistics: each
    LayerNorm input gradient within that file's `check_ln_backward`, the
    LayerNorm's own gradients within `param_grad_slack`, quick-GELU's bit
    for bit; the plain version with ``dy`` shifted by a row must fail each
    check. Each is timed (CUDA events, median) beside its bytes bound and
    its plain version."""
    import torch

    from pigeon_tpu_torch.kernels import eltwise

    rows, d, inter, eps = 512 * 577, 1024, 4096, tol.EPS
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3 + 1) \
        .bfloat16()
    dy, ds = (torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    w, bias = ln_params(d, gen)
    stats = torch.empty(2, rows, device="cuda")
    eltwise.layer_norm_bf16(x, w, bias, eps, stats)
    kernels = (eltwise.layer_norm_bwd_bf16, eltwise.add_layer_norm_bwd_bf16)
    before = [k.launches for k in kernels]
    dx, dw, db = eltwise.layer_norm_bwd_bf16(x, dy, w, bias, stats, True)
    dx2 = eltwise.add_layer_norm_bwd_bf16(x, ds, dy, w, bias, stats,
                                          False)[0]
    torch.cuda.synchronize()
    if [k.launches - n for k, n in zip(kernels, before)] != [1, 1]:
        raise RuntimeError("the LayerNorm backwards launched "
                           f"{[k.launches - n for k, n in zip(kernels, before)]}"
                           " times for one call each")
    slack = tol.ln_grad_slack(x, dy, w, stats)
    inner = eltwise.layer_norm_backward_reference(x, dy, w, bias, stats,
                                                  True)
    want2 = eltwise.add_layer_norm_backward_reference(x, ds, dy, w, bias,
                                                      stats, False)[0]
    tol.check_ln_backward(dx, inner[0], slack)
    tol.check_ln_backward(dx2, want2, slack, inner[0])
    for got, want, room in zip((dw, db), inner[1:],
                               tol.param_grad_slack(x, dy, stats)):
        if not bool(((got - want).abs() <= room).all()):
            raise RuntimeError("layer_norm_bwd_bf16's parameter gradients "
                               "are outside their slack")
    shifted = eltwise.layer_norm_backward_reference(
        x, dy.roll(1, 0), w, bias, stats, True)
    try:
        tol.check_ln_backward(dx, shifted[0], slack)
    except AssertionError:
        pass
    else:
        raise RuntimeError("the LayerNorm backward's check cannot see dy "
                           "shifted by a row")
    del inner, shifted, want2
    act = rows * d * 2
    times = {
        "layer_norm_bwd_bf16": (
            lambda: eltwise.layer_norm_bwd_bf16(x, dy, w, bias, stats, False),
            lambda: eltwise.layer_norm_backward_reference(
                x, dy, w, bias, stats, False), 3 * act),
        "layer_norm_bwd_bf16+dw,db": (
            lambda: eltwise.layer_norm_bwd_bf16(x, dy, w, bias, stats, True),
            lambda: eltwise.layer_norm_backward_reference(
                x, dy, w, bias, stats, True), 3 * act),
        "add_layer_norm_bwd_bf16": (
            lambda: eltwise.add_layer_norm_bwd_bf16(x, ds, dy, w, bias,
                                                    stats, False),
            lambda: eltwise.add_layer_norm_backward_reference(
                x, ds, dy, w, bias, stats, False), 4 * act)}
    for name, (kernel, plain, moved) in times.items():
        ms = median_ms(kernel)
        phase("eltwise", name=name, rows=rows, d=d, ms=ms,
              plain_ms=median_ms(plain, runs=10),
              bound_ms=round(bound({"bf16": 0}, moved)["bound_ms"], 4),
              share_of_bound=round(moved / PEAK_BYTES * 1e3 / ms, 4))
    del x, dy, ds, dx, dx2, stats
    torch.cuda.empty_cache()
    u = (torch.randn(rows, inter, generator=gen, device="cuda") * 4) \
        .bfloat16()
    dy = torch.randn(rows, inter, generator=gen, device="cuda").bfloat16()
    before = eltwise.quick_gelu_bwd_bf16.launches
    du = eltwise.quick_gelu_bwd_bf16(u, dy)
    torch.cuda.synchronize()
    if eltwise.quick_gelu_bwd_bf16.launches != before + 1:
        raise RuntimeError("quick_gelu_bwd_bf16 launched other than once")
    if not torch.equal(du, eltwise.quick_gelu_backward_reference(u, dy)):
        raise RuntimeError("quick_gelu_bwd_bf16 is not autograd's chain "
                           "bit for bit at the cell's rows")
    if torch.equal(du, eltwise.quick_gelu_backward_reference(
            u, dy.roll(1, 0))):
        raise RuntimeError("the quick-GELU backward's check cannot see dy "
                           "shifted by a row")
    moved = 3 * rows * inter * 2
    ms = median_ms(lambda: eltwise.quick_gelu_bwd_bf16(u, dy))
    phase("eltwise", name="quick_gelu_bwd_bf16", rows=rows, inter=inter,
          bit_exact=True, ms=ms,
          plain_ms=median_ms(
              lambda: eltwise.quick_gelu_backward_reference(u, dy), runs=10),
          bound_ms=round(bound({"bf16": 0}, moved)["bound_ms"], 4),
          share_of_bound=round(moved / PEAK_BYTES * 1e3 / ms, 4))
    del u, dy, du
    torch.cuda.empty_cache()


def check_ln_output(tol, name: str, got, inp, w, bias, where: str) -> None:
    """``got`` within `ln_within_one_ulp` of LayerNorm(``inp``), and the
    plain version with the scale or the bias dropped outside it."""
    import torch

    from pigeon_tpu_torch.kernels import eltwise

    if not tol.ln_within_one_ulp(got, inp, w, bias):
        raise RuntimeError(f"{name} is more than one bf16 ulp from its plain "
                           f"version at {where}")
    for label, params in (("scale", (torch.ones_like(w), bias)),
                          ("bias", (w, torch.zeros_like(bias)))):
        wrong = eltwise.layer_norm_reference(inp, *params, tol.EPS)
        if tol.ln_within_one_ulp(wrong, inp, w, bias):
            raise RuntimeError(f"{name}'s check cannot see a dropped LN "
                               f"{label}")


def check_dinov2_eltwise(tol, gen) -> dict:
    """DINOv2's element-wise kernels at the benchmark cell's rows (128 x
    1,374; D 1536, I 4096), one launch a call: `layer_norm_bf16` at D
    1536 and `scale_add_layer_norm_bf16`'s LayerNorm within
    `ln_within_one_ulp` (a dropped LN scale or bias must fail it);
    `swiglu_bf16` and the scale-add sum bit for bit against `swiglu` and
    `scale_add`, whose plain versions with the halves of ``u`` swapped,
    or with gamma set to one, must differ. The two new kernels are timed
    beside their plain versions, with bounds from the bytes they move.
    Returns their records."""
    import torch

    from pigeon_tpu_torch.kernels import eltwise

    rows, d, inter = DINOV2_BATCH * DINOV2_SEQ, DINOV2_D, DINOV2_I
    eps = tol.EPS
    kernels = (eltwise.layer_norm_bf16, eltwise.scale_add_layer_norm_bf16,
               eltwise.swiglu_bf16)
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3 + 1) \
        .bfloat16()
    a = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    # LayerScale drawn per channel as the benchmark's weights draw it.
    gamma = 0.05 + 0.95 * torch.rand(d, generator=gen, device="cuda")
    w, bias = ln_params(d, gen)
    u = (torch.randn(rows, 2 * inter, generator=gen, device="cuda") * 4) \
        .bfloat16()
    before = [k.launches for k in kernels]
    ln = eltwise.layer_norm_bf16(x, w, bias, eps)
    s, ln2 = eltwise.scale_add_layer_norm_bf16(x, a, gamma, w, bias, eps)
    gated = eltwise.swiglu_bf16(u)
    torch.cuda.synchronize()
    counts = [k.launches - n for k, n in zip(kernels, before)]
    if counts != [1, 1, 1]:
        raise RuntimeError(f"{counts} launches of layer_norm_bf16, "
                           "scale_add_layer_norm_bf16 and swiglu_bf16 for "
                           "one call of each at DINOv2's rows")
    where = f"DINOv2's {rows} x {d}"
    if not torch.equal(s, eltwise.scale_add(x, a, gamma)):
        raise RuntimeError(f"scale_add_layer_norm_bf16's sum is not x + "
                           f"gamma a at {where}")
    if torch.equal(s, eltwise.scale_add(x, a, torch.ones_like(gamma))):
        raise RuntimeError("the scale-add check cannot see gamma dropped")
    if not torch.equal(gated, eltwise.swiglu(u)):
        raise RuntimeError(f"swiglu_bf16 is not silu(u1) u2 at {rows} x "
                           f"{inter}")
    if torch.equal(gated, eltwise.swiglu(u.roll(inter, -1))):
        raise RuntimeError("the SwiGLU check cannot see its halves swapped")
    check_ln_output(tol, "layer_norm_bf16", ln, x, w, bias, where)
    check_ln_output(tol, "scale_add_layer_norm_bf16", ln2, s, w, bias, where)
    ln_err = max_abs([ln2], [eltwise.layer_norm_reference(s, w, bias, eps)])
    del ln
    params = (gamma, w, bias)
    records = {
        "swiglu_bf16": {
            "max_abs_err": 0.0,
            "ms": median_ms(lambda: eltwise.swiglu_bf16(u)),
            "plain_ms": median_ms(lambda: eltwise.swiglu(u), runs=10),
            **bound({"bf16": 0}, nbytes(u, gated))},
        "scale_add_layer_norm_bf16": {
            "max_abs_err": ln_err,
            "ms": median_ms(lambda: eltwise.scale_add_layer_norm_bf16(
                x, a, gamma, w, bias, eps)),
            "plain_ms": median_ms(
                lambda: eltwise.scale_add_layer_norm_reference(
                    x, a, gamma, w, bias, eps), runs=10),
            **bound({"bf16": 0}, nbytes(x, a, s, ln2, *params))}}
    for name, rec in records.items():
        phase("eltwise", name=name, shape="dinov2", rows=rows, d=d,
              inter=inter,
              bit_exact="output" if name == "swiglu_bf16" else "sum",
              max_abs_err=rec["max_abs_err"], ms=rec["ms"],
              plain_ms=rec["plain_ms"], bound_ms=round(rec["bound_ms"], 4),
              bound_by=rec["bound_by"])
    del x, a, s, ln2, u, gated
    torch.cuda.empty_cache()
    return records


def check_dinov2_k1(seed: int) -> None:
    """K1 at the DINOv2 cell's shape, x (128, 1374, 1536), 24 heads, which
    no other phase launches it at: against its plain version on the
    first and last 8 images (K1's bound), its fault guard on the first 8,
    timed beside its bound. Errors and times only."""
    import torch

    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.tuning import qkv_operands

    b, s, d, h = DINOV2_BATCH, DINOV2_SEQ, DINOV2_D, DINOV2_H
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, ws, bs = qkv_operands(gen, b, s, d, raw=False)
    args = (x, *ws, *bs, h)
    rel = check_rows_at(k1.fused_qkv_attention,
                        k1.fused_qkv_attention_reference, args, b, K1_TOL,
                        "K1 at DINOv2's shape")
    head = (x[:8], *ws, *bs, h)
    check_qkv_fault_shows(k1.fused_qkv_attention_reference, head,
                          k1.fused_qkv_attention_reference(*head), K1_TOL)
    ms = median_ms(lambda: k1.fused_qkv_attention(*args), runs=5)
    flop = 3 * 2 * b * s * d * d + 2 * 2 * b * h * s * s * 64
    rec = bound({"bf16": flop}, nbytes(x, *ws, *bs, x))
    phase("kernel", name="fused_qkv_attention", shapes="dinov2",
          shape=f"({b},{s},{d})", heads=h, out_err=round(rel, 6),
          tol=K1_TOL, ms=ms, bound_ms=round(rec["bound_ms"], 4),
          bound_by=rec["bound_by"], tflops=round(flop / ms / 1e9, 1))
    del x, args
    torch.cuda.empty_cache()


def write_assets(root: str, seed: int) -> list:
    """Geocells, a training bank and its prototypes, as the ``serve``
    command reads them. Every cell gets 1-3 clusters of 2-256 members; the
    bank is packed to the refiner's (64 protos x 256 members) buckets."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cells = np.stack([rng.uniform(-180, 180, NUM_CELLS),
                      rng.uniform(-60, 75, NUM_CELLS)], -1)
    with open(os.path.join(root, "cells.csv"), "w") as f:
        f.write("name,lng,lat\n")
        f.writelines(f"c{i},{lng},{lat}\n"
                     for i, (lng, lat) in enumerate(cells.tolist()))
    bank_lla = np.stack([rng.uniform(-180, 180, BANK_ROWS),
                         rng.uniform(-60, 75, BANK_ROWS)], -1) \
        .astype(np.float32)
    with open(os.path.join(root, "meta.csv"), "w") as f:
        f.write("lng,lat,selection\n")
        f.writelines(f"{lng},{lat},train\n" for lng, lat in bank_lla.tolist())
    os.makedirs(os.path.join(root, "emb"))
    np.save(os.path.join(root, "emb", "train.npy"),
            rng.normal(size=(BANK_ROWS, 1024)).astype(np.float32))
    np.save(os.path.join(root, "emb", "train_indices.npy"),
            np.arange(BANK_ROWS))
    pool = [tuple(p) for p in bank_lla.tolist()]
    with open(os.path.join(root, "protos.csv"), "w") as f:
        f.write("geocell_idx,lng,lat,count,indices\n")
        for cell in range(NUM_CELLS):
            for _ in range(rng.integers(1, 4)):
                idx = rng.choice(BANK_ROWS, int(rng.integers(2, 257)),
                                 replace=False).tolist()
                lng, lat = bank_lla[idx].mean(0).tolist()
                pool.append((lng, lat))
                f.write(f'{cell},{lng},{lat},{len(idx)},"{idx}"\n')
    return pool


def post(url: str, payload: dict):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def serve_payloads(n_requests: int) -> list:
    """Panorama requests built from the repo's PNG fixtures, 4 each."""
    fixtures = sorted(glob.glob(os.path.join(
        HERE, "data", "benchmarks", "sample20", "images", "*.png")))
    if len(fixtures) < 4 * n_requests:
        raise RuntimeError(f"need {4 * n_requests} PNG fixtures, found "
                           f"{len(fixtures)}")
    payloads = []
    for r in range(n_requests):
        views = fixtures[4 * r:4 * r + 4]
        payloads.append({"gameID": "smoke", "roundID": r, **{
            key: "data:image/png;base64," + base64.b64encode(
                open(path, "rb").read()).decode()
            for key, path in zip(
                ("image", "image_2", "image_3", "image_4"), views)}})
    return payloads


def start_serving(root: str, *extra):
    """The ``serve`` command's `start_server` on the assets under
    ``root``, on a loopback port; returns the server and its seconds."""
    from pigeon_tpu_torch.cli.run import build_parser, start_server

    args = build_parser().parse_args([
        "serve", "pigeon", "--panorama", "-m", "--heading", "--hedge",
        "--geocells", os.path.join(root, "cells.csv"),
        "--metadata", os.path.join(root, "meta.csv"),
        "--prototypes", os.path.join(root, "protos.csv"),
        "--embeddings", os.path.join(root, "emb"),
        "--port", "0", "--device", "cuda", *extra])
    t0 = time.perf_counter()
    httpd = start_server(args, block=False)
    return httpd, time.perf_counter() - t0


def request_all(httpd, payloads, pool, counters: dict) -> tuple:
    """A CORS preflight, then each payload over HTTP; every answer must be
    200 on a bank or prototype location. ``counters`` are set to 0 after
    the preflight. Returns the latencies (ms) and each counter's
    launches during the requests."""
    import numpy as np

    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict"
    # A CORS preflight first: urllib's first call builds its opener, which
    # would otherwise be timed as the server's.
    with urllib.request.urlopen(urllib.request.Request(
            url, method="OPTIONS"), timeout=60) as resp:
        if resp.status != 204:
            raise RuntimeError(f"preflight answered {resp.status}")
    for fn in counters.values():
        fn.launches = 0
    latencies = []
    for payload in payloads:
        t = time.perf_counter()
        status, body = post(url, payload)
        latencies.append((time.perf_counter() - t) * 1e3)
        lat, lng = body["results"]["lat"], body["results"]["lng"]
        if status != 200 or not (-90 <= lat <= 90 and -180 <= lng <= 180):
            raise RuntimeError(f"bad answer {status} {body}")
        if not np.isclose(pool, [lng, lat], atol=1e-3).all(-1).any():
            raise RuntimeError(f"({lng}, {lat}) is no bank or prototype "
                               "location")
    return latencies, {name: fn.launches for name, fn in counters.items()}


@contextlib.contextmanager
def eager_chain():
    """`models/clip.py`'s calls of the element-wise kernels, and of their
    autograd versions, routed to the eager compositions (their plain
    versions) for the ``with`` block."""
    from types import SimpleNamespace

    from pigeon_tpu_torch.kernels import eltwise
    from pigeon_tpu_torch.models import clip

    plain = {"layer_norm_bf16": eltwise.layer_norm_reference,
             "add_layer_norm_bf16": eltwise.add_layer_norm_reference,
             "quick_gelu_bf16": eltwise.quick_gelu,
             "LayerNormBF16": SimpleNamespace(
                 apply=eltwise.layer_norm_reference),
             "AddLayerNormBF16": SimpleNamespace(
                 apply=eltwise.add_layer_norm_reference),
             "QuickGeluBF16": SimpleNamespace(apply=eltwise.quick_gelu)}
    saved = {name: getattr(clip, name) for name in plain}
    for name, fn in plain.items():
        setattr(clip, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(clip, name, fn)


def check_serving(root: str, pool, n_requests: int) -> tuple:
    """The full-width panorama model served over HTTP in bf16; returns
    K1's launches during the requests and the embedding of the first
    panorama. Each request launches K1 and each element-wise kernel of
    the inference forward once a layer (the LayerNorm once more, the
    pre-LN); the eager chain's forward of the same panorama (`eager_chain`)
    launches none of the latter and lands within `ELTWISE_EMBED_TOL` of
    the served embedding."""
    import torch

    from pigeon_tpu_torch.data.image_ops import normalize_images
    from pigeon_tpu_torch.kernels import eltwise
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.models.clip import set_route

    counters = {"fused_qkv_attention": k1.fused_qkv_attention,
                **{name: getattr(eltwise, name) for name in ELTWISE_KERNELS}}
    payloads = serve_payloads(n_requests)
    torch.cuda.reset_peak_memory_stats()
    httpd, startup_s = start_serving(root)
    try:
        service = httpd.RequestHandlerClass.service
        latencies, counts = request_all(httpd, payloads, pool, counters)
        launches = counts["fused_qkv_attention"]
        model = service.serve_fn.model
        layers = len(model.vision.encoder.layers)
        want = {**dict.fromkeys(counters, layers * n_requests),
                "layer_norm_bf16": (layers + 1) * n_requests}
        if counts != want:
            raise RuntimeError(f"{n_requests} requests launched {counts}, "
                               f"not each kernel once per layer ({layers}) "
                               f"and the pre-LN once")

        # The same panorama through the plain attention route.
        pixels = service.decode(payloads[0])
        fused = service.serve_fn(pixels)["embedding"].flatten().float()
        set_route(model, "plain")
        plain = service.serve_fn(pixels)["embedding"].flatten().float()
        set_route(model, "fused")
        cos = torch.nn.functional.cosine_similarity(
            fused, plain, dim=0).item()
        if not cos >= 0.999:
            raise RuntimeError(f"embedding cosine {cos} < 0.999")
        layer_ms = time_layers(service, payloads)
        peak_gib = round(torch.cuda.max_memory_allocated() / 2**30, 3)

        # The same panorama through the eager chain.
        before = {name: counters[name].launches for name in ELTWISE_KERNELS}
        with eager_chain(), torch.inference_mode():
            out = model(normalize_images(torch.tensor(pixels).cuda()))
        eager = out.embedding.flatten().float()
        del out
        eager_counts = {name: counters[name].launches - n
                        for name, n in before.items()}
        if any(eager_counts.values()):
            raise RuntimeError(f"the eager chain launched {eager_counts}")
        eager_err = ((fused - eager).norm() / eager.norm()).item()
        if not eager_err < ELTWISE_EMBED_TOL:
            raise RuntimeError(f"served embedding {eager_err} from the "
                               f"eager chain's (relative L2), limit "
                               f"{ELTWISE_EMBED_TOL}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    phase("serve", requests=n_requests, status=200, layers=layers,
          k1_launches=launches,
          **{f"{name}_launches": counts[name] for name in ELTWISE_KERNELS},
          eager_chain_eltwise_launches=sum(eager_counts.values()),
          eager_embedding_err=eager_err,
          median_ms=sorted(latencies)[len(latencies) // 2],
          latencies_ms=[round(t, 3) for t in latencies],
          startup_s=round(startup_s, 3), embedding_cosine=cos,
          peak_gib=peak_gib)
    phase("layers", **layer_ms)
    return launches, fused


def check_serving_int8(root: str, pool, n_requests: int,
                       bf16_embedding) -> dict:
    """The same model, assets and command with ``--quant --calib-images``
    over the 20 fixtures; returns K3's launches in the calibration and
    K8's in the requests."""
    import gc

    import torch

    from pigeon_tpu_torch.kernels import attention as k3
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.models.clip import set_route

    counters = {"fused_qkv_attention": k1.fused_qkv_attention,
                "flash_attention": k3.flash_attention,
                "fused_qkv_attention_int8": k8.fused_qkv_attention_int8}
    payloads = serve_payloads(n_requests)
    calib_dir = os.path.join(HERE, "data", "benchmarks", "sample20",
                             "images")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    httpd, startup_s = start_serving(root, "--quant", "--calib-images",
                                     calib_dir)
    try:
        service = httpd.RequestHandlerClass.service
        layers = len(service.serve_fn.model.vision.encoder.layers)
        # Start-up: one dynamic calibration forward (K3 in every layer),
        # then the static warm-up request (K8 in every layer).
        setup = {name: fn.launches for name, fn in counters.items()}
        if setup != {"fused_qkv_attention": 0, "flash_attention": layers,
                     "fused_qkv_attention_int8": layers}:
            raise RuntimeError(f"int8 start-up launched {setup}; expected "
                               f"K3 {layers} (calibration), K8 {layers} "
                               "(warm-up), K1 0")
        latencies, launches = request_all(httpd, payloads, pool, counters)
        want = {"fused_qkv_attention": 0, "flash_attention": 0,
                "fused_qkv_attention_int8": layers * n_requests}
        if launches != want:
            raise RuntimeError(f"int8 requests launched {launches}, "
                               f"expected {want}")
        pixels = service.decode(payloads[0])
        int8 = service.serve_fn(pixels)["embedding"].flatten().float()
        cos = torch.nn.functional.cosine_similarity(
            int8, bf16_embedding, dim=0).item()
        if not cos >= INT8_COSINE:
            raise RuntimeError(f"int8 embedding cosine {cos} < "
                               f"{INT8_COSINE} against the bf16 route")
        layer_ms = time_layers(service, payloads)

        # The same int8 model on the flash route (`serve --quant` under
        # PIGEON_ATTN_IMPL=flash): static int8 projections, then K3.
        model = service.serve_fn.model
        set_route(model, "flash")
        try:
            service.serve_fn(pixels)
            torch.cuda.synchronize()
            forwards, times = 3, []
            for fn in counters.values():
                fn.launches = 0
            for _ in range(forwards):
                t0 = time.perf_counter()
                flash = service.serve_fn(pixels)["embedding"].flatten() \
                    .float()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            flash_launches = {name: fn.launches
                              for name, fn in counters.items()}
        finally:
            set_route(model, "fused")
        want = {"fused_qkv_attention": 0,
                "flash_attention": layers * forwards,
                "fused_qkv_attention_int8": 0}
        if flash_launches != want:
            raise RuntimeError(f"{forwards} int8 forwards on the flash route "
                               f"launched {flash_launches}, expected {want}")
        flash_cos = torch.nn.functional.cosine_similarity(
            flash, bf16_embedding, dim=0).item()
        if not flash_cos >= INT8_COSINE:
            raise RuntimeError(f"int8 flash-route embedding cosine "
                               f"{flash_cos} < {INT8_COSINE} against the "
                               "bf16 route")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        httpd.shutdown()
        httpd.server_close()
    phase("serve_int8", requests=n_requests, status=200, layers=layers,
          calib_views=4 * 20, k3_calib_launches=setup["flash_attention"],
          k8_launches=launches["fused_qkv_attention_int8"],
          median_ms=sorted(latencies)[len(latencies) // 2],
          latencies_ms=[round(t, 3) for t in latencies],
          startup_s=round(startup_s, 3),
          embedding_cosine_vs_bf16=cos,
          flash_route_k3_launches=flash_launches["flash_attention"],
          flash_route_forward_ms=round(sorted(times)[forwards // 2], 3),
          flash_route_cosine_vs_bf16=flash_cos,
          peak_gib=round(peak_gib, 3))
    phase("layers_int8", **layer_ms)
    return {"flash_attention": setup["flash_attention"]
            + flash_launches["flash_attention"],
            "fused_qkv_attention_int8": launches["fused_qkv_attention_int8"]}


def check_serving_int8_block(root: str, pool, n_requests: int,
                             bf16_embedding) -> dict:
    """``serve --quant --calib-images`` under
    ``PIGEON_QUANT_ATTN_IMPL=flash_fused_block``: the calibration forward
    launches K3 once a layer, each request K7 once a layer and K1, K3 and
    K8 never; the embedding within cosine >= 0.99 of bf16's. Returns K3's
    launches in the calibration and K7's in the requests."""
    import gc

    import torch

    from pigeon_tpu_torch.kernels import attention as k3
    from pigeon_tpu_torch.kernels import fused_block_attention_int8 as k7
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.models.clip import routes_of

    counters = {"fused_qkv_attention": k1.fused_qkv_attention,
                "flash_attention": k3.flash_attention,
                "fused_qkv_attention_int8": k8.fused_qkv_attention_int8,
                "fused_block_attention_int8": k7.fused_block_attention_int8}
    payloads = serve_payloads(n_requests)
    calib_dir = os.path.join(HERE, "data", "benchmarks", "sample20",
                             "images")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with environ(PIGEON_QUANT_ATTN_IMPL="flash_fused_block"):
        httpd, startup_s = start_serving(root, "--quant", "--calib-images",
                                         calib_dir)
    try:
        service = httpd.RequestHandlerClass.service
        model = service.serve_fn.model
        if routes_of(model) != {"block"}:
            raise RuntimeError(f"serve --quant built routes "
                               f"{routes_of(model)} under "
                               "PIGEON_QUANT_ATTN_IMPL=flash_fused_block")
        layers = len(model.vision.encoder.layers)
        # Start-up: one dynamic calibration forward (K3 in every layer),
        # then the static warm-up request (K7 in every layer).
        setup = {name: fn.launches for name, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want.update(flash_attention=layers, fused_block_attention_int8=layers)
        if setup != want:
            raise RuntimeError(f"int8 block start-up launched {setup}; "
                               f"expected {want}")
        latencies, launches = request_all(httpd, payloads, pool, counters)
        want = dict.fromkeys(counters, 0)
        want["fused_block_attention_int8"] = layers * n_requests
        if launches != want:
            raise RuntimeError(f"int8 block requests launched {launches}, "
                               f"expected {want}")
        emb = service.serve_fn(service.decode(payloads[0]))["embedding"]
        cos = torch.nn.functional.cosine_similarity(
            emb.flatten().float(), bf16_embedding, dim=0).item()
        if not cos >= INT8_COSINE:
            raise RuntimeError(f"int8 block embedding cosine {cos} < "
                               f"{INT8_COSINE} against the bf16 route")
        layer_ms = time_layers(service, payloads)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        httpd.shutdown()
        httpd.server_close()
    phase("serve_int8", route="flash_fused_block", requests=n_requests,
          status=200, layers=layers, calib_views=4 * 20,
          k3_calib_launches=setup["flash_attention"],
          k7_launches=launches["fused_block_attention_int8"],
          median_ms=sorted(latencies)[len(latencies) // 2],
          latencies_ms=[round(t, 3) for t in latencies],
          startup_s=round(startup_s, 3), embedding_cosine_vs_bf16=cos,
          peak_gib=round(peak_gib, 3))
    phase("layers_int8_block", **layer_ms)
    return {"flash_attention": setup["flash_attention"],
            "fused_block_attention_int8":
                launches["fused_block_attention_int8"]}


@contextlib.contextmanager
def environ(**values):
    """Environment variables set for the ``with`` block only."""
    old = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def route_counters() -> dict:
    """The launch counters of every kernel a bf16 route may run."""
    from pigeon_tpu_torch.kernels import attention as k34
    from pigeon_tpu_torch.kernels import fused_block_attention as k6
    from pigeon_tpu_torch.kernels import fused_ln_qkv_attention as k5
    from pigeon_tpu_torch.kernels import fused_mlp as k9
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k12
    from pigeon_tpu_torch.kernels import geodesy

    return {"fused_qkv_attention": k12.fused_qkv_attention,
            "fused_qkv_attention_bwd": k12.fused_qkv_attention_backward,
            "flash_attention": k34.flash_attention,
            "flash_attention_online": k34.flash_attention_online,
            "flash_attention_bwd": k34.flash_attention_backward,
            "fused_ln_qkv_attention": k5.fused_ln_qkv_attention,
            "fused_block_attention": k6.fused_block_attention,
            "fused_mlp": k9.fused_ln_mlp,
            "smooth_labels": geodesy.smooth_labels_from_points}


#: [serve_routes]: each server's ``PIGEON_ATTN_IMPL``, the port's route
#: and the kernels a request launches once a layer; then single serving
#: forwards on the first server's model: (label, route, environment,
#: kernels launched once a layer).
SERVE_ROUTES = (
    ("flash_fused_mlp", "fused_mlp", ("fused_ln_qkv_attention", "fused_mlp")),
    ("flash_fused_block", "block", ("fused_block_attention", "fused_mlp")),
)
FORWARD_ROUTES = (
    ("flash", "flash", {}, ("flash_attention",)),
    ("fused_ln", "fused_ln", {}, ("fused_ln_qkv_attention",)),
    ("flash_online", "flash", {"PIGEON_FLASH_FWD": "online"},
     ("flash_attention_online",)),
)


def check_serve_routes(root: str, pool, n_requests: int,
                       bf16_embedding) -> dict:
    """``serve`` under each ``PIGEON_ATTN_IMPL`` of `SERVE_ROUTES` over
    HTTP (``flash_fused_mlp``: K5 and K9 once a layer a request;
    ``flash_fused_block``: K6 and K9; every other kernel never); on the
    first server's model, the serving forward of one panorama on each of
    `FORWARD_ROUTES` (``flash``: K3 once a layer; ``flash_fused_ln``: K5;
    ``flash`` under ``PIGEON_FLASH_FWD=online``: K3′, K3 never); every
    embedding within ``ROUTE_COSINE`` of the ``flash_fused`` route's.
    Returns each kernel's launches."""
    import gc

    import torch

    from pigeon_tpu_torch.models.clip import routes_of, set_route

    counters = route_counters()
    payloads = serve_payloads(n_requests)
    total = dict.fromkeys(counters, 0)

    def cosine(emb) -> float:
        cos = torch.nn.functional.cosine_similarity(
            emb.flatten().float(), bf16_embedding, dim=0).item()
        if not cos >= ROUTE_COSINE:
            raise RuntimeError(f"embedding cosine {cos} < {ROUTE_COSINE} "
                               "against the flash_fused route")
        return cos

    for name, route, kernels in SERVE_ROUTES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with environ(PIGEON_ATTN_IMPL=name):
            httpd, startup_s = start_serving(root)
        forward_ms, cosines = {}, {}
        try:
            service = httpd.RequestHandlerClass.service
            model = service.serve_fn.model
            if routes_of(model) != {route}:
                raise RuntimeError(f"serve built routes {routes_of(model)} "
                                   f"under PIGEON_ATTN_IMPL={name}")
            layers = len(model.vision.encoder.layers)
            latencies, launches = request_all(httpd, payloads, pool,
                                              counters)
            want = dict.fromkeys(counters, 0)
            want.update(dict.fromkeys(kernels, layers * n_requests))
            if launches != want:
                raise RuntimeError(f"{name} requests launched {launches}, "
                                   f"expected {want}")
            for kernel, n in launches.items():
                total[kernel] += n
            per_request = {kernel: n // n_requests
                           for kernel, n in launches.items() if n}
            pixels = service.decode(payloads[0])
            cosines[route] = cosine(service.serve_fn(pixels)["embedding"])
            layer_ms = time_layers(service, payloads)

            # On the first server: one panorama's serving forward on each
            # of FORWARD_ROUTES, 3 times.
            forwards = 3
            for label, other, env, names in (
                    FORWARD_ROUTES if name == SERVE_ROUTES[0][0] else ()):
                set_route(model, other)
                with environ(**env):
                    service.serve_fn(pixels)
                    torch.cuda.synchronize()
                    for fn in counters.values():
                        fn.launches = 0
                    times = []
                    for _ in range(forwards):
                        t0 = time.perf_counter()
                        emb = service.serve_fn(pixels)["embedding"]
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                    launches = {n: fn.launches for n, fn in counters.items()}
                want = dict.fromkeys(counters, 0)
                want.update(dict.fromkeys(names, layers * forwards))
                if launches != want:
                    raise RuntimeError(f"{forwards} forwards on {label} "
                                       f"launched {launches}, expected "
                                       f"{want}")
                for kernel, n in launches.items():
                    total[kernel] += n
                forward_ms[label] = sorted(times)[forwards // 2]
                cosines[label] = cosine(emb)
            set_route(model, route)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
        finally:
            httpd.shutdown()
            httpd.server_close()
        phase("serve_routes", route=name, requests=n_requests, status=200,
              layers=layers,
              launches_per_request=json.dumps(per_request,
                                              separators=(",", ":")),
              median_ms=sorted(latencies)[len(latencies) // 2],
              latencies_ms=[round(t, 3) for t in latencies],
              startup_s=round(startup_s, 3), peak_gib=round(peak_gib, 3),
              **{f"forward_ms_{r}": round(t, 3)
                 for r, t in forward_ms.items()},
              **{f"cosine_vs_flash_fused_{r}": c for r, c in cosines.items()})
        phase(f"layers_{route}", **layer_ms)
    return total


def time_layers(service, payloads) -> dict:
    """Median host-clock milliseconds of each layer of a request, outside
    HTTP: decode, the serving forward (tower + head + top-k) and the
    refiner, each ended by a device synchronise."""
    import torch

    out = {"decode": [], "forward": [], "refine": []}
    for payload in payloads:
        t0 = time.perf_counter()
        pixels = service.decode(payload)
        t1 = time.perf_counter()
        res = service.serve_fn(pixels)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        service.refine_fn(res["embedding"], res["pred_lla"],
                          res["topk_cells"], res["topk_probs"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(out, (t1 - t0, t2 - t1, t3 - t2)):
            out[key].append(dt * 1e3)
    return {f"{key}_ms": sorted(v)[len(v) // 2] for key, v in out.items()}


def eval_counters() -> dict:
    """The launch counters of every kernel an ``evaluate`` or ``predict``
    run may reach: the bf16 routes' and the int8 ones'."""
    from pigeon_tpu_torch.kernels import fused_block_attention_int8 as k7
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8

    return {**route_counters(),
            "fused_qkv_attention_int8": k8.fused_qkv_attention_int8,
            "fused_block_attention_int8": k7.fused_block_attention_int8}


def write_base(root: str, seed: int, cfg) -> str:
    """A seeded reference-layout SuperGuessr state dict (``base_model.*``
    and ``cell_layer``) of the ``cfg`` model, stored in bf16, as
    ``--base`` reads it; its weights are `init_weights` of another seed
    than the CLI's own initialisation."""
    import torch

    from pigeon_tpu_torch.models.hf_import import reference_state
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr, init_weights

    model = init_weights(SuperGuessr(cfg.vision, cfg.head), BASE_SEED + seed)
    path = os.path.join(root, "base.pt")
    torch.save({k: v.to(torch.bfloat16)
                for k, v in reference_state(model).items()}, path)
    return path


def run_command(argv, counters: dict, expect: dict) -> dict:
    """The port CLI's ``main(argv)`` with every counter set to 0 just
    before it; each counter's launches must equal ``expect``'s (0 where
    unnamed). Returns the launches, the seconds and the peak GiB."""
    import gc

    import torch

    from pigeon_tpu_torch.cli import run

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    if run.main(argv) != 0:
        raise RuntimeError(f"{argv[0]} exited non-zero")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: expect.get(name, 0) for name in counters}
    if launches != want:
        raise RuntimeError(f"{argv[0]} {argv[-1]} launched {launches}, "
                           f"expected {want}")
    return {"launches": {k: n for k, n in launches.items() if n},
            "seconds": seconds,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def time_evaluation(ev, runs: int = EVAL_LOOP_RUNS) -> list:
    """The seconds of ``runs`` passes of the ``evaluate`` command's own
    loop (`run_evaluation`) over a run `build_evaluation` set up, its
    set-up (model, bank, datasets) outside the clock, decode included,
    each ended by a synchronise; after one warm-up."""
    import torch

    from pigeon_tpu_torch.cli import run

    times = []
    for _ in range(runs + 1):
        t0 = time.perf_counter()
        run.run_evaluation(ev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times[1:]


def check_evaluate(root: str, pool, seed: int) -> dict:
    """``evaluate -l sample20 --base`` (refined, the ``im2gps3k`` preset;
    bf16, then ``--quant``) and ``predict --images`` through the CLI's
    own ``main`` at full width on `write_assets`' cells, bank and
    prototypes, each with exact launch counts; then, outside the counts,
    the weights of a model the CLI builds on the same arguments against
    the file's, its first batch's embeddings on the kernel route against
    the plain route and the int8 tower's against bf16's. Returns each
    kernel's launches."""
    import numpy as np
    import torch

    from pigeon_tpu_torch.cli import run
    from pigeon_tpu_torch.data.image_ops import normalize_images
    from pigeon_tpu_torch.data.pipeline import iter_batches
    from pigeon_tpu_torch.models.clip import set_route
    from pigeon_tpu_torch.train.metrics import compute_geoguessr_metrics

    images = os.path.join(HERE, "data", "benchmarks", "sample20", "images")
    common = ["--geocells", os.path.join(root, "cells.csv"),
              "--metadata", os.path.join(root, "meta.csv"),
              "--prototypes", os.path.join(root, "protos.csv"),
              "--embeddings", os.path.join(root, "emb"),
              "--checkpoint-dir", os.path.join(root, "eval_ckpt"),
              "--batch-size", str(EVAL_BATCH), "--device", "cuda"]
    evaluate = ["evaluate", "smoke_eval", "-l", EVAL_BENCHMARK,
                "--benchmarks", os.path.join(HERE, "data", "benchmarks",
                                             "benchmarks.json"), *common]
    cfg = run.make_config(run.build_parser().parse_args(evaluate))
    cfg = cfg.replace(head=dataclasses.replace(cfg.head,
                                               num_cells=NUM_CELLS))
    t0 = time.perf_counter()
    base = write_base(root, seed, cfg)
    base_s = time.perf_counter() - t0
    evaluate += ["--base", base]
    args = run.build_parser().parse_args(evaluate)
    counters = eval_counters()
    layers = cfg.vision.num_layers
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    runs = {}
    for label, extra, expect in (
            ("bf16", (), {"fused_qkv_attention": layers * batches,
                          "smooth_labels": batches}),
            ("int8", ("--quant",), {"flash_attention": layers,
                                    "fused_qkv_attention_int8":
                                        layers * batches,
                                    "smooth_labels": batches})):
        out = os.path.join(root, f"eval_{label}.json")
        runs[label] = run_command([*evaluate, *extra, "--output", out],
                                  counters, expect)
        metrics = json.load(open(out))[EVAL_BENCHMARK]
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise RuntimeError(f"evaluate {label}: metrics not finite: {bad}")
        runs[label]["metrics"] = metrics
    # The suite's keys for these inputs: a geocell label column, no
    # multi-task, climate or month labels, no scaler or country file.
    n = np.zeros((1, 2))
    want_keys = [*compute_geoguessr_metrics(
        n, n, cell_preds=np.zeros(1), cell_labels=np.zeros(1),
        topk_cells=np.zeros((1, 1))), "Eval_loss"]
    for label, rec in runs.items():
        if list(rec["metrics"]) != want_keys:
            raise RuntimeError(f"evaluate {label}: keys "
                               f"{list(rec['metrics'])}, not {want_keys}")

    predictions = os.path.join(root, "predictions.csv")
    runs["predict"] = run_command(
        ["predict", "smoke_eval", "--images", images, "--base", base,
         *common, "--output", predictions], counters,
        {"fused_qkv_attention": layers * batches})
    with open(predictions) as f:
        rows = list(csv.DictReader(f))
    if len(rows) != EVAL_IMAGES or list(rows[0]) != list(
            run.PREDICT_COLUMNS):
        raise RuntimeError(f"predict wrote {len(rows)} rows of "
                           f"{list(rows[0]) if rows else []}")
    for row in rows:
        lat, lng = float(row["lat"]), float(row["lng"])
        if not (-90 <= lat <= 90 and -180 <= lng <= 180
                and 0 <= int(row["geocell_idx"]) < NUM_CELLS
                and 0 <= float(row["top1_prob"]) <= 1):
            raise RuntimeError(f"predict: bad row {row}")
        if not np.isclose(pool, [lng, lat], atol=1e-3).all(-1).any():
            raise RuntimeError(f"predict: ({lng}, {lat}) is no bank or "
                               "prototype location")

    # Outside the counts: the run the command builds from the same
    # arguments, its weights, embeddings and timed loop.
    file = torch.load(base, weights_only=True)
    ev = run.build_evaluation(args)
    model = ev.model.eval()
    tower = "base_model.vision_model."
    patch = file[tower + "embeddings.patch_embedding.weight"].float()
    for name, want in (
            ("vision.patch_embed.weight",
             patch.permute(0, 2, 3, 1).reshape(patch.shape[0], -1)),
            (f"vision.encoder.layers.{layers - 1}.attn.q_proj.weight",
             file[f"{tower}encoder.layers.{layers - 1}.self_attn.q_proj."
                  "weight"].float())):
        if not torch.equal(model.get_parameter(name).detach().cpu(), want):
            raise RuntimeError(f"{name} is not the --base file's tensor")
    with contextlib.closing(iter_batches(ev.datasets[EVAL_BENCHMARK],
                                         EVAL_BATCH)) as it:
        first = next(it)
    pixels = normalize_images(torch.from_numpy(first["inputs"]).cuda())
    with torch.inference_mode():
        kernel = model(pixels).embedding.flatten().float()
        set_route(model, "plain")
        plain = model(pixels).embedding.flatten().float()
        set_route(model, "fused")
    cos = torch.nn.functional.cosine_similarity(kernel, plain, dim=0).item()
    if not cos >= ROUTE_COSINE:
        raise RuntimeError(f"evaluate: kernel-route embedding cosine {cos} "
                           f"< {ROUTE_COSINE} against the plain route")
    loop_s = {"bf16": time_evaluation(ev)}
    del ev, model
    ev = run.build_evaluation(run.build_parser().parse_args(
        [*evaluate, "--quant"]))
    with torch.inference_mode():
        int8 = ev.model.eval()(pixels).embedding.flatten().float()
    int8_cos = torch.nn.functional.cosine_similarity(int8, kernel,
                                                     dim=0).item()
    if not int8_cos >= INT8_COSINE:
        raise RuntimeError(f"evaluate --quant: int8 embedding cosine "
                           f"{int8_cos} < {INT8_COSINE} against bf16")
    loop_s["int8"] = time_evaluation(ev)
    del ev

    phase("evaluate", base_file_gib=round(os.path.getsize(base) / 2**30, 3),
          base_write_s=round(base_s, 3), images=EVAL_IMAGES,
          batches=batches, cosine_vs_plain=cos, int8_cosine_vs_bf16=int8_cos)
    for label, times in loop_s.items():
        median = sorted(times)[len(times) // 2]
        phase("evaluate", loop=label, seconds=round(median, 4),
              images_per_s=round(EVAL_IMAGES / median, 2),
              seconds_all=[round(t, 4) for t in times])
    total = {}
    for label, rec in runs.items():
        fields = {k: rec["metrics"][k] for k in ("Median_km_error",
                                                 "Geoguessr_score",
                                                 "Eval_loss")} \
            if "metrics" in rec else {}
        phase("evaluate", run=label,
              launches=json.dumps(rec["launches"], separators=(",", ":")),
              seconds=round(rec["seconds"], 3),
              images_per_s=round(EVAL_IMAGES / rec["seconds"], 3),
              peak_gib=round(rec["peak_gib"], 3), **fields)
        for name, count in rec["launches"].items():
            total[name] = total.get(name, 0) + count
    return total


def write_train_assets(root: str, seed: int, train_rows: int = TRAIN_ROWS,
                       val_rows: int = VAL_ROWS, test_rows: int = 0):
    """Geocells and a panorama metadata CSV with every label column the
    multi-task loss reads, over the repo's PNG fixtures (``train_rows``,
    ``val_rows`` and ``test_rows`` by ``selection``). Returns the
    metadata path, the geocell path and the image directory."""
    import numpy as np

    from pigeon_tpu_torch.core.geodesy import haversine_matrix_np

    images = os.path.join(HERE, "data", "benchmarks", "sample20", "images")
    fixtures = sorted(os.path.basename(p)
                      for p in glob.glob(os.path.join(images, "*.png")))
    if len(fixtures) < 4:
        raise RuntimeError(f"need PNG fixtures under {images}")
    rng = np.random.default_rng(seed + 1)
    cells = np.stack([rng.uniform(-180, 180, NUM_CELLS),
                      rng.uniform(-60, 75, NUM_CELLS)], -1)
    cells_csv = os.path.join(root, "train_cells.csv")
    with open(cells_csv, "w") as f:
        f.write("name,lng,lat\n")
        f.writelines(f"c{i},{lng},{lat}\n"
                     for i, (lng, lat) in enumerate(cells.tolist()))
    n = train_rows + val_rows + test_rows
    lla = np.stack([rng.uniform(-180, 180, n), rng.uniform(-60, 75, n)], -1)
    nearest = haversine_matrix_np(lla, cells.astype(np.float32)).argmin(1)
    columns = ("image", "image_2", "image_3", "image_4", "lng", "lat",
               "selection", "elevation", "population", "temp_avg",
               "temp_diff", "prec_avg", "prec_diff", "climate_zone_idx",
               "month", "heading", "geocell_idx")
    meta = os.path.join(root, "train_meta.csv")
    with open(meta, "w") as f:
        f.write(",".join(columns) + "\n")
        for i in range(n):
            row = [*rng.choice(fixtures, 4), *lla[i],
                   "train" if i < train_rows else
                   "val" if i < train_rows + val_rows else "test",
                   *rng.normal(size=6), rng.integers(0, 28),
                   rng.integers(0, 12), rng.uniform(0, 360), nearest[i]]
            f.write(",".join(str(v) for v in row) + "\n")
    return meta, cells_csv, images


def grads_of(model) -> dict:
    """Every trainable gradient, flattened, in f32."""
    return {n: p.grad.float().flatten().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def worst_cosine(got: dict, want: dict) -> tuple:
    """The least cosine of ``got``'s gradients against ``want``'s, and
    where: the key bias's (zero in exact arithmetic: a shift shared by
    all keys) must be rounding noise in both instead."""
    import torch

    if got.keys() != want.keys():
        raise RuntimeError(f"gradients of other tensors: "
                           f"{got.keys() ^ want.keys()}")
    cosines = {}
    for name, g in got.items():
        if name.endswith("k_proj.bias"):
            ref = want[name.replace("k_proj", "q_proj")].norm()
            if not max(g.norm(), want[name].norm()) <= 1e-2 * ref:
                raise RuntimeError(f"{name} gradient is not ~0")
            continue
        cosines[name] = torch.nn.functional.cosine_similarity(
            g, want[name], dim=0).item()
    worst = min(cosines, key=cosines.get)
    return cosines[worst], worst


def check_training(seed: int) -> dict:
    """The full-width panorama model finetuned through the ``finetune``
    command's own functions; returns the launches in the first epoch of
    each kernel of `KERNELS`. Each train step launches the element-wise forward kernels of
    `kernels/eltwise.py` once a layer and again in the remat recompute,
    the pre-LN's once, and each backward kernel once a layer (the
    pre-LN's too); each eval batch the forward kernels as serving does."""
    import gc
    import math

    import numpy as np
    import torch

    from pigeon_tpu_torch.cli.run import (
        build_finetune,
        build_parser,
        train_finetune,
    )
    from pigeon_tpu_torch.kernels import eltwise
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k
    from pigeon_tpu_torch.kernels import geodesy
    from pigeon_tpu_torch.models.clip import set_route
    from pigeon_tpu_torch.models.geocell_head import smoothed_targets
    from pigeon_tpu_torch.train.checkpoints import latest_step
    from pigeon_tpu_torch.train.train_loop import (
        batch_loss,
        batch_to_device,
        make_train_step,
    )

    counters = {"fused_qkv_attention": k.fused_qkv_attention,
                "fused_qkv_attention_bwd": k.fused_qkv_attention_backward,
                "smooth_labels": geodesy.smooth_labels_from_points,
                **{name: getattr(eltwise, name)
                   for name in (*ELTWISE_KERNELS, *ELTWISE_BACKWARDS)}}
    gc.collect()
    torch.cuda.empty_cache()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)      # the run's scalars go to ./runs/NAME
        try:
            meta, cells_csv, images = write_train_assets(root, seed)
            argv = ["finetune", "smoke", "--panorama", "-m", "--heading",
                    "--metadata", meta, "--images", images,
                    "--geocells", cells_csv,
                    "--batch-size", str(TRAIN_BATCH), "--epochs", "1",
                    "--checkpoint-dir", os.path.join(root, "ckpt"),
                    "--device", "cuda"]
            t0 = time.perf_counter()
            run = build_finetune(build_parser().parse_args(argv))
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0

            # --- one epoch: 4 steps and the eval pass ---
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            history = train_finetune(run, 1, "smoke")
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            peak_attn_kernel = torch.cuda.max_memory_allocated() / 2**30
            layers = len(run.state.model.vision.encoder.layers)
            steps = TRAIN_ROWS // TRAIN_BATCH
            evals = math.ceil(VAL_ROWS / TRAIN_BATCH)
            runs = 1 if run.state.model.vision.encoder.remat == "none" \
                else 2
            chain = {name: steps * runs * layers + evals * layers
                     for name in ELTWISE_KERNELS}
            chain["layer_norm_bf16"] += steps + evals
            want = {"fused_qkv_attention": layers * (steps + evals),
                    "fused_qkv_attention_bwd": layers * steps,
                    "smooth_labels": steps + evals, **chain,
                    "layer_norm_bwd_bf16": (layers + 1) * steps,
                    "add_layer_norm_bwd_bf16": layers * steps,
                    "quick_gelu_bwd_bf16": layers * steps}
            if launches != want:
                raise RuntimeError(f"first epoch launched {launches}, "
                                   f"expected {want}")
            with open(os.path.join("runs", "smoke", "metrics.jsonl")) as f:
                losses = [r["value"] for r in map(json.loads, f)
                          if r["tag"] == "train/loss"]
            if len(losses) != steps or not np.isfinite(
                    losses + [history[-1]["Eval_loss"]]).all():
                raise RuntimeError(f"train losses {losses}, eval loss "
                                   f"{history[-1]['Eval_loss']}")
            if (run.state.step, latest_step(run.checkpoint_dir)) \
                    != (steps, steps):
                raise RuntimeError(
                    f"after the epoch: step {run.state.step}, checkpoint "
                    f"{latest_step(run.checkpoint_dir)}; expected {steps}")

            # --- gradients of the first batch: kernels vs plain route ---
            batches = run.train_batches(0)
            batch = batch_to_device(next(batches), run.device)
            batches.close()
            model, head = run.state.model, run.cfg.head

            def grads(impl, smooth_fn):
                set_route(model, impl)
                model.zero_grad(set_to_none=True)
                _, total, parts = batch_loss(model, batch, run.geocells,
                                             head, smooth_fn)
                total.backward()
                # post_ln feeds the pooled CLS output, which the head
                # does not read: it gets no gradient on either route.
                return ({n: p.grad.float().flatten().clone()
                         for n, p in model.named_parameters()
                         if p.grad is not None},
                        {n: v.item() for n, v in parts.items()})

            try:
                kernel_g, kernel_parts = grads("fused", smoothed_targets)
                plain_g, plain_parts = grads(
                    "plain", geodesy.smooth_labels_reference)
            finally:
                set_route(model, "fused")
            model.zero_grad(set_to_none=True)
            cosine, worst = worst_cosine(kernel_g, plain_g)
            if not cosine >= 0.999:
                raise RuntimeError(f"gradient cosine {cosine} < "
                                   f"0.999 for {worst}")
            rel = {n: abs(kernel_parts[n] - plain_parts[n])
                   / max(abs(plain_parts[n]), 1e-12) for n in plain_parts}
            if not max(rel.values()) <= 1e-2:
                raise RuntimeError(f"loss parts differ: {kernel_parts} vs "
                                   f"{plain_parts}")

            # --- step time and peak memory under both remat policies ---
            train_step = make_train_step(head, run.geocells)
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(run.state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            step_ms = sorted(times[1:])[len(times[1:]) // 2]
            model.vision.encoder.remat = "none"
            torch.cuda.reset_peak_memory_stats()
            train_step(run.state, batch)
            torch.cuda.synchronize()
            peak_none = torch.cuda.max_memory_allocated() / 2**30
            del run, model, batch, kernel_g, plain_g
            gc.collect()
            torch.cuda.empty_cache()

            # --- --resume continues from the checkpoint ---
            resumed = build_finetune(build_parser().parse_args(
                argv + ["--resume"]))
            start = resumed.state.step
            train_finetune(resumed, 1, "smoke")
            if (start, resumed.state.step,
                    latest_step(resumed.checkpoint_dir)) != (
                        steps, 2 * steps, 2 * steps):
                raise RuntimeError(
                    f"resume: from step {start} to {resumed.state.step}, "
                    f"checkpoint {latest_step(resumed.checkpoint_dir)}")
            del resumed
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    views = TRAIN_BATCH * 4
    phase("train", layers=layers, batch_panoramas=TRAIN_BATCH,
          steps=steps, eval_batches=evals,
          **{f"{name}_launches": n for name, n in launches.items()},
          losses=[round(v, 4) for v in losses],
          eval_loss=round(history[-1]["Eval_loss"], 4),
          grad_cosine_min=round(cosine, 6), grad_cosine_at=worst,
          loss_rel_diff_max=max(rel.values()),
          step_ms=round(step_ms, 3), step_ms_all=[round(t, 3) for t in times],
          images_per_s=round(views / step_ms * 1e3, 2),
          peak_gib_attn_kernel=round(peak_attn_kernel, 3),
          peak_gib_none=round(peak_none, 3), setup_s=round(setup_s, 3),
          epoch_s=round(epoch_s, 3), resumed_from=start)
    return {name: n for name, n in launches.items() if name in KERNELS}


#: [train_routes]: (label, the port's route, the environment it runs
#: under), the kernels each launches per layer in a forward and in a
#: backward, and those a backward launches per layer whose out-projection
#: trains.
TRAIN_ROUTES = (
    ("flash", "flash", {}, ("flash_attention",), ("flash_attention_bwd",),
     ()),
    ("flash_fused_ln", "fused_ln", {},
     ("fused_ln_qkv_attention",), ("fused_qkv_attention_bwd",), ()),
    ("flash_fused_mlp", "fused_mlp", {},
     ("fused_ln_qkv_attention", "fused_mlp"), ("fused_qkv_attention_bwd",),
     ()),
    ("flash_fused_xla_bwd", "fused", {"PIGEON_FUSED_BWD": "xla"},
     ("fused_qkv_attention",), ("flash_attention_bwd",), ()),
    # K6's backward launches K1 again for dWo's input, where Wo trains.
    ("flash_fused_block", "block", {},
     ("fused_block_attention", "fused_mlp"), ("fused_qkv_attention_bwd",),
     ("fused_qkv_attention",)),
    ("flash_online", "flash", {"PIGEON_FLASH_FWD": "online"},
     ("flash_attention_online",), ("flash_attention_bwd",), ()),
)


def check_train_routes(seed: int) -> dict:
    """The ``[train]`` preset, width and batch under remat ``attn_kernel``
    on each route of `TRAIN_ROUTES`, from the same parameters: the
    ``finetune`` command's `build_finetune` under
    ``PIGEON_ATTN_IMPL=flash``, then the route switched on the built
    model. On the first batch every trainable gradient of each route must
    be within ``ROUTE_COSINE`` of the plain route's. Then, from the same
    parameters and a fresh optimizer, ``ROUTE_STEPS`` = 2 steps and one
    eval batch with finite losses and these exact launch counts (L = 24
    layers; the remat recompute replays the saved kernel outputs, so no
    forward kernel runs twice):

    * ``flash``: K3 3 L, K4 2 L;
    * ``flash_fused_ln``: K5 3 L, K2 2 L;
    * ``flash_fused_mlp``: K5 3 L, K9 3 L, K2 2 L;
    * ``flash_fused`` with ``PIGEON_FUSED_BWD=xla``: K1 3 L, K4 2 L, K2 0;
    * ``flash_fused_block``: K6 3 L, K9 3 L, K2 2 L, and K1 2 (K6's
      backward, in the one layer whose out-projection trains);
    * ``flash`` with ``PIGEON_FLASH_FWD=online``: K3′ 3 L, K4 2 L, K3 0;

    every other kernel of `route_counters` none but K10, 3 times (2 steps
    + 1 eval batch). Step time, images/s and peak memory per route.
    Returns each kernel's launches."""
    import gc

    import numpy as np
    import torch

    from pigeon_tpu_torch.cli.run import build_finetune, build_parser
    from pigeon_tpu_torch.models.clip import routes_of, set_route
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        batch_loss,
        batch_to_device,
        make_eval_step,
        make_train_step,
    )

    counters = route_counters()
    total = dict.fromkeys(counters, 0)
    gc.collect()
    torch.cuda.empty_cache()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            meta, cells_csv, images = write_train_assets(root, seed)
            argv = ["finetune", "routes", "--panorama", "-m", "--heading",
                    "--metadata", meta, "--images", images,
                    "--geocells", cells_csv,
                    "--batch-size", str(TRAIN_BATCH),
                    "--checkpoint-dir", os.path.join(root, "ckpt"),
                    "--device", "cuda"]
            with environ(PIGEON_ATTN_IMPL="flash"):
                run = build_finetune(build_parser().parse_args(argv))
            model, head = run.state.model, run.cfg.head
            if routes_of(model) != {"flash"}:
                raise RuntimeError(f"finetune built routes {routes_of(model)}"
                                   " under PIGEON_ATTN_IMPL=flash")
            layers = len(model.vision.encoder.layers)
            trained = sum(layer.attn.out_proj.weight.requires_grad
                          for layer in model.vision.encoder.layers)

            def first(batches):
                batch = batch_to_device(next(batches), run.device)
                batches.close()
                return batch

            batch, val_batch = first(run.train_batches(0)), \
                first(run.eval_batches())
            start = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}

            def grads(route, env):
                set_route(model, route)
                model.train()
                model.zero_grad(set_to_none=True)
                with environ(**env):
                    _, total_loss, _ = batch_loss(model, batch, run.geocells,
                                                  head)
                    total_loss.backward()
                out = {n: p.grad.float().flatten().clone()
                       for n, p in model.named_parameters()
                       if p.grad is not None}
                model.zero_grad(set_to_none=True)
                return out

            plain = grads("plain", {})
            for label, route, env, fwd, bwd, bwd_trained in TRAIN_ROUTES:
                # --- gradients of the first batch against the plain route
                model.load_state_dict(start)
                cosine, worst = worst_cosine(grads(route, env), plain)
                if not cosine >= ROUTE_COSINE:
                    raise RuntimeError(f"{label}: gradient cosine "
                                       f"{cosine} < {ROUTE_COSINE} "
                                       f"for {worst}")

                # --- 2 steps and an eval batch from the same parameters
                state = TrainState(model, adamw(model.parameters(),
                                                run.cfg.train.learning_rate))
                train_step = make_train_step(head, run.geocells)
                eval_step = make_eval_step(head, run.geocells)
                with environ(**env):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    for fn in counters.values():
                        fn.launches = 0
                    losses, times = [], []
                    for _ in range(ROUTE_STEPS):
                        t0 = time.perf_counter()
                        losses.append(float(train_step(state, batch)["loss"]))
                        times.append((time.perf_counter() - t0) * 1e3)
                    eval_loss = float(eval_step(model, val_batch)[0]["loss"])
                    torch.cuda.synchronize()
                    launches = {n: fn.launches for n, fn in counters.items()}
                    # Step time: 3 more synchronised steps.
                    for _ in range(3):
                        t0 = time.perf_counter()
                        train_step(state, batch)
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                    peak_gib = torch.cuda.max_memory_allocated() / 2**30
                want = dict.fromkeys(counters, 0)
                want["smooth_labels"] = ROUTE_STEPS + 1
                want.update(dict.fromkeys(fwd, layers * (ROUTE_STEPS + 1)))
                want.update(dict.fromkeys(bwd, layers * ROUTE_STEPS))
                want.update(dict.fromkeys(bwd_trained, trained * ROUTE_STEPS))
                if launches != want:
                    raise RuntimeError(f"{label}: {ROUTE_STEPS} steps and an "
                                       f"eval batch launched {launches}, "
                                       f"expected {want}")
                if not np.isfinite(losses + [eval_loss]).all():
                    raise RuntimeError(f"{label}: losses {losses}, eval "
                                       f"loss {eval_loss}")
                for name, n in launches.items():
                    total[name] += n
                del state
                step_ms = sorted(times[1:])[len(times[1:]) // 2]
                phase("train_routes", route=label, layers=layers,
                      batch_panoramas=TRAIN_BATCH, steps=ROUTE_STEPS,
                      eval_batches=1,
                      **{f"{n}_launches": launches[n]
                         for n in (*fwd, *bwd, *bwd_trained)},
                      losses=[round(v, 4) for v in losses],
                      eval_loss=round(eval_loss, 4),
                      grad_cosine_min=round(cosine, 6),
                      grad_cosine_at=worst, step_ms=round(step_ms, 3),
                      step_ms_all=[round(t, 3) for t in times],
                      images_per_s=round(4 * TRAIN_BATCH / step_ms * 1e3, 2),
                      peak_gib=round(peak_gib, 3))
            del run, model, batch, val_batch, start, plain
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    return total


#: [train_durable]: the remat policies a step runs under, each on the
#: route named; the steps timed after each counted one.
DURABLE_REMATS = (("fused", "none"), ("fused", "full"),
                  ("fused", "attn_out"), ("fused", "attn_kernel"),
                  ("fused", "attn_slim"), ("block", "attn_kernel"),
                  ("block", "attn_slim"), ("block", "attn_out"))
DURABLE_TIMED_STEPS = 5
#: [train_durable]: SIGTERM is raised as the loop takes this train batch
#: (1-based), so the run stops at the step before it.
PREEMPT_AT = 3
#: [train_durable]: steps timed after an async save, and without one.
ASYNC_STEPS = 4


def durable_launches(route: str, remat: str, layers: int, trained: int,
                     steps: int, evals: int = 0) -> dict:
    """The launches of ``steps`` train steps and ``evals`` eval batches on
    ``route`` under ``remat`` (`models/clip.py`'s docstring): the
    attention forward once a layer, and once more in every layer's
    backward under ``full`` and, on ``fused``, ``attn_out``; K2 once a
    layer a step; K9 once a layer a forward on ``block``; K1 once a step
    in K6's backward, for each layer whose out-projection trains; K10
    once a step and once an eval batch."""
    rerun = remat == "full" or (remat == "attn_out" and route == "fused")
    fwd = layers * (steps * (2 if rerun else 1) + evals)
    want = dict.fromkeys(route_counters(), 0)
    want["fused_qkv_attention_bwd"] = layers * steps
    want["smooth_labels"] = steps + evals
    if route == "fused":
        want["fused_qkv_attention"] = fwd
    else:
        want["fused_block_attention"] = fwd
        want["fused_mlp"] = layers * (steps + evals)
        want["fused_qkv_attention"] = trained * steps
    return want


def write_aux_dir(root: str, seed: int) -> str:
    """A seeded auxiliary-data directory in the GeoAugmentor's layout
    (`geocell/augmentor.py::build_augmentor`): a country GeoJSON, and one
    small GeoTIFF a raster source (Köppen, elevation, population in
    Mollweide metres, 12 monthly WorldClim temperatures and
    precipitations)."""
    import numpy as np
    from PIL import Image, TiffImagePlugin

    rng = np.random.default_rng(seed + 5)
    aux = os.path.join(root, "aux")

    def tif(sub: str, name: str, data, origin=(-180.0, 90.0),
            scale=(10.0, 10.0)) -> None:
        os.makedirs(os.path.join(aux, sub), exist_ok=True)
        ifd = TiffImagePlugin.ImageFileDirectory_v2()
        ifd[33550] = (float(scale[0]), float(scale[1]), 0.0)
        ifd[33922] = (0.0, 0.0, 0.0, float(origin[0]), float(origin[1]),
                      0.0)
        Image.fromarray(data).save(os.path.join(aux, sub, name),
                                   tiffinfo=ifd)

    grid = (18, 36)
    tif("koppen_geiger", "koppen.tif",
        rng.integers(1, 31, grid).astype(np.uint8))
    tif("elevation", "elevation.tif",
        rng.normal(500, 300, grid).astype(np.float32))
    tif("pop_density", "population.tif",
        rng.gamma(2, 50, grid).astype(np.float32),
        origin=(-18040095.0, 9020047.0), scale=(1e6, 1e6))
    for var, mean in (("tavg", 15.0), ("prec", 60.0)):
        for month in range(1, 13):
            tif(os.path.join("worldclim", var), f"{var}_{month:02d}.tif",
                rng.normal(mean, 8, grid).astype(np.float32))
    os.makedirs(os.path.join(aux, "boundaries"), exist_ok=True)
    with open(os.path.join(aux, "boundaries",
                           "geoBoundariesCGAZ_ADM0.geojson"), "w") as f:
        json.dump({"type": "FeatureCollection", "features": [
            {"type": "Feature", "properties": {"shapeName": name},
             "geometry": {"type": "Polygon", "coordinates": [[
                 [x0, -60], [x0 + 90, -60], [x0 + 90, 75], [x0, 75],
                 [x0, -60]]]}}
            for name, x0 in (("West", -180), ("Centre", -90),
                             ("East", 0), ("Far", 90))]}, f)
    return aux


def check_train_durable(seed: int) -> dict:
    """[train_durable]: the rest of ``finetune`` at the ``[train]``
    preset, width and batch (8 panoramas, 32 views; 2203 seeded cells).
    One model built by `build_finetune` serves every check that does not
    need the CLI. Returns each kernel's launches.

    * remat: one step from the same weights and batch under each of
      `DURABLE_REMATS`, with the exact launches of `durable_launches`,
      every trainable gradient within ``ROUTE_COSINE`` of ``none``'s, the
      peak memory of the step and the median of `DURABLE_TIMED_STEPS`
      more;
    * divergence: `train_model` for 3 epochs of 4 steps (``log_every``
      2) whose epoch-1 second batch has a NaN label row (location and
      multi-task labels): one rollback to epoch 0's checkpoint (step 4), a
      finite history of epochs 0 and 2, K10 bit for bit equal to its plain
      version on that batch's labels, the NaN row a row of zero targets
      in both;
    * preemption: `cmd_finetune` with SIGTERM raised as the loop takes
      train batch `PREEMPT_AT`: it returns 0 at step `PREEMPT_AT` - 1
      with no eval written and that step's checkpoint; ``--resume`` loads
      parameters and Adam moments bit for bit equal to the stopped run's
      and trains its epoch to the end;
    * async save: `CheckpointSession.save` of the model's state, then
      `ASYNC_STEPS` steps while it is written, timed against as many
      without a write, then a second save into the staging buffers the
      first made; each call must return before its write ends, and the
      first checkpoint restores bit for bit equal to the state at its
      save;
    * profiler: a `ProfilerWindow` (wait 4, active 10) over 15 steps whose
      `summarize_trace` names K1's and K2's kernels (retried once when
      the window kept no device records);
    * data: `cmd_finetune -m` for one epoch on two metadata files without
      the multi-task columns (comma-separated) and a seeded ``--aux-dir``:
      the train rows of both files, augmented, finite losses;
    * hierarchical: two steps of a panorama head with ``hierarchical``
      and ``heading`` on the same tower (``flash_fused``): finite losses
      and ``view_attention`` gradients.
    """
    import gc
    import math
    import signal

    import numpy as np
    import pandas as pd
    import torch

    from pigeon_tpu_torch.cli import run as cli
    from pigeon_tpu_torch.data import pipeline
    from pigeon_tpu_torch.kernels import geodesy
    from pigeon_tpu_torch.models.clip import set_route
    from pigeon_tpu_torch.models.geocell_head import GeocellHead
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train import loop, profiling
    from pigeon_tpu_torch.train.checkpoints import (
        CheckpointSession,
        latest_step,
    )
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        batch_to_device,
        make_eval_step,
        make_train_step,
    )

    counters = route_counters()
    total = dict.fromkeys(counters, 0)

    def reset() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read() -> dict:
        """The launches since the last read or reset, added to the
        phase's; the counters start again from 0."""
        torch.cuda.synchronize()
        counts = {n: fn.launches for n, fn in counters.items()}
        for name, n in counts.items():
            total[name] += n
        reset()
        return counts

    def expect(label: str, got: dict, want: dict) -> None:
        if got != want:
            raise RuntimeError(f"[train_durable] {label} launched {got}, "
                               f"expected {want}")

    gc.collect()
    torch.cuda.empty_cache()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)      # the runs' scalars go to ./runs/NAME
        try:
            meta, cells_csv, images = write_train_assets(root, seed)
            base = ["--panorama", "-m", "--heading", "--images", images,
                    "--geocells", cells_csv, "--batch-size",
                    str(TRAIN_BATCH), "--device", "cuda"]
            argv = ["finetune", "durable", "--metadata", meta, *base,
                    "--checkpoint-dir", os.path.join(root, "ckpt")]
            run = cli.build_finetune(cli.build_parser().parse_args(argv))
            model, head = run.state.model, run.cfg.head
            layers = len(model.vision.encoder.layers)
            trained = sum(layer.attn.out_proj.weight.requires_grad
                          for layer in model.vision.encoder.layers)
            host_train = list(run.train_batches(0))
            host_val = list(run.eval_batches())
            batch = batch_to_device(host_train[0], run.device)
            start = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
            train_step = make_train_step(head, run.geocells)
            lr = run.cfg.train.learning_rate

            def fresh_state() -> TrainState:
                model.load_state_dict(start)
                model.zero_grad(set_to_none=True)
                return TrainState(model, adamw(model.parameters(), lr))

            # --- remat: one step per policy from the same weights ---
            remat_grads, remat_rows = {}, {}
            for route, remat in DURABLE_REMATS:
                set_route(model, route)
                model.vision.encoder.remat = remat
                state = fresh_state()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset()
                loss = float(train_step(state, batch)["loss"])
                counts = read()
                peak = torch.cuda.max_memory_allocated() / 2**30
                expect(f"{route} {remat} step", counts, durable_launches(
                    route, remat, layers, trained, 1))
                remat_grads[(route, remat)] = grads_of(model)
                times = []
                for _ in range(DURABLE_TIMED_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    train_step(state, batch)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                read()
                if not math.isfinite(loss):
                    raise RuntimeError(f"{route} {remat}: loss {loss}")
                remat_rows[(route, remat)] = dict(
                    loss=round(loss, 5), peak_gib=round(peak, 3),
                    step_ms=round(sorted(times)[len(times) // 2], 3),
                    launches={n: c for n, c in counts.items() if c})
                del state
            for (route, remat), grads in remat_grads.items():
                cosine, at = worst_cosine(grads, remat_grads[("fused",
                                                              "none")])
                if not cosine >= ROUTE_COSINE:
                    raise RuntimeError(f"{route} {remat}: gradient cosine "
                                       f"{cosine} < {ROUTE_COSINE} at {at}")
                phase("train_durable", check="remat", route=route,
                      remat=remat, grad_cosine_min=round(cosine, 6),
                      grad_cosine_at=at, **remat_rows[(route, remat)])
            del remat_grads
            set_route(model, "fused")
            model.vision.encoder.remat = "attn_kernel"

            to_device = functools.partial(batch_to_device,
                                          device=run.device)
            eval_step = make_eval_step(head, run.geocells)

            # --- divergence: a NaN label row in epoch 1's second batch ---
            # (location and multi-task labels, a corrupt metadata row: K10
            # maps the NaN location to a row of zero targets, as its plain
            # version does, and the regression term makes the loss NaN)
            nan_batch = dict(host_train[1])
            for key in ("labels", "labels_multi_task"):
                nan_batch[key] = nan_batch[key].copy()
                nan_batch[key][0] = np.nan
            record = {"saved": [], "restored": []}

            class Recording(CheckpointSession):
                def save(self, state, wait=False):
                    record["saved"].append(super().save(state, wait))
                    return record["saved"][-1]

                def restore(self, state, step=None):
                    super().restore(state, step)
                    record["restored"].append(state.step)
                    return state

            t0 = time.perf_counter()
            state = fresh_state()
            loop.CheckpointSession = Recording
            reset()
            try:
                state, history = loop.train_model(
                    state, train_step, eval_step,
                    lambda epoch: [nan_batch if (epoch, i) == (1, 1) else b
                                   for i, b in enumerate(host_train)],
                    lambda: host_val, num_epochs=3,
                    batch_to_device=to_device,
                    checkpoint_dir=os.path.join(root, "diverge"),
                    log_every=2)
            finally:
                loop.CheckpointSession = CheckpointSession
            counts = read()
            steps = len(host_train)
            expect("divergence run", counts, durable_launches(
                "fused", "attn_kernel", layers, trained,
                2 * steps + 2, 2))
            eval_losses = [h["Eval_loss"] for h in history]
            if record["restored"] != [steps] or len(history) != 2 \
                    or not np.isfinite(eval_losses).all() \
                    or state.step != 2 * steps:
                raise RuntimeError(f"divergence: {record}, eval losses "
                                   f"{eval_losses}, step {state.step}")
            labels = torch.from_numpy(nan_batch["labels"]).to(run.device)
            got = geodesy.smooth_labels_from_points(
                labels, run.geocells, head.label_smoothing_km)
            want = geodesy.smooth_labels_reference(
                labels, run.geocells, head.label_smoothing_km)
            if not (torch.equal(got, want) and not got[0].any()
                    and torch.isfinite(got).all()):
                raise RuntimeError("K10 and its plain version disagree on "
                                   "the batch with a NaN label row, or it "
                                   "is not a row of zeros")
            phase("train_durable", check="divergence", epochs=3,
                  steps=state.step, saved=record["saved"],
                  restored=record["restored"],
                  eval_losses=[round(v, 4) for v in eval_losses],
                  k10_zero_rows=int((~got.any(1)).sum()),
                  seconds=round(time.perf_counter() - t0, 3),
                  **{f"{n}_launches": c for n, c in counts.items() if c})
            del state, history

            # --- preemption: SIGTERM as train batch PREEMPT_AT is taken ---
            held, taken = [], {"n": 0}
            real_build, real_iter = cli.build_finetune, cli.iter_batches

            def build_and_hold(args):
                held.append(real_build(args))
                return held[-1]

            def iter_with_sigterm(dataset, batch_size, shuffle=False, **kw):
                inner = real_iter(dataset, batch_size, shuffle=shuffle, **kw)
                try:
                    for b in inner:
                        if shuffle:
                            taken["n"] += 1
                            if taken["n"] == PREEMPT_AT:
                                os.kill(os.getpid(), signal.SIGTERM)
                        yield b
                finally:
                    inner.close()

            ckpt = os.path.join(root, "preempt_ckpt")
            run_dir = os.path.join(ckpt, "preempt")
            pargv = ["finetune", "preempt", "--metadata", meta, *base,
                     "--checkpoint-dir", ckpt, "--epochs", "1"]
            t0 = time.perf_counter()
            cli.build_finetune, cli.iter_batches = build_and_hold, \
                iter_with_sigterm
            reset()
            try:
                rc = cli.cmd_finetune(cli.build_parser().parse_args(pargv))
            finally:
                cli.build_finetune, cli.iter_batches = real_build, real_iter
            counts = read()
            stopped = held[0].state
            expect("preempted run", counts, durable_launches(
                "fused", "attn_kernel", layers, trained, PREEMPT_AT - 1))
            with open(os.path.join("runs", "preempt", "metrics.jsonl")) as f:
                tags = [json.loads(line)["tag"] for line in f]
            if (rc, stopped.step, latest_step(run_dir)) != (
                    0, PREEMPT_AT - 1, PREEMPT_AT - 1) \
                    or any(t.startswith("eval/") for t in tags):
                raise RuntimeError(f"preemption: exit {rc}, step "
                                   f"{stopped.step}, checkpoint "
                                   f"{latest_step(run_dir)}, tags {tags}")
            stop_s = time.perf_counter() - t0
            resumed = cli.build_finetune(cli.build_parser().parse_args(
                pargv + ["--resume"]))
            mismatched = [n for (n, a), b in zip(
                stopped.model.state_dict().items(),
                resumed.state.model.state_dict().values())
                if not torch.equal(a, b)]
            moments = 0
            want_opt = stopped.optimizer.state_dict()["state"]
            got_opt = resumed.state.optimizer.state_dict()["state"]
            for i, entry in want_opt.items():
                for key, value in entry.items():
                    moments += 1
                    if not torch.equal(value.cpu(), got_opt[i][key].cpu()):
                        mismatched.append(f"optimizer {i} {key}")
            if mismatched or resumed.state.step != stopped.step \
                    or got_opt.keys() != want_opt.keys():
                raise RuntimeError(f"--resume differs from the stopped "
                                   f"run: {mismatched[:5]}")
            del held, stopped
            reset()
            cli.train_finetune(resumed, 1, "preempt")
            counts = read()
            expect("resumed run", counts, durable_launches(
                "fused", "attn_kernel", layers, trained, steps, 1))
            if (resumed.state.step, latest_step(run_dir)) != (
                    PREEMPT_AT - 1 + steps, PREEMPT_AT - 1 + steps):
                raise RuntimeError(f"resume ended at {resumed.state.step}, "
                                   f"checkpoint {latest_step(run_dir)}")
            phase("train_durable", check="preemption",
                  stopped_at=PREEMPT_AT - 1, exit_code=rc,
                  resumed_to=resumed.state.step,
                  tensors_equal=len(start) + moments,
                  stop_seconds=round(stop_s, 3),
                  seconds=round(time.perf_counter() - t0, 3))
            del resumed
            gc.collect()
            torch.cuda.empty_cache()

            # --- async save: the write overlaps the next steps ---
            state = fresh_state()
            train_step(state, batch)
            plain_ms = []
            for _ in range(ASYNC_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(state, batch)
                torch.cuda.synchronize()
                plain_ms.append((time.perf_counter() - t0) * 1e3)
            snap = {k: v.clone() for k, v in model.state_dict().items()}
            snap_opt = {i: {k: v.clone() for k, v in entry.items()}
                        for i, entry in
                        state.optimizer.state_dict()["state"].items()}
            snap_step = state.step
            session = CheckpointSession(os.path.join(root, "async"))
            in_flight = []
            try:
                t0 = time.perf_counter()
                session.save(state)
                save_ms = (time.perf_counter() - t0) * 1e3
                async_ms = []
                for _ in range(ASYNC_STEPS):
                    t0 = time.perf_counter()
                    train_step(state, batch)
                    torch.cuda.synchronize()
                    async_ms.append((time.perf_counter() - t0) * 1e3)
                    in_flight.append(session.writing)
                t0 = time.perf_counter()
                session.wait()
                join_ms = (time.perf_counter() - t0) * 1e3
                write_ms = session.write_seconds * 1e3
                # A second save into the staging buffers the first made.
                t0 = time.perf_counter()
                session.save(state)
                resave_ms = (time.perf_counter() - t0) * 1e3
                session.wait()
                rewrite_ms = session.write_seconds * 1e3
                session.restore(state, snap_step)
            finally:
                session.close()
            bad = [k for k, v in model.state_dict().items()
                   if not torch.equal(v, snap[k])]
            for i, entry in state.optimizer.state_dict()["state"].items():
                bad += [f"optimizer {i} {k}" for k, v in entry.items()
                        if not torch.equal(v.cpu(), snap_opt[i][k].cpu())]
            if bad or state.step != snap_step:
                raise RuntimeError(f"the async checkpoint restores other "
                                   f"values: {bad[:5]}")
            if not (save_ms < write_ms and resave_ms < rewrite_ms):
                raise RuntimeError(f"the save calls took {save_ms}, "
                                   f"{resave_ms} ms, their writes "
                                   f"{write_ms}, {rewrite_ms} ms: they "
                                   "waited")
            phase("train_durable", check="async_save", step=snap_step,
                  save_call_ms=round(save_ms, 3),
                  second_save_call_ms=round(resave_ms, 3),
                  second_write_ms=round(rewrite_ms, 3),
                  steps_ms_during_write=[round(t, 3) for t in async_ms],
                  steps_ms_without=[round(t, 3) for t in plain_ms],
                  write_in_flight=in_flight, write_ms=round(write_ms, 3),
                  join_ms=round(join_ms, 3))
            del snap, snap_opt, state
            read()

            # --- profiler: a window of 4 + 10 steps ---
            state = fresh_state()
            for attempt in range(2):
                trace_dir = os.path.join(root, f"profile{attempt}")
                window = profiling.ProfilerWindow(trace_dir)
                for _ in range(window.wait + window.active + 1):
                    window.step()
                    train_step(state, batch)
                window.close()
                read()
                try:
                    rows = profiling.summarize_trace(trace_dir, top=1000)
                    break
                except profiling.NoDeviceRecords:
                    phase("train_durable", check="profiler", attempt=attempt,
                          device_records=0)
            else:
                raise RuntimeError("the profiler window kept no device "
                                   "records twice")
            tags = {"K1": ("K1Projection", "K1Attention"),
                    "K2": ("K2Projection", "K2Attention", "K2Dx")}
            by_kernel = {k: sum(ms for name, ms, _ in rows
                                if any(t in name for t in marks))
                         for k, marks in tags.items()}
            if not all(by_kernel.values()):
                raise RuntimeError(f"the window's summary names no kernel of "
                                   f"{[k for k, v in by_kernel.items() if not v]}"
                                   f": {[r[0][:60] for r in rows[:10]]}")
            phase("train_durable", check="profiler", attempt=attempt,
                  steps=window.active,
                  device_ms=round(sum(r[1] for r in rows), 3),
                  k1_ms=round(by_kernel["K1"], 3),
                  k2_ms=round(by_kernel["K2"], 3),
                  top=[(r[0][:48], round(r[1], 3)) for r in rows[:3]],
                  trace_mb=round(os.path.getsize(window.path) / 2**20, 2))
            del state

            # --- data: two metadata files without the multi-task columns
            aux = write_aux_dir(root, seed)
            frame = pd.read_csv(meta)
            dropped = [*pipeline.MT_COLUMNS, "climate_zone_idx"]
            files = []
            for i in range(2):
                path = os.path.join(root, f"bare_{i}.csv")
                frame.drop(columns=dropped).to_csv(path, index=False)
                files.append(path)
            made = []

            class RecordingDataset(pipeline.TabularImageDataset):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    made.append(self)

            dargv = ["finetune", "data", "--metadata", ",".join(files),
                     *base, "--aux-dir", aux, "--epochs", "1",
                     "--checkpoint-dir", os.path.join(root, "data_ckpt")]
            t0 = time.perf_counter()
            pipeline.TabularImageDataset = RecordingDataset
            reset()
            try:
                rc = cli.cmd_finetune(cli.build_parser().parse_args(dargv))
            finally:
                pipeline.TabularImageDataset = RecordingDataset.__base__
            counts = read()
            n_train = 2 * int((frame["selection"] == "train").sum())
            expect("two-file run", counts, durable_launches(
                "fused", "attn_kernel", layers, trained,
                n_train // TRAIN_BATCH, math.ceil(VAL_ROWS / TRAIN_BATCH)))
            with open(os.path.join("runs", "data", "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            added = set(made[0].df.columns) \
                - set(frame.drop(columns=dropped).columns)
            if rc != 0 or len(made[0]) != n_train \
                    or len(made[1]) != VAL_ROWS \
                    or not set(dropped) <= set(made[0].df.columns) \
                    or not set(dropped) <= set(made[1].df.columns) \
                    or not np.isfinite([r["value"] for r in records]).all():
                raise RuntimeError(f"two-file finetune -m: exit {rc}, rows "
                                   f"{[len(d) for d in made]}, columns "
                                   f"{sorted(made[0].df.columns)}")
            phase("train_durable", check="data", files=2, train_rows=n_train,
                  val_rows=len(made[1]), augmented=sorted(added),
                  losses=[round(r["value"], 4) for r in records
                          if r["tag"] == "train/loss"],
                  seconds=round(time.perf_counter() - t0, 3))

            # --- hierarchical: a panorama head of view attention ---
            hcfg = dataclasses.replace(head, hierarchical=True)
            model.load_state_dict(start)
            model.head = init_weights(GeocellHead(hcfg, dtype=torch.bfloat16),
                                      seed).to(run.device)
            model.head_config = hcfg
            state = TrainState(model, adamw(model.parameters(), lr))
            hstep = make_train_step(hcfg, run.geocells)
            reset()
            losses = [float(hstep(state, batch)["loss"]) for _ in range(2)]
            counts = read()
            expect("hierarchical steps", counts, durable_launches(
                "fused", "attn_kernel", layers, trained, 2))
            attn_grads = {n: p.grad for n, p in
                          model.head.view_attention.named_parameters()}
            if not np.isfinite(losses).all() or not all(
                    g is not None and torch.isfinite(g).all()
                    and g.abs().sum() > 0 for g in attn_grads.values()):
                raise RuntimeError(f"hierarchical head: losses {losses}, "
                                   f"view_attention gradients "
                                   f"{ {n: g is not None for n, g in attn_grads.items()} }")
            phase("train_durable", check="hierarchical",
                  width=model.head.cell_layer.in_features,
                  losses=[round(v, 4) for v in losses],
                  view_attention_grad_norm=round(float(torch.stack(
                      [g.float().norm() for g in attn_grads.values()])
                      .norm()), 6))
            del run, model, state, batch, start
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    phase("train_durable", check="launches",
          **{f"{n}_launches": c for n, c in total.items() if c})
    return total


#: [scale_out]: panoramas of the global batch, train / val / test rows
#: (2 steps and one eval batch an epoch at batch 8), and the seconds a
#: rank run may take.
SCALE_BATCH, SCALE_TRAIN, SCALE_VAL, SCALE_TEST = 8, 16, 8, 8
SCALE_TIMEOUT = 600
#: [scale_out]: the local head widths K1, K2 and K8 are held at (tp = 2
#: and 4 of ViT-L/14's 16 heads of 64).
LOCAL_WIDTHS = (512, 256)
#: [scale_out]: a run's loss and grad_norm at each step against the
#: one-process run's, relative: [train]'s bound on the loss parts between
#: routes (bf16 sums over other splits of the batch, in another order).
#: The global norm reads the gradients' scale, which AdamW's update does
#: not: a data axis that sums where it should average doubles it.
SCALE_METRIC_REL = 1e-2
#: [scale_out]: at most this share of the trainable entries may end two
#: AdamW steps more than lr / 10 from the one-process run's (entries
#: whose gradient is within rounding of 0 take either sign). Set between
#: the runs that agree and the planted control (DDP whose ranks skip the
#: gradient all-reduce, so that each trains on its half of the batch),
#: which must exceed it.
SCALE_SHARE_APART = 0.05


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def recorded_steps(record: dict):
    """`train_loop.make_train_step`'s steps timed (synchronised), each
    step's ms, loss and grad_norm appended to ``record``'s lists."""
    import torch

    from pigeon_tpu_torch.train import train_loop

    make = train_loop.make_train_step
    for key in ("step_ms", "loss", "grad_norm"):
        record[key] = []

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            record["step_ms"].append((time.perf_counter() - t0) * 1e3)
            record["loss"].append(float(metrics["loss"]))
            record["grad_norm"].append(float(metrics["grad_norm"]))
            return metrics

        return run

    train_loop.make_train_step = recording
    try:
        yield record
    finally:
        train_loop.make_train_step = make


def rank_run(out: str, argv: list) -> int:
    """One `torchrun` rank of [scale_out]: ``cli.run.main(argv)`` with
    each train step recorded (`recorded_steps`) and the kernels'
    launches and the peak memory written to ``OUT.<rank>.json``."""
    import torch

    from pigeon_tpu_torch.cli.run import main as cli_main
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k
    from pigeon_tpu_torch.kernels import geodesy

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    counters = {"fused_qkv_attention": k.fused_qkv_attention,
                "fused_qkv_attention_bwd": k.fused_qkv_attention_backward,
                "smooth_labels": geodesy.smooth_labels_from_points}
    for fn in counters.values():
        fn.launches = 0
    with recorded_steps({}) as record:
        rc = cli_main(argv)
    rank = torch.distributed.get_rank()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"rc": rc, **record,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "backend": str(torch.distributed.get_backend()),
                   "device": str(torch.cuda.current_device()),
                   "launches": {n: fn.launches
                                for n, fn in counters.items()}}, f)
    torch.distributed.destroy_process_group()
    return rc


def torchrun(root: str, nproc: int, argv: list, label: str) -> list:
    """``argv`` through the CLI's ``main`` in ``nproc`` ranks started by
    `torchrun` (NCCL, one card a rank), from ``root``; each rank's
    record."""
    out = os.path.join(root, f"rank_{label}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", os.path.join(HERE, "chip_smoke.py"),
           "--rank-run", out, *argv]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=SCALE_TIMEOUT,
                          env=dict(os.environ, PYTHONPATH=HERE))
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun {label} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return [json.load(open(f"{out}.{r}.json")) for r in range(nproc)]


def trainable(model) -> dict:
    """A model's trainable parameters, f32, on the CPU."""
    return {n: p.detach().float().cpu().clone()
            for n, p in model.named_parameters() if p.requires_grad}


def agreement(got: dict, want: dict, lr: float, label: str) -> dict:
    """A run against the one-process run, both after the same two steps:
    the share of the trainable entries more than lr / 10 apart and the
    largest difference (two AdamW steps move an entry by about lr each,
    so it reads about 2 lr wherever some gradient takes another sign,
    and bounds nothing), then each step's loss and grad_norm relative
    difference. ``got`` and ``want``: ``{"params": ..., "loss": [...],
    "grad_norm": [...]}``."""
    gp, wp = got["params"], want["params"]
    if gp.keys() != wp.keys():
        raise RuntimeError(f"{label}: other trainable parameters")
    out = {
        f"{label}_param_share_apart": sum(
            int(((gp[n] - wp[n]).abs() > lr / 10).sum()) for n in wp)
        / sum(t.numel() for t in wp.values()),
        f"{label}_param_max_diff": max(
            (gp[n] - wp[n]).abs().max().item() for n in wp)}
    for key in ("loss", "grad_norm"):
        if len(got[key]) != len(want[key]):
            raise RuntimeError(f"{label}: {len(got[key])} steps of {key}, "
                               f"the one-process run {len(want[key])}")
        out[f"{label}_{key}_rel_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(got[key], want[key]))
    return out


def agree(readings: dict, label: str) -> None:
    """Raise unless ``label``'s `agreement` readings are within
    `SCALE_SHARE_APART` and `SCALE_METRIC_REL`."""
    share = readings[f"{label}_param_share_apart"]
    rel = max(readings[f"{label}_loss_rel_diff"],
              readings[f"{label}_grad_norm_rel_diff"])
    if not (share <= SCALE_SHARE_APART and rel <= SCALE_METRIC_REL):
        raise RuntimeError(
            f"{label}: {share} of the parameters more than lr / 10 apart "
            f"(limit {SCALE_SHARE_APART}), loss or grad_norm {rel} apart "
            f"relative (limit {SCALE_METRIC_REL}): {readings}")


def check_local_heads(seed: int) -> dict:
    """K1, K2 and K8 at x (32, 577, 1024) with P = 512 and 256 (the local
    heads of ViT-L/14 at tp = 2 and 4) against their plain versions
    within K1's, K2's and K8's limits, each timed beside its plain version
    and its library composition; returns the records by name."""
    import torch

    from pigeon_tpu_torch.kernels import fused_qkv_attention as k
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.tuning import (
        int8_packs,
        int8_qkv_composition,
        qkv_composition,
        qkv_operands,
    )

    b, s, d = 32, 577, 1024
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    x, ws_full, bs_full = qkv_operands(gen, b, s, d, raw=False)
    packs_full = int8_packs(gen, d, (0.02,) * 3)
    act_scale = x.float().abs().max() * 1.1 / 127
    records = {}
    for p in LOCAL_WIDTHS:
        h = p // 64
        ws = [w[:p].contiguous() for w in ws_full]
        bs = [bb[:p].contiguous() for bb in bs_full]
        g = (torch.randn(b, s, p, generator=gen, device="cuda") * 0.01) \
            .bfloat16()
        # K1
        got = k.fused_qkv_attention(x, *ws, *bs, h)
        want = k.fused_qkv_attention_reference(x, *ws, *bs, h)
        rel = rel_errors([got], [want], ("out",))["out"]
        if not rel <= K1_TOL:
            raise RuntimeError(f"K1 at P={p}: {rel} > {K1_TOL}")
        flop = 3 * 2 * b * s * d * p + 2 * 2 * b * h * s * s * 64
        rec1 = {"max_abs_err": max_abs([got], [want]),
                "ms": median_ms(lambda: k.fused_qkv_attention(
                    x, *ws, *bs, h)),
                "plain_ms": median_ms(lambda: k.fused_qkv_attention_reference(
                    x, *ws, *bs, h), runs=5),
                **bound({"bf16": flop}, nbytes(x, *ws, *bs, got)),
                "library_ms": median_ms(lambda: qkv_composition(
                    x, ws, bs, h))}
        del got, want
        # K2
        got = k.fused_qkv_attention_backward(x, *ws, *bs, g, h)
        want = k.fused_qkv_attention_backward_reference(x, *ws, *bs, g, h)
        errs = rel_errors(got, want, ("dx", "dq", "dk", "dv"))
        if not max(errs.values()) <= K2_TOL:
            raise RuntimeError(f"K2 at P={p}: {errs} > {K2_TOL}")
        # As `check_backward_kernel` counts it: the projections and dx,
        # and five S x S x dh products a head.
        flop2 = 2 * 2 * b * s * d * 3 * p + 5 * 2 * b * h * s * s * 64
        rec2 = {"max_abs_err": max_abs(got, want),
                "ms": median_ms(lambda: k.fused_qkv_attention_backward(
                    x, *ws, *bs, g, h), runs=10),
                "plain_ms": median_ms(
                    lambda: k.fused_qkv_attention_backward_reference(
                        x, *ws, *bs, g, h), runs=3),
                **bound({"bf16": flop2}, nbytes(x, *ws, *bs, g, *got)),
                "library_ms": None}
        del got, want
        # K2's yardstick, timed only: `check_backward_kernel`'s
        # composition (three F.linear, SDPA's backward, the dx product).
        heads = (b, s, h, 64)
        leaves = [torch.nn.functional.linear(x, w, bb).view(heads)
                  .transpose(1, 2).detach().requires_grad_()
                  for w, bb in zip(ws, bs)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        gt = g.view(heads).transpose(1, 2)
        w_all = torch.cat(ws, 0)

        def composition():
            for w, bb in zip(ws, bs):
                torch.nn.functional.linear(x, w, bb)
            grads = torch.autograd.grad(out, leaves, gt, retain_graph=True)
            return torch.cat([t.transpose(1, 2).reshape(b, s, p)
                              for t in grads], -1) @ w_all

        rec2_composition_ms = median_ms(composition)
        del out, leaves
        # K8
        ops = [t[:p].contiguous() for pack in packs_full for t in pack]
        got = k8.fused_qkv_attention_int8(x, act_scale, *ops, h)
        want = k8.fused_qkv_attention_int8_reference(x, act_scale, *ops, h)
        rel8 = rel_errors([got], [want], ("out",))["out"]
        err8 = max_abs([got], [want])
        if not (err8 <= K8_TOL and rel8 <= K1_TOL):
            raise RuntimeError(f"K8 at P={p}: {err8} (limit {K8_TOL}), "
                               f"{rel8} of its magnitude (limit {K1_TOL})")
        int8_ops = 3 * 2 * b * s * d * p
        bf16_ops = 2 * 2 * b * h * s * s * 64
        rec8 = {"max_abs_err": err8,
                "ms": median_ms(lambda: k8.fused_qkv_attention_int8(
                    x, act_scale, *ops, h)),
                "plain_ms": median_ms(
                    lambda: k8.fused_qkv_attention_int8_reference(
                        x, act_scale, *ops, h), runs=5),
                **bound({"int8": int8_ops, "bf16": bf16_ops},
                        nbytes(x, *ops, got)),
                "library_ms": median_ms(lambda: int8_qkv_composition(
                    x, act_scale, [ops[i:i + 3] for i in (0, 3, 6)], h))}
        del got, want
        for name, rec, err, extra in (
                ("fused_qkv_attention", rec1, rel, {}),
                ("fused_qkv_attention_bwd", rec2, max(errs.values()),
                 {"composition_ms": round(rec2_composition_ms, 4)}),
                ("fused_qkv_attention_int8", rec8, rel8, {})):
            phase("scale_out", kernel=name, shape=f"({b},{s},{d})",
                  P=p, heads=h, rel_err=round(err, 6),
                  **{kk: (round(v, 4) if isinstance(v, float) else v)
                     for kk, v in rec.items()}, **extra)
            records[f"{name}@P{p}"] = rec
    return records


def rig_rank(rank: int, port: int, root: str, argv: list, out: str
             ) -> None:
    """One of the two ranks that share the card over gloo: the smoke's
    own process group (CUDA tensors through gloo), then for each case
    the port's ``build_finetune`` (`create_mesh`, `tensor_parallel`,
    DDP) and two train steps at a global batch of 8: ``ddp``, ``tp2``
    (``--tp 2``) and ``nosync``, the planted control (DDP with its
    gradient all-reduce skipped: each rank trains on its half of the
    batch); after ``tp2``, ``evaluate --quant --tp 2`` (K8 on 8 heads a
    rank). Each case's launches, step ms, loss, grad_norm and peak
    memory, and (rank 0) its trainable parameters, whole, go to files
    under ``out``."""
    import torch
    import torch.distributed as dist

    from pigeon_tpu_torch.cli.run import (
        build_finetune,
        build_parser,
        main as cli_main,
    )
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.kernels import geodesy
    from pigeon_tpu_torch.train.mesh import full_parameters
    from pigeon_tpu_torch.train.train_loop import (
        batch_to_device,
        make_train_step,
    )

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    counters = {"fused_qkv_attention": k.fused_qkv_attention,
                "fused_qkv_attention_bwd": k.fused_qkv_attention_backward,
                "smooth_labels": geodesy.smooth_labels_from_points,
                "fused_qkv_attention_int8": k8.fused_qkv_attention_int8}
    record = {}
    os.chdir(root)
    try:
        flags = {"ddp": [], "tp2": ["--tp", "2"], "nosync": []}
        for case, extra in flags.items():
            run = build_finetune(build_parser().parse_args(
                argv + ["--checkpoint-dir", f"ckpt_{case}", *extra]))
            step = make_train_step(run.cfg.head, run.geocells)
            sync = (run.state.forward.no_sync if case == "nosync"
                    else contextlib.nullcontext)
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            rec = record[case] = {"step_ms": [], "loss": [],
                                  "grad_norm": []}
            batches = run.train_batches(0)
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with sync():
                    metrics = step(run.state,
                                   batch_to_device(batch, run.device))
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["loss"].append(float(metrics["loss"]))
                rec["grad_norm"].append(float(metrics["grad_norm"]))
            batches.close()
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            rec["launches"] = {n: fn.launches for n, fn in counters.items()}
            full = full_parameters(run.state.model, run.state.mesh,
                                   trainable_only=True)
            if rank == 0:
                torch.save({n: t.float().cpu() for n, t in full.items()},
                           os.path.join(out, f"{case}.pt"))
            del run, step, full
            torch.cuda.empty_cache()
            if case == "tp2":
                for fn in counters.values():
                    fn.launches = 0
                rc = cli_main(["evaluate", "rig", *argv[2:], "-t",
                               "--quant", "--tp", "2", "--checkpoint-dir",
                               "none", "--output", f"rig_eval_{rank}.json"])
                record["evaluate_quant_tp2"] = {
                    "rc": rc, "launches": {n: fn.launches
                                           for n, fn in counters.items()}}
    finally:
        with open(os.path.join(out, f"rig.{rank}.json"), "w") as f:
            json.dump(record, f)
        dist.destroy_process_group()


def check_scale_out(seed: int) -> dict:
    """[scale_out]: the scale-out of ``finetune`` and ``evaluate`` at full
    ViT-L/14-336 width (24 layers), 2 steps at 8 panoramas. Every run is
    held against the one-process run (`agreement`): its loss and
    grad_norm at each step, and its trainable parameters after both.

    1. `torchrun` at world size 1 over NCCL, ``--fsdp`` and ``--tp 1``
       (DDP): each rank's exact K1/K2/K10 launches ([train]'s: 24 a
       forward and a backward, one K10 a batch), its DCP checkpoint read
       back in this process and by ``evaluate`` (K1 24 a batch);
    2. two ranks sharing the card over gloo on CUDA tensors (`rig_rank`):
       DDP at a global batch of 8 and ``--tp 2``, 2 steps each;
       ``evaluate --quant --tp 2`` (K8 on local heads); and the planted
       control, whose ranks skip the gradient all-reduce, which the
       checks must catch. FSDP2 over gloo on CUDA tensors is not run (it
       ends in a SIGSEGV): two-rank FSDP2 is held by the CPU tests;
    3. with 2 cards or more, (1) at 2 ranks over NCCL;
    4. K1, K2 and K8 at P = 512 and 256 (`check_local_heads`).

    Returns the launches of this process's own runs (the one-process
    finetune and the two evaluates)."""
    import gc

    import torch
    import torch.multiprocessing as mp

    from pigeon_tpu_torch.cli.run import (
        build_finetune,
        build_parser,
        main as cli_main,
        train_finetune,
    )
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.kernels import geodesy
    from pigeon_tpu_torch.train.checkpoints import latest_step, restore_model

    counters = {"fused_qkv_attention": k.fused_qkv_attention,
                "fused_qkv_attention_bwd": k.fused_qkv_attention_backward,
                "smooth_labels": geodesy.smooth_labels_from_points,
                "fused_qkv_attention_int8": k8.fused_qkv_attention_int8}
    launches = dict.fromkeys(counters, 0)
    layers, steps, evals = 24, SCALE_TRAIN // SCALE_BATCH, 1
    want_train = {"fused_qkv_attention": layers * (steps + evals),
                  "fused_qkv_attention_bwd": layers * steps,
                  "smooth_labels": steps + evals}
    fields = {}
    t_phase = time.perf_counter()
    # The card's name and power limit beside this phase's numbers, also
    # when it runs alone.
    phase("scale_out", card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace(" ", "_"))
    check_local_heads(seed)
    gc.collect()
    torch.cuda.empty_cache()
    # Seconds of each part of the phase, in order.
    parts = {"local_heads": time.perf_counter() - t_phase}

    def lap(name: str) -> None:
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            meta, cells_csv, images = write_train_assets(
                root, seed, SCALE_TRAIN, SCALE_VAL, SCALE_TEST)
            argv = ["finetune", "scale", "--panorama", "-m", "--heading",
                    "--metadata", meta, "--images", images,
                    "--geocells", cells_csv, "--batch-size",
                    str(SCALE_BATCH), "--epochs", "1", "--device", "cuda"]

            # --- the one-process run, every count from 0 ---
            for fn in counters.values():
                fn.launches = 0
            run = build_finetune(build_parser().parse_args(
                argv + ["--checkpoint-dir", "ckpt_one"]))
            lr = run.cfg.train.learning_rate
            with recorded_steps({}) as one:
                train_finetune(run, 1, "one")
            torch.cuda.synchronize()
            got = {n: fn.launches for n, fn in counters.items()}
            if {n: got[n] for n in want_train} != want_train:
                raise RuntimeError(f"one-process run launched {got}, "
                                   f"expected {want_train}")
            for n, v in got.items():
                launches[n] += v
            one["params"] = trainable(run.state.model)
            fields["one_loss"] = one["loss"]
            fields["one_grad_norm"] = one["grad_norm"]
            # The model the DCP checkpoints are read back into.
            holder = run.state.model
            del run
            gc.collect()
            torch.cuda.empty_cache()
            lap("one_process")

            # --- 1. world size 1 over NCCL, --fsdp and --tp 1 ---
            for label, extra in (("fsdp", ["--fsdp"]), ("tp1", ["--tp",
                                                               "1"])):
                ranks = torchrun(root, 1, argv + [
                    "--checkpoint-dir", f"ckpt_{label}"] + extra, label)
                for r, rec in enumerate(ranks):
                    if rec["launches"] != want_train or rec["backend"] \
                            .find("nccl") < 0:
                        raise RuntimeError(f"torchrun {label} rank {r}: "
                                           f"{rec}")
                    fields[f"nccl1_{label}_rank{r}_step_ms"] = [
                        round(t, 3) for t in rec["step_ms"]]
                    fields[f"nccl1_{label}_rank{r}_peak_gib"] = round(
                        rec["peak_gib"], 3)
                    fields[f"nccl1_{label}_rank{r}_launches"] = \
                        rec["launches"]
                ckpt = os.path.join(root, f"ckpt_{label}", "scale")
                step = latest_step(ckpt)
                if step != steps or not os.path.isdir(
                        os.path.join(ckpt, f"step_{step}")):
                    raise RuntimeError(f"{label}: no DCP checkpoint of step "
                                       f"{steps} in {ckpt}")
                # The DCP checkpoint restored in this process: its
                # parameters, and ``evaluate`` on it.
                if restore_model(ckpt, holder) != steps:
                    raise RuntimeError(f"{label}: {ckpt} restored no step "
                                       f"{steps}")
                readings = agreement(dict(ranks[0], params=trainable(
                    holder)), one, lr, f"nccl1_{label}")
                fields.update(readings)
                agree(readings, f"nccl1_{label}")
                for fn in counters.values():
                    fn.launches = 0
                rc = cli_main(["evaluate", "scale", *argv[2:], "-t",
                               "--checkpoint-dir", f"ckpt_{label}",
                               "--output", f"eval_{label}.json"])
                torch.cuda.synchronize()
                got = {n: fn.launches for n, fn in counters.items()}
                want_eval = {"fused_qkv_attention": layers,
                             "smooth_labels": 1}
                if rc != 0 or {n: got[n] for n in want_eval} != want_eval:
                    raise RuntimeError(f"evaluate on the {label} DCP "
                                       f"checkpoint: rc {rc}, {got}")
                metrics = json.load(open(f"eval_{label}.json"))["test"]
                if not all(math.isfinite(v) for v in metrics.values()):
                    raise RuntimeError(f"evaluate {label}: {metrics}")
                for n, v in got.items():
                    launches[n] += v
                lap(f"nccl1_{label}")

            # --- 2. two ranks on the one card over gloo ---
            rig = os.path.join(root, "rig")
            os.makedirs(rig)
            mp.start_processes(rig_rank, args=(free_port(), root, argv,
                                               rig),
                               nprocs=2, start_method="spawn", join=True)
            per_rank = [json.load(open(os.path.join(rig, f"rig.{r}.json")))
                        for r in range(2)]
            lap("gloo2_rig")
            fields["gloo2_fsdp"] = ("not run: FSDP2 over gloo on CUDA "
                                    "tensors SIGSEGVs; held by the CPU "
                                    "tests")
            want = {"fused_qkv_attention": layers * steps,
                    "fused_qkv_attention_bwd": layers * steps,
                    "smooth_labels": steps, "fused_qkv_attention_int8": 0}
            for case in ("ddp", "tp2", "nosync"):
                for r, rec in enumerate(per_rank):
                    if rec[case]["launches"] != want:
                        raise RuntimeError(f"rig {case} rank {r} launched "
                                           f"{rec[case]['launches']}, "
                                           f"expected {want}")
                    fields[f"gloo2_{case}_rank{r}_step_ms"] = [
                        round(t, 3) for t in rec[case]["step_ms"]]
                    fields[f"gloo2_{case}_rank{r}_peak_gib"] = round(
                        rec[case]["peak_gib"], 3)
                    fields[f"gloo2_{case}_rank{r}_launches"] = \
                        rec[case]["launches"]
                fields.update(agreement(dict(
                    per_rank[0][case], params=torch.load(
                        os.path.join(rig, f"{case}.pt"))), one, lr,
                    f"gloo2_{case}"))
            evals_q = math.ceil(SCALE_TEST / SCALE_BATCH)
            for r, rec in enumerate(per_rank):
                ev = rec["evaluate_quant_tp2"]
                if ev["rc"] != 0 or ev["launches"][
                        "fused_qkv_attention_int8"] != layers * evals_q:
                    raise RuntimeError(f"rig evaluate --quant --tp 2 rank "
                                       f"{r}: {ev}")
                fields[f"gloo2_eval_quant_tp2_rank{r}_launches"] = \
                    ev["launches"]
            # The readings first, then the checks: the planted control
            # must fail both the parameters' share and the grad_norm.
            phase("scale_out", check="agreement", lr=lr, **{
                n: v for n, v in fields.items() if "_rel_diff" in n
                or "_param_" in n or n.startswith("one_")})
            agree(fields, "gloo2_ddp")
            agree(fields, "gloo2_tp2")
            if not (fields["gloo2_nosync_param_share_apart"]
                    > SCALE_SHARE_APART
                    and fields["gloo2_nosync_grad_norm_rel_diff"]
                    > SCALE_METRIC_REL):
                raise RuntimeError(
                    "the planted control (ranks that skip the gradient "
                    "all-reduce) passes the checks: share apart "
                    f"{fields['gloo2_nosync_param_share_apart']}, "
                    "grad_norm "
                    f"{fields['gloo2_nosync_grad_norm_rel_diff']} apart")

            # --- 3. two cards or more: world size 2 over NCCL ---
            if torch.cuda.device_count() >= 2:
                ranks = torchrun(root, 2, argv + [
                    "--checkpoint-dir", "ckpt_nccl2", "--fsdp"], "nccl2")
                for r, rec in enumerate(ranks):
                    if rec["launches"] != want_train:
                        raise RuntimeError(f"nccl2 rank {r}: {rec}")
                    fields[f"nccl2_rank{r}_step_ms"] = [
                        round(t, 3) for t in rec["step_ms"]]
                    fields[f"nccl2_rank{r}_peak_gib"] = round(
                        rec["peak_gib"], 3)
                restore_model(os.path.join(root, "ckpt_nccl2", "scale"),
                              holder)
                readings = agreement(dict(ranks[0], params=trainable(
                    holder)), one, lr, "nccl2")
                fields.update(readings)
                agree(readings, "nccl2")
            else:
                fields["nccl2"] = "not run: one card"
        finally:
            os.chdir(cwd)
    fields["phase_s"] = round(time.perf_counter() - t_phase, 1)
    fields["parts_s"] = {n: round(v, 1) for n, v in parts.items()}
    phase("scale_out", layers=layers, batch_panoramas=SCALE_BATCH,
          steps=steps, lr=lr, **fields)
    return launches


def write_hf_bases(root: str, seed: int, vision) -> tuple:
    """Seeded ``--base`` files for ``embed`` at ``vision``'s width, stored
    in bf16: an HF CLIP vision tower (``vision_model.*``: a
    `ClipEmbedder`'s `reference_state`, the ``base_model.`` prefix
    stripped) and an HF `ViTModel` (a `ViTEmbedder`'s `hf_vit_state`),
    from `init_weights` of another seed than the CLI's own
    initialisation. Returns their paths."""
    import torch

    from pigeon_tpu_torch.models.embedder import ClipEmbedder
    from pigeon_tpu_torch.models.hf_import import reference_state
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.models.vit_embedder import ViTEmbedder, hf_vit_state

    prefix = "base_model."
    clip = reference_state(init_weights(ClipEmbedder(vision),
                                        BASE_SEED + seed))
    vit = hf_vit_state(init_weights(ViTEmbedder(vision), BASE_SEED + seed))
    paths = (os.path.join(root, "clip_base.pt"),
             os.path.join(root, "vit_base.pt"))
    for path, state in zip(paths, (
            {k[len(prefix):]: v for k, v in clip.items()}, vit)):
        torch.save({k: v.to(torch.bfloat16) for k, v in state.items()},
                   path)
    return paths


def row_cosines(got, want):
    """The cosine of each embedding row (the last axis) of two banks."""
    import torch

    a, b = (torch.as_tensor(x).float().cpu().reshape(-1, x.shape[-1])
            for x in (got, want))
    return torch.nn.functional.cosine_similarity(a, b, dim=-1)


def check_rows_at(kernel, reference, args, b: int, tol: float,
                  name: str) -> float:
    """``kernel`` at batch ``b`` against ``reference`` on its first and
    last 8 rows (the plain version of the whole batch would take minutes):
    max abs error over the max magnitude; raises beyond ``tol``."""
    import torch

    x, rest = args[0], args[1:]
    got = kernel(x, *rest)
    worst = 0.0
    for rows in (slice(0, 8), slice(b - 8, b)):
        want = reference(x[rows], *rest)
        worst = max(worst, rel_errors([got[rows]], [want], ("out",))["out"])
    torch.cuda.synchronize()
    if not worst <= tol:
        raise RuntimeError(f"{name} at batch {b}: max abs error over max "
                           f"magnitude {worst} (limit {tol})")
    return worst


def check_embed_shapes(seed: int) -> None:
    """K1 at the sweep's batch of `EMBED_BATCH` images and K8 at the int8
    sweep's `EMBED_BATCH_INT8`, which no other phase launches them at,
    against their plain versions on the first and last 8 rows, with their
    bounds (2e-2 of the output's magnitude; K8 also 3e-2 absolute), and
    timed. Errors and times only; the kernels' records stay at their own
    shapes."""
    import torch

    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.tuning import int8_packs, qkv_operands

    s, d, h = 577, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, ws, bs = qkv_operands(gen, EMBED_BATCH, s, d, raw=False)
    args = (x, *ws, *bs, h)
    k1_rel = check_rows_at(k1.fused_qkv_attention,
                           k1.fused_qkv_attention_reference, args,
                           EMBED_BATCH, K1_TOL, "K1")
    k1_ms = median_ms(lambda: k1.fused_qkv_attention(*args), runs=5)
    flop = 3 * 2 * EMBED_BATCH * s * d * d + 2 * 2 * EMBED_BATCH * h * s \
        * s * 64
    k1_bound = bound({"bf16": flop}, nbytes(x, *ws, *bs, x))["bound_ms"]
    del x, args
    x = qkv_operands(gen, EMBED_BATCH_INT8, s, d, raw=False)[0]
    act_scale = x.float().abs().max() * 1.1 / 127
    ops = [t for pack in int8_packs(gen, d, (0.02,) * 3) for t in pack]
    args = (x, act_scale, *ops, h)
    k8_rel = check_rows_at(k8.fused_qkv_attention_int8,
                           k8.fused_qkv_attention_int8_reference, args,
                           EMBED_BATCH_INT8, K1_TOL, "K8")
    got = k8.fused_qkv_attention_int8(*args)
    k8_err = max(max_abs([got[r]], [k8.fused_qkv_attention_int8_reference(
        x[r], *args[1:])]) for r in (slice(0, 8), slice(-8, None)))
    if not k8_err <= K8_TOL:
        raise RuntimeError(f"K8 at batch {EMBED_BATCH_INT8}: max abs error "
                           f"{k8_err} (limit {K8_TOL})")
    k8_ms = median_ms(lambda: k8.fused_qkv_attention_int8(*args), runs=10)
    phase("kernel", shapes="embed", k1_views=EMBED_BATCH,
          k1_out_err=round(k1_rel, 6), k1_ms=k1_ms,
          k1_bound_ms=round(k1_bound, 4), k8_views=EMBED_BATCH_INT8,
          k8_out_err=round(k8_rel, 6), k8_max_abs_err=k8_err, k8_ms=k8_ms)
    del x, args, got
    torch.cuda.empty_cache()


def time_sweep(model, dataset, batch: int, runs: int = EMBED_TIMED_RUNS
               ) -> tuple:
    """``(seconds of each run, peak GiB)``: `train.embed.embed_dataset` of
    ``model`` over ``dataset`` at ``batch``, decoding included, each run
    ended by a synchronise, after one warm-up."""
    import numpy as np
    import torch

    from pigeon_tpu_torch.train.embed import embed_dataset

    times = []
    for i in range(runs + 1):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = embed_dataset(model, dataset, batch, torch.device("cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if out["embeddings"].shape[0] != len(dataset) or not np.isfinite(
                out["embeddings"]).all():
            raise RuntimeError(f"sweep at batch {batch}: "
                               f"{out['embeddings'].shape}, not finite")
    return times[1:], torch.cuda.max_memory_allocated() / 2**30


def sweep_split(model, dataset, batch: int) -> dict:
    """Where a sweep's time goes: ``decode_s``, the input pipeline alone
    over ``dataset`` (decode, resize, stack on its threads); for its first
    batch, ``to_device_ms``, the copy to the card and the normalisation,
    and ``forward_ms``, the embedder's forward on the card; each
    synchronised, the median of 3 after one."""
    import torch

    from pigeon_tpu_torch.data.pipeline import iter_batches
    from pigeon_tpu_torch.train.train_loop import batch_to_device

    t0 = time.perf_counter()
    first = None
    for batch_ in iter_batches(dataset, batch):
        first = batch_["inputs"] if first is None else first
    decode_s = time.perf_counter() - t0
    device = torch.device("cuda")
    to_device = lambda: batch_to_device({"inputs": first},  # noqa: E731
                                        device)["inputs"]
    pixels = to_device()
    out = {"decode_s": decode_s}
    with torch.inference_mode():
        for name, fn in (("to_device_ms", to_device),
                         ("forward_ms", lambda: model(pixels))):
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[name] = sorted(times[1:])[1]
    return out


def time_head_step(cfg, geocells, seed: int) -> dict:
    """The head-only train step at the preset's batch (256 panoramas of
    1024-wide embeddings, synthetic) on a seeded `GeocellHead`: the
    median of `HEAD_STEPS` synchronised steps after 3, K10 at (256, 2203)
    inside each."""
    import torch

    from pigeon_tpu_torch.kernels import geodesy
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.modes import build_embedding_model
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        make_train_step,
    )

    b = cfg.train.batch_size_per_device
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = init_weights(build_embedding_model(cfg), seed).cuda()
    state = TrainState(model, adamw(model.parameters(),
                                    cfg.train.learning_rate))
    batch = {"inputs": torch.randn(b, 4, cfg.head.embed_dim, generator=gen,
                                   device="cuda"),
             "labels": torch.stack([
                 torch.rand(b, generator=gen, device="cuda") * 360 - 180,
                 torch.rand(b, generator=gen, device="cuda") * 135 - 60], -1),
             "labels_clf": torch.randint(0, len(geocells), (b,),
                                         generator=gen, device="cuda")}
    step = make_train_step(cfg.head, geocells)
    fn = geodesy.smooth_labels_from_points
    times = []
    for i in range(3 + HEAD_STEPS):
        if i == 3:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(state, batch)["loss"]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if fn.launches != HEAD_STEPS or not bool(torch.isfinite(loss)):
        raise RuntimeError(f"head step: K10 launched {fn.launches} in "
                           f"{HEAD_STEPS} steps, loss {loss}")
    times = times[3:]
    return {"batch": b, "step_ms": sorted(times)[len(times) // 2],
            "step_ms_all": [round(t, 3) for t in times]}


def check_embed(seed: int) -> dict:
    """``embed`` and ``finetune --embeddings`` through the CLI's own
    ``main`` at full width on the ``[train]`` phase's metadata (32 train
    and 8 val panoramas over the PNG fixtures, batch 8: 5 batches) and
    2203 seeded cells, each with exact launch counts (L = 24 layers;
    every other kernel of `eval_counters` none):

    * ``embed --panorama --base`` an HF CLIP file: K1 5 L; banks of
      (32, 4, 1024) and (8, 4, 1024) with their indices;
    * ``embed --quant``: K3 L in the calibration, K8 5 L;
    * ``embed --embedder vit --base`` an HF ViT file: K1 5 L (K9 never:
      exact GELU);
    * ``finetune --embeddings --panorama`` on the bf16 banks, 2 epochs:
      K10 (4 + 1) x 2, finite losses, a checkpoint;

    then, outside the counts, each bf16 bank's first batch against the
    plain route on a model the CLI builds from the same arguments (cosine
    >= 0.999 a row), the int8 rows against the bf16 ones (>= 0.99), the
    head's first-step gradients on K10 against plain smoothing (>=
    0.999); K1 and K8 at the sweep's batches; the sweep's images/s
    (bf16 at 512, int8 at 48, over `EMBED_TIMED_IMAGES` single fixture
    images, decoding included) with peak memory, and the head-only train
    step at the preset's batch. Returns each kernel's launches."""
    import contextlib
    import gc
    import math

    import numpy as np
    import pandas as pd
    import torch

    from pigeon_tpu_torch.cli import run
    from pigeon_tpu_torch.data.image_ops import normalize_images
    from pigeon_tpu_torch.data.pipeline import (
        TabularImageDataset,
        iter_batches,
    )
    from pigeon_tpu_torch.kernels import geodesy
    from pigeon_tpu_torch.models.clip import set_route
    from pigeon_tpu_torch.models.geocell_head import smoothed_targets
    from pigeon_tpu_torch.train.checkpoints import latest_step
    from pigeon_tpu_torch.train.embed import make_embed_step
    from pigeon_tpu_torch.train.train_loop import batch_loss, batch_to_device

    counters = eval_counters()
    gc.collect()
    torch.cuda.empty_cache()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)      # the head's scalars go to ./runs/NAME
        try:
            meta, cells_csv, images = write_train_assets(root, seed)
            common = ["--panorama", "--metadata", meta, "--images", images,
                      "--batch-size", str(TRAIN_BATCH), "--device", "cuda"]
            vision = run.make_config(run.build_parser().parse_args(
                ["embed"])).vision
            t0 = time.perf_counter()
            clip_base, vit_base = write_hf_bases(root, seed, vision)
            base_s = time.perf_counter() - t0
            layers = vision.num_layers
            batches = math.ceil(TRAIN_ROWS / TRAIN_BATCH) + math.ceil(
                VAL_ROWS / TRAIN_BATCH)
            sweeps = {"bf16": ["--base", clip_base],
                      "int8": ["--base", clip_base, "--quant"],
                      "vit": ["--base", vit_base, "--embedder", "vit"]}
            expects = {"bf16": {"fused_qkv_attention": layers * batches},
                       "int8": {"flash_attention": layers,
                                "fused_qkv_attention_int8":
                                    layers * batches},
                       "vit": {"fused_qkv_attention": layers * batches}}
            runs, banks = {}, {}
            for label, extra in sweeps.items():
                out = os.path.join(root, f"emb_{label}")
                argv = ["embed", "smoke_embed", *common, *extra,
                        "--output", out]
                runs[label] = run_command(argv, counters, expects[label])
                if sorted(os.listdir(out)) != [
                        "train.npy", "train_indices.npy", "val.npy",
                        "val_indices.npy"]:
                    raise RuntimeError(f"embed {label} wrote "
                                       f"{sorted(os.listdir(out))}")
                banks[label] = {s: np.load(os.path.join(out, f"{s}.npy"))
                                for s in ("train", "val")}
                for split, n in (("train", TRAIN_ROWS), ("val", VAL_ROWS)):
                    bank = banks[label][split]
                    idx = np.load(os.path.join(out, f"{split}_indices.npy"))
                    if bank.shape != (n, 4, vision.hidden_size) or \
                            bank.dtype != np.float32 or \
                            not np.isfinite(bank).all() or \
                            not np.array_equal(idx, np.arange(n)):
                        raise RuntimeError(
                            f"embed {label} {split}: {bank.shape} "
                            f"{bank.dtype}, indices {idx[:4]}...")
            int8_cos = min(row_cosines(banks["int8"][s], banks["bf16"][s])
                           .min().item() for s in ("train", "val"))
            if not int8_cos >= INT8_COSINE:
                raise RuntimeError(f"embed --quant: a row's cosine "
                                   f"{int8_cos} < {INT8_COSINE} against "
                                   "bf16")

            # --- the first batch of each bf16 bank against the plain
            # route, on a model the CLI builds from the same arguments
            cosines, models = {}, {}
            for label in ("vit", "bf16"):
                args = run.build_parser().parse_args(
                    ["embed", "smoke_embed", *common, *sweeps[label]])
                cfg = run.make_config(args)
                model = run.build_embedder(args, cfg).cuda().eval()
                with contextlib.closing(iter_batches(
                        run.embed_splits(args, cfg)["train"],
                        TRAIN_BATCH)) as it:
                    pixels = next(it)["inputs"]
                step = make_embed_step(model, torch.device("cuda"))
                set_route(model, "plain")
                plain = step(pixels)
                set_route(model, "fused")
                cosines[label] = row_cosines(
                    banks[label]["train"][:TRAIN_BATCH], plain).min().item()
                if not cosines[label] >= ROUTE_COSINE:
                    raise RuntimeError(
                        f"embed {label}: a row's cosine {cosines[label]} < "
                        f"{ROUTE_COSINE} against the plain route")
                models[label] = model
            del models["vit"], plain
            gc.collect()

            # --- head-only training on the bf16 banks
            epochs = 2
            steps = TRAIN_ROWS // TRAIN_BATCH
            evals = VAL_ROWS // TRAIN_BATCH
            head_argv = ["finetune", "smoke_head", "--panorama",
                         "--metadata", meta, "--geocells", cells_csv,
                         "--embeddings", os.path.join(root, "emb_bf16"),
                         "--batch-size", str(TRAIN_BATCH),
                         "--epochs", str(epochs),
                         "--checkpoint-dir", os.path.join(root, "head_ckpt"),
                         "--device", "cuda"]
            runs["head"] = run_command(head_argv, counters, {
                "smooth_labels": (steps + evals) * epochs})
            with open(os.path.join("runs", "smoke_head",
                                   "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            losses = [r["value"] for r in records if r["tag"] == "train/loss"]
            eval_losses = [r["value"] for r in records
                           if r["tag"] == "eval/Eval_loss"]
            ckpt = latest_step(os.path.join(root, "head_ckpt", "smoke_head"))
            if len(losses) != steps * epochs or len(eval_losses) != epochs \
                    or not np.isfinite(losses + eval_losses).all() \
                    or ckpt is None:
                raise RuntimeError(f"finetune --embeddings: losses {losses}, "
                                   f"eval {eval_losses}, checkpoint {ckpt}")
            head_run = run.build_finetune(run.build_parser().parse_args(
                head_argv))
            batch = batch_to_device(next(head_run.train_batches(0)),
                                    head_run.device)
            head = head_run.state.model

            def grads(smooth_fn):
                head.zero_grad(set_to_none=True)
                _, total, _ = batch_loss(head, batch, head_run.geocells,
                                         head_run.cfg.head, smooth_fn)
                total.backward()
                return {n: p.grad.flatten().clone()
                        for n, p in head.named_parameters()}

            kernel_g = grads(smoothed_targets)
            plain_g = grads(geodesy.smooth_labels_reference)
            head_cos = min(torch.nn.functional.cosine_similarity(
                g, plain_g[n], dim=0).item() for n, g in kernel_g.items())
            if not head_cos >= ROUTE_COSINE:
                raise RuntimeError(f"head gradients on K10: cosine {head_cos}"
                                   f" < {ROUTE_COSINE} against plain "
                                   "smoothing")
            head_cfg, geocells = head_run.cfg, head_run.geocells
            del head_run, head, batch, kernel_g, plain_g

            # --- outside the counts: K1 and K8 at the sweep's batches,
            # the sweep's images/s, the head step
            check_embed_shapes(seed)
            fixtures = sorted(os.path.basename(p) for p in glob.glob(
                os.path.join(images, "*.png")))
            timed = TabularImageDataset(
                pd.DataFrame({"image": [fixtures[i % len(fixtures)]
                                        for i in range(EMBED_TIMED_IMAGES)]}),
                images, image_size=vision.image_size)
            model = models.pop("bf16")
            sweep = {"bf16": time_sweep(model, timed, EMBED_BATCH)}
            split = {"bf16": sweep_split(model, timed, EMBED_BATCH)}
            with contextlib.closing(iter_batches(timed, 8)) as it:
                calib = next(it)["inputs"]
            model = run.quantize_model(
                model, normalize_images(torch.from_numpy(calib)),
                run.EVAL_CALIB_MARGIN, torch.device("cuda"), "8 fixtures")
            sweep["int8"] = time_sweep(model, timed, EMBED_BATCH_INT8)
            split["int8"] = sweep_split(model, timed, EMBED_BATCH_INT8)
            del model
            gc.collect()
            torch.cuda.empty_cache()
            step = time_head_step(head_cfg, geocells, seed)
        finally:
            os.chdir(cwd)
    phase("embed", base_write_s=round(base_s, 3), views=4,
          panoramas=TRAIN_ROWS + VAL_ROWS, batches=batches,
          cosine_vs_plain=cosines["bf16"], vit_cosine_vs_plain=cosines["vit"],
          int8_row_cosine_min=int8_cos, head_grad_cosine_min=head_cos,
          head_losses=[round(v, 4) for v in losses],
          head_eval_losses=[round(v, 4) for v in eval_losses],
          head_checkpoint_step=ckpt)
    total = {}
    for label, rec in runs.items():
        phase("embed", run=label,
              launches=json.dumps(rec["launches"], separators=(",", ":")),
              seconds=round(rec["seconds"], 3),
              peak_gib=round(rec["peak_gib"], 3))
        for name, count in rec["launches"].items():
            total[name] = total.get(name, 0) + count
    for label, (times, peak) in sweep.items():
        median = sorted(times)[len(times) // 2]
        phase("embed", sweep=label, batch=(EMBED_BATCH if label == "bf16"
                                           else EMBED_BATCH_INT8),
              images=EMBED_TIMED_IMAGES, seconds=round(median, 4),
              images_per_s=round(EMBED_TIMED_IMAGES / median, 2),
              seconds_all=[round(t, 4) for t in times],
              peak_gib=round(peak, 3),
              **{k: round(v, 4) for k, v in split[label].items()})
    phase("embed", head_step_batch=step["batch"],
          head_step_ms=round(step["step_ms"], 4),
          head_step_ms_all=step["step_ms_all"])
    return total


# ---------------------------------------------------------------------------
# Serving extras, pretraining and zero-shot
# ---------------------------------------------------------------------------

#: [serve_batch]: ``--serve-batch``, client threads, rounds, and the fills
#: of the largest bucket whose padded rows are timed.
SERVE_BATCH, SERVE_CLIENTS, SERVE_ROUNDS = 8, 8, 4
PAD_FILLS = (3, 5, 7)
#: [export]: requests answered by the artifact server.
ARTIFACT_REQUESTS = 5
#: [export]: the artifact's top-k probabilities against the live route's.
ARTIFACT_PROB_TOL = 2e-3
#: [landmarks]: the second (landmark) dataset's bank rows.
LANDMARK_ROWS = 4096
#: [pretrain]: the preset's micro-batch and accumulation, the micro-batches
#: run (two updates), and the retrieval probe's batches before and after.
PRETRAIN_BATCH, PRETRAIN_ACCUM, PRETRAIN_STEPS, PROBE_BATCHES = 32, 8, 16, 4
#: [zeroshot]: ViT-B/32's tokens (7 x 7 patches + CLS), width and heads.
ZS_TOKENS, ZS_WIDTH, ZS_HEADS = 50, 768, 12


def concurrent_rounds(url: str, payloads: list, clients: int,
                      rounds: int, pool) -> tuple:
    """``rounds`` rounds of ``clients`` threads, each posting one payload
    at once (a barrier a round); every answer must be 200 on a bank or
    prototype location. Returns the latencies (ms) and the wall s."""
    import numpy as np

    latencies, errors = [], []
    barrier = threading.Barrier(clients)

    def client(c):
        for r in range(rounds):
            barrier.wait()
            payload = payloads[(c + r * clients) % len(payloads)]
            t = time.perf_counter()
            try:
                status, body = post(url, payload)
                lat, lng = body["results"]["lat"], body["results"]["lng"]
                if status != 200 or not np.isclose(
                        pool, [lng, lat], atol=1e-3).all(-1).any():
                    errors.append((status, body))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
            latencies.append((time.perf_counter() - t) * 1e3)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} bad answers, first {errors[0]}")
    return latencies, wall


def serve_batch_run(root: str, pool, quant: bool) -> dict:
    """``serve --serve-batch 8`` (bf16, or ``--quant`` on a synthetic
    calibration batch): concurrent clients through the batcher, then the
    same clients on the serialised path of the same server; the attention
    kernel's launches per dispatch, each row's embedding against its
    panorama served alone, and the padded rows' cost."""
    import numpy as np
    import torch

    from pigeon_tpu_torch.kernels import attention as k3
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8

    counters = {"fused_qkv_attention": k1.fused_qkv_attention,
                "flash_attention": k3.flash_attention,
                "fused_qkv_attention_int8": k8.fused_qkv_attention_int8}
    kernel = "fused_qkv_attention_int8" if quant else "fused_qkv_attention"
    payloads = serve_payloads(5)
    for fn in counters.values():
        fn.launches = 0
    httpd, startup_s = start_serving(
        root, "--serve-batch", str(SERVE_BATCH),
        *(("--quant",) if quant else ()))
    setup = {name: fn.launches for name, fn in counters.items()}
    try:
        service = httpd.RequestHandlerClass.service
        batcher = service.batcher
        layers = len(service.serve_fn.model.vision.encoder.layers)
        # Start-up: the calibration forward (K3, int8), the batch-1
        # warm-up and one forward per bucket.
        warm = layers * (1 + len(batcher.buckets))
        want = {name: 0 for name in counters}
        want[kernel] = warm
        if quant:
            want["flash_attention"] = layers
        if setup != want:
            raise RuntimeError(f"serve --serve-batch start-up launched "
                               f"{setup}, expected {want}")
        url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict"
        post(url, payloads[0])                    # the client's opener
        batcher.fills = []
        for fn in counters.values():
            fn.launches = 0
        latencies, wall = concurrent_rounds(url, payloads, SERVE_CLIENTS,
                                            SERVE_ROUNDS, pool)
        launches = {name: fn.launches for name, fn in counters.items()}
        runs, served = batcher.batches_run, batcher.requests_served
        fills = list(batcher.fills)
        if served != SERVE_CLIENTS * SERVE_ROUNDS or not runs < served:
            raise RuntimeError(f"the batcher ran {runs} batches for "
                               f"{served} requests")
        want = {name: 0 for name in counters}
        want[kernel] = layers * runs
        if launches != want:
            raise RuntimeError(f"{runs} batched dispatches launched "
                               f"{launches}, expected {want}")

        # The same clients on the serialised path of the same model.
        service.batcher = None
        try:
            serial_lat, serial_wall = concurrent_rounds(
                url, payloads, SERVE_CLIENTS, SERVE_ROUNDS, pool)
        finally:
            service.batcher = batcher

        # Each panorama's row of one coalesced batch against it alone.
        pixels = [service.decode(p)[0] for p in payloads]
        futures = [batcher.submit(p) for p in pixels]
        rows = [f.result(120) for f in futures]
        cosines = []
        for px, row in zip(pixels, rows):
            alone = service.serve_fn(px[None])["embedding"][0].float().cpu()
            cosines.append(torch.nn.functional.cosine_similarity(
                torch.from_numpy(row["embedding"]).float().flatten(),
                alone.flatten(), dim=0).item())
        limit = INT8_COSINE if quant else ROUTE_COSINE
        if not min(cosines) >= limit:
            raise RuntimeError(f"a batched row's embedding cosine "
                               f"{min(cosines)} < {limit} against its "
                               "panorama alone")

        # The padded rows: a fill of n runs the bucket's forward; the
        # forward of the n rows alone is what padding adds to.
        batch = torch.from_numpy(np.stack(
            [pixels[i % len(pixels)] for i in range(SERVE_BATCH)])).cuda()
        forward_ms = {n: median_ms(lambda n=n: service.serve_fn(batch[:n]),
                                   runs=10)
                      for n in (*PAD_FILLS, SERVE_BATCH)}
    finally:
        batcher.close()
        httpd.shutdown()
        httpd.server_close()
    images = 4 * SERVE_CLIENTS * SERVE_ROUNDS
    label = "int8" if quant else "bf16"
    phase("serve_batch", route=label, serve_batch=SERVE_BATCH,
          buckets=list(batcher.buckets), clients=SERVE_CLIENTS,
          rounds=SERVE_ROUNDS, requests=served, batches_run=runs,
          mean_fill=round(served / runs, 3),
          fills=[n for n, _ in fills], buckets_run=[b for _, b in fills],
          kernel=kernel, launches=launches[kernel],
          launches_per_dispatch=launches[kernel] / runs,
          startup_s=round(startup_s, 3),
          calib_k3_launches=setup["flash_attention"],
          median_ms=round(sorted(latencies)[len(latencies) // 2], 3),
          max_ms=round(max(latencies), 3),
          images_per_s=round(images / wall, 2),
          serial_median_ms=round(
              sorted(serial_lat)[len(serial_lat) // 2], 3),
          serial_max_ms=round(max(serial_lat), 3),
          serial_images_per_s=round(images / serial_wall, 2),
          min_cosine_vs_alone=min(cosines), cosine_limit=limit,
          **{f"forward_ms_b{n}": round(v, 3) for n, v in forward_ms.items()},
          **{f"padded_rows_ms_fill{n}": round(forward_ms[SERVE_BATCH]
                                              - forward_ms[n], 3)
             for n in PAD_FILLS})
    out = {kernel: launches[kernel] + setup[kernel]}
    if quant:
        out["flash_attention"] = setup["flash_attention"]
    return out


def check_serve_batch(root: str, pool) -> dict:
    """[serve_batch]: `serve_batch_run` in bf16 (K1 24 a dispatch) and
    int8 (K8 24 a dispatch, K3 24 in the calibration); returns each
    kernel's launches."""
    launches = serve_batch_run(root, pool, quant=False)
    for name, n in serve_batch_run(root, pool, quant=True).items():
        launches[name] = launches.get(name, 0) + n
    return launches


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def check_export(root: str, pool) -> None:
    """[export]: ``export --platforms cuda,cpu`` (symbolic batch) in bf16
    and with ``--quant``, then ``serve --artifact`` on the card answering
    `ARTIFACT_REQUESTS` requests (no kernel launches: the artifact runs
    the plain route), its embeddings and top-k probabilities against live
    ``serve`` on the plain route (``PIGEON_ATTN_IMPL=xla``; the int8 one
    under ``PIGEON_QUANT_ATTN_IMPL=xla``) with the same weights."""
    import gc

    import numpy as np
    import torch

    from pigeon_tpu_torch.cli import run
    from pigeon_tpu_torch.serve.export import kernel_ops

    counters = eval_counters()
    payloads = serve_payloads(ARTIFACT_REQUESTS)
    refine = ["--hedge", "--metadata", os.path.join(root, "meta.csv"),
              "--prototypes", os.path.join(root, "protos.csv"),
              "--embeddings", os.path.join(root, "emb")]
    ckpt = ["--checkpoint-dir", os.path.join(root, "export_ckpt")]
    for label, quant in (("bf16", ()), ("int8", ("--quant",))):
        art = os.path.join(root, f"artifact_{label}")
        exported = run_command(
            ["export", "pigeon", "--panorama", "-m", "--heading",
             "--geocells", os.path.join(root, "cells.csv"), *ckpt,
             "--platforms", "cuda,cpu", "--device", "cuda", "--output", art,
             *quant], counters, {})
        manifest = json.load(open(os.path.join(art, "manifest.json")))
        if manifest["batch"] != "symbolic" or \
                manifest["platforms"] != ["cuda", "cpu"]:
            raise RuntimeError(f"export wrote {manifest}")
        gc.collect()
        torch.cuda.empty_cache()
        args = run.build_parser().parse_args(
            ["serve", "--artifact", art, "--port", "0", "--device", "cuda",
             *refine])
        t0 = time.perf_counter()
        httpd = run.start_artifact_server(args, block=False)
        load_s = time.perf_counter() - t0
        try:
            service = httpd.RequestHandlerClass.service
            if kernel_ops(service.serve_fn.program):
                raise RuntimeError("the artifact's program calls a kernel")
            latencies, launches = request_all(httpd, payloads, pool,
                                              counters)
            if any(launches.values()):
                raise RuntimeError(f"the artifact launched {launches}")
            pixels = [service.decode(p) for p in payloads]
            artifact = [service.serve_fn(px) for px in pixels]
        finally:
            httpd.shutdown()
            httpd.server_close()
        with environ(PIGEON_ATTN_IMPL="xla", PIGEON_QUANT_ATTN_IMPL="xla"):
            live_httpd, _ = start_serving(root, *ckpt, *quant)
        try:
            live_fn = live_httpd.RequestHandlerClass.service.serve_fn
            live = [live_fn(px) for px in pixels]
        finally:
            live_httpd.shutdown()
            live_httpd.server_close()
        cosines, prob_errs = [], []
        for a, b in zip(artifact, live):
            cosines.append(torch.nn.functional.cosine_similarity(
                a["embedding"].float().flatten(),
                b["embedding"].float().flatten(), dim=0).item())
            prob_errs.append((a["topk_probs"] - b["topk_probs"]).abs()
                             .max().item())
        if not (min(cosines) >= ROUTE_COSINE
                and max(prob_errs) <= ARTIFACT_PROB_TOL):
            raise RuntimeError(f"artifact {label} against live serve: "
                               f"cosine {min(cosines)}, top-k probability "
                               f"error {max(prob_errs)}")
        phase("export", route=label, export_s=round(exported["seconds"], 3),
              load_s=round(load_s, 3),
              artifact_mib=round(dir_bytes(art) / 2**20, 3),
              num_params=manifest["num_params"],
              requests=len(payloads), status=200, launches=0,
              median_ms=round(sorted(latencies)[len(latencies) // 2], 3),
              min_cosine_vs_live=min(cosines), cosine_limit=ROUTE_COSINE,
              max_topk_prob_err=max(prob_errs),
              prob_limit=ARTIFACT_PROB_TOL,
              torch_version=manifest["torch_version"])
        del artifact, live


def write_landmark_dataset(root: str, seed: int) -> list:
    """A second refinement dataset beside `write_assets`' (the landmark
    half of ``--landmarks``): `LANDMARK_ROWS` bank rows and 1-2
    prototypes a cell over them. Returns its bank and prototype
    locations."""
    import numpy as np

    rng = np.random.default_rng(seed + 100)
    lla = np.stack([rng.uniform(-180, 180, LANDMARK_ROWS),
                    rng.uniform(-60, 75, LANDMARK_ROWS)], -1) \
        .astype(np.float32)
    with open(os.path.join(root, "landmarks.csv"), "w") as f:
        f.write("lng,lat,selection\n")
        f.writelines(f"{lng},{lat},train\n" for lng, lat in lla.tolist())
    os.makedirs(os.path.join(root, "landmark_emb"))
    np.save(os.path.join(root, "landmark_emb", "train.npy"),
            rng.normal(size=(LANDMARK_ROWS, 1024)).astype(np.float32))
    np.save(os.path.join(root, "landmark_emb", "train_indices.npy"),
            np.arange(LANDMARK_ROWS))
    pool = [tuple(p) for p in lla.tolist()]
    with open(os.path.join(root, "landmark_protos.csv"), "w") as f:
        f.write("geocell_idx,lng,lat,count,indices\n")
        for cell in range(NUM_CELLS):
            for _ in range(rng.integers(1, 3)):
                idx = rng.choice(LANDMARK_ROWS, int(rng.integers(2, 65)),
                                 replace=False).tolist()
                lng, lat = lla[idx].mean(0).tolist()
                pool.append((lng, lat))
                f.write(f'{cell},{lng},{lat},{len(idx)},"{idx}"\n')
    return pool


def check_landmarks(root: str, pool, seed: int) -> dict:
    """[landmarks]: ``serve --landmarks --hedge`` (the PIGEOTTO preset,
    single images) with `write_assets`' dataset and a landmark one listed
    comma-separated: the bank holds both's rows, every request is a 200
    on a location of either, K1 24 a request. Returns K1's launches."""
    import numpy as np

    from pigeon_tpu_torch.cli import run
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1

    pool = np.concatenate([pool, np.array(write_landmark_dataset(root, seed),
                                          np.float32)])
    argv = ["serve", "pigeotto", "--landmarks", "--hedge",
            "--geocells", os.path.join(root, "cells.csv"),
            "--metadata", ",".join(os.path.join(root, m) for m in
                                   ("meta.csv", "landmarks.csv")),
            "--embeddings", ",".join(os.path.join(root, e) for e in
                                     ("emb", "landmark_emb")),
            "--prototypes", ",".join(os.path.join(root, p) for p in
                                     ("protos.csv", "landmark_protos.csv")),
            "--checkpoint-dir", os.path.join(root, "landmark_ckpt"),
            "--port", "0", "--device", "cuda"]
    args = run.build_parser().parse_args(argv)
    rows, bank, bank_lla = run.load_refine_assets(args)
    if len(bank) != BANK_ROWS + LANDMARK_ROWS or \
            len(bank_lla) != len(bank):
        raise RuntimeError(f"the bank has {len(bank)} rows, not "
                           f"{BANK_ROWS} + {LANDMARK_ROWS}")
    if not max(max(r["indices"]) for r in rows) >= BANK_ROWS:
        raise RuntimeError("no landmark prototype addresses its rows")
    cfg = run.make_config(args)
    if cfg.name != "pigeotto-landmarks" or cfg.head.panorama:
        raise RuntimeError(f"--landmarks built {cfg.name}")
    payloads = [{"gameID": "smoke", "roundID": i, "image": p["image"]}
                for i, p in enumerate(serve_payloads(5))]
    t0 = time.perf_counter()
    httpd = run.start_server(args, block=False)
    startup_s = time.perf_counter() - t0
    try:
        layers = len(httpd.RequestHandlerClass.service.serve_fn.model
                     .vision.encoder.layers)
        latencies, launches = request_all(
            httpd, payloads, pool,
            {"fused_qkv_attention": k1.fused_qkv_attention})
    finally:
        httpd.shutdown()
        httpd.server_close()
    if launches["fused_qkv_attention"] != layers * len(payloads):
        raise RuntimeError(f"K1 launched {launches} for {len(payloads)} "
                           "requests")
    phase("landmarks", preset=cfg.name, datasets=2,
          bank_rows=len(bank), prototypes=len(rows), requests=len(payloads),
          status=200, k1_launches=launches["fused_qkv_attention"],
          startup_s=round(startup_s, 3),
          median_ms=round(sorted(latencies)[len(latencies) // 2], 3))
    return launches


def write_pretrain_metadata(root: str, seed: int) -> str:
    """Captioned ``o``/``v``/``l`` metadata over the repo's PNG fixtures:
    enough items for `PRETRAIN_STEPS` micro-batches of `PRETRAIN_BATCH`
    (64 panorama rows of 4 items, 192 single rows, 13 landmark rows of 5
    strips: 513 items)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fixtures = [os.path.basename(p) for p in sorted(glob.glob(os.path.join(
        HERE, "data", "benchmarks", "sample20", "images", "*.png")))]
    countries = ("France", "Japan", "United States Of America", "Brazil",
                 "Philippines", "Kenya")
    rows = []
    for source, n in (("o", 64), ("v", 192), ("l", 13)):
        for _ in range(n):
            views = rng.choice(fixtures, 4)
            rows.append({
                "source": source, "image": views[0], "image_2": views[1],
                "image_3": views[2], "image_4": views[3],
                "country_name": countries[rng.integers(len(countries))],
                "geo_area": "Region" if rng.random() > 0.3 else "",
                "town": "Town" if rng.random() > 0.3 else "",
                "climate_zone": "Temperate", "driving_right": True,
                "heading": float(rng.uniform(0, 360)),
                "month": int(rng.integers(12)), "selection": "train"})
    path = os.path.join(root, "pretrain.csv")
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return path


def whole_cosine(got: dict, want: dict) -> float:
    """The cosine of two gradients, each the concatenation of its
    tensors."""
    import torch

    return torch.nn.functional.cosine_similarity(
        torch.cat([got[n] for n in sorted(got)]),
        torch.cat([want[n] for n in sorted(got)]), dim=0).item()


def pretrain_plain_grads(model, batch, dtype) -> dict:
    """The vision tower's gradients of one contrastive micro-batch on the
    plain route with compute in ``dtype``, flattened, in f32; the model
    is left on the ``fused`` route in bf16 with no gradients."""
    import torch

    from pigeon_tpu_torch.models.clip import set_route

    towers = (model, model.vision, model.text)
    set_route(model.vision, "plain")
    for m in towers:
        m.dtype = dtype
    try:
        model.zero_grad(set_to_none=True)
        model(batch["pixel_values"], batch["input_ids"],
              return_loss=True)["loss"].backward()
        return {n: p.grad.float().flatten().clone()
                for n, p in model.vision.named_parameters()}
    finally:
        model.zero_grad(set_to_none=True)
        set_route(model.vision, "fused")
        for m in towers:
            m.dtype = torch.bfloat16


def check_embed_dinov2(seed: int) -> dict:
    """``embed --model dinov2-g14-reg`` (ViT-g/14-reg4 at 518 px, seeded
    by the CLI) through the CLI's own ``main`` on the ``[train]`` phase's
    32 + 8 panoramas, batch 8 (32 views, 5 batches): each batch launches
    K1, `swiglu_bf16` and `scale_add_layer_norm_bf16` 40, 40 and 80
    times and `layer_norm_bf16` once, and nothing else of the bf16
    routes or CLIP's element-wise kernels; banks (32, 4, 1536) and (8, 4,
    1536) with their indices; the bank's first batch within cosine >=
    `ROUTE_COSINE` a row of the plain route (the eager chain and plain
    attention) on a model the CLI builds from the same arguments.
    Returns the launches of the kernels line's kernels."""
    import contextlib
    import gc
    import math

    import numpy as np
    import torch

    from pigeon_tpu_torch.cli import run
    from pigeon_tpu_torch.data.pipeline import iter_batches
    from pigeon_tpu_torch.kernels import eltwise
    from pigeon_tpu_torch.models.clip import set_route
    from pigeon_tpu_torch.train.embed import make_embed_step

    names = (*ELTWISE_KERNELS, "swiglu_bf16", "scale_add_layer_norm_bf16")
    counters = {**route_counters(),
                **{name: getattr(eltwise, name) for name in names}}
    batches = math.ceil(TRAIN_ROWS / TRAIN_BATCH) + math.ceil(
        VAL_ROWS / TRAIN_BATCH)
    per_batch = {"fused_qkv_attention": DINOV2_LAYERS,
                 "swiglu_bf16": DINOV2_LAYERS,
                 "scale_add_layer_norm_bf16": 2 * DINOV2_LAYERS,
                 "layer_norm_bf16": 1}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            meta, _, images = write_train_assets(root, seed)
            out = os.path.join(root, "emb")
            argv = ["embed", "smoke_dinov2", "--model", "dinov2-g14-reg",
                    "--panorama", "--metadata", meta, "--images", images,
                    "--batch-size", str(TRAIN_BATCH), "--device", "cuda"]
            rec = run_command([*argv, "--output", out], counters, {
                name: n * batches for name, n in per_batch.items()})
            for split, n in (("train", TRAIN_ROWS), ("val", VAL_ROWS)):
                bank = np.load(os.path.join(out, f"{split}.npy"))
                idx = np.load(os.path.join(out, f"{split}_indices.npy"))
                if bank.shape != (n, 4, DINOV2_D) or \
                        not np.isfinite(bank).all() or \
                        not np.array_equal(idx, np.arange(n)):
                    raise RuntimeError(f"embed dinov2 {split}: {bank.shape},"
                                       f" indices {idx[:4]}...")
            train = np.load(os.path.join(out, "train.npy"))[:TRAIN_BATCH]
            args = run.build_parser().parse_args(argv)
            cfg = run.make_config(args)
            model = run.build_embedder(args, cfg).cuda().eval()
            with contextlib.closing(iter_batches(
                    run.embed_splits(args, cfg)["train"], TRAIN_BATCH)) as it:
                pixels = next(it)["inputs"]
            step = make_embed_step(model, torch.device("cuda"))
            set_route(model, "plain")
            plain = step(pixels)
            cosine = row_cosines(train, plain).min().item()
            del model, step, plain
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    if not cosine >= ROUTE_COSINE:
        raise RuntimeError(f"embed dinov2: a row's cosine {cosine} < "
                           f"{ROUTE_COSINE} against the plain route")
    phase("embed_dinov2", views=4, panoramas=TRAIN_ROWS + VAL_ROWS,
          batches=batches, layers=DINOV2_LAYERS,
          launches=json.dumps(rec["launches"], separators=(",", ":")),
          seconds=round(rec["seconds"], 3),
          peak_gib=round(rec["peak_gib"], 3), cosine_vs_plain=cosine)
    return {name: n for name, n in rec["launches"].items() if name in KERNELS}


def check_pretrain(seed: int) -> dict:
    """[pretrain]: the ``pretrain`` command at full width (ViT-L/14-336
    vision, ViT-L/14 text, `HashTokenizer` at 49,408) through its own
    ``main``: `PRETRAIN_STEPS` micro-batches of the preset's 32, two
    updates of 8; K1 once a layer a forward (the steps and the probe's
    batches before and after), K2 once a layer a step; finite losses;
    the first micro-batch's vision gradient (all its tensors as one
    vector) within cosine 0.999 of the plain route's on the same batch,
    with the worst tensor's cosine and both routes' against the plain
    route in f32 printed beside it (per tensor, bf16's own error at 24
    trained layers reaches past 0.999: `scripts/
    pretrain_grad_precision.py`); a checkpoint. Returns the launches."""
    import gc
    import math

    import torch

    from pigeon_tpu_torch.cli import run
    from pigeon_tpu_torch.train import checkpoints
    from pigeon_tpu_torch.train import modes

    counters = route_counters()
    records = {"losses": [], "ms": [], "accuracy": []}
    real_step, real_acc = modes.make_pretrain_step, modes.retrieval_accuracy

    def make_step():
        step = real_step()

        def timed(state, batch):
            first = not records["ms"]
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            records["ms"].append((time.perf_counter() - t0) * 1e3)
            records["losses"].append(metrics["loss"].item())
            if first:
                # The micro-step leaves its gradients (no update yet); the
                # plain route's on the same batch, in bf16 and in f32,
                # outside the counts.
                model = state.model
                got = {n: p.grad.float().flatten().clone()
                       for n, p in model.vision.named_parameters()}
                launches = {n: fn.launches for n, fn in counters.items()}
                refs = {label: pretrain_plain_grads(model, batch, dtype)
                        for label, dtype in (("bf16", torch.bfloat16),
                                             ("f32", torch.float32))}
                if {n: fn.launches for n, fn in counters.items()} \
                        != launches:
                    raise RuntimeError("the plain route launched a kernel")
                records["cosine"] = whole_cosine(got, refs["bf16"])
                records["worst"] = worst_cosine(got, refs["bf16"])
                records["vs_f32"] = (whole_cosine(got, refs["f32"]),
                                     whole_cosine(refs["bf16"], refs["f32"]))
                del got, refs
            return metrics

        return timed

    def accuracy(probe, batches, trials=30):
        records["accuracy"].append(real_acc(probe, batches, trials))
        return records["accuracy"][-1]

    root = tempfile.mkdtemp(prefix="pretrain_")
    argv = ["pretrain", "smoke_clip", "--metadata",
            write_pretrain_metadata(root, seed), "--images",
            os.path.join(HERE, "data", "benchmarks", "sample20", "images"),
            "-a", "--epochs", "1", "--checkpoint-dir",
            os.path.join(root, "ckpt"), "--device", "cuda"]
    cfg = run.make_config(run.build_parser().parse_args(argv))
    layers = cfg.vision.num_layers
    forwards = PRETRAIN_STEPS + 2 * PROBE_BATCHES
    modes.make_pretrain_step = make_step
    modes.retrieval_accuracy = accuracy
    try:
        gc.collect()
        torch.cuda.empty_cache()
        result = run_command(argv, counters, {
            "fused_qkv_attention": layers * forwards,
            "fused_qkv_attention_bwd": layers * PRETRAIN_STEPS})
    finally:
        modes.make_pretrain_step = real_step
        modes.retrieval_accuracy = real_acc
    steps = len(records["ms"])
    if steps != PRETRAIN_STEPS:
        raise RuntimeError(f"pretrain ran {steps} micro-steps")
    if not all(math.isfinite(x) for x in records["losses"]):
        raise RuntimeError(f"pretrain losses {records['losses']}")
    cos = records["cosine"]
    if not cos >= ROUTE_COSINE:
        raise RuntimeError(f"pretrain's first vision gradient: cosine "
                           f"{cos} against the plain route's")
    ckpt = os.path.join(root, "ckpt", "smoke_clip_pretrained")
    if checkpoints.latest_step(ckpt) != PRETRAIN_STEPS:
        raise RuntimeError(f"no checkpoint of step {PRETRAIN_STEPS} in "
                           f"{ckpt}")
    updates = checkpoints.read_counters(ckpt)["updates"]
    if updates != PRETRAIN_STEPS // PRETRAIN_ACCUM:
        raise RuntimeError(f"{updates} optimizer updates")
    step_ms = sorted(records["ms"][1:])[(steps - 1) // 2]
    phase("pretrain", vision_layers=layers,
          text_layers=cfg.text.num_layers, vocab=cfg.text.vocab_size,
          batch=PRETRAIN_BATCH, accumulation=PRETRAIN_ACCUM,
          micro_steps=steps, updates=updates,
          k1_launches=result["launches"].get("fused_qkv_attention", 0),
          k2_launches=result["launches"].get("fused_qkv_attention_bwd", 0),
          first_loss=round(records["losses"][0], 5),
          last_loss=round(records["losses"][-1], 5),
          grad_cosine_vs_plain=cos,
          worst_tensor_cosine=records["worst"][0],
          worst_tensor=records["worst"][1],
          kernel_vs_f32=records["vs_f32"][0],
          plain_vs_f32=records["vs_f32"][1],
          retrieval_before=records["accuracy"][0],
          retrieval_after=records["accuracy"][-1],
          micro_step_ms=round(step_ms, 3),
          first_micro_step_ms=round(records["ms"][0], 3),
          images_per_s=round(PRETRAIN_BATCH / step_ms * 1e3, 2),
          command_s=round(result["seconds"], 3),
          peak_gib=round(result["peak_gib"], 3))
    shutil.rmtree(root, ignore_errors=True)
    return result["launches"]


def check_zeroshot_kernel(seed: int) -> None:
    """K1 at ViT-B/32's shape, (B, 50, 768) with 12 heads: one partial
    128-row tile, at ``evaluate``'s batch of 8 images and its last of 4,
    against its plain version (K1's bound and fault guard), timed beside
    the plain version and the library composition at 8."""
    import torch

    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.tuning import qkv_composition, qkv_operands

    s, d, h = ZS_TOKENS, ZS_WIDTH, ZS_HEADS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for b in (EVAL_IMAGES % EVAL_BATCH, EVAL_BATCH):
        x, ws, bs = qkv_operands(gen, b, s, d, raw=False)
        got = k1.fused_qkv_attention(x, *ws, *bs, h)
        want = k1.fused_qkv_attention_reference(x, *ws, *bs, h)
        torch.cuda.synchronize()
        rel = rel_errors([got], [want], ("out",))["out"]
        if not rel <= K1_TOL:
            raise RuntimeError(f"K1 disagrees with its plain version at "
                               f"({b}, {s}, {d}): {rel} (limit {K1_TOL})")
        check_qkv_fault_shows(k1.fused_qkv_attention_reference,
                              (x, *ws, *bs, h), want, K1_TOL)
    err = max_abs([got], [want])
    ms = median_ms(lambda: k1.fused_qkv_attention(x, *ws, *bs, h))
    plain_ms = median_ms(lambda: k1.fused_qkv_attention_reference(
        x, *ws, *bs, h))
    composition_ms = median_ms(lambda: qkv_composition(x, ws, bs, h))
    flop = 3 * 2 * b * s * d * d + 2 * 2 * b * h * s * s * (d // h)
    rec = bound({"bf16": flop}, nbytes(x, *ws, *bs, got))
    phase("kernel", name="fused_qkv_attention", shape=f"({b},{s},{d})",
          heads=h, out_err=round(rel, 6), tol=K1_TOL, max_abs_err=err,
          ms=ms, plain_ms=plain_ms, bound_ms=rec["bound_ms"],
          bound_by=rec["bound_by"], library_ms=composition_ms,
          gflop=round(flop / 1e9, 3), tflops=round(flop / 1e9 / ms, 2))


def check_zeroshot(seed: int) -> dict:
    """[zeroshot]: K1 at ViT-B/32's shape (`check_zeroshot_kernel`), then
    ``evaluate --zeroshot --model vit-b32 -b`` (a seeded bf16 HF CLIP
    B/32 state dict) on sample20 at batch 8 through the CLI's ``main``:
    K1 12 a batch, finite metrics with the suite's keys. Returns the
    launches."""
    import numpy as np
    import torch

    from pigeon_tpu_torch.cli import run
    from pigeon_tpu_torch.config import vit_b32_text, vit_b32_vision
    from pigeon_tpu_torch.models.clip import CLIPModel
    from pigeon_tpu_torch.models.hf_import import clip_hf_state
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.metrics import compute_geoguessr_metrics

    check_zeroshot_kernel(seed)
    root = tempfile.mkdtemp(prefix="zeroshot_")
    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "cells.csv"), "w") as f:
        f.write("name,lng,lat\n")
        f.writelines(f"c{i},{rng.uniform(-180, 180)},{rng.uniform(-60, 75)}\n"
                     for i in range(NUM_CELLS))
    base = os.path.join(root, "clip_b32.pt")
    model = init_weights(CLIPModel(vit_b32_vision(), vit_b32_text()),
                         BASE_SEED + seed)
    torch.save({k: v.to(torch.bfloat16)
                for k, v in clip_hf_state(model).items()}, base)
    del model
    out = os.path.join(root, "zeroshot.json")
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    layers = vit_b32_vision().num_layers
    result = run_command(
        ["evaluate", "smoke_zs", "--zeroshot", "--model", "vit-b32",
         "-b", base, "-l", EVAL_BENCHMARK, "--benchmarks",
         os.path.join(HERE, "data", "benchmarks", "benchmarks.json"),
         "--geocells", os.path.join(root, "cells.csv"),
         "--batch-size", str(EVAL_BATCH), "--device", "cuda",
         "--output", out], eval_counters(),
        {"fused_qkv_attention": layers * batches})
    metrics = json.load(open(out))[EVAL_BENCHMARK]
    n = np.zeros((1, 2))
    want_keys = [*compute_geoguessr_metrics(
        n, n, cell_preds=np.zeros(1), cell_labels=np.zeros(1),
        topk_cells=np.zeros((1, 1))), "Eval_loss"]
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or list(metrics) != want_keys:
        raise RuntimeError(f"evaluate --zeroshot: keys {list(metrics)} "
                           f"(want {want_keys}), not finite: {bad}")
    phase("zeroshot", model="vit-b32", images=EVAL_IMAGES,
          batch=EVAL_BATCH, prompts=NUM_CELLS,
          k1_launches=result["launches"].get("fused_qkv_attention", 0),
          k1_per_batch=layers, seconds=round(result["seconds"], 3),
          peak_gib=round(result["peak_gib"], 3),
          **{k: round(v, 5) for k, v in metrics.items()})
    shutil.rmtree(root, ignore_errors=True)
    return result["launches"]


#: [geocell_ladder]: training and held-out rows, sites a country (three
#: streets a site), the admin-2 grid a country (4-degree squares), and
#: the batches of ``embed`` and ``evaluate``.
LADDER_TRAIN, LADDER_HELD, LADDER_SITES, LADDER_GRID = 4096, 512, 12, 3
LADDER_EMBED_BATCH, LADDER_EVAL_BATCH = 512, 64


def write_geocell_world(root: str, seed: int) -> tuple:
    """A seeded metadata CSV of `LADDER_TRAIN` training and `LADDER_HELD`
    test rows (``image`` one of the PNG fixtures, ``lng``, ``lat``,
    ``selection``) around `LADDER_SITES` sites in each of three synthetic
    countries, three streets a site, and the countries' admin-2 squares
    as GeoJSON. Returns the metadata, the GeoJSON and the image
    directory."""
    import numpy as np

    images = os.path.join(HERE, "data", "benchmarks", "sample20", "images")
    fixtures = sorted(os.path.basename(p)
                      for p in glob.glob(os.path.join(images, "*.png")))
    rng = np.random.default_rng(seed + 2)
    feats, sites = [], []
    span = 4.0 * LADDER_GRID
    for ci, (x0, y0) in enumerate(((-100.0, 30.0), (5.0, 45.0),
                                   (120.0, -30.0))):
        for gy in range(LADDER_GRID):
            for gx in range(LADDER_GRID):
                a, b = x0 + 4.0 * gx, y0 + 4.0 * gy
                feats.append({"type": "Feature", "properties": {
                    "shapeName": f"c{ci}_{gx}_{gy}"}, "geometry": {
                        "type": "Polygon", "coordinates": [[
                            [a, b], [a + 4, b], [a + 4, b + 4],
                            [a, b + 4], [a, b]]]}})
        sites.append(np.stack([rng.uniform(x0 + 0.3, x0 + span - 0.3,
                                           LADDER_SITES),
                               rng.uniform(y0 + 0.3, y0 + span - 0.3,
                                           LADDER_SITES)], -1))
    sites = np.concatenate(sites)
    streets = (sites[:, None] + rng.normal(0, 0.4, (len(sites), 3, 2))
               ).reshape(-1, 2)
    n = LADDER_TRAIN + LADDER_HELD
    lla = streets[rng.integers(0, len(streets), n)] + rng.normal(
        0, 0.04, (n, 2))
    selection = np.array(["train"] * LADDER_TRAIN + ["test"] * LADDER_HELD)
    rng.shuffle(selection)
    meta = os.path.join(root, "ladder_meta.csv")
    with open(meta, "w") as f:
        f.write("image,lng,lat,selection\n")
        f.writelines(f"{rng.choice(fixtures)},{lng},{lat},{sel}\n"
                     for (lng, lat), sel in zip(lla.tolist(), selection))
    geojson = os.path.join(root, "admin2.geojson")
    with open(geojson, "w") as f:
        json.dump({"type": "FeatureCollection", "features": feats}, f)
    return meta, geojson, images


def stored_xi_case() -> tuple:
    """The fixed seeded OPTICS case of `tests/test_torch_geokernels.py`
    (its ``XI_CASE``, ``XI_EXPECTED`` (scikit-learn's labels, computed on
    the CPU) and ``xi_case_points``), read from the file's source."""
    import ast

    import numpy as np

    path = os.path.join(HERE, "tests", "test_torch_geokernels.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    found, scope = {}, {"np": np}
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id in (
                "XI_CASE", "XI_EXPECTED"):
            found[node.targets[0].id] = ast.literal_eval(node.value)
        elif isinstance(node, ast.FunctionDef) \
                and node.name == "xi_case_points":
            exec(compile(ast.Module([node], []), path, "exec"), scope)
    return found["XI_CASE"], found["XI_EXPECTED"], scope["xi_case_points"]


def check_ladder_outputs(meta: str, cells_csv: str, protos_csv: str
                         ) -> dict:
    """The artifacts' checks: every training row lies in the cell the
    ``prototypes`` command's assigner gives it or, lying in none, takes
    the nearest centroid's; the C++ OPTICS graph equals the numpy one on
    three cells (the largest, the median and the smallest of at least 10
    rows), euclidean at the split's first setting and
    on the prototypes' haversine matrix; the stored xi case's labels."""
    import numpy as np
    import pandas as pd

    from pigeon_tpu_torch.core.geodesy import haversine_matrix_np
    from pigeon_tpu_torch.geocell import geokernels, geometry, optics
    from pigeon_tpu_torch.geocell.assignment import CellAssigner
    from pigeon_tpu_torch.geocell.cells import OPTICS_PARAMS_STREETVIEW
    from pigeon_tpu_torch.geocell.prototypes import DEFAULT_CLUSTER_ARGS

    if not geokernels.available():
        raise RuntimeError("the C++ geo kernels did not build here")
    df = pd.read_csv(meta)
    pts = df[df["selection"] == "train"][["lng", "lat"]].to_numpy(
        np.float64)
    assigner = CellAssigner.from_csv(cells_csv)
    labels = assigner.assign(pts)
    inside = np.stack([geometry.points_in_multipolygon(pts, polys)
                       if polys else np.zeros(len(pts), bool)
                       for polys in assigner.polygons], 1)
    nearest = np.linalg.norm(pts[:, None] - assigner.centroids[None],
                             axis=-1).argmin(1)
    own = inside[np.arange(len(pts)), labels]
    fallback = ~inside.any(1) & (labels == nearest)
    if not (own | fallback).all():
        raise RuntimeError(f"{int((~(own | fallback)).sum())} training rows "
                           "neither in their cell nor at the nearest one")
    sizes = np.bincount(labels, minlength=assigner.num_cells)
    order = [c for c in np.argsort(sizes, kind="stable") if sizes[c] >= 10]
    picks = [order[-1], order[len(order) // 2], order[0]]
    graphs = []
    for cell in picks:
        cp = pts[labels == cell]
        d = haversine_matrix_np(cp, cp)
        d = np.where(d == 0, 1e-5, d)
        for x, ms, pre in ((cp, OPTICS_PARAMS_STREETVIEW[0][0], False),
                           (d, DEFAULT_CLUSTER_ARGS[0], True)):
            ms = min(ms, len(cp))
            got = geokernels.optics_graph(x, ms, precomputed=pre)
            want = optics.optics_graph_np(x, ms, precomputed=pre)
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"cell {cell}: the C++ OPTICS graph "
                                   "differs from the numpy graph")
        graphs.append(int(len(cp)))
    case, expected, points = stored_xi_case()
    xi_labels = optics.optics_xi_labels(points(**case), case["min_samples"],
                                        case["xi"]).tolist()
    if xi_labels != expected:
        raise RuntimeError("the stored xi case's labels differ: "
                           f"{xi_labels} against {expected}")
    protos = pd.read_csv(protos_csv)
    return {"rows_in_own_cell": int(own.sum()),
            "rows_nearest_fallback": int((fallback & ~own).sum()),
            "graph_cells_rows": graphs, "xi_case_points": case["n"],
            "prototypes": len(protos),
            "prototype_cells": int(protos["geocell_idx"].nunique())}


def check_geocell_ladder(seed: int) -> dict:
    """[geocell_ladder]: the artifact ladder through the CLI's own
    ``main``, entirely on this machine, on a seeded world of
    `LADDER_TRAIN` + `LADDER_HELD` rows (`write_geocell_world`):

    1. ``geocells --load`` the admin-2 GeoJSON, the PIGEON preset's 30/60
       cell sizes and StreetView OPTICS ladder (host only: no launch);
    2. ``embed`` every split at full ViT-L/14-336 width, batch 512: K1 24
       a batch;
    3. ``prototypes --geocells`` (rows labelled by the cells; host only);
    4. ``evaluate -t --prototypes --embeddings --metadata`` (refined) on
       the held-out rows at batch 64: K1 24 and K10 1 a batch;

    each command's seconds and exact launches; the cell count and size
    range, the prototype count, whether scikit-learn is importable here
    (the port does not need it), `check_ladder_outputs`, finite metrics.
    Returns the launches."""
    import importlib.util
    import math

    import pandas as pd

    from pigeon_tpu_torch.cli import run

    counters = eval_counters()
    launches = dict.fromkeys(counters, 0)
    layers = run.make_config(run.build_parser().parse_args(
        ["embed"])).vision.num_layers
    fields = {"sklearn_importable": importlib.util.find_spec("sklearn")
              is not None}
    with tempfile.TemporaryDirectory() as root:
        meta, geojson, images = write_geocell_world(root, seed)
        cells = os.path.join(root, "cells.csv")
        emb = os.path.join(root, "emb")
        protos = os.path.join(root, "protos.csv")
        out = os.path.join(root, "ladder.json")
        embed_batches = (math.ceil(LADDER_TRAIN / LADDER_EMBED_BATCH)
                         + math.ceil(LADDER_HELD / LADDER_EMBED_BATCH))
        eval_batches = math.ceil(LADDER_HELD / LADDER_EVAL_BATCH)
        steps = (
            ("geocells", ["geocells", "ladder", "--metadata", meta,
                          "--load", geojson, "--output", cells], {}),
            ("embed", ["embed", "ladder", "--metadata", meta, "--images",
                       images, "--batch-size", str(LADDER_EMBED_BATCH),
                       "--device", "cuda", "--output", emb],
             {"fused_qkv_attention": layers * embed_batches}),
            ("prototypes", ["prototypes", "ladder", "--metadata", meta,
                            "--geocells", cells, "--output", protos], {}),
            ("evaluate", ["evaluate", "ladder", "-t", "--metadata", meta,
                          "--images", images, "--geocells", cells,
                          "--prototypes", protos, "--embeddings", emb,
                          "--batch-size", str(LADDER_EVAL_BATCH),
                          "--device", "cuda", "--output", out],
             {"fused_qkv_attention": layers * eval_batches,
              "smooth_labels": eval_batches}))
        for label, argv, expect in steps:
            result = run_command(argv, counters, expect)
            fields[f"{label}_s"] = round(result["seconds"], 3)
            for name, n in result["launches"].items():
                launches[name] += n
            if label == "embed":
                fields["embed_peak_gib"] = round(result["peak_gib"], 3)
        table = pd.read_csv(cells)
        fields.update(cells=len(table), cell_size_min=int(table["size"].min()),
                      cell_size_max=int(table["size"].max()),
                      cell_rows=int(table["size"].sum()))
        if fields["cell_rows"] != LADDER_TRAIN:
            raise RuntimeError(f"the cells hold {fields['cell_rows']} rows, "
                               f"not the {LADDER_TRAIN} training rows")
        fields.update(check_ladder_outputs(meta, cells, protos))
        metrics = json.load(open(out))["test"]
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        if bad or not metrics:
            raise RuntimeError(f"evaluate: not finite: {bad} of {metrics}")
        fields.update({k: round(v, 5) for k, v in metrics.items()
                       if k in ("Median_km_error", "Geoguessr_score",
                                "Eval_loss")})
    phase("geocell_ladder", train_rows=LADDER_TRAIN,
          held_rows=LADDER_HELD, launches={
              n: v for n, v in launches.items() if v}, **fields)
    return launches


#: [pipeline]: stages, microbatches, and the global batch of images
#: (ViT-L/14-336, 12 layers a stage).
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_BATCH, PIPE_STEPS = 2, 4, 16, 2
#: [pipeline]: the pipelined tower's output against one process's, of
#: its magnitude (bf16; K1's bound), and the train steps' loss and
#: grad_norm, relative ([scale_out]'s gloo rig's).
PIPE_TOWER_REL, PIPE_METRIC_REL = 2e-2, 5e-3
#: [pipeline]: AdamW's first update is lr x sign(g) where |g| >> eps, so
#: it carries bf16 rounding noise of near-zero gradients into step 2 in
#: proportion to lr: on an H100 80GB HBM3 (700 W) one process's own
#: step-2 grad_norm ranged 8.3e-3 over five runs at 1e-5, 1.6e-3 at this
#: rate (the loss still falls by a tenth), below `PIPE_METRIC_REL`.
PIPE_LR = 1e-6


def pipe_model():
    """The [pipeline] model: the PIGEON preset's tower at full width and
    a geocell head of `NUM_CELLS` cells on single images (bf16 compute,
    f32 parameters, the ``fused`` route: K1, K2 behind it, K10 in the
    loss)."""
    import dataclasses

    import torch

    from pigeon_tpu_torch.config import pigeon_config
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr

    cfg = pigeon_config(NUM_CELLS)
    cfg = cfg.replace(head=dataclasses.replace(
        cfg.head, panorama=False, multi_task=False, heading=False))
    return cfg, SuperGuessr(cfg.vision, cfg.head, dtype=torch.bfloat16)


def pipe_batch(seed: int, cfg) -> dict:
    """A seeded batch of `PIPE_BATCH` CLIP-normalised images and labels,
    and the cells."""
    import numpy as np

    rng = np.random.default_rng(seed + 3)
    size = cfg.vision.image_size
    return ({"inputs": rng.normal(size=(PIPE_BATCH, size, size, 3)).astype(
                np.float32),
             "labels": np.stack([rng.uniform(-180, 180, PIPE_BATCH),
                                 rng.uniform(-60, 75, PIPE_BATCH)],
                                -1).astype(np.float32)},
            np.stack([rng.uniform(-180, 180, NUM_CELLS),
                      rng.uniform(-60, 75, NUM_CELLS)],
                     -1).astype(np.float32))


def pipe_counters() -> dict:
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k
    from pigeon_tpu_torch.kernels import geodesy

    return {"fused_qkv_attention": k.fused_qkv_attention,
            "fused_qkv_attention_bwd": k.fused_qkv_attention_backward,
            "smooth_labels": geodesy.smooth_labels_from_points}


def pipeline_rank(rank: int, port: int, state_path: str, seed: int,
                  out: str) -> None:
    """One stage of [pipeline]: two ranks share the card over gloo
    (activations and gradients through pinned host copies). The model
    from ``state_path``, this stage's 12 layers; the pipelined tower's
    output under no_grad, then `PIPE_STEPS` pipelined train steps; each
    part's launches, ms, the metrics and the peak memory to
    ``out/pipe.<rank>.json``, the tower's output (rank 0) to
    ``out/pipe_tower.pt``. A failure is written there too and raised."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from pigeon_tpu_torch.train.pipeline import (
        create_pipeline_mesh,
        create_pipeline_train_state,
        make_pipeline_train_step,
        pipeline_vision_forward,
    )
    from pigeon_tpu_torch.train.train_loop import adamw, batch_to_device

    torch.cuda.set_device(0)
    # A peer that fails ends this rank's waits too, within the phase.
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=PIPE_STAGES,
                            timeout=datetime.timedelta(seconds=300))
    record = {}
    try:
        counters = pipe_counters()
        cfg, model = pipe_model()
        model.load_state_dict(torch.load(state_path, mmap=True), strict=True)
        model.cuda()
        mesh = create_pipeline_mesh(PIPE_STAGES, device_type="cuda")
        state = create_pipeline_train_state(
            model, lambda p: adamw(p, PIPE_LR), mesh, "cuda")
        record["layers"] = sorted(int(i) for i in
                                  model.vision.encoder.layers.keys())
        batch, cells = pipe_batch(seed, cfg)
        device_batch = batch_to_device(batch, "cuda")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            hidden, pooled = pipeline_vision_forward(
                model.vision, device_batch["inputs"], mesh,
                PIPE_MICROBATCHES)
        torch.cuda.synchronize()
        record["tower_ms"] = (time.perf_counter() - t0) * 1e3
        record["tower_launches"] = {n: fn.launches
                                    for n, fn in counters.items()}
        if rank == 0:
            torch.save({"hidden": hidden.float().cpu(),
                        "pooled": pooled.float().cpu()},
                       os.path.join(out, "pipe_tower.pt"))
        del hidden, pooled
        step = make_pipeline_train_step(
            cfg.head, torch.from_numpy(cells).cuda(), PIPE_MICROBATCHES)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        record.update(step_ms=[], loss=[], grad_norm=[])
        for _ in range(PIPE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, device_batch)
            torch.cuda.synchronize()
            record["step_ms"].append((time.perf_counter() - t0) * 1e3)
            record["loss"].append(float(metrics["loss"]))
            record["grad_norm"].append(float(metrics["grad_norm"]))
        record["train_launches"] = {n: fn.launches
                                    for n, fn in counters.items()}
        record["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    except BaseException:
        record["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out, f"pipe.{rank}.json"), "w") as f:
            json.dump(record, f)
        dist.destroy_process_group()


def check_pipeline(seed: int) -> dict:
    """[pipeline]: the GPipe schedule (`train/pipeline.py`) at pp =
    `PIPE_STAGES`, M = `PIPE_MICROBATCHES` over two gloo ranks sharing
    the card (`pipeline_rank`), ViT-L/14-336 at full width (12 layers a
    stage), held against one process on the same seeded weights and
    batch: the tower's output (last hidden and pooled, within
    `PIPE_TOWER_REL` of each one's magnitude) and `PIPE_STEPS` train
    steps of the whole model (loss and grad_norm within
    `PIPE_METRIC_REL`); each rank's K1 and K2 launches exactly as
    predicted (12 layers x M microbatches a forward or a backward; K10
    once a step on each stage, which runs the loss on the broadcast
    output). Returns this process's launches (the one-process runs)."""
    import gc

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.mesh import Mesh
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        batch_to_device,
        make_train_step,
    )

    t_phase = time.perf_counter()
    counters = pipe_counters()
    launches = dict.fromkeys(counters, 0)
    cfg, model = pipe_model()
    layers = cfg.vision.num_layers
    per_stage = layers // PIPE_STAGES
    init_weights(model, BASE_SEED + seed)
    batch, cells = pipe_batch(seed, cfg)
    fields = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace(" ", "_")}
    with tempfile.TemporaryDirectory() as root:
        state_path = os.path.join(root, "state.pt")
        torch.save(model.state_dict(), state_path)
        # --- one process: the tower, then the train steps ---
        model.cuda()
        device_batch = batch_to_device(batch, "cuda")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            want_h, want_p = model.vision(device_batch["inputs"])
        torch.cuda.synchronize()
        fields["one_tower_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        want_h, want_p = want_h.float().cpu(), want_p.float().cpu()
        ref = TrainState(model, adamw(model.parameters(), PIPE_LR),
                         mesh=Mesh())
        step = make_train_step(cfg.head, torch.from_numpy(cells).cuda())
        one = {"loss": [], "grad_norm": [], "step_ms": []}
        for _ in range(PIPE_STEPS):
            t0 = time.perf_counter()
            metrics = step(ref, device_batch)
            one["loss"].append(float(metrics["loss"]))
            one["grad_norm"].append(float(metrics["grad_norm"]))
            torch.cuda.synchronize()
            one["step_ms"].append(round((time.perf_counter() - t0) * 1e3, 3))
        torch.cuda.synchronize()
        got = {n: fn.launches for n, fn in counters.items()}
        want_one = {"fused_qkv_attention": layers * (1 + PIPE_STEPS),
                    "fused_qkv_attention_bwd": layers * PIPE_STEPS,
                    "smooth_labels": PIPE_STEPS}
        if got != want_one:
            raise RuntimeError(f"one process launched {got}, expected "
                               f"{want_one}")
        for n, v in got.items():
            launches[n] += v
        del ref, step, model, device_batch
        gc.collect()
        torch.cuda.empty_cache()
        fields["one_process_s"] = round(time.perf_counter() - t_phase, 1)

        # --- two ranks, one stage each ---
        t0 = time.perf_counter()
        mp.start_processes(pipeline_rank, args=(free_port(), state_path,
                                                seed, root),
                           nprocs=PIPE_STAGES, start_method="spawn",
                           join=True)
        fields["ranks_s"] = round(time.perf_counter() - t0, 1)
        ranks = [json.load(open(os.path.join(root, f"pipe.{r}.json")))
                 for r in range(PIPE_STAGES)]
        tower = torch.load(os.path.join(root, "pipe_tower.pt"))
    errors = {}
    for name, got_t, want_t in (("hidden", tower["hidden"], want_h),
                                ("pooled", tower["pooled"], want_p)):
        errors[name] = float((got_t - want_t).abs().max()
                             / want_t.abs().max())
    want_tower = {"fused_qkv_attention": per_stage * PIPE_MICROBATCHES,
                  "fused_qkv_attention_bwd": 0, "smooth_labels": 0}
    want_train = {"fused_qkv_attention":
                  per_stage * PIPE_MICROBATCHES * PIPE_STEPS,
                  "fused_qkv_attention_bwd":
                  per_stage * PIPE_MICROBATCHES * PIPE_STEPS,
                  "smooth_labels": PIPE_STEPS}
    for r, rec in enumerate(ranks):
        want_layers = list(range(r * per_stage, (r + 1) * per_stage))
        if rec.get("layers") != want_layers:
            raise RuntimeError(f"pipeline rank {r} holds layers "
                               f"{rec.get('layers')}")
        if rec["tower_launches"] != want_tower or \
                rec["train_launches"] != want_train:
            raise RuntimeError(
                f"pipeline rank {r} launched {rec['tower_launches']} in "
                f"the tower and {rec['train_launches']} in the steps, "
                f"expected {want_tower} and {want_train}")
        for key in ("loss", "grad_norm"):
            fields[f"rank{r}_{key}_rel_diff"] = [
                abs(g - w) / abs(w) for g, w in zip(rec[key], one[key])]
        fields[f"rank{r}_tower_ms"] = round(rec["tower_ms"], 3)
        fields[f"rank{r}_step_ms"] = [round(t, 3) for t in rec["step_ms"]]
        fields[f"rank{r}_peak_gib"] = round(rec["peak_gib"], 3)
        fields[f"rank{r}_launches"] = {
            n: rec["tower_launches"][n] + rec["train_launches"][n]
            for n in counters}
    fields["one_loss"] = one["loss"]
    fields["one_grad_norm"] = one["grad_norm"]
    fields["one_step_ms"] = one["step_ms"]
    fields["tower_rel_err"] = errors
    fields["phase_s"] = round(time.perf_counter() - t_phase, 1)
    phase("pipeline", stages=PIPE_STAGES, microbatches=PIPE_MICROBATCHES,
          batch=PIPE_BATCH, layers=layers, steps=PIPE_STEPS, **fields)
    if max(errors.values()) > PIPE_TOWER_REL:
        raise RuntimeError(f"the pipelined tower is {errors} of its "
                           f"magnitude from one process's")
    worst = max(v for k, vs in fields.items() if k.endswith("_rel_diff")
                for v in vs)
    if not worst <= PIPE_METRIC_REL:
        raise RuntimeError(f"a pipelined step's loss or grad_norm is {worst} "
                           "from one process's")
    if not all(np.isfinite(ranks[0]["loss"])):
        raise RuntimeError(f"pipelined losses {ranks[0]['loss']}")
    return launches


def variant_counters() -> dict:
    """The launch counters of every kernel the tuning drivers run."""
    from pigeon_tpu_torch.kernels import attention_bwd_variants as bv
    from pigeon_tpu_torch.kernels import attention_fwd_variants as fv

    return {**route_counters(),
            "bwd_r_from_o": bv.bwd_r_from_o,
            "attention_dq": bv.attention_dq,
            "attention_dkv": bv.attention_dkv,
            "bwd_dots_only": bv.bwd_dots_only,
            "bwd_vpu_only": bv.bwd_vpu_only,
            "fwd_dots_only": fv.fwd_dots_only,
            "fwd_softmax_only": fv.fwd_softmax_only,
            "fwd_qk_only": fv.fwd_qk_only,
            "fwd_qk_chunked": fv.fwd_qk_chunked,
            "flash_attention_online_c256": fv.flash_attention_online_c256}


def load_driver(name: str):
    """The tuning driver ``scripts/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_variants() -> tuple:
    """[variants]: the path of the tuning drivers (`DRIVERS`), each
    driver's ``run`` at the TPU scripts' flagship shape (32 views, S = 577,
    16 heads of 64; x (32, 577, 1024) for the QKV driver). ``run`` checks
    every variant against its plain version before timing it and raises
    on a disagreement: exact forwards within 3e-2 absolute, exact
    backwards within 2e-2 of each output's max magnitude, diagnostics
    within 2e-2 of each output's max magnitude. Returns the launches of
    the tuning kernels V1-V10 on this path (counted from 0 just before
    it) and their records for the kernels line: times, errors and plain
    times from the drivers' runs, bounds from `VARIANT_WORK` at the
    drivers' shape, ``library_ms`` the yardstick of `VARIANT_LIBRARY`."""
    import gc

    import torch

    from pigeon_tpu_torch import tuning

    counters = variant_counters()
    for fn in counters.values():
        fn.launches = 0
    records = []
    for name in DRIVERS:
        t0 = time.perf_counter()
        driver = load_driver(name)
        for rec in driver.run(tuning.BATCH, VARIANT_ITERS, VARIANT_WINDOWS):
            records.append(rec)
            if "yardstick" in rec:
                phase("variants", driver=name, yardstick=rec["yardstick"],
                      ms=rec["ms_per_call"],
                      **{key: rec[key] for key in ("max_err_vs_plain",)
                         if key in rec})
                continue
            if "check" in rec:
                phase("variants", driver=name, **rec)
                continue
            phase("variants", driver=name, variant=rec["variant"],
                  ms=rec["ms_per_call"], plain_ms=rec["plain_ms"],
                  err=rec["max_err_vs_plain"], tol=rec["tol"],
                  relative=rec["relative"],
                  **{key: rec[key] for key in ("max_err_vs_xla",
                                               "max_err_vs_base")
                     if key in rec})
        phase("variants", driver=name,
              seconds=round(time.perf_counter() - t0, 3))
        gc.collect()
        torch.cuda.empty_cache()
    launches = {name: fn.launches for name, fn in counters.items()}
    phase("variants", launches=json.dumps(launches, separators=(",", ":")))
    by_name = {r["variant"]: r["ms_per_call"] for r in records
               if "variant" in r}
    for name, beside in VARIANT_PAIRS:
        phase("variants", variant=name, ms=by_name[name], beside=beside,
              beside_ms=by_name[beside])
    backward_stages()
    forward_stages()
    yardsticks = {r["yardstick"]: r["ms_per_call"] for r in records
                  if "yardstick" in r}
    out, counts = {}, {}
    b, s, h, dh = tuning.BATCH, tuning.SEQ, tuning.HEADS, tuning.HEAD_DIM
    for name, (products, f32_ops, tensors, rows) in VARIANT_WORK.items():
        part = next(k for r in records for k in r.get("kernels", ())
                    if k["kernel"] == name)
        elems = b * h * s * s
        ops = {"bf16": products * 2 * elems * dh}
        if f32_ops:
            ops["f32"] = f32_ops * elems
        out[name] = {"max_abs_err": part["max_abs_err"], "ms": part["ms"],
                     "plain_ms": part["plain_ms"],
                     **bound(ops, tensors * b * s * h * dh * 2
                             + rows * b * h * s * 4),
                     "library_ms": yardsticks.get(VARIANT_LIBRARY.get(name))}
        counts[name] = launches[name]
    return counts, out


def device_stages(fns, operands, passes, tags, base, diffs,
                  bare=None) -> dict:
    """[variants]: each wrapper's device ms by pass on ``operands``, each
    pass (``passes``: label, kernel name) found by its kernel's name and
    the wrapper's tag (``tags``: wrapper, tag, the passes it launches);
    raises if a pass a tag lists takes no time, or one it does not list
    takes some. Beside them the host ms a call takes to enqueue its work
    (calls without a synchronise: below the device ms, the wrapper is
    device-bound), and the wrapper ms beside the bare C call's where
    ``bare`` has one. Returns ``base``'s device ms of each pass minus each
    diagnostic's (``diffs``: pass, wrapper), keyed ``pass-wrapper``."""
    import torch

    by_pass = {}
    for name, tag, launched in tags:
        fn = functools.partial(fns[name], *operands)
        ms = by_pass[name] = device_ms_by_mark(
            fn, [(label, (mark, tag)) for label, mark in passes],
            expect=launched)
        idle = [label for label in launched if ms[label] <= 0]
        stray = [label for label, _ in passes
                 if label not in launched and ms[label] > 0]
        if idle or stray:
            raise RuntimeError(f"{name}: no device time in {idle}, or time "
                               f"in passes it does not launch {stray}, "
                               f"under {tag}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        times = {"enqueue_ms": round((time.perf_counter() - t0) / 20 * 1e3,
                                    4)}
        torch.cuda.synchronize()
        if bare and name in bare:
            times.update(wrapper_ms=round(median_ms(fn), 4),
                         bare_ms=round(median_ms(bare[name]), 4))
        phase("variants", kernel=name, tag=tag,
              **{f"{label}_device_ms": round(ms[label], 4)
                 for label in (*launched, "other")}, **times)
    return {f"{label}-{name}": round(by_pass[base][label]
                                     - by_pass[name][label], 4)
            for label, name in diffs}


def backward_stages() -> None:
    """[variants]: V1's-V5's and K4's device ms by pass (`BWD_PASSES`,
    `BWD_TAGS`) at the drivers' shape, V2's and V3's wrapper ms beside the
    bare C call's on workspaces allocated once (`device_stages`); then
    K4's passes minus V4's and V5's (`BWD_DIFFS`). Runs after [variants]
    has read its launch counts."""
    import torch

    from pigeon_tpu_torch import tuning
    from pigeon_tpu_torch.kernels import attention as k34
    from pigeon_tpu_torch.kernels import attention_bwd_variants as bv

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (tuning.BATCH, tuning.SEQ, tuning.HEADS, tuning.HEAD_DIM)
    q, k, v, g = tuning.normal(gen, 4, shape)
    fns = {"bwd_r_from_o": bv.bwd_r_from_o,
           "attention_dq": bv.attention_dq,
           "attention_dkv": bv.attention_dkv,
           "bwd_dots_only": bv.bwd_dots_only,
           "bwd_vpu_only": bv.bwd_vpu_only,
           "flash_attention_bwd": k34.flash_attention_backward}
    lib = bv.load()
    stream = torch.cuda.current_stream().cuda_stream
    stats, g_n = bv._stats_workspaces(q)
    outs = [torch.empty_like(q) for _ in range(2)]
    bare = {"attention_dq": lambda: lib.pigeon_attention_dq(
                *(t.data_ptr() for t in (q, k, v, g, outs[0], stats, g_n)),
                *shape[:3], stream),
            "attention_dkv": lambda: lib.pigeon_attention_dkv(
                *(t.data_ptr() for t in (q, k, v, g, *outs, stats, g_n)),
                *shape[:3], stream)}
    diffs = device_stages(fns, (q, k, v, g), BWD_PASSES, BWD_TAGS,
                          "flash_attention_bwd", BWD_DIFFS, bare)
    phase("variants", k4_minus_diagnostic_device_ms=json.dumps(
        diffs, separators=(",", ":")))
    del q, k, v, g, stats, g_n, outs
    torch.cuda.empty_cache()


def forward_stages() -> None:
    """[variants]: the device ms of K3's streaming forward under each
    wrapper's tag (`FWD_PASSES`, `FWD_TAGS`) at the drivers' shape, K3
    under its monolithic body (`device_stages`); then K3's minus V6's-V9's
    (`FWD_DIFFS`), and V7's and V6's minus V9's (`FWD_WALK_DIFFS`). Runs
    after [variants] has read its launch counts."""
    from unittest import mock

    import torch

    from pigeon_tpu_torch import tuning
    from pigeon_tpu_torch.kernels import attention as k34
    from pigeon_tpu_torch.kernels import attention_fwd_variants as fv

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = tuning.normal(gen, 3, (tuning.BATCH, tuning.SEQ, tuning.HEADS,
                                     tuning.HEAD_DIM))
    fns = {"flash_attention": k34.flash_attention,
           "fwd_dots_only": fv.fwd_dots_only,
           "fwd_softmax_only": fv.fwd_softmax_only,
           "fwd_qk_only": fv.fwd_qk_only,
           "fwd_qk_chunked": fv.fwd_qk_chunked,
           "flash_attention_online_c256": fv.flash_attention_online_c256}
    with mock.patch.dict(os.environ, {"PIGEON_FLASH_FWD": "monolithic"}):
        diffs = device_stages(fns, (q, k, v), FWD_PASSES, FWD_TAGS,
                              "flash_attention", FWD_DIFFS)
    phase("variants", k3_minus_diagnostic_device_ms=json.dumps(
        diffs, separators=(",", ":")))
    # (K3 - b) - (K3 - a) = a - b, from the same profiles.
    walk = {f"{a}-{b}": round(diffs[f"forward-{b}"] - diffs[f"forward-{a}"],
                              4)
            for a, b in FWD_WALK_DIFFS}
    phase("variants", diagnostic_minus_walk_device_ms=json.dumps(
        walk, separators=(",", ":")))
    del q, k, v
    torch.cuda.empty_cache()


def sass_by_function(sass) -> dict:
    """[sass]: each kernel of the tags in `SASS_TAGS` in the lines of a
    `cuobjdump -sass` listing, with its HGMMA and MUFU.EX2 counts; raises
    if a kernel of a tag in `SASS_EXPS` has no MUFU.EX2, or one in
    `SASS_NO_EXPS` has any. Returns ``{tag: [(hgmma, ex2), ...]}``."""
    counts, name = {}, None
    for line in sass:
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = [0, 0]
        elif name:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "MUFU.EX2" in line
    by_tag = {}
    for name, (hgmma, ex2) in counts.items():
        tag = next((tag for tag in SASS_TAGS if tag in name), None)
        if tag is None:
            continue
        phase("sass", function=name, hgmma=hgmma, mufu_ex2=ex2)
        by_tag.setdefault(tag, []).append((hgmma, ex2))
        if tag in SASS_EXPS and not ex2:
            raise RuntimeError(f"{name}: no MUFU.EX2 in its SASS")
        if tag in SASS_NO_EXPS and ex2:
            raise RuntimeError(f"{name}: {ex2} MUFU.EX2 in its SASS")
    return by_tag


def check_smoothing_build(built, cuobjdump: str) -> None:
    """[ptxas]/[sass]: each K10 instance's registers and spilled bytes
    from nvcc's log (`native.build_shared` keeps it beside a reused
    library); the instances the main path's shape and the check shape
    launch (`geodesy.launch_plan` on this card) must spill nothing, and
    fail if the log lacks them. K10's SASS must hold no atomic (its row
    minimum goes through distributed shared memory)."""
    import re

    import torch

    from pigeon_tpu_torch.kernels import geodesy

    stats, rows = {}, None
    for line in built.log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"smooth_labels_kernelILi(\d+)E", line)
            rows = int(found[1]) if found else None
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if rows and spill:
            stats.setdefault(rows, {})["spill_bytes"] = (
                int(spill[1]) + int(spill[2]))
        if rows and regs:
            stats.setdefault(rows, {})["registers"] = int(regs[1])
    for rows, found in sorted(stats.items()):
        phase("ptxas", kernel="smooth_labels", rows=rows, **found)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, c in K10_TIMED:
        plan = geodesy.launch_plan(b, c, sms)
        found = stats.get(plan.rows, {})
        if found.get("spill_bytes") != 0:
            raise RuntimeError(f"K10's instance of {plan.rows} rows for "
                               f"({b}, {c}) spills or is missing from "
                               f"nvcc's log: {found}")
        phase("ptxas", kernel="smooth_labels", shape=f"({b},{c})",
              rows=plan.rows, threads=plan.threads,
              spill_bytes=found["spill_bytes"])
    sass = subprocess.run([cuobjdump, "-sass", built.path],
                          capture_output=True, text=True,
                          check=True).stdout
    atomics = len(re.findall(r"\b(?:ATOM[GS]?|REDG?|REDAS)\.", sass))
    if atomics:
        raise RuntimeError(f"K10's SASS holds {atomics} atomics")
    phase("sass", kernel="smooth_labels", atomics=atomics,
          cluster_barriers=sass.count("UCGABAR"))


def build_kernels() -> None:
    """Build every kernel's source at once (one nvcc for each) and load
    them."""
    from concurrent.futures import ThreadPoolExecutor

    from pigeon_tpu_torch import native
    from pigeon_tpu_torch.data import native_decode
    from pigeon_tpu_torch.geocell import geokernels
    from pigeon_tpu_torch.kernels import attention as k3
    from pigeon_tpu_torch.kernels import attention_bwd_variants as bv
    from pigeon_tpu_torch.kernels import attention_fwd_variants as fv
    from pigeon_tpu_torch.kernels import fused_block_attention as k6
    from pigeon_tpu_torch.kernels import fused_block_attention_int8 as k7
    from pigeon_tpu_torch.kernels import fused_ln_qkv_attention as k5
    from pigeon_tpu_torch.kernels import fused_mlp as k9
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.kernels import geodesy

    sources = sorted({os.path.splitext(os.path.basename(src))[0]
                      for src, _ in KERNELS.values()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(native.build_cuda, sources)))
    wall = time.perf_counter() - t0
    for name, b in built.items():
        for line in b.log.splitlines():
            if any(mark in line for mark in ("registers", "spill", "C7513",
                                             "C7514")):
                phase("ptxas", kernel=name, line=line.strip())
        phase("build", kernel=name, seconds=round(b.seconds, 3))
    # The wgmma kernels' products in their SASS: HGMMA instructions (bf16),
    # and IGMMA (int8) in K7's and K8's GEMMs.
    cuobjdump = os.path.join(os.path.dirname(native.nvcc()), "cuobjdump")
    hgmma_by_source, by_tag = {}, {}
    for name in WGMMA_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", built[name].path],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
        hgmma = sum("HGMMA" in line for line in sass)
        igmma = sum("IGMMA" in line for line in sass)
        hmma = sum("HMMA" in line for line in sass)
        if not hgmma or (name.endswith("_int8") and not igmma):
            raise RuntimeError(f"{name}: no HGMMA or IGMMA in its SASS")
        if name == "attention_fwd_variants" and hmma:
            raise RuntimeError(f"{name}: {hmma} HMMA (WMMA) in its SASS")
        phase("sass", kernel=name, hgmma=hgmma, igmma=igmma, hmma=hmma)
        hgmma_by_source[name] = hgmma
        if name.startswith("attention_"):
            by_tag.update(sass_by_function(sass))
    # V6 is K3's kernel under casts for the chain: K3's products, no exp.
    # V7, V8 and V9 are K3's kernel without P V: K3's products less the 16
    # of P V.
    k3_hgmma = hgmma_by_source["flash_attention"]
    for tag, hgmma in (("V6Attention", k3_hgmma),
                       ("V7Attention", k3_hgmma - 16),
                       ("V8Attention", k3_hgmma - 16),
                       ("V9Attention", k3_hgmma - 16)):
        got = [h for h, _ in by_tag.get(tag, [])]
        if got != [hgmma]:
            raise RuntimeError(f"{tag}: HGMMA {got}, not [{hgmma}] "
                               f"(K3's kernel has {k3_hgmma})")
    check_smoothing_build(built["smooth_labels"], cuobjdump)
    k.load()
    k.load_backward()
    geodesy.load()
    k3.load()
    k3.load_backward()
    k5.load()
    k8.load()
    k9.load()
    k6.load()
    k7.load()
    k3.load_online()
    bv.load()
    fv.load()
    phase("build", sources=len(built), wall_seconds=round(wall, 3),
          native_decode="built" if native_decode.available()
          else "unavailable (PIL decodes)",
          geokernels="built" if geokernels.available()
          else "unavailable (numpy)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=5)
    parser.add_argument("--rank-run", default=None, help=argparse.SUPPRESS)
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank_run is not None:
        return rank_run(args.rank_run, args.command)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, HERE)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", name=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    build_kernels()
    records = {"fused_qkv_attention": check_kernel(args.seed),
               "fused_qkv_attention_bwd": check_backward_kernel(args.seed),
               "smooth_labels": check_smoothing_kernel(args.seed),
               "flash_attention": check_attention_kernel(args.seed),
               "fused_qkv_attention_int8": check_int8_kernel(args.seed),
               "flash_attention_bwd":
                   check_attention_backward_kernel(args.seed),
               "fused_ln_qkv_attention": check_ln_kernel(args.seed),
               "fused_mlp": check_mlp_kernel(args.seed),
               "fused_block_attention": check_block_kernel(args.seed),
               "fused_block_attention_int8":
                   check_block_int8_kernel(args.seed),
               "flash_attention_online": check_online_kernel(args.seed)}
    check_eval_shapes(args.seed)
    records.update(check_eltwise_kernels(args.seed))
    # Each path's launches, counted from 0 just before it runs.
    launches = dict.fromkeys(KERNELS, 0)

    def add(counts: dict) -> None:
        for name, n in counts.items():
            launches[name] += n

    with tempfile.TemporaryDirectory() as root:
        pool = np.array(write_assets(root, args.seed), np.float32)
        serve_launches, bf16_embedding = check_serving(root, pool,
                                                       args.requests)
        add({"fused_qkv_attention": serve_launches})
        add(check_serving_int8(root, pool, args.requests, bf16_embedding))
        add(check_serving_int8_block(root, pool, args.requests,
                                     bf16_embedding))
        add(check_serve_routes(root, pool, args.requests, bf16_embedding))
        del bf16_embedding
        add(check_evaluate(root, pool, args.seed))
        add(check_serve_batch(root, pool))
        check_export(root, pool)
        add(check_landmarks(root, pool, args.seed))
    add(check_training(args.seed))
    add(check_train_routes(args.seed))
    add(check_train_durable(args.seed))
    add(check_scale_out(args.seed))
    add(check_embed(args.seed))
    add(check_embed_dinov2(args.seed))
    add(check_pretrain(args.seed))
    add(check_zeroshot(args.seed))
    add(check_geocell_ladder(args.seed))
    add(check_pipeline(args.seed))
    variant_launches, variant_records = check_variants()
    add(variant_launches)
    records.update(variant_records)
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on a path: {idle}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name], **records[name]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
