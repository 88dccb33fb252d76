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
             (1, 1), (3, 5), (300, 2203) and (500, 2203), tau 75 km, max
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
7. train   - the ``finetune`` command's own functions on the same preset
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
8. train_routes - the ``[train]`` preset, width and batch under remat
             ``attn_kernel`` on ``flash``, ``flash_fused_ln``,
             ``flash_fused_mlp``, ``flash_fused`` with
             ``PIGEON_FUSED_BWD=xla``, ``flash_fused_block`` and ``flash``
             with ``PIGEON_FLASH_FWD=online``: first-batch gradients
             within cosine >= 0.999 of the plain route's, then 2 steps and
             an eval batch
             with finite losses and the exact launch counts that
             `check_train_routes` states; step time, images/s and peak
             memory per route;
9. variants - the tuning drivers `scripts/bench_torch_attn_bwd.py`,
             `bench_torch_attn_fwd_diag.py` and
             `bench_torch_attn_qkv_fused.py` through their own ``run`` at
             the TPU scripts' flagship shape (32 views, S = 577, H = 16;
             x (32, 577, 1024)), 3 windows of 3 calls: every variant
             checked against its plain version (`check_variants` states
             the bounds) and timed beside it and the SDPA yardstick; the
             tuning kernels V1-V10 launched there. The kernels line's
             launches of K1-K10 and K3′ stay those of phases 4-8. Then,
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
import functools
import glob
import json
import os
import subprocess
import sys
import tempfile
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
#: Every other bf16 route's embedding against the ``flash_fused`` one's,
#: and every route's trainable gradients against the plain route's.
ROUTE_COSINE = 0.999
NUM_CELLS = 2203
BANK_ROWS = 16384
TRAIN_ROWS, VAL_ROWS, TRAIN_BATCH = 32, 8, 8
#: K10's shapes, labels x cells: the main path's (every train step and
#: eval batch), the check shape, one cell, fewer cells than a cluster's
#: CTAs, 300 labels, and a ragged last row tile of 8 rows (500 = 62 x 8
#: + 4); the first two are timed.
K10_TIMED = ((TRAIN_BATCH, NUM_CELLS), (256, NUM_CELLS))
K10_SHAPES = (*K10_TIMED, (1, 1), (3, 5), (300, NUM_CELLS),
              (500, NUM_CELLS))
#: [train_routes]: each route takes this many steps and one eval batch.
ROUTE_STEPS = 2


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
    one: every launch of [train] and [train_routes] is at that shape."""
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


def check_serving(root: str, pool, n_requests: int) -> tuple:
    """The full-width panorama model served over HTTP in bf16; returns
    K1's launches during the requests and the embedding of the first
    panorama."""
    import torch

    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.models.clip import set_route

    payloads = serve_payloads(n_requests)
    torch.cuda.reset_peak_memory_stats()
    httpd, startup_s = start_serving(root)
    try:
        service = httpd.RequestHandlerClass.service
        latencies, launches = request_all(
            httpd, payloads, pool,
            {"fused_qkv_attention": k1.fused_qkv_attention})
        launches = launches["fused_qkv_attention"]
        model = service.serve_fn.model
        layers = len(model.vision.encoder.layers)
        if launches != layers * n_requests:
            raise RuntimeError(f"K1 launched {launches} times for "
                               f"{n_requests} requests, not once per "
                               f"layer ({layers})")

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
    finally:
        httpd.shutdown()
        httpd.server_close()
    phase("serve", requests=n_requests, status=200, layers=layers,
          k1_launches=launches,
          median_ms=sorted(latencies)[len(latencies) // 2],
          latencies_ms=[round(t, 3) for t in latencies],
          startup_s=round(startup_s, 3), embedding_cosine=cos,
          peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
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


def write_train_assets(root: str, seed: int):
    """Geocells and a panorama metadata CSV with every label column the
    multi-task loss reads, over the repo's PNG fixtures. Returns the
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
    n = TRAIN_ROWS + VAL_ROWS
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
                   "train" if i < TRAIN_ROWS else "val",
                   *rng.normal(size=6), rng.integers(0, 28),
                   rng.integers(0, 12), rng.uniform(0, 360), nearest[i]]
            f.write(",".join(str(v) for v in row) + "\n")
    return meta, cells_csv, images


def check_training(seed: int) -> dict:
    """The full-width panorama model finetuned through the ``finetune``
    command's own functions; returns each kernel's launches in the first
    epoch."""
    import gc
    import math

    import numpy as np
    import torch

    from pigeon_tpu_torch.cli.run import (
        build_finetune,
        build_parser,
        train_finetune,
    )
    from pigeon_tpu_torch.data.pipeline import iter_batches
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
                "smooth_labels": geodesy.smooth_labels_from_points}
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
            want = {"fused_qkv_attention": layers * (steps + evals),
                    "fused_qkv_attention_bwd": layers * steps,
                    "smooth_labels": steps + evals}
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
            batches = iter_batches(run.train, TRAIN_BATCH, shuffle=True,
                                   seed=0, drop_last=True)
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
            if kernel_g.keys() != plain_g.keys():
                raise RuntimeError("the routes give gradients to other "
                                   f"tensors: {kernel_g.keys() ^ plain_g.keys()}")
            cosines = {}
            for name, g in kernel_g.items():
                if name.endswith("k_proj.bias"):
                    # Zero in exact arithmetic (the softmax ignores a shift
                    # shared by all keys): both must be rounding noise.
                    ref = plain_g[name.replace("k_proj", "q_proj")].norm()
                    if not max(g.norm(), plain_g[name].norm()) <= 1e-2 * ref:
                        raise RuntimeError(f"{name} gradient is not ~0")
                    continue
                cosines[name] = torch.nn.functional.cosine_similarity(
                    g, plain_g[name], dim=0).item()
            worst = min(cosines, key=cosines.get)
            if not cosines[worst] >= 0.999:
                raise RuntimeError(f"gradient cosine {cosines[worst]} < "
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
          grad_cosine_min=round(cosines[worst], 6), grad_cosine_at=worst,
          loss_rel_diff_max=max(rel.values()),
          step_ms=round(step_ms, 3), step_ms_all=[round(t, 3) for t in times],
          images_per_s=round(views / step_ms * 1e3, 2),
          peak_gib_attn_kernel=round(peak_attn_kernel, 3),
          peak_gib_none=round(peak_none, 3), setup_s=round(setup_s, 3),
          epoch_s=round(epoch_s, 3), resumed_from=start)
    return launches


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
    from pigeon_tpu_torch.data.pipeline import iter_batches
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

            def first(dataset, shuffle):
                batches = iter_batches(dataset, TRAIN_BATCH, shuffle=shuffle,
                                       seed=0, drop_last=shuffle)
                batch = batch_to_device(next(batches), run.device)
                batches.close()
                return batch

            batch, val_batch = first(run.train, True), first(run.val, False)
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
                got = grads(route, env)
                if got.keys() != plain.keys():
                    raise RuntimeError(f"{label} gives gradients to other "
                                       f"tensors: {got.keys() ^ plain.keys()}")
                cosines = {}
                for name, g in got.items():
                    if name.endswith("k_proj.bias"):
                        # Zero in exact arithmetic (a shift shared by all
                        # keys): both must be rounding noise.
                        ref = plain[name.replace("k_proj", "q_proj")].norm()
                        if not max(g.norm(), plain[name].norm()) <= 1e-2 * ref:
                            raise RuntimeError(f"{label}: {name} gradient "
                                               "is not ~0")
                        continue
                    cosines[name] = torch.nn.functional.cosine_similarity(
                        g, plain[name], dim=0).item()
                del got
                worst = min(cosines, key=cosines.get)
                if not cosines[worst] >= ROUTE_COSINE:
                    raise RuntimeError(f"{label}: gradient cosine "
                                       f"{cosines[worst]} < {ROUTE_COSINE} "
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
                      grad_cosine_min=round(cosines[worst], 6),
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
          else "unavailable (PIL decodes)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=5)
    args = parser.parse_args()

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
    add(check_training(args.seed))
    add(check_train_routes(args.seed))
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
