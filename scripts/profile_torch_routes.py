#!/usr/bin/env python3
"""Device-time breakdown of `pigeon_tpu_torch`'s attention routes on one GPU.

    python3 scripts/profile_torch_routes.py [--steps N] [--seed N]
                                            [--serve-only]

Builds the PIGEON preset at full ViT-L/14-336 width (24 layers, D=1024,
seeded weights and 2203 seeded geocells) as ``finetune`` does (every
encoder layer but the last frozen, remat ``attn_kernel``), on synthetic
pixels and labels made on the device, and profiles with `torch.profiler`:

* the train step at 8 panoramas (32 views) on the routes ``fused``
  (``flash_fused``), ``flash``, ``fused_ln``, ``fused_mlp``, ``block``
  (``flash_fused_block``), ``fused`` with ``PIGEON_FUSED_BWD=xla`` and
  ``flash`` with ``PIGEON_FLASH_FWD=online``;
* the serving forward of one panorama (4 views) on ``fused``, ``flash``,
  ``fused_ln``, ``fused_mlp``, ``block`` and ``flash`` with
  ``PIGEON_FLASH_FWD=online``;
* then the int8 serving forward (``serve --quant``) of the same weights,
  quantized and calibrated on two panoramas of the batch (margin 1.1), on
  ``fused`` (K8) and ``block`` (K7, ``PIGEON_QUANT_ATTN_IMPL=
  flash_fused_block``).

``--serve-only`` skips the train steps.

For each it prints one line: the host-clock milliseconds of a
synchronised step or forward (median), the summed self device time of
the profiled window by group (each of the port's kernels, the library
GEMMs, everything else) per step or forward, and the device's busy
share; then the top kernels by self device time. Without a CUDA device
it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The port's kernels by a substring of their CUDA function names, the
#: first match in this order (the tags before the library's generic
#: "gemm": K1's, K2's, K5's, K6's, K7's, K8's and K9's GEMMs are the
#: port's). K1's two
#: stages (projection GEMM, K3's streaming forward on its q/k/v) and K5's
#: three (LN1, the same two) run on the fused routes, each kernel tagged
#: K1* or K5*; K6's four (K5's three, then the out-projection GEMM) on
#: ``block``, tagged K6*; K9's three (LN2, fc1 and fc2 GEMMs) on
#: ``fused_mlp`` and ``block``, tagged K9*; K2's three stages (projection
#: GEMM, K4's attention passes on its q/k/v, dx GEMM), each kernel tagged
#: K2*; K4's three passes (statistics, gradients, dq cast), each a group,
#: on ``flash`` and under ``PIGEON_FUSED_BWD=xla``. K3 and K3′ launch one
#: kernel under the tags K3Forward and K3OnlineForward. The int8 forwards
#: run K8's two stages (int8 projection GEMM, streaming forward; K8*) on
#: ``fused`` and K7's four (LN1 + quantize, K8's two stages requantizing
#: the attention output, the int8 out-projection GEMM; K7*) on ``block``.
KERNEL_GROUPS = (
    ("K1 projection GEMM", "K1Projection"),
    ("K1 attention", "K1Attention"),
    ("K5 LN1", "K5LayerNorm"),
    ("K5 projection GEMM", "K5Projection"),
    ("K5 attention", "K5Attention"),
    ("K2 projection GEMM", "K2Projection"),
    ("K2 attention passes", "K2Attention"),
    ("K2 dx GEMM", "K2Dx"),
    ("K3′", "K3OnlineForward"),
    ("K3", "K3Forward"),
    ("K6 LN1", "K6LayerNorm"),
    ("K6 projection GEMM", "K6Projection"),
    ("K6 attention", "K6Attention"),
    ("K6 out-projection GEMM", "K6OutProjection"),
    ("K8 projection GEMM", "K8Projection"),
    ("K8 attention", "K8Attention"),
    ("K7 LN1", "K7LayerNorm"),
    ("K7 projection GEMM", "K7Projection"),
    ("K7 attention", "K7Attention"),
    ("K7 out-projection GEMM", "K7OutProjection"),
    ("K4 statistics", "flash_attention_bwd_stats"),
    ("K4 gradients", "flash_attention_bwd_grad"),
    ("K4 dq cast", "flash_attention_bwd_dq"),
    ("K9 LN2", "K9LayerNorm"),
    ("K9 fc1 GEMM", "K9Fc1"),
    ("K9 fc2 GEMM", "K9Fc2"),
    ("K10", "smooth_labels_kernel"),
)
#: Library GEMMs (cuBLAS, CUTLASS) by name.
GEMM_MARKS = ("gemm", "cutlass", "nvjet", "xmma", "sm90_")
#: (label, route, environment) of each profiled configuration.
TRAIN_ROUTES = (("fused", "fused", {}), ("flash", "flash", {}),
                ("fused_ln", "fused_ln", {}), ("fused_mlp", "fused_mlp", {}),
                ("block", "block", {}),
                ("fused+xla_bwd", "fused", {"PIGEON_FUSED_BWD": "xla"}),
                ("flash+online", "flash", {"PIGEON_FLASH_FWD": "online"}))
SERVE_ROUTES = (("fused", "fused", {}), ("flash", "flash", {}),
                ("fused_ln", "fused_ln", {}), ("fused_mlp", "fused_mlp", {}),
                ("block", "block", {}),
                ("flash+online", "flash", {"PIGEON_FLASH_FWD": "online"}))
#: The int8 serving forwards: ``flash_fused`` (K8) and ``flash_fused_block``
#: (K7) on the quantized tower.
INT8_SERVE_ROUTES = (("fused_int8", "fused", {}), ("block_int8", "block", {}))
NUM_CELLS = 2203


def group_of(name: str) -> str:
    # The port's marks come before the library's generic "gemm": the
    # port's "gemm_sm90_kernel" instances carry their users' tags.
    for label, mark in KERNEL_GROUPS:
        if mark in name:
            return label
    if any(m in name.lower() for m in GEMM_MARKS):
        return "library GEMMs"
    return "other"


def device_breakdown(prof, calls: int) -> tuple:
    """Self device ms per call by group, and the top kernels."""
    import torch

    groups = collections.Counter()
    kernels = collections.Counter()
    counts = collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        groups[group_of(evt.key)] += us / 1e3 / calls
        kernels[evt.key] += us / 1e3 / calls
        counts[evt.key] += evt.count / calls
    return groups, kernels, counts


def report(tag: str, route: str, host_ms: list, prof, calls: int,
           window_ms: float) -> None:
    groups, kernels, counts = device_breakdown(prof, calls)
    busy = sum(groups.values()) * calls / window_ms
    fields = {"route": route,
              "host_ms": round(sorted(host_ms)[len(host_ms) // 2], 3),
              "device_ms": round(sum(groups.values()), 3),
              "busy": round(busy, 3),
              **{k.replace(" ", "_").replace("/", "_"): round(v, 3)
                 for k, v in groups.most_common()}}
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)
    for name, ms in kernels.most_common(8):
        print(f"  {ms:9.3f} ms  x{counts[name]:6.1f}  {name[:110]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=2,
                        help="profiled steps (and forwards) per route")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--serve-only", action="store_true",
                        help="profile the serving forwards only")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_routes: no CUDA device")
    sys.path.insert(0, HERE)
    from torch.profiler import ProfilerActivity, profile

    from pigeon_tpu_torch.config import pigeon_config
    from pigeon_tpu_torch.models.clip import set_route
    from pigeon_tpu_torch.models.quant import quantize_and_calibrate
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.serve.server import make_serving_fn
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        batch_to_device,
        make_train_step,
    )

    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    device = torch.device("cuda")
    cfg = pigeon_config(num_cells=NUM_CELLS)
    rng = np.random.default_rng(args.seed)
    cells = torch.tensor(np.stack([rng.uniform(-180, 180, NUM_CELLS),
                                   rng.uniform(-60, 75, NUM_CELLS)], -1),
                         dtype=torch.float32, device=device)
    b = 8
    heading = rng.uniform(0, 2 * np.pi, (b, 4))
    batch = batch_to_device({
        "inputs": rng.integers(0, 256, (b, 4, 336, 336, 3), dtype=np.uint8),
        "heading": np.stack([np.sin(heading), np.cos(heading)],
                            -1).astype(np.float32),
        "labels": np.stack([rng.uniform(-180, 180, b),
                            rng.uniform(-60, 70, b)], -1).astype(np.float32),
        "labels_clf": rng.integers(0, NUM_CELLS, b).astype(np.int32),
        "labels_multi_task": rng.normal(size=(b, 6)).astype(np.float32),
        "labels_climate": rng.integers(0, 28, b).astype(np.int32),
        "labels_month": rng.integers(0, 12, b).astype(np.int32)}, device)
    model = init_weights(build_finetune_model(cfg), args.seed).to(device)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def window(fn, calls):
        """Warm up, time ``calls`` synchronised calls on the host clock,
        then profile ``calls`` more; returns (host ms, prof, window ms)."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        host = []
        for _ in range(calls + 1):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        return host, prof, window_ms

    train_step = make_train_step(cfg.head, cells)
    for label, route, env in () if args.serve_only else TRAIN_ROUTES:
        model.load_state_dict(start)
        set_route(model, route)
        os.environ.update(env)
        state = TrainState(model, adamw(model.parameters(),
                                        cfg.train.learning_rate))
        torch.cuda.reset_peak_memory_stats()
        host, prof, window_ms = window(lambda: train_step(state, batch),
                                       args.steps)
        report("train", label, host, prof, args.steps, window_ms)
        print(f"  peak_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}",
              flush=True)
        del state
        for key in env:
            os.environ.pop(key)
    model.zero_grad(set_to_none=True)

    serve_fn = make_serving_fn(model, cfg.head, cells.cpu().numpy(), device)
    pixels = batch["inputs"][:1]

    def serve_routes(routes):
        for label, route, env in routes:
            set_route(model, route)
            os.environ.update(env)
            host, prof, window_ms = window(lambda: serve_fn(pixels),
                                           args.steps)
            report("serve", label, host, prof, args.steps, window_ms)
            for key in env:
                os.environ.pop(key)

    serve_routes(SERVE_ROUTES)
    # serve_fn runs the same model, its tower now int8.
    set_route(model, "fused")
    quantize_and_calibrate(model, batch["inputs"][:2], tower_key="vision",
                           margin=1.1)
    serve_routes(INT8_SERVE_ROUTES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
