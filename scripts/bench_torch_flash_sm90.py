#!/usr/bin/env python3
"""Times the wgmma kernels K2, K3, K3′ and K4 of `pigeon_tpu_torch` on one
GPU.

    python3 scripts/bench_torch_flash_sm90.py [--runs N]

Prints the card's name and power limit, then one line per measurement,
CUDA-event medians over ``--runs`` calls after a warm-up:

* K3 (`attention.flash_attention`) at q/k/v (B, 577, 16, 64) bf16 for B
  in 80 (the int8 calibration), 32 (the ``flash`` training step) and 4
  (one served panorama): through the wrapper (host work included, as
  `chip_smoke.py` times it), by a bare call of the C entry point, and
  PyTorch's scaled_dot_product_attention on the same values; K3′
  (`attention.flash_attention_online`) through its wrapper on the same
  values;
* K4 (`attention.flash_attention_backward`) at (32, 577, 16, 64) through
  the wrapper, and the device time of each of its launches (statistics
  pass, gradient pass, dq cast, the workspace's zeroing) from
  `torch.profiler`;
* K2 (`fused_qkv_attention.fused_qkv_attention_backward`) at x (32, 577,
  1024), H = 16, through the wrapper, its TFLOP/s on the TPU kernel's
  work, and the device time of each of its launches;
* the host microseconds a call of each wrapper takes at a toy shape.

Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, HEADS, HEAD_DIM = 577, 16, 64


def median_ms(fn, runs: int) -> float:
    import torch

    for _ in range(3):
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


def launches(name: str, fn, calls: int = 5) -> None:
    """The device microseconds of each launch of ``fn`` per call, from
    `torch.profiler`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        us = evt.self_device_time_total / calls
        if us > 0:
            print(f"{name} launch us={us:.1f} {evt.key[:110]}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=40)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_flash_sm90: no CUDA device")
    sys.path.insert(0, HERE)

    from pigeon_tpu_torch.kernels import attention as k34
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k12

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    stream = torch.cuda.current_stream().cuda_stream
    for b in (80, 32, 4):
        q, k, v = (torch.randn(b, SEQ, HEADS, HEAD_DIM, device="cuda")
                   .bfloat16() for _ in range(3))
        out = torch.empty_like(q)
        lib = k34.load()
        ms = median_ms(lambda: k34.flash_attention(q, k, v), args.runs)
        bare_ms = median_ms(lambda: lib.pigeon_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, SEQ,
            HEADS, stream), args.runs)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa_ms = median_ms(lambda: sdpa(qt, kt, vt), args.runs)
        online_ms = median_ms(lambda: k34.flash_attention_online(q, k, v),
                              args.runs)
        flop = 2 * 2 * b * HEADS * SEQ * SEQ * HEAD_DIM
        print(f"K3 views={b} ms={ms:.4f} bare_ms={bare_ms:.4f} "
              f"sdpa_ms={sdpa_ms:.4f} tflops={flop / ms / 1e9:.1f}",
              flush=True)
        print(f"K3′ views={b} ms={online_ms:.4f} "
              f"tflops={flop / online_ms / 1e9:.1f}", flush=True)
    q, k, v, g = (torch.randn(32, SEQ, HEADS, HEAD_DIM, device="cuda")
                  .bfloat16() for _ in range(4))
    ms = median_ms(lambda: k34.flash_attention_backward(q, k, v, g),
                   args.runs)
    flop = 5 * 2 * 32 * HEADS * SEQ * SEQ * HEAD_DIM
    print(f"K4 views=32 ms={ms:.4f} tflops_5_walks={flop / ms / 1e9:.1f}",
          flush=True)
    launches("K4", lambda: k34.flash_attention_backward(q, k, v, g))
    b, d = 32, HEADS * HEAD_DIM
    x = torch.nn.functional.layer_norm(
        torch.randn(b, SEQ, d, device="cuda"), (d,)).bfloat16()
    ws = [(torch.randn(d, d, device="cuda") * 0.02).bfloat16()
          for _ in range(3)]
    bs = [(torch.randn(d, device="cuda") * 0.02).bfloat16()
          for _ in range(3)]
    g2 = (torch.randn(b, SEQ, d, device="cuda") * 0.01).bfloat16()

    def k2():
        return k12.fused_qkv_attention_backward(x, *ws, *bs, g2, HEADS)

    ms = median_ms(k2, args.runs)
    # The TPU kernel's work: projections and dx, five S x S x 64 products
    # a head.
    flop = (2 * 2 * b * SEQ * d * 3 * d
            + 5 * 2 * b * HEADS * SEQ * SEQ * HEAD_DIM)
    print(f"K2 views={b} ms={ms:.4f} tflops={flop / ms / 1e9:.1f}",
          flush=True)
    launches("K2", k2)
    tiny = q[:1, :64].contiguous()
    for name, fn in (("K3", lambda: k34.flash_attention(tiny, tiny, tiny)),
                     ("K4", lambda: k34.flash_attention_backward(
                         tiny, tiny, tiny, tiny))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        print(f"{name} host_us_per_call="
              f"{(time.perf_counter() - t0) / 200 * 1e6:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
