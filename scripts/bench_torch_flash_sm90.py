#!/usr/bin/env python3
"""Times the wgmma kernels K1, K2, K3, K3′, K4, K5, K6, K7, K8 and K9 of
`pigeon_tpu_torch` on one GPU.

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
* K1 (`fused_qkv_attention.fused_qkv_attention`) and K5
  (`fused_ln_qkv_attention.fused_ln_qkv_attention`) at x (B, 577, 1024),
  H = 16, for B in 32 (a train step's 8 panoramas) and 4 (one served
  panorama): through the wrapper, by a bare call of the C entry point on
  workspaces allocated once, their TFLOP/s on the TPU kernels' work, the
  device time of each launch, and the library composition of the same
  function (three ``F.linear`` and SDPA, after ``F.layer_norm`` for K5)
  on the same values;
* K6 (`fused_block_attention.fused_block_attention`) and K9
  (`fused_mlp.fused_ln_mlp`, I = 4096) at x (B, 577, 1024) for B in 32
  and 4: through the wrapper, their TFLOP/s on the TPU kernels' work, the
  device time of each launch, and the library composition of the same
  function (K6: ``F.layer_norm``, K1's composition, ``F.linear`` and the
  residual; K9: `fused_mlp.ln_mlp_composition`) on the same values;
* K8 (`fused_qkv_attention_int8.fused_qkv_attention_int8`) and K7
  (`fused_block_attention_int8.fused_block_attention_int8`) at x (4,
  577, 1024), H = 16, on `chip_smoke.py`'s operands: through the
  wrapper, by a bare call of the C entry point on workspaces allocated
  once, their TOP/s on the TPU kernels' work, the device time of each
  launch, and the library composition of the same function
  (`tuning.int8_qkv_composition`, `tuning.int8_block_composition`); for
  K8 whether its q/k/v workspaces equal the plain projections bit for
  bit, for K7 the share of its int8 workspaces xq and oq that differ
  from the plain version's quantize of LN1 and of the attention output
  (a requantize flip), and its output error in out-projection LSBs;
* the tile widths of the wgmma GEMM (`csrc/gemm_sm90.cuh`): K9's fc1 and
  fc2, K6's out-projection and the int8 GEMMs of K8 and K7 (a q/k/v
  projection, N = 3 x 1024, and K7's out-projection) at M = B x 577 for
  B in 4 and 32, with 128 x 128 and 128 x 256 output tiles on the same
  operands (`csrc/gemm_sm90_tiles.cu`, built here), each width's output
  against the other's;
* the host microseconds a call of K1's and K5's wrappers takes at those
  shapes, and of K3's and K4's at a toy shape.

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


def host_us(name: str, fn, calls: int = 200) -> None:
    """The host microseconds of a call of ``fn``, synchronised once after
    ``calls`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    print(f"{name} host_us_per_call="
          f"{(time.perf_counter() - t0) / calls * 1e6:.1f}", flush=True)


def fused_forwards(b: int, runs: int) -> None:
    """K1 and K5 at x (b, 577, 1024), and their library compositions."""
    import torch

    from pigeon_tpu_torch.kernels import fused_ln_qkv_attention as k5
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.tuning import qkv_composition, qkv_operands

    d = HEADS * HEAD_DIM
    gen = torch.Generator(device="cuda").manual_seed(b)
    x, ws, bs = qkv_operands(gen, b, SEQ, d, raw=True)
    ls = 1 + 0.5 * torch.randn(d, generator=gen, device="cuda")
    lb = 0.5 * torch.randn(d, generator=gen, device="cuda")

    def layer_norm():
        return torch.nn.functional.layer_norm(x, (d,), ls.bfloat16(),
                                              lb.bfloat16())

    xn = layer_norm()
    # The TPU kernels' work: three projections, QK^T and PV.
    flop = 3 * 2 * b * SEQ * d * d + 2 * 2 * b * HEADS * SEQ * SEQ * HEAD_DIM
    out = torch.empty_like(x)
    ws1, ws5 = k1.forward_workspaces(x, HEADS), k5.forward_workspaces(x,
                                                                       HEADS)
    stream = torch.cuda.current_stream().cuda_stream

    def bare1():
        if k1.load().pigeon_fused_qkv_attention(
                *(t.data_ptr() for t in (xn, *ws, *bs, out, *ws1)), b, SEQ,
                d, HEADS, stream):
            raise RuntimeError("K1's launch failed")

    def bare5():
        if k5.load().pigeon_fused_ln_qkv_attention(
                *(t.data_ptr() for t in (x, ls, lb, *ws, *bs, out, *ws5)), b,
                SEQ, d, HEADS, 1e-5, stream):
            raise RuntimeError("K5's launch failed")

    for name, fn, bare, library in (
            ("K1", lambda: k1.fused_qkv_attention(xn, *ws, *bs, HEADS),
             bare1, lambda: qkv_composition(xn, ws, bs, HEADS)),
            ("K5", lambda: k5.fused_ln_qkv_attention(x, ls, lb, *ws, *bs,
                                                      HEADS, 1e-5),
             bare5, lambda: qkv_composition(layer_norm(), ws, bs, HEADS))):
        ms = median_ms(fn, runs)
        bare_ms = median_ms(bare, runs)
        library_ms = median_ms(library, runs)
        print(f"{name} views={b} ms={ms:.4f} bare_ms={bare_ms:.4f} "
              f"tflops={flop / ms / 1e9:.1f} composition_ms={library_ms:.4f}",
              flush=True)
        launches(f"{name} views={b}", fn)
        host_us(f"{name} views={b}", fn)


def block_and_mlp(b: int, runs: int) -> None:
    """K6 and K9 at x (b, 577, 1024), and their library compositions."""
    import torch

    from pigeon_tpu_torch.kernels import fused_block_attention as k6
    from pigeon_tpu_torch.kernels import fused_mlp as k9
    from pigeon_tpu_torch.tuning import (block_composition, mlp_operands,
                                         normal, qkv_operands)

    d, inter = HEADS * HEAD_DIM, 4 * HEADS * HEAD_DIM
    gen = torch.Generator(device="cuda").manual_seed(b)
    x, ws, bs = qkv_operands(gen, b, SEQ, d, raw=True)
    ls = 1 + 0.5 * torch.randn(d, generator=gen, device="cuda")
    lb = 0.5 * torch.randn(d, generator=gen, device="cuda")
    wo, bo = normal(gen, 1, (d, d), 0.02)[0], normal(gen, 1, (d,), 0.02)[0]
    block = (x, ls, lb, *ws, *bs, wo, bo, HEADS, 1e-5)
    mlp = (*mlp_operands(gen, b, SEQ, d, inter), 1e-5)
    ln = (ls.bfloat16(), lb.bfloat16())
    # The TPU kernels' work: K1's products and the out-projection; fc1 and
    # fc2.
    flops = {"K6": 4 * 2 * b * SEQ * d * d
             + 2 * 2 * b * HEADS * SEQ * SEQ * HEAD_DIM,
             "K9": 2 * 2 * b * SEQ * d * inter}
    for name, fn, library in (
            ("K6", lambda: k6.fused_block_attention(*block),
             lambda: block_composition(x, ln, ws, bs, wo, bo, HEADS)),
            ("K9", lambda: k9.fused_ln_mlp(*mlp),
             lambda: k9.ln_mlp_composition(*mlp))):
        ms = median_ms(fn, runs)
        library_ms = median_ms(library, runs)
        print(f"{name} views={b} ms={ms:.4f} "
              f"tflops={flops[name] / ms / 1e9:.1f} "
              f"composition_ms={library_ms:.4f}", flush=True)
        launches(f"{name} views={b}", fn)


def int8_forwards(runs: int) -> None:
    """K8 and K7 at x (4, 577, 1024) on `chip_smoke.py`'s operands, their
    library compositions, and what their workspaces hold against the
    plain versions' intermediates."""
    import torch

    from pigeon_tpu_torch.kernels import fused_block_attention_int8 as k7
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.kernels.fused_ln_qkv_attention import (
        flax_layer_norm_f32,
    )
    from pigeon_tpu_torch.models.quant import int8_matmul, quantize_static
    from pigeon_tpu_torch.tuning import (int8_block_composition,
                                         int8_packs, int8_qkv_composition)

    b, d = 4, HEADS * HEAD_DIM
    stream = torch.cuda.current_stream().cuda_stream
    # K8: chip_smoke.check_int8_kernel's operands.
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.nn.functional.layer_norm(
        torch.randn(b, SEQ, d, generator=gen, device="cuda"), (d,)).bfloat16()
    act = x.float().abs().max() * 1.1 / 127
    packs = int8_packs(gen, d, (0.02,) * 3)
    ops = [t for pack in packs for t in pack]
    x_q = quantize_static(x, act)
    folded = k8.fold_scales(act, ops[1::3])
    ws8 = k8.forward_workspaces(x, HEADS)
    out8 = torch.empty_like(ws8.q)

    def bare8():
        if k8.load().pigeon_fused_qkv_attention_int8(
                *(t.data_ptr() for t in (x_q, *ops[0::3], *folded,
                                         *ops[2::3], out8, *ws8)),
                b, SEQ, d, HEADS, stream):
            raise RuntimeError("K8's launch failed")

    bare8()
    torch.cuda.synchronize()
    same = all(torch.equal(w, (int8_matmul(x_q, wq).float() * f + bias)
                           .bfloat16())
               for w, wq, f, bias in zip(ws8, ops[0::3], folded, ops[2::3]))
    want = k8.fused_qkv_attention_int8_reference(x, act, *ops, HEADS)
    err = (out8.float() - want.float()).abs().max().item()
    print(f"K8 views={b} qkv_bitwise={same} max_abs_err={err:.3g} "
          f"rel_err={err / want.float().abs().max().item():.3g}", flush=True)
    # K7: chip_smoke.check_block_int8_kernel's operands.
    gen = torch.Generator(device="cuda").manual_seed(0)
    xr = (torch.randn(b, SEQ, d, generator=gen, device="cuda") * 0.5 + 0.5) \
        .bfloat16()
    ls = 1 + 0.5 * torch.randn(d, generator=gen, device="cuda")
    lb = 0.5 * torch.randn(d, generator=gen, device="cuda")
    bpacks = int8_packs(gen, d, (0.05, 0.05, 0.03, 0.02))
    xn = flax_layer_norm_f32(xr, ls, lb, 1e-5)
    a_qkv = xn.abs().max() * 1.1 / 127
    xn = xn.bfloat16()
    ao = torch.tensor(5.5 / 127, device="cuda")
    bops = [t for pack in bpacks for t in pack]
    args7 = (xr, ls, lb, a_qkv, *bops[:9], ao, *bops[9:], HEADS, 1e-5)
    bfolded = k7.fold_scales(a_qkv, bops[1:9:3]) + k7.fold_scales(
        ao, bops[10:11])
    ws7 = k7.forward_workspaces(xr)
    out7 = torch.empty_like(xr)

    def bare7():
        if k7.load().pigeon_fused_block_attention_int8(
                *(t.data_ptr() for t in (
                    xr, ls, lb, a_qkv, *bops[0:9:3], *bfolded[:3],
                    *bops[2:9:3], ao, bops[9], bfolded[3], bops[11], out7,
                    *ws7)),
                b, SEQ, d, HEADS, 1e-5, stream):
            raise RuntimeError("K7's launch failed")

    bare7()
    torch.cuda.synchronize()
    o = k8.fused_qkv_attention_int8_reference(xn, a_qkv, *bops[:9], HEADS)
    xq_flips = (ws7.xq != quantize_static(xn, a_qkv)).float().mean().item()
    oq_flips = (ws7.oq != quantize_static(o, ao)).float().mean().item()
    want = k7.fused_block_attention_int8_reference(*args7)
    diff = (out7.float() - want.float()).abs()
    lsb = (ao * bops[10].max() * 127).item()
    print(f"K7 views={b} xq_flip_share={xq_flips:.3g} "
          f"oq_flip_share={oq_flips:.3g} max_abs_err={diff.max().item():.4g} "
          f"lsb={lsb:.4g} limit={1.5 * lsb + 3e-2:.4g} "
          f"share_over_3e-2={(diff > 3e-2).float().mean().item():.3g}",
          flush=True)
    ops7 = {"K8": 3 * 2 * b * SEQ * d * d, "K7": 4 * 2 * b * SEQ * d * d}
    attn = 2 * 2 * b * HEADS * SEQ * SEQ * HEAD_DIM
    for name, fn, bare, library in (
            ("K8", lambda: k8.fused_qkv_attention_int8(x, act, *ops, HEADS),
             bare8, lambda: int8_qkv_composition(x, act, packs, HEADS)),
            ("K7", lambda: k7.fused_block_attention_int8(*args7), bare7,
             lambda: int8_block_composition(xr, ls, lb, 1e-5, a_qkv, bpacks,
                                            ao, HEADS))):
        ms = median_ms(fn, runs)
        bare_ms = median_ms(bare, runs)
        library_ms = median_ms(library, runs)
        print(f"{name} views={b} ms={ms:.4f} bare_ms={bare_ms:.4f} "
              f"tops={(ops7[name] + attn) / ms / 1e9:.1f} "
              f"composition_ms={library_ms:.4f}", flush=True)
        launches(f"{name} views={b}", fn)
        host_us(f"{name} views={b}", fn)


def gemm_tiles(runs: int) -> None:
    """K9's fc1 and fc2, K6's out-projection and the int8 GEMMs of K8 and
    K7 with 128-wide and 256-wide output tiles, at M = 4 x 577 and 32 x
    577."""
    import ctypes

    import torch

    from pigeon_tpu_torch import native

    lib = ctypes.CDLL(native.build_cuda("gemm_sm90_tiles").path)
    lib.pigeon_gemm_sm90_tiles.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    d, inter = HEADS * HEAD_DIM, 4 * HEADS * HEAD_DIM
    for b in (4, 32):
        m = b * SEQ
        for which, name, n, k in ((0, "fc1", inter, d), (1, "fc2", d, inter),
                                  (2, "out_projection", d, d),
                                  (3, "s8_projection", 3 * d, d),
                                  (4, "s8_out_projection", d, d)):
            if which < 3:
                a = (torch.randn(m, k, device="cuda")).bfloat16()
                w = (torch.randn(n, k, device="cuda") * k ** -0.5).bfloat16()
                bias = (torch.randn(n, device="cuda") * 0.1).bfloat16()
            else:
                a = torch.randint(-127, 128, (m, k), device="cuda",
                                  dtype=torch.int8)
                w = torch.randint(-127, 128, (n, k), device="cuda",
                                  dtype=torch.int8)
                bias = torch.randn(n, device="cuda") * 0.1
            scale = torch.rand(n, device="cuda") * 1e-5
            res = torch.randn(m, n, device="cuda").bfloat16()
            outs = {}
            for bn in (128, 256):
                out = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)

                def call(bn=bn, out=out):
                    if lib.pigeon_gemm_sm90_tiles(
                            which, bn, *(t.data_ptr() for t in
                                         (a, w, bias, scale, res, out)),
                            m, n, k, stream):
                        raise RuntimeError(f"{name} at BN {bn} failed")

                call()
                torch.cuda.synchronize()
                outs[bn] = out
                ms = median_ms(call, runs)
                print(f"gemm_tiles {name} views={b} M={m} N={n} K={k} "
                      f"BN={bn} tiles={(m + 127) // 128 * (n // bn)} "
                      f"ms={ms:.4f} tops={2 * m * n * k / ms / 1e9:.1f}",
                      flush=True)
            diff = (outs[128].float() - outs[256].float()).abs().max()
            print(f"gemm_tiles {name} views={b} max_abs_diff_128_vs_256="
                  f"{diff.item():.3g}", flush=True)


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
    for b in (32, 4):
        fused_forwards(b, args.runs)
    for b in (32, 4):
        block_and_mlp(b, args.runs)
    int8_forwards(args.runs)
    gemm_tiles(args.runs)
    tiny = q[:1, :64].contiguous()
    host_us("K3", lambda: k34.flash_attention(tiny, tiny, tiny))
    host_us("K4", lambda: k34.flash_attention_backward(tiny, tiny, tiny,
                                                       tiny))
    return 0


if __name__ == "__main__":
    sys.exit(main())
