#!/usr/bin/env python3
"""Times the one-pass element-wise kernels of `pigeon_tpu_torch`
(`kernels/eltwise.py`: LayerNorm, residual add + LayerNorm, quick-GELU,
SwiGLU, LayerScale'd add + LayerNorm, and the backwards of the first
three) on one GPU, and counts their launches in a ViT-L/14-336 forward
and in a training step.

    python3 scripts/bench_torch_eltwise.py [--iters N] [--output OUT.json]

Prints the card's name and power limit, then one line per kernel and
shape (the main path's: the ViT-L/14-336 sweep's 512 x 577 rows, a
training or 8-panorama serving batch's 32 x 577, the ViT-B/32 sweep's
512 x 50; DINOv2-g/14's sweep of 128 x 1,374 rows and one image), each
with

* the kernel's device ms a call (`torch.profiler`, its kernels' summed
  time over ``--iters`` calls), and its wrapper's ms a call (CUDA events
  around the same calls, host work included);
* the byte bound: each input read once and each output written once at
  3.35 TB/s;
* the plain version's device ms a call: the eager composition the
  layers ran before the kernels (LayerNorm: ``x.float()``,
  ``F.layer_norm``, ``.to``; add + LayerNorm: the add, then that;
  quick-GELU: ``1.702 * x``, ``sigmoid``, the product; SwiGLU: ``silu``
  of the first half, the product; the LayerScale'd add: gamma's cast,
  the product, the add, then the LayerNorm's); for a backward, the
  operations eager autograd runs for it (LayerNorm: ``dy.float()``,
  ``F.layer_norm``'s backward, the cast back, and the residual sum;
  quick-GELU: two products, ``sigmoid_backward``, the scalar product and
  the sum, after the forward's ``t`` and ``s`` again);
* where one PyTorch call computes nearly the same function, that call's
  device ms (``F.layer_norm`` on bf16 with the parameters rounded to bf16);
* the largest distance from the plain version in bf16 ulps (a LayerNorm
  output that cancels below 1/256 of its terms' magnitude in ulps of
  that floor), and the share of elements that differ.

Each call reads its own copy of the inputs, in turn over enough copies
to pass 200 MB, so no call finds them in the 50 MB L2 cache. The
backwards run at the finetune cell's rows (512 views of 577 tokens) and
a 32-view batch's, the LayerNorm's with and without its own gradients.
Last, a 24-layer ViT-L/14-336 tower on one image counts each kernel's
launches in an inference forward and in a training step (the last
layer trained, remat ``attn_kernel``). Writes every number to
``--output`` as JSON. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pigeon_tpu_torch.config import VisionConfig  # noqa: E402
from pigeon_tpu_torch.kernels import eltwise  # noqa: E402
from pigeon_tpu_torch.models import clip  # noqa: E402

EPS = 1e-5
BANDWIDTH = 3.35e12
ROWS = [("vit-l sweep", 512 * 577, 1024), ("32 views", 32 * 577, 1024),
        ("vit-b/32 sweep", 512 * 50, 768)]
GELU = [("vit-l sweep", 512 * 577, 4096), ("32 views", 32 * 577, 4096),
        ("vit-b/32 sweep", 512 * 50, 3072)]
#: DINOv2-g/14: (rows, I) for SwiGLU, (rows, D) for the scaled add + LN.
DINOV2 = [("dinov2-g sweep", 128 * 1374, 4096, 1536),
          ("dinov2-g image", 1374, 4096, 1536)]


def device_ms(fn, copies, iters):
    """Device ms a call of ``fn(*copies[i % len(copies)])``: the summed
    time of the kernels it launched over ``iters`` calls, by
    `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*copies[i % len(copies)])
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel") / 1e3 / iters


def wall_ms(fn, copies, iters):
    """CUDA-event ms a call, host work included."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*copies[i % len(copies)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ulps(got, want, floor=None):
    """The largest distance in bf16 ulps of ``want`` (of ``floor`` where
    ``|want|`` is below it) and the share of elements that differ."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    if floor is not None:
        mag = torch.maximum(mag, floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    apart = torch.where(diff > 0, diff / ulp, torch.zeros_like(diff))
    return apart.max().item(), (diff > 0).float().mean().item()


def cancellation_floor(x, w, b):
    """1/256 of the magnitude of a LayerNorm output's terms, ``|w x_hat| +
    |b|``: below it the output has cancelled, and a few f32 ulps of the
    terms are many bf16 ulps of the result."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    x_hat = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    return ((w * x_hat).abs() + b.abs()) / 256


def backward_floor(x, dy, w, stats):
    """1/256 of the magnitude of a LayerNorm input gradient's terms,
    ``rstd (|g| + mean|g| + |x_hat| mean|g x_hat|)``, ``g = w dy``: below
    it the gradient has cancelled (as `cancellation_floor`)."""
    mean, rstd = (t.view(-1, 1) for t in stats)
    x_hat = (x.float() - mean) * rstd
    g = dy.float() * w
    return rstd * (g.abs() + g.abs().mean(-1, keepdim=True) + x_hat.abs()
                   * (g * x_hat).abs().mean(-1, keepdim=True)) / 256


def copies_of(make, nbytes):
    n = max(1, -(-200_000_000 // nbytes))
    return [make(i) for i in range(n)]


def measure(name, shape, kernel, plain, library, make, nbytes, iters,
            floor=None):
    """One row; ``floor(*inputs)`` gives the magnitude below which the
    last output's distance is counted in ulps of the floor."""
    copies = copies_of(make, nbytes)
    for fn in (kernel, plain) + ((library,) if library else ()):
        fn(*copies[0])                           # build, warm up
    got, want = kernel(*copies[0]), plain(*copies[0])
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    exact = [torch.equal(g, w) for g, w in zip(got, want)]
    dist = ulps(got[-1], want[-1], floor and floor(*copies[0]))
    del got, want
    row = {"kernel": name, "shape": list(shape),
           "device_ms": device_ms(kernel, copies, iters),
           "wrapper_ms": wall_ms(kernel, copies, iters),
           "bound_ms": nbytes / BANDWIDTH * 1e3,
           "plain_ms": device_ms(plain, copies, iters),
           "library_ms": (device_ms(library, copies, iters)
                          if library else None),
           "max_ulps": dist[0], "share_differing": dist[1],
           "outputs_equal": exact}
    print(json.dumps(row), flush=True)
    return row


#: The kernels `launches_in_a_tower` counts, forwards then backwards.
COUNTED = ("layer_norm_bf16", "add_layer_norm_bf16", "quick_gelu_bf16",
           "layer_norm_bwd_bf16", "add_layer_norm_bwd_bf16",
           "quick_gelu_bwd_bf16")


def launches_in_a_tower():
    """Launches of each kernel in one ViT-L/14-336 forward (24 layers, one
    image) under ``inference_mode``, and in a training step of the same
    tower: every layer but the last frozen, remat ``attn_kernel``, the
    backward of a loss on the last hidden state."""
    with torch.device("cuda"):
        tower = clip.CLIPVisionTower(VisionConfig(), dtype=torch.bfloat16,
                                     attn_impl="fused",
                                     remat="attn_kernel").eval()
    torch.nn.init.zeros_(tower.cls_token)
    torch.nn.init.zeros_(tower.pos_embed)
    for layer in tower.encoder.layers[:-1]:
        layer.requires_grad_(False)
    px = torch.randn(1, 336, 336, 3, device="cuda")
    kernels = [getattr(eltwise, name) for name in COUNTED]

    def inference():
        with torch.inference_mode():
            tower(px)

    def step():
        hidden, _ = tower(px)
        hidden.float().square().mean().backward()

    out = {}
    for mode, fn in (("inference", inference), ("training step", step)):
        before = [k.launches for k in kernels]
        fn()
        torch.cuda.synchronize()
        out[mode] = dict(zip(COUNTED, (k.launches - n
                                       for k, n in zip(kernels, before))))
    print(json.dumps({"launches_in_a_vitl_tower": out}), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch_eltwise: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale \
            + shift

    rows = []
    for label, m, d in ROWS:
        w, b = randn(d, scale=0.5, shift=1.0), randn(d, scale=0.5)
        wb, bb = w.bfloat16(), b.bfloat16()
        act = m * d * 2
        rows.append(measure(
            f"layer_norm_bf16 ({label})", (m, d),
            lambda x: eltwise.layer_norm_bf16(x, w, b, EPS),
            lambda x: eltwise.layer_norm_reference(x, w, b, EPS),
            lambda x: F.layer_norm(x, (d,), wb, bb, EPS),
            lambda i: (randn(m, d, scale=3.0, shift=1.0).bfloat16(),),
            2 * act, args.iters,
            floor=lambda x: cancellation_floor(x, w, b)))
        rows.append(measure(
            f"add_layer_norm_bf16 ({label})", (m, d),
            lambda x, a: eltwise.add_layer_norm_bf16(x, a, w, b, EPS),
            lambda x, a: eltwise.add_layer_norm_reference(x, a, w, b, EPS),
            None,
            lambda i: (randn(m, d, scale=3.0, shift=1.0).bfloat16(),
                       randn(m, d).bfloat16()),
            4 * act, args.iters,
            floor=lambda x, a: cancellation_floor(x + a, w, b)))
    for label, m, n in GELU:
        rows.append(measure(
            f"quick_gelu_bf16 ({label})", (m, n), eltwise.quick_gelu_bf16,
            eltwise.quick_gelu, None,
            lambda i: (randn(m, n, scale=4.0).bfloat16(),),
            2 * m * n * 2, args.iters))
    for label, m, d in ROWS[:2]:
        w, b = randn(d, scale=0.5, shift=1.0), randn(d, scale=0.5)
        act = m * d * 2

        def ln_inputs(i, m=m, d=d, w=w, b=b):
            x = randn(m, d, scale=3.0, shift=1.0).bfloat16()
            stats = torch.empty(2, m, device="cuda")
            eltwise.layer_norm_bf16(x, w, b, EPS, stats)
            return x, randn(m, d).bfloat16(), randn(m, d).bfloat16(), stats

        for trains in (False, True):
            rows.append(measure(
                f"layer_norm_bwd_bf16{' +dw,db' if trains else ''} "
                f"({label})", (m, d),
                lambda x, dy, ds, st, t=trains, w=w, b=b:
                    eltwise.layer_norm_bwd_bf16(x, dy, w, b, st, t)[0],
                lambda x, dy, ds, st, t=trains, w=w, b=b:
                    eltwise.layer_norm_backward_reference(
                        x, dy, w, b, st, t)[0],
                None, ln_inputs, 3 * act + 8 * m, args.iters,
                floor=lambda x, dy, ds, st, w=w: backward_floor(
                    x, dy, w, st)))
        rows.append(measure(
            f"add_layer_norm_bwd_bf16 ({label})", (m, d),
            lambda x, dy, ds, st, w=w, b=b: eltwise.add_layer_norm_bwd_bf16(
                x, ds, dy, w, b, st, False)[0],
            lambda x, dy, ds, st, w=w, b=b:
                eltwise.add_layer_norm_backward_reference(
                    x, ds, dy, w, b, st, False)[0],
            None, ln_inputs, 4 * act + 8 * m, args.iters,
            floor=lambda x, dy, ds, st, w=w: ds.float().abs() / 256
            + backward_floor(x, dy, w, st)))
    for label, m, n in GELU[:2]:
        rows.append(measure(
            f"quick_gelu_bwd_bf16 ({label})", (m, n),
            eltwise.quick_gelu_bwd_bf16, eltwise.quick_gelu_backward_reference,
            None,
            lambda i, m=m, n=n: (randn(m, n, scale=4.0).bfloat16(),
                                 randn(m, n).bfloat16()),
            3 * m * n * 2, args.iters))
    for label, m, inter, d in DINOV2:
        rows.append(measure(
            f"swiglu_bf16 ({label})", (m, inter), eltwise.swiglu_bf16,
            eltwise.swiglu, None,
            lambda i: (randn(m, 2 * inter, scale=4.0).bfloat16(),),
            3 * m * inter * 2, args.iters))
        w, b = randn(d, scale=0.5, shift=1.0), randn(d, scale=0.5)
        g = 0.05 + 0.95 * torch.rand(d, generator=gen, device="cuda")
        rows.append(measure(
            f"scale_add_layer_norm_bf16 ({label})", (m, d),
            lambda x, a: eltwise.scale_add_layer_norm_bf16(x, a, g, w, b,
                                                           EPS),
            lambda x, a: eltwise.scale_add_layer_norm_reference(
                x, a, g, w, b, EPS),
            None,
            lambda i: (randn(m, d, scale=3.0, shift=1.0).bfloat16(),
                       randn(m, d).bfloat16()),
            4 * m * d * 2, args.iters,
            floor=lambda x, a: cancellation_floor(
                eltwise.scale_add(x, a, g), w, b)))
    result = {"card": card.strip(), "rows": rows,
              "launches": launches_in_a_tower()}
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
