"""What the attention tuning drivers share (`scripts/bench_torch_attn_bwd.py`,
`scripts/bench_torch_attn_fwd_diag.py`, `scripts/bench_torch_attn_qkv_fused.py`):
the card they run on, seeded inputs made on it, the check of every
variant against its plain version before it is timed, and CUDA-event
timing as the median over windows.

A driver lists its variants under the TPU scripts' names. A variant runs
one or more of the port's kernels (its parts, each a wrapper with a
``launches`` counter and a plain PyTorch version); the driver checks the
variant's outputs against the plain versions' on the same inputs, then
times the variant and its plain version. A variant of several parts
(``split4``) times each part on its own as well.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from typing import Callable, Sequence

import torch

#: The TPU scripts' flagship shape: 32 views of ViT-L/14-336 (S = 577), 16
#: heads of 64 (BH = 512), and the model width of the QKV script.
BATCH, SEQ, HEADS, HEAD_DIM, WIDTH = 32, 577, 16, 64, 1024
#: An exact forward against its plain version: max abs error (the repo's
#: bf16 attention bound).
FWD_TOL = 3e-2
#: An exact backward against its plain version: each output's max abs
#: error over its max magnitude (K4's bound: u and dl are rounded to bf16
#: from f32 sums taken in another order).
BWD_TOL = 2e-2
#: A diagnostic against its plain version: each output's max abs error
#: over its max magnitude. Its outputs round f32 sums (scores, products,
#: row sums) to bf16 as the plain version does, in another order, and the
#: unscaled scores make them large (backward ``dots_only`` reaches ~4e3).
DIAG_TOL = 2e-2


@dataclasses.dataclass(frozen=True)
class Part:
    """One kernel of a variant: its wrapper's name (the key of its launch
    counter in `chip_smoke.py`), the call on the driver's inputs and its
    plain version's."""

    kernel: str
    fn: Callable
    plain: Callable


@dataclasses.dataclass(frozen=True)
class Variant:
    """A TPU script's variant in the port: ``parts`` run in turn, the
    outputs checked within ``tol`` (``relative``: over each output's max
    magnitude, else absolute)."""

    name: str
    parts: Sequence[Part]
    tol: float
    relative: bool
    note: str = ""

    def __call__(self):
        return [out for part in self.parts for out in outputs(part.fn())]

    def plain(self):
        return [out for part in self.parts for out in outputs(part.plain())]


def outputs(result) -> tuple:
    return result if isinstance(result, (tuple, list)) else (result,)


def card() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reports them; raises
    ``SystemExit`` without a CUDA device."""
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: the kernels run on the card "
                         "only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return smi.strip().splitlines()[torch.cuda.current_device()]


def normal(gen: torch.Generator, n: int, shape, scale: float = 1.0) -> list:
    """``n`` bf16 tensors of ``shape``, N(0, scale^2), made on the card
    from ``gen``."""
    return [(torch.randn(shape, generator=gen, device=gen.device) * scale)
            .bfloat16() for _ in range(n)]


def window_ms(fn: Callable, iters: int, windows: int,
              warmup: int = 2) -> float:
    """Median over ``windows`` of the CUDA-event milliseconds a call of
    ``iters`` back-to-back calls of ``fn``, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def errors(got: Sequence, want: Sequence) -> tuple:
    """``(max abs error, max relative error)`` over the outputs, relative
    meaning an output's max abs error over its max magnitude; raises on an
    output that is not finite or of another shape."""
    abs_err = rel_err = 0.0
    for i, (a, w) in enumerate(zip(got, want, strict=True)):
        if a.shape != w.shape:
            raise RuntimeError(f"output {i}: shape {tuple(a.shape)} != "
                               f"{tuple(w.shape)}")
        if not bool(torch.isfinite(a.float()).all()):
            raise RuntimeError(f"output {i} is not finite")
        err = (a.float() - w.float()).abs().max().item()
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / max(w.float().abs().max().item(),
                                         1e-30))
    return abs_err, rel_err


def check(variant: Variant) -> dict:
    """Each part's outputs against its plain version's; raises
    ``RuntimeError`` when one is off by more than the variant's tolerance.
    Returns ``{kernel: (max abs error, max relative error)}``."""
    errs = {}
    for part in variant.parts:
        got, want = outputs(part.fn()), outputs(part.plain())
        if got[0].is_cuda:
            torch.cuda.synchronize()
        abs_err, rel_err = errors(got, want)
        err = rel_err if variant.relative else abs_err
        if not err <= variant.tol:
            raise RuntimeError(
                f"{variant.name}: {part.kernel} disagrees with its plain "
                f"version: {'relative' if variant.relative else 'abs'} "
                f"error {err} (limit {variant.tol})")
        errs[part.kernel] = (abs_err, rel_err)
        del got, want
    return errs


def measure(variant: Variant, iters: int, windows: int) -> dict:
    """Check ``variant`` (`check`), then time it and its plain version;
    the record of one JSON line, without the driver's own comparisons."""
    errs = check(variant)
    ms = window_ms(variant, iters, windows)
    plain_ms = window_ms(variant.plain, iters, windows, warmup=1)
    kernels = []
    for part in variant.parts:
        abs_err, rel_err = errs[part.kernel]
        if len(variant.parts) > 1:
            part_ms = window_ms(part.fn, iters, windows)
            part_plain_ms = window_ms(part.plain, iters, windows, warmup=1)
        else:
            part_ms, part_plain_ms = ms, plain_ms
        kernels.append({"kernel": part.kernel, "ms": part_ms,
                        "plain_ms": part_plain_ms, "max_abs_err": abs_err,
                        "max_rel_err": rel_err})
    rec = {"variant": variant.name, "ms_per_call": ms, "plain_ms": plain_ms,
           "max_err_vs_plain": max(e[1] if variant.relative else e[0]
                                   for e in errs.values()),
           "tol": variant.tol, "relative": variant.relative,
           "kernels": kernels}
    if variant.note:
        rec["note"] = variant.note
    return rec


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def main(run: Callable, argv: Sequence[str] | None = None) -> int:
    """A driver's command line: ``--batch``, ``--iters``, ``--windows``;
    prints the card's line, then one JSON line per record of ``run``."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--windows", type=int, default=5)
    args = parser.parse_args(argv)
    print(card(), flush=True)
    run(args.batch, args.iters, args.windows, report=emit)
    sys.stdout.flush()
    return 0
