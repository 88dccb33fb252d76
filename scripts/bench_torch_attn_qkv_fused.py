#!/usr/bin/env python3
"""QKV-projection + attention fusion of `pigeon_tpu_torch` on one GPU: the
port of `scripts/bench_attn_qkv_fused.py`, under its variant names.

    python3 scripts/bench_torch_attn_qkv_fused.py [--batch 32] [--iters 8] [--windows 5]

At the TPU script's flagship shape (x (32, 577, 1024) bf16, 16 heads of
64, seeded weights in the port's (out, in) layout) on inputs made on the
card:

  baseline_xla_proj_flash   ``F.linear`` projections (+ bias), then K3
                            (`attention.flash_attention`)
  fused                     K1 (`fused_qkv_attention`): the script's
                            ``qkv_attn_kernel`` line for line. Its groups
                            (fused_g2/g4/g8) are a TPU VMEM knob, which the
                            port does not have: one kernel, printed once
  ln_xla_then_fused         Flax-form LayerNorm in PyTorch, then K1
  ln_fused_in_kernel        K5 (`fused_ln_qkv_attention`)

Every variant is checked against its plain version on the same inputs
before it is timed, and against its family's first variant (the
projections outside a kernel) on the first four views, as
``max_err_vs_base`` (within 5e-2, as the TPU script asserts). Times are
CUDA-event medians over windows. ``F.linear`` projections followed by
PyTorch's ``scaled_dot_product_attention`` are timed as a yardstick, never
a variant. The first line is the card's name and power limit, then one
JSON line per variant. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: K5 against its plain version: max abs error over the output's max
#: magnitude (`chip_smoke.py`'s K5 bound).
LN_TOL = 2e-2
#: A variant against its family's first one (the TPU script's bound).
FAMILY_TOL = 5e-2
EPS = 1e-5
GROUPS_NOTE = ("the script's fused_g2/g4/g8: groups (PIGEON_FUSED_GROUPS) "
               "is a TPU VMEM knob, one kernel here")


def projected(x, w, b, heads: int):
    """``F.linear`` of x (B, S, D), as (B, S, H, 64)."""
    import torch

    y = torch.nn.functional.linear(x, w, b)
    return y.view(*x.shape[:2], heads, -1)


def variants(x, ls, lb, ws, bs, heads: int) -> list:
    """The script's variants on the port's kernels, in its order."""
    from pigeon_tpu_torch import tuning
    from pigeon_tpu_torch.kernels import attention as k34
    from pigeon_tpu_torch.kernels import fused_ln_qkv_attention as k5
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1

    def baseline(attend):
        out = attend(*(projected(x, w, b, heads) for w, b in zip(ws, bs)))
        return out.reshape(*x.shape[:2], -1)

    def normed():
        return k5.flax_layer_norm_f32(x, ls, lb, EPS).to(x.dtype)

    return [
        tuning.Variant("baseline_xla_proj_flash", [tuning.Part(
            "flash_attention", lambda: baseline(k34.flash_attention),
            lambda: baseline(k34.flash_attention_reference))],
            tuning.FWD_TOL, False),
        tuning.Variant("fused", [tuning.Part(
            "fused_qkv_attention",
            lambda: k1.fused_qkv_attention(x, *ws, *bs, heads),
            lambda: k1.fused_qkv_attention_reference(x, *ws, *bs, heads))],
            tuning.FWD_TOL, False, GROUPS_NOTE),
        tuning.Variant("ln_xla_then_fused", [tuning.Part(
            "fused_qkv_attention",
            lambda: k1.fused_qkv_attention(normed(), *ws, *bs, heads),
            lambda: k1.fused_qkv_attention_reference(normed(), *ws, *bs,
                                                     heads))],
            tuning.FWD_TOL, False),
        tuning.Variant("ln_fused_in_kernel", [tuning.Part(
            "fused_ln_qkv_attention",
            lambda: k5.fused_ln_qkv_attention(x, ls, lb, *ws, *bs, heads,
                                              EPS),
            lambda: k5.fused_ln_qkv_attention_reference(
                x, ls, lb, *ws, *bs, heads, EPS))],
            LN_TOL, True),
    ]


def run(batch: int = 32, iters: int = 8, windows: int = 5, *,
        report=None) -> list:
    """Check and time every variant at ``batch`` views; one record a
    variant, then the yardstick's. ``report`` is called with each record
    as it is made. K3 runs its monolithic body whatever
    ``PIGEON_FLASH_FWD`` says."""
    import torch

    from pigeon_tpu_torch import tuning

    tuning.card()
    d, heads = tuning.WIDTH, tuning.HEADS
    gen = torch.Generator(device="cuda").manual_seed(0)
    (x,) = tuning.normal(gen, 1, (batch, tuning.SEQ, d))
    ws = tuning.normal(gen, 3, (d, d), 0.02)
    bs = tuning.normal(gen, 3, (d,), 0.02)
    ls = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    lb = 0.1 * torch.randn(d, generator=gen, device="cuda")
    records, base = [], {}
    with mock.patch.dict(os.environ, {"PIGEON_FLASH_FWD": "monolithic"}):
        for variant in variants(x, ls, lb, ws, bs, heads):
            rec = tuning.measure(variant, iters, windows)
            family = "ln" if variant.name.startswith("ln_") else "plain"
            out = variant()[0][:4].float()
            if family not in base:
                base[family] = out
            else:
                err = (out - base[family]).abs().max().item()
                if not err < FAMILY_TOL:
                    raise RuntimeError(f"{variant.name} parity {err}")
                rec["max_err_vs_base"] = err
            del out
            records.append(rec)
            if report:
                report(rec)

    def sdpa():
        qkv = [projected(x, w, b, heads).transpose(1, 2)
               for w, b in zip(ws, bs)]
        out = torch.nn.functional.scaled_dot_product_attention(*qkv)
        return out.transpose(1, 2).reshape(*x.shape[:2], -1)

    rec = {"yardstick": "linear_then_sdpa_forward",
           "ms_per_call": tuning.window_ms(sdpa, iters, windows)}
    records.append(rec)
    if report:
        report(rec)
    return records


if __name__ == "__main__":
    from pigeon_tpu_torch import tuning

    sys.exit(tuning.main(run))
