#!/usr/bin/env python3
"""Attention-forward floor diagnostics of `pigeon_tpu_torch` on one GPU: the
port of `scripts/bench_attn_fwd_diag.py`, under its variant names.

    python3 scripts/bench_torch_attn_fwd_diag.py [--batch 32] [--iters 8] [--windows 5]

At the TPU script's flagship shape (32 views, S = 577, 16 heads of 64,
bf16; the port's (B, S, H, 64) layout) on seeded inputs made on the card:

  base_fwd_pack4                  K3 (`attention.flash_attention`)
  diag_dots_only_p4               V6 `fwd_dots_only`
  diag_softmax_only_p4            V7 `fwd_softmax_only`
  diag_qk_only_p4                 V8 `fwd_qk_only`
  diag_qk_chunked_p4              V9 `fwd_qk_chunked`
  online_softmax_p{4,8}_c128      K3′ (`attention.flash_attention_online`:
                                  the script's body at chunk 128 is K3′'s)
  online_softmax_p4_c256          V10 `flash_attention_online_c256`

The pack is a TPU grid knob; the port runs the same kernel at every pack
and times each name. Every variant, the diagnostics too, is checked
against its plain version on the same inputs before it is timed; the
exact ones are also compared with K3's output on the first view, as
``max_err_vs_base`` (within 3e-2, as the TPU script asserts), and V7 once
more with v = 0 (`softmax_only_without_v`). Times are
CUDA-event medians over windows. PyTorch's ``scaled_dot_product_attention``
forward is timed as a yardstick, never a variant, and so is each
diagnostic's function composed of library calls (`COMPOSITIONS`, V6-V9:
bf16 matmuls, ``softmax``, slices and sums), after a check against the
diagnostic's plain version. The first line is the card's name and power
limit, then one JSON line per variant. Without a CUDA device it exits
non-zero.
"""

from __future__ import annotations

import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PACK_NOTE = "pack is a TPU grid knob: the same kernel as at any other pack"


def _heads(*tensors):
    return (t.transpose(1, 2) for t in tensors)


def dots_only_composition(q, k, v):
    """V6 as library calls: two bf16 ``torch.matmul``, ``bf16(bf16(q k^T)
    v)``, in (B, S, H, dh)."""
    qh, kh, vh = _heads(q, k, v)
    return ((qh @ kh.transpose(-1, -2)) @ vh).transpose(1, 2)


def softmax_only_composition(q, k, v):
    """V7 as library calls: ``q k^T`` by a bf16 matmul, the f32 scale and
    ``softmax``, its first 64 columns plus v."""
    qh, kh, vh = _heads(q, k, v)
    s = (qh @ kh.transpose(-1, -2)).float() * q.shape[-1] ** -0.5
    out = s.softmax(-1)[..., :q.shape[-1]] + vh
    return out.to(q.dtype).transpose(1, 2)


def qk_only_composition(q, k, v):
    """V8 as library calls: a bf16 matmul, its first 64 columns plus v,
    and each row's f32 sum: ``(out, rowsum)``."""
    import torch

    qh, kh, vh = _heads(q, k, v)
    s = qh @ kh.transpose(-1, -2)
    return ((s[..., :q.shape[-1]] + vh).transpose(1, 2),
            s.sum(-1, dtype=torch.float32))


def qk_chunked_composition(q, k, v):
    """V9 as library calls: a bf16 matmul and each row's f32 sum, plus
    v."""
    import torch

    qh, kh, vh = _heads(q, k, v)
    acc = (qh @ kh.transpose(-1, -2)).sum(-1, keepdim=True,
                                          dtype=torch.float32)
    return (acc + vh).to(q.dtype).transpose(1, 2)


def softmax_only_without_v(q, k) -> dict:
    """V7 against its plain version with v = 0, where its output is p / den
    alone; raises past the diagnostics' bound of p / den's own magnitude.
    With v ~ N(0, 1) p / den (about 1e-3) sits mostly below v's bf16
    rounding, so V7's own check barely sees a p of keys 0-63 that missed
    the later chunks' corr (e^(m - m0) too large, m0 chunk 0's max); this
    one reads such a p far past its bound (`tests/test_torch_variants.py`
    holds a model of it). One JSON record."""
    import torch

    from pigeon_tpu_torch import tuning
    from pigeon_tpu_torch.kernels import attention_fwd_variants as fv

    v = torch.zeros_like(q)
    want = fv.fwd_softmax_only_reference(q, k, v)
    err, rel = tuning.errors([fv.fwd_softmax_only(q, k, v)], [want])
    if not rel <= tuning.DIAG_TOL:
        raise RuntimeError(f"fwd_softmax_only with v = 0 disagrees with its "
                           f"plain version: relative error {rel} (limit "
                           f"{tuning.DIAG_TOL})")
    return {"check": "fwd_softmax_only_v_zero", "max_abs_err": err,
            "max_err_vs_plain": rel, "tol": tuning.DIAG_TOL,
            "max_magnitude": want.float().abs().max().item()}


#: The diagnostics' yardsticks: each one's function in library calls, by
#: its kernel's name; timed as ``<kernel>_composition`` after a check
#: against the kernel's plain version.
COMPOSITIONS = {"fwd_dots_only": dots_only_composition,
                "fwd_softmax_only": softmax_only_composition,
                "fwd_qk_only": qk_only_composition,
                "fwd_qk_chunked": qk_chunked_composition}


def variants(q, k, v) -> list:
    """The script's variants on the port's kernels, in its order."""
    from pigeon_tpu_torch import tuning
    from pigeon_tpu_torch.kernels import attention as k34
    from pigeon_tpu_torch.kernels import attention_fwd_variants as fv

    def part(kernel, fn, plain):
        return tuning.Part(kernel, lambda: fn(q, k, v),
                           lambda: plain(q, k, v))

    def exact(name, p, note=""):
        return tuning.Variant(name, [p], tuning.FWD_TOL, False, note)

    def diag(name, p):
        return tuning.Variant(name, [p], tuning.DIAG_TOL, True, "diagnostic")

    k3p = part("flash_attention_online", k34.flash_attention_online,
               k34.flash_attention_online_reference)
    return [
        exact("base_fwd_pack4", part("flash_attention", k34.flash_attention,
                                     k34.flash_attention_reference)),
        diag("diag_dots_only_p4", part("fwd_dots_only", fv.fwd_dots_only,
                                       fv.fwd_dots_only_reference)),
        diag("diag_softmax_only_p4", part(
            "fwd_softmax_only", fv.fwd_softmax_only,
            fv.fwd_softmax_only_reference)),
        diag("diag_qk_only_p4", part("fwd_qk_only", fv.fwd_qk_only,
                                     fv.fwd_qk_only_reference)),
        diag("diag_qk_chunked_p4", part("fwd_qk_chunked", fv.fwd_qk_chunked,
                                        fv.fwd_qk_chunked_reference)),
        exact("online_softmax_p4_c128", k3p,
              "the script's body at chunk 128 is K3′'s"),
        exact("online_softmax_p8_c128", k3p, PACK_NOTE),
        exact("online_softmax_p4_c256", part(
            "flash_attention_online_c256", fv.flash_attention_online_c256,
            fv.flash_attention_online_c256_reference)),
    ]


def run(batch: int = 32, iters: int = 8, windows: int = 5, *,
        report=None) -> list:
    """Check and time every variant at ``batch`` views; one record a
    variant, then V7's check with v = 0, then the yardsticks'. ``report`` is called with each record
    as it is made. K3 runs its monolithic body whatever
    ``PIGEON_FLASH_FWD`` says."""
    import torch

    from pigeon_tpu_torch import tuning
    from pigeon_tpu_torch.kernels import attention_fwd_variants as fv

    tuning.card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = tuning.normal(
        gen, 3, (batch, tuning.SEQ, tuning.HEADS, tuning.HEAD_DIM))
    records, base = [], None

    def add(rec):
        records.append(rec)
        if report:
            report(rec)

    with mock.patch.dict(os.environ, {"PIGEON_FLASH_FWD": "monolithic"}):
        for variant in variants(q, k, v):
            rec = tuning.measure(variant, iters, windows)
            if variant.name == "base_fwd_pack4":
                base = variant()[0][:1].float()
            elif variant.note != "diagnostic":
                err = (variant()[0][:1].float() - base).abs().max().item()
                if not err < tuning.FWD_TOL:
                    raise RuntimeError(f"{variant.name} parity {err}")
                rec["max_err_vs_base"] = err
            add(rec)
        add(softmax_only_without_v(q, k))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    add({"yardstick": "sdpa_forward", "ms_per_call": tuning.window_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
        iters, windows)})
    for kernel, composition in COMPOSITIONS.items():
        name = f"{kernel}_composition"
        err = tuning.errors(
            tuning.outputs(composition(q, k, v)),
            tuning.outputs(getattr(fv, f"{kernel}_reference")(q, k, v)))[1]
        if not err <= tuning.DIAG_TOL:
            raise RuntimeError(f"{name} disagrees with {kernel}'s plain "
                               f"version: relative error {err} (limit "
                               f"{tuning.DIAG_TOL})")
        add({"yardstick": name, "max_err_vs_plain": err,
             "ms_per_call": tuning.window_ms(
                 lambda c=composition: c(q, k, v), iters, windows)})
    return records


if __name__ == "__main__":
    from pigeon_tpu_torch import tuning

    sys.exit(tuning.main(run))
