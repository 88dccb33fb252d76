#!/usr/bin/env python3
"""Attention-backward tuning variants of `pigeon_tpu_torch` on one GPU: the
port of `scripts/bench_attn_bwd.py`, under its variant names.

    python3 scripts/bench_torch_attn_bwd.py [--batch 32] [--iters 8] [--windows 5]

At the TPU script's flagship shape (32 views, S = 577, 16 heads of 64,
bf16; the port's (B, S, H, 64) layout) on seeded inputs made on the card:

  base_pack2, base_pack4          K4 (`attention.flash_attention_backward`)
  r_from_o_pack{2,4,1}            V1 `bwd_r_from_o`
  split4                          V2 `attention_dq`, then V3 `attention_dkv`
  diag_dots_only_p2               V4 `bwd_dots_only` (diagnostic)
  diag_vpu_only_p2                V5 `bwd_vpu_only` (diagnostic)

The pack is a TPU grid knob (sequences a grid step); the port runs the
same kernel at every pack and times each name. Every variant, the
diagnostics too, is checked against its plain version on the same inputs
before it is timed; the exact ones are also compared with the autograd
VJP of the einsum attention the TPU script takes as its reference
(`flash_attention.py::_xla_attention_bshd`), on the first view, as
``max_err_vs_xla``. Times are CUDA-event medians over windows. PyTorch's
``scaled_dot_product_attention`` backward is timed as a yardstick, never a
variant, and so is V4's ``dots_only_composition`` (its five products as
cuBLAS calls). The first line is the card's name and power limit, then one JSON
line per variant. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PACK_NOTE = "pack is a TPU grid knob: the same kernel as at any other pack"


def xla_attention(q, k, v):
    """The TPU script's reference (`flash_attention.py::_xla_attention_bshd`)
    on ``(B, S, H, dh)``: bf16 products, the softmax in f32 rounded to
    bf16."""
    import torch

    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = (qh @ kh.transpose(-1, -2)) * q.shape[-1] ** -0.5
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    return (probs @ vh).transpose(1, 2)


def xla_grads(q, k, v, g):
    """``(dq, dk, dv)`` of `xla_attention` by autograd."""
    import torch

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(xla_attention(*leaves), leaves, g)


def variants(q, k, v, g) -> list:
    """The script's variants on the port's kernels, in its order."""
    from pigeon_tpu_torch import tuning
    from pigeon_tpu_torch.kernels import attention as k34
    from pigeon_tpu_torch.kernels import attention_bwd_variants as bv

    def part(kernel, fn, plain):
        return tuning.Part(kernel, lambda: fn(q, k, v, g),
                           lambda: plain(q, k, v, g))

    k4 = part("flash_attention_bwd", k34.flash_attention_backward,
              k34.flash_attention_backward_reference)
    v1 = part("bwd_r_from_o", bv.bwd_r_from_o, bv.bwd_r_from_o_reference)
    v2 = part("attention_dq", bv.attention_dq, bv.attention_dq_reference)
    v3 = part("attention_dkv", bv.attention_dkv, bv.attention_dkv_reference)
    v4 = part("bwd_dots_only", bv.bwd_dots_only,
              bv.bwd_dots_only_reference)
    v5 = part("bwd_vpu_only", bv.bwd_vpu_only, bv.bwd_vpu_only_reference)

    def exact(name, parts, note=""):
        return tuning.Variant(name, parts, tuning.BWD_TOL, True, note)

    def diag(name, parts):
        return tuning.Variant(name, parts, tuning.DIAG_TOL, True,
                              "diagnostic")

    return [exact("base_pack2", [k4]),
            exact("base_pack4", [k4], PACK_NOTE),
            exact("r_from_o_pack2", [v1]),
            exact("r_from_o_pack4", [v1], PACK_NOTE),
            exact("r_from_o_pack1", [v1], PACK_NOTE),
            exact("split4", [v2, v3]),
            diag("diag_dots_only_p2", [v4]),
            diag("diag_vpu_only_p2", [v5])]


def sdpa_backward_ms(q, k, v, g, iters: int, windows: int) -> float:
    """PyTorch's fused attention backward on the same values in its
    (B, H, S, dh) layout: the yardstick."""
    import torch

    from pigeon_tpu_torch import tuning

    leaves = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves)
    gt = g.transpose(1, 2).contiguous()
    return tuning.window_ms(
        lambda: torch.autograd.grad(out, leaves, gt, retain_graph=True),
        iters, windows)


def dots_only_composition(q, k, v, g):
    """V4's five products as library calls in the (B, H, S, dh) layout,
    the scores rounded to bf16 by the product: ``s = q k^T``, ``dv = s^T
    g``, ``dl = s (g v^T)``, ``dq = dl k``, ``dk = dl^T q``; ``(dq, dk,
    dv)`` in (B, S, H, dh). A yardstick of V4's time, never a variant."""
    qh, kh, vh, gh = (t.transpose(1, 2) for t in (q, k, v, g))
    s = qh @ kh.transpose(-1, -2)
    dv = s.transpose(-1, -2) @ gh
    dl = s * (gh @ vh.transpose(-1, -2))
    return tuple(t.transpose(1, 2) for t in (dl @ kh,
                                             dl.transpose(-1, -2) @ qh, dv))


def run(batch: int = 32, iters: int = 8, windows: int = 5, *,
        report=None) -> list:
    """Check and time every variant at ``batch`` views; one record a
    variant, then the yardsticks'. ``report`` is called with each record
    as it is made."""
    import torch

    from pigeon_tpu_torch import tuning

    tuning.card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = tuning.normal(
        gen, 4, (batch, tuning.SEQ, tuning.HEADS, tuning.HEAD_DIM))
    first = [t[:1] for t in (q, k, v, g)]
    xla = xla_grads(*first)
    records = []
    for variant in variants(q, k, v, g):
        rec = tuning.measure(variant, iters, windows)
        if variant.note != "diagnostic":
            got = variant()
            rec["max_err_vs_xla"] = max(
                (a[:1].float() - w.float()).abs().max().item()
                for a, w in zip(got, xla))
            del got
        records.append(rec)
        if report:
            report(rec)
    for rec in ({"yardstick": "sdpa_backward",
                 "ms_per_call": sdpa_backward_ms(q, k, v, g, iters, windows)},
                {"yardstick": "dots_only_composition",
                 "ms_per_call": tuning.window_ms(
                     lambda: dots_only_composition(q, k, v, g), iters,
                     windows)}):
        records.append(rec)
        if report:
            report(rec)
    return records


if __name__ == "__main__":
    from pigeon_tpu_torch import tuning

    sys.exit(tuning.main(run))
