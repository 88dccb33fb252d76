"""The attention-forward tuning variants of `scripts/bench_attn_fwd_diag.py`
(kernels V6-V10), for the H100.

Each replaces one Pallas body of that TPU script, on the port's
``(B, S, H, 64)`` q/k/v layout (K3's, `kernels/attention.py`):

- V10 :func:`flash_attention_online_c256` (`online_softmax` at
  ``chunk=256``): exact attention, K3′'s online softmax over 256-key
  chunks; at ``chunk=128`` the script's body is K3′ itself
  (`attention.flash_attention_online`);
- V6 :func:`fwd_dots_only` (`dots_only`), V7 :func:`fwd_softmax_only`
  (`softmax_only`), V8 :func:`fwd_qk_only` (`qk_only`) and V9
  :func:`fwd_qk_chunked` (`qk_chunked`): diagnostics that drop the
  softmax, the PV product or the (S, S) block from K3's body.

All are CUDA C++ for ``sm_90a`` in `csrc/attention_fwd_variants.cu`,
built by ``nvcc`` at first use and bound with ``ctypes``; the source note
says what bounds each on the card and how the designs answer that. All
five run K3's streaming ``wgmma`` forward (`csrc/flash_fwd_sm90.cuh`)
under tags of their own: V10 with 256-key softmax steps, each taking two
of its 128-key K/V stages and one max over both before any exp; V6 with
casts for the softmax chain (``CastChain``: p = bf16(s), o undivided);
V7 without the P V product (``PV = false``: o keeps p of keys 0-63,
rescaled as K3 rescales o, and is written as ``o / l + v``); V8 and V9
as one walk of Q K^T without P V under ``SumChain``, which only sums
each row's scores into l (V8: o keeps the raw scores of keys 0-63,
written as ``bf16(bf16(o) + v)``, and l goes to ``rowsum``; V9: ``l +
v`` in every column). The TPU script times them; on the card
`scripts/bench_torch_attn_fwd_diag.py` does.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (``*_reference``, the arithmetic of the TPU body, which the CPU
tests hold against the script's own body in interpret mode); a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pigeon_tpu_torch import native
from pigeon_tpu_torch.kernels.attention import (
    HEAD_DIM,
    _check_operands,
    flash_attention_online_reference,
)

#: V10's keys per online-softmax step (the script's ``chunk=256``).
CHUNK_256 = 256


def _heads(*tensors):
    return tuple(t.transpose(1, 2).float() for t in tensors)


def _tokens(t):
    return t.transpose(1, 2).contiguous()


def flash_attention_online_c256_reference(q, k, v):
    """Plain V10: K3′'s arithmetic at 256-key chunks
    (`attention.flash_attention_online_reference`, ``chunk=256``)."""
    return flash_attention_online_reference(q, k, v, chunk=CHUNK_256)


def fwd_dots_only_reference(q, k, v):
    """Plain V6 (`scripts/bench_attn_fwd_diag.py::dots_only`):
    ``bf16(bf16(q k^T) v)``, the scores unscaled, no softmax."""
    dt = q.dtype
    qh, kh, vh = _heads(q, k, v)
    s = (qh @ kh.transpose(-1, -2)).to(dt).float()
    return _tokens((s @ vh).to(dt))


def fwd_softmax_only_reference(q, k, v):
    """Plain V7 (`softmax_only`): ``bf16(p[:, :64] / den + v)`` with
    ``p = exp(s - max s)`` of the scaled f32 scores and ``den`` its row sum
    over all keys. Needs S >= 64."""
    dt = q.dtype
    qh, kh, vh = _heads(q, k, v)
    logits = (qh @ kh.transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = p[..., :HEAD_DIM] / p.sum(-1, keepdim=True) + vh
    return _tokens(out.to(dt))


def fwd_qk_only_reference(q, k, v):
    """Plain V8 (`qk_only`): ``(out, rowsum)``, ``out = bf16(bf16(q
    k^T)[:, :64] + v)`` and ``rowsum`` ``(B, H, S)`` f32 each row's sum of
    ``q k^T`` over all keys (the side output that keeps the kernel's
    S-wide product alive). Needs S >= 64."""
    dt = q.dtype
    qh, kh, vh = _heads(q, k, v)
    s = qh @ kh.transpose(-1, -2)
    out = (s[..., :HEAD_DIM].to(dt).float() + vh).to(dt)
    return _tokens(out), s.sum(-1)


def fwd_qk_chunked_reference(q, k, v, chunk: int = 128):
    """Plain V9 (`qk_chunked`): ``bf16(acc + v)`` with ``acc`` each row's
    sum of ``q k^T``, taken over ``chunk``-key steps as the TPU body
    does."""
    dt = q.dtype
    qh, kh, vh = _heads(q, k, v)
    acc = torch.zeros(qh.shape[:-1] + (1,), device=q.device)
    for c0 in range(0, q.shape[1], chunk):
        acc = acc + (qh @ kh[:, :, c0:c0 + chunk].transpose(-1, -2)).sum(
            -1, keepdim=True)
    return _tokens((acc + vh).to(dt))


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the variants' library."""
    lib = ctypes.CDLL(native.build_cuda("attention_fwd_variants").path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptrs in (("online_c256", 4), ("fwd_dots_only", 4),
                       ("fwd_softmax_only", 4), ("fwd_qk_only", 5),
                       ("fwd_qk_chunked", 4)):
        entry = getattr(lib, f"pigeon_attention_{fn}")
        entry.argtypes = [ptr] * n_ptrs + [i32] * 3 + [ptr]
        entry.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(q, k, v, min_seq: int = 1) -> None:
    """Raise unless q/k/v are operands the CUDA variants take: K3's
    (`attention._check_operands`) and S >= ``min_seq``."""
    _check_operands(q, k, v, max_seq=q.shape[1])
    if q.shape[1] < min_seq:
        raise ValueError(f"S={q.shape[1]} below {min_seq}: the TPU body "
                         f"slices {min_seq} key columns")


def _run(name: str, q, k, v, *extra, min_seq: int = 1):
    """Check q/k/v, launch ``pigeon_attention_<name>`` into a new output
    (and ``extra`` side outputs) on q's current stream; returns the
    output."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    check_operands(q, k, v, min_seq)
    lib = load()
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"pigeon_attention_{name}")(
            *(t.data_ptr() for t in (q, k, v, out, *extra)), b, s, h, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.pigeon_cuda_error_string(rc).decode()} "
                           f"(CUDA error {rc})")
    return out


def flash_attention_online_c256(q, k, v):
    """V10: exact attention, online softmax over 256-key chunks; CPU
    tensors run :func:`flash_attention_online_c256_reference`."""
    if q.device.type == "cpu":
        return flash_attention_online_c256_reference(q, k, v)
    out = _run("online_c256", q, k, v)
    flash_attention_online_c256.launches += 1
    return out


flash_attention_online_c256.launches = 0


def fwd_dots_only(q, k, v):
    """V6 (diagnostic); CPU tensors run :func:`fwd_dots_only_reference`."""
    if q.device.type == "cpu":
        return fwd_dots_only_reference(q, k, v)
    out = _run("fwd_dots_only", q, k, v)
    fwd_dots_only.launches += 1
    return out


fwd_dots_only.launches = 0


def fwd_softmax_only(q, k, v):
    """V7 (diagnostic); CPU tensors run
    :func:`fwd_softmax_only_reference`. Needs S >= 64."""
    if q.device.type == "cpu":
        return fwd_softmax_only_reference(q, k, v)
    out = _run("fwd_softmax_only", q, k, v, min_seq=HEAD_DIM)
    fwd_softmax_only.launches += 1
    return out


fwd_softmax_only.launches = 0


def fwd_qk_only(q, k, v):
    """V8 (diagnostic): ``(out, rowsum)``; CPU tensors run
    :func:`fwd_qk_only_reference`. Needs S >= 64."""
    if q.device.type == "cpu":
        return fwd_qk_only_reference(q, k, v)
    b, s, h, _ = q.shape
    rowsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    out = _run("fwd_qk_only", q, k, v, rowsum, min_seq=HEAD_DIM)
    fwd_qk_only.launches += 1
    return out, rowsum


fwd_qk_only.launches = 0


def fwd_qk_chunked(q, k, v):
    """V9 (diagnostic); CPU tensors run :func:`fwd_qk_chunked_reference`."""
    if q.device.type == "cpu":
        return fwd_qk_chunked_reference(q, k, v)
    out = _run("fwd_qk_chunked", q, k, v)
    fwd_qk_chunked.launches += 1
    return out


fwd_qk_chunked.launches = 0
