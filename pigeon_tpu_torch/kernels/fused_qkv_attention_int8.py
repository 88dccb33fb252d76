"""Int8 fused QKV projection + attention (kernel K8), for the H100.

K8 replaces `pigeon_tpu/kernels/flash_attention.py::_fused_qkv_int8_kernel`,
reached through `fused_qkv_mha_int8` once per encoder layer of an int8
(static-quant) tower on the `flash_fused` route: every layer of every
``serve --quant`` request. It is CUDA C++ for ``sm_90a``
(`csrc/fused_qkv_attention_int8.cu`: K1's two stages on int8 operands,
the `wgmma` GEMM with s8 products and a dequant epilogue projecting q/k/v
into (B, S, P) workspaces, then K3's streaming forward on them), built by
``nvcc`` at first use and bound with ``ctypes``; the source note says what
bounds it on the card and how the design answers that.

Weights are int8 in ``torch.nn.Linear`` layout, ``(P, D)`` with
``P = H * 64``; scales and biases f32 ``(P,)``. As in the JAX wrapper, x
is quantized here at the shared per-tensor ``act_scale`` (a plain torch
op, XLA's in the JAX package) and ``act_scale`` is folded into the
per-channel weight scales (:func:`fold_scales`), so the kernel takes no
scalar.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (:func:`fused_qkv_attention_int8_reference`, which the CPU tests
hold against the JAX package); a CUDA tensor launches the kernel or
raises. Forward only: the int8 tower serves and is never trained.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pigeon_tpu_torch import native
from pigeon_tpu_torch.kernels.attention import flash_attention_reference
from pigeon_tpu_torch.kernels.fused_qkv_attention import (
    GEMM_TILE,
    HEAD_DIM,
    ForwardWorkspaces,
    forward_workspaces,
)
from pigeon_tpu_torch.models.quant import int8_matmul, quantize_static


def fold_scales(act_scale, scales) -> list:
    """The per-channel dequant scales with the activation scale folded in,
    ``act_scale * f32(s)`` for each ``s``, contiguous f32 (the JAX
    wrappers' ``fold`` and ``sv_vec``)."""
    return [(act_scale * s.float()).contiguous() for s in scales]


def fused_qkv_attention_int8_reference(x, act_scale, wq, sq, bq, wk, sk, bk,
                                       wv, sv, bv, num_heads: int):
    """Plain PyTorch K8: ``(B, S, D) -> (B, S, P)`` in ``x.dtype``, heads
    concatenated.

    The arithmetic of `flash_attention.py::fused_qkv_mha_int8`:
    ``x_q = clip(round(f32(x) / act_scale), +-127)``; each projection
    ``y = f32(x_q @ W^T) * (act_scale * s) + b`` with the int8 product
    summed in int32 and the scale product formed first, rounded to
    ``x.dtype``; then K3's attention (`flash_attention_reference`).
    """
    b, s, _ = x.shape
    p = wq.shape[0]
    act_scale = torch.as_tensor(act_scale, dtype=torch.float32,
                                device=x.device)
    x_q = quantize_static(x, act_scale)

    def proj(w, scale, bias):
        y = (int8_matmul(x_q, w).float() * (act_scale * scale.float())
             + bias.float())
        return y.to(x.dtype).view(b, s, num_heads, p // num_heads)

    return flash_attention_reference(
        proj(wq, sq, bq), proj(wk, sk, bk), proj(wv, sv, bv)).reshape(b, s, p)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("fused_qkv_attention_int8").path)
    ptr = ctypes.c_void_p
    lib.pigeon_fused_qkv_attention_int8.argtypes = [ptr] * 14 + [
        ctypes.c_int] * 4 + [ptr]
    lib.pigeon_fused_qkv_attention_int8.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(x, x_q, weights, scales, biases, num_heads: int):
    """K8's operands: any S, D and P multiples of `GEMM_TILE` (the int8
    GEMM's tiles), head_dim 64."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got {tuple(x.shape)}")
    b, s, d = x.shape
    p = num_heads * HEAD_DIM
    if d % GEMM_TILE or p % GEMM_TILE:
        raise ValueError(f"D={d} and P={p} must be multiples of {GEMM_TILE} "
                         "(an even head count)")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x: dtype {x.dtype}, kernel writes bf16")
    for name, t, shape, dtype in (
            [("x_q", x_q, (b, s, d), torch.int8)]
            + [(f"w{n}", w, (p, d), torch.int8)
               for n, w in zip("qkv", weights)]
            + [(f"s{n}", sc, (p,), torch.float32)
               for n, sc in zip("qkv", scales)]
            + [(f"b{n}", bb, (p,), torch.float32)
               for n, bb in zip("qkv", biases)]):
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)} != {shape} (H={num_heads}, "
                f"head_dim must be {HEAD_DIM})")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def fused_qkv_attention_int8(x, act_scale, wq, sq, bq, wk, sk, bk, wv, sv,
                             bv, num_heads: int):
    """K8: int8 q/k/v projection + softmax attention, ``(B, S, D) ->
    (B, S, P)`` before the output projection.

    ``x`` float activations; ``act_scale`` the f32 per-tensor input scale;
    ``w*`` int8 ``(P, D)``; ``s*``, ``b*`` f32 ``(P,)``. CPU tensors run
    the plain version; CUDA tensors (x bf16, head_dim 64, D and P
    multiples of 128, any S) launch the kernel's two stages (the int8
    projection GEMM into K1's :func:`forward_workspaces`, allocated here
    on every call, then K3's streaming forward) on PyTorch's current
    stream and count one launch in ``fused_qkv_attention_int8.launches``;
    any other device raises.
    """
    if x.device.type == "cpu":
        return fused_qkv_attention_int8_reference(
            x, act_scale, wq, sq, bq, wk, sk, bk, wv, sv, bv, num_heads)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_qkv_attention_int8: no kernel for {x.device}")
    act_scale = torch.as_tensor(act_scale, dtype=torch.float32,
                                device=x.device)
    x_q = quantize_static(x, act_scale)
    folded = fold_scales(act_scale, (sq, sk, sv))
    _check_operands(x, x_q, (wq, wk, wv), folded, (bq, bk, bv), num_heads)
    lib = load()
    b, s, d = x.shape
    ws: ForwardWorkspaces = forward_workspaces(x, num_heads)
    out = torch.empty_like(ws.q)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pigeon_fused_qkv_attention_int8(
            *(t.data_ptr() for t in (x_q, wq, wk, wv, *folded, bq, bk, bv,
                                     out, *ws)),
            b, s, d, num_heads, stream)
    if rc != 0:
        raise RuntimeError(
            "fused_qkv_attention_int8 launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    fused_qkv_attention_int8.launches += 1
    return out


fused_qkv_attention_int8.launches = 0
