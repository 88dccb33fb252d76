"""The int8 attention half of a block in one call (kernel K7), for the
H100.

K7 replaces `pigeon_tpu/kernels/flash_attention.py::_block_attn_int8_kernel`
(launcher and entry `fused_block_attention_int8`), reached once per
encoder layer of a static int8 tower under
``PIGEON_QUANT_ATTN_IMPL=flash_fused_block``: LN1, the shared-scale
quantize, the int8 q/k/v products, bf16 attention, the quantize of the
attention output, the int8 out-projection and the residual. It is CUDA
C++ for ``sm_90a`` (`csrc/fused_block_attention_int8.cu`: K6's four stages
on int8 operands, a LayerNorm kernel writing int8 xn, K8's projection GEMM
and K3's streaming forward requantizing its output, and the int8
out-projection GEMM with a residual + dequant epilogue), built by
``nvcc`` at first use and bound with ``ctypes``; the source note says
what bounds it on the card and how the design answers that. Forward only:
the int8 tower serves and is never trained.

Weights arrive in `models.quant.QuantLinear`'s layout: int8 ``(D, D)``
with f32 per-channel ``scale`` and ``bias``. ``a_qkv`` is the shared
activation scale of q/k/v (the max of their three, as K8's branch takes
it), ``ao`` the out-projection's. Both stay on the device: the kernel
reads them there, and no quantize runs as a torch op here; the wrapper
folds them into the per-channel scales (``a * s``), as the JAX wrapper
does.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (:func:`fused_block_attention_int8_reference`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pigeon_tpu_torch import native
from pigeon_tpu_torch.kernels.fused_ln_qkv_attention import (
    check_ln_params,
    flax_layer_norm_f32,
)
from pigeon_tpu_torch.kernels.fused_qkv_attention import GEMM_TILE, HEAD_DIM
from pigeon_tpu_torch.kernels.fused_qkv_attention_int8 import (
    fold_scales,
    fused_qkv_attention_int8_reference,
)
from pigeon_tpu_torch.models.quant import int8_matmul, quantize_static


def _scalar(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device).reshape(())


def fused_block_attention_int8_reference(x, ln_scale, ln_bias, a_qkv, wq,
                                         sq, bq, wk, sk, bk, wv, sv, bv, ao,
                                         wo, so, bo, num_heads: int,
                                         eps: float):
    """Plain PyTorch K7: raw ``(B, S, D) -> (B, S, D)`` in ``x.dtype``, the
    residual included, with `_block_attn_int8_kernel`'s arithmetic:
    ``xn = bf16(LN_f32(x))``; K8's plain version on ``xn`` at ``a_qkv``
    (``xq = clip(round(f32(xn) / a_qkv), +-127)``, each projection
    ``f32(xq @ W^T) * (a_qkv s) + b`` rounded, K3's attention);
    ``oq = clip(round(f32(o) / ao), +-127)``; and
    ``(x + bo) + f32(oq @ Wo^T) * (ao so)`` in f32, rounded once. The
    int8 products sum exactly in int32."""
    a_qkv, ao = _scalar(a_qkv, x.device), _scalar(ao, x.device)
    xn = flax_layer_norm_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    o = fused_qkv_attention_int8_reference(xn, a_qkv, wq, sq, bq, wk, sk, bk,
                                           wv, sv, bv, num_heads)
    po = int8_matmul(quantize_static(o, ao), wo).float()
    return ((x.float() + bo.float()) + po * (ao * so.float())).to(x.dtype)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("fused_block_attention_int8").path)
    ptr = ctypes.c_void_p
    lib.pigeon_fused_block_attention_int8.argtypes = [ptr] * 23 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ptr]
    lib.pigeon_fused_block_attention_int8.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(x, ln_scale, ln_bias, scalars, weights, vectors,
                    num_heads: int):
    """K7's operands: any S, D = H * 64 a multiple of `GEMM_TILE` (the
    int8 GEMMs' tiles)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got {tuple(x.shape)}")
    d = x.shape[-1]
    if num_heads * HEAD_DIM != d or d % GEMM_TILE:
        raise ValueError(f"D={d} must be H * {HEAD_DIM} (H={num_heads}) "
                         f"and a multiple of {GEMM_TILE}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x: dtype {x.dtype}, kernel takes bf16")
    for name, t, shape, dtype in (
            [(n, a, (), torch.float32) for n, a in scalars]
            + [(n, w, (d, d), torch.int8) for n, w in weights]
            + [(n, v, (d,), torch.float32) for n, v in vectors]):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} is not contiguous and 16-byte aligned")
    check_ln_params(x, ln_scale, ln_bias)


class ForwardWorkspaces(NamedTuple):
    """K7's scratch, each ``(B, S, D)``: the quantized xn ``xq`` (int8),
    the projected ``q``, ``k`` and ``v`` (bf16, read by K3's streaming
    forward as ``(B, S, H, 64)``) and the requantized attention output
    ``oq`` (int8)."""

    xq: torch.Tensor
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    oq: torch.Tensor


def forward_workspaces(x) -> ForwardWorkspaces:
    """K7's workspaces for ``x`` (B, S, D) from PyTorch's allocator
    (uninitialised: each stage writes every row below B * S)."""
    def empty(dtype):
        return torch.empty(x.shape, dtype=dtype, device=x.device)

    return ForwardWorkspaces(empty(torch.int8), *(empty(torch.bfloat16)
                                                  for _ in range(3)),
                             empty(torch.int8))


def fused_block_attention_int8(x, ln_scale, ln_bias, a_qkv, wq, sq, bq, wk,
                               sk, bk, wv, sv, bv, ao, wo, so, bo,
                               num_heads: int, eps: float):
    """K7: the int8 ``x + out_proj(attention(LN1(x)))``, raw ``(B, S, D)
    -> (B, S, D)``, the residual included.

    ``a_qkv``, ``ao`` f32 scalars; ``w*`` int8 ``(D, D)``; ``s*``, ``b*``
    f32 ``(D,)``. CPU tensors run the plain version; CUDA tensors (x bf16,
    head_dim 64, D = H * 64 a multiple of 128, any S) launch the kernel's
    four stages (LN1 + quantize, the int8 projection GEMM, K3's streaming
    forward requantizing its output, the int8 out-projection GEMM;
    :func:`forward_workspaces`, allocated here on every call) on PyTorch's
    current stream and count one launch in
    ``fused_block_attention_int8.launches``; any other device raises.
    """
    if x.device.type == "cpu":
        return fused_block_attention_int8_reference(
            x, ln_scale, ln_bias, a_qkv, wq, sq, bq, wk, sk, bk, wv, sv, bv,
            ao, wo, so, bo, num_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_block_attention_int8: no kernel for {x.device}")
    a_qkv = _scalar(a_qkv, x.device).contiguous()
    ao = _scalar(ao, x.device).contiguous()
    folded = fold_scales(a_qkv, (sq, sk, sv)) + fold_scales(ao, (so,))
    _check_operands(
        x, ln_scale, ln_bias, (("a_qkv", a_qkv), ("ao", ao)),
        (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)),
        [(f"fs{n}", f) for n, f in zip("qkvo", folded)]
        + [("bq", bq), ("bk", bk), ("bv", bv), ("bo", bo)],
        num_heads)
    lib = load()
    b, s, d = x.shape
    out = torch.empty_like(x)
    ws = forward_workspaces(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pigeon_fused_block_attention_int8(
            *(t.data_ptr() for t in (x, ln_scale, ln_bias, a_qkv, wq, wk, wv,
                                     *folded[:3], bq, bk, bv, ao, wo,
                                     folded[3], bo, out, *ws)),
            b, s, d, num_heads, float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            "fused_block_attention_int8 launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    fused_block_attention_int8.launches += 1
    return out


fused_block_attention_int8.launches = 0
