"""Softmax attention forward on separate q/k/v (kernel K3), for the H100.

K3 replaces `pigeon_tpu/kernels/flash_attention.py::_flash_forward` with
its default body `_attn_kernel`, reached through `mha`: the ``flash``
attention route and the dynamic-quant calibration forward of
``serve --quant``, where the q/k/v projections run outside the kernel.
It is CUDA C++ for ``sm_90a`` (`csrc/flash_attention.cu`, sharing its
attention body with K1 and K8 through `csrc/attention_tile.cuh`), built by
``nvcc`` at first use and bound with ``ctypes``; the source note says what
bounds it on the card and how the design answers that.

q/k/v keep the model's ``(B, S, H, dh)`` layout, the contract of `mha`;
the kernel reads that layout directly.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (:func:`flash_attention_reference`, which the CPU tests hold
against the JAX package); a CUDA tensor launches the kernel or raises.

Forward only: :class:`FlashAttention` is the differentiable face of the
route, and its backward raises until K4 (`_flash_backward`) is ported. It
never differentiates the plain version instead.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pigeon_tpu_torch import native

#: The head width the kernel is written for (ViT-B and ViT-L both use 64).
HEAD_DIM = 64


def flash_attention_reference(q, k, v):
    """Plain PyTorch K3: ``(B, S, H, dh)`` q/k/v -> ``(B, S, H, dh)`` in
    ``q.dtype``.

    The arithmetic of `flash_attention.py::_attn_kernel` (and of
    `_heads_attention`, which K1 and K8 share): f32 logits times
    ``dh ** -0.5``, the exact row max subtracted, unnormalised f32 ``exp``,
    ``p`` rounded to ``q.dtype`` for the product with ``v``, and the f32
    denominator dividing the ``(S, dh)`` output.
    """
    dt = q.dtype
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    logits = (qh @ kh.transpose(-1, -2)) * q.shape[-1] ** -0.5
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = probs.sum(-1, keepdim=True)
    out = (probs.to(dt).float() @ vh) / denom
    return out.to(dt).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("flash_attention").path)
    ptr = ctypes.c_void_p
    lib.pigeon_flash_attention.argtypes = [ptr] * 4 + [ctypes.c_int] * 3 + [
        ptr]
    lib.pigeon_flash_attention.restype = ctypes.c_int
    lib.pigeon_flash_attention_max_seq.argtypes = []
    lib.pigeon_flash_attention_max_seq.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(q, k, v, max_seq: int):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, dh), got {tuple(q.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]}: the kernel takes "
                         f"{HEAD_DIM}")
    if not 1 <= q.shape[1] <= max_seq:
        raise ValueError(f"S={q.shape[1]} outside the kernel's 1..{max_seq}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(q.shape)}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes bf16")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def flash_attention(q, k, v):
    """K3: softmax attention, ``(B, S, H, dh)`` q/k/v -> ``(B, S, H, dh)``.

    CPU tensors run the plain version; CUDA tensors (bf16, head_dim 64)
    launch the kernel on PyTorch's current stream and count the launch in
    ``flash_attention.launches``; any other device raises.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    lib = load()
    _check_operands(q, k, v, lib.pigeon_flash_attention_max_seq())
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pigeon_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, stream)
    if rc != 0:
        raise RuntimeError(
            "flash_attention launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """K3 as an autograd node: the forward is :func:`flash_attention`; the
    backward raises, because its kernel K4
    (`flash_attention.py::_flash_backward`) is not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v):
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the backward of attention kernel K3 is kernel K4 "
            "(pigeon_tpu/kernels/flash_attention.py::_flash_backward), "
            "which pigeon_tpu_torch has not ported yet: train on "
            "attn_impl='fused' (K1 + K2)")
