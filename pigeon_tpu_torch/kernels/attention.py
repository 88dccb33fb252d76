"""Softmax attention on separate q/k/v: forward (kernel K3) and backward
(kernel K4), for the H100.

K3 replaces `pigeon_tpu/kernels/flash_attention.py::_flash_forward` with
its default body `_attn_kernel`, reached through `mha`: the ``flash``
attention route and the dynamic-quant calibration forward of
``serve --quant``, where the q/k/v projections run outside the kernel.
K4 replaces `_flash_backward` with its body `_attn_bwd_kernel`, the VJP
of `mha` (and of `fused_qkv_mha` under ``PIGEON_FUSED_BWD=xla``). Both
are CUDA C++ for ``sm_90a`` on Hopper's ``wgmma`` with TMA-fed operands
(`csrc/flash_attention.cu` with `csrc/flash_fwd_sm90.cuh`: a streaming
forward with the softmax online over 128-key chunks;
`csrc/flash_attention_bwd.cu` with `csrc/flash_bwd_sm90.cuh`: a
statistics pass, a key-major gradient pass and a dq cast), built by
``nvcc`` at first use and bound with ``ctypes``; the source notes say
what bounds them on the card and how the designs answer that.

q/k/v keep the model's ``(B, S, H, dh)`` layout, the contract of `mha`;
the kernels read that layout directly, at any S.

``PIGEON_FLASH_FWD`` picks the forward's body at each call, as the JAX
package reads it when it traces `_flash_forward`: ``monolithic`` (the
default, K3) or ``online`` (kernel K3′, `_attn_kernel_online`:
online softmax over 128-key chunks, `csrc/flash_attention_online.cu`,
counted in ``flash_attention_online.launches``); any other value raises.
K3's kernel is online too, but its plain version keeps `_attn_kernel`'s
exact row max: K3 rounds p relative to the running max, within K3's
bound of that plain version. That is `_attn_kernel_online`'s function,
so K3′ launches K3's streaming ``wgmma`` forward under a symbol of its
own, held against its own plain version.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (:func:`flash_attention_reference`,
:func:`flash_attention_online_reference`,
:func:`flash_attention_backward_reference`, which the CPU tests hold
against the JAX package); a CUDA tensor launches the kernel or raises.
:func:`flash_attention_backward_stats_reference` is the plain version of
K4's statistics pass, which the card's checks hold the kernel's
statistics workspace against.

:class:`FlashAttention` pairs them as one differentiable operation, K3
forward and K4 backward. Its forward goes through the registered operator
``pigeon::flash_attention``, which the ``attn_kernel`` remat policy
(`models/clip.py`) names to save K3's output instead of launching K3
again.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from pigeon_tpu_torch import native

#: The head width the kernel is written for (ViT-B and ViT-L both use 64).
HEAD_DIM = 64
#: K3′'s keys per online-softmax step (`flash_attention.py::ONLINE_CHUNK`).
ONLINE_CHUNK = 128
#: ``PIGEON_FLASH_FWD``: the forward's body (`_flash_forward`).
FLASH_FWDS = ("monolithic", "online")


def flash_fwd() -> str:
    """The ``PIGEON_FLASH_FWD`` choice: ``monolithic`` (default, K3) or
    ``online`` (K3′); anything else raises, where the JAX package takes
    ``monolithic``."""
    value = os.environ.get("PIGEON_FLASH_FWD", "monolithic")
    if value not in FLASH_FWDS:
        raise ValueError(f"PIGEON_FLASH_FWD={value!r}, not in {FLASH_FWDS}")
    return value


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
    """K3: softmax attention, ``(B, S, H, dh)`` q/k/v -> ``(B, S, H, dh)``;
    under ``PIGEON_FLASH_FWD=online`` :func:`flash_attention_online` (K3′).

    CPU tensors run the plain version; CUDA tensors (bf16, head_dim 64,
    any S) launch the kernel on PyTorch's current stream and count the
    launch in ``flash_attention.launches``; any other device raises.
    """
    if flash_fwd() == "online":
        return flash_attention_online(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    lib = load()
    _check_operands(q, k, v, max_seq=q.shape[1])
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


def flash_attention_online_reference(q, k, v, chunk: int = ONLINE_CHUNK):
    """Plain PyTorch K3′: ``(B, S, H, dh)`` q/k/v -> ``(B, S, H, dh)`` in
    ``q.dtype``.

    The arithmetic of `flash_attention.py::_attn_kernel_online`: over
    ``chunk``-key steps, f32 logits times ``dh ** -0.5``, the running max
    ``m``, ``p = exp(s - m_new)`` and ``corr = exp(m - m_new)``, the f32
    denominator ``l * corr + sum(p)`` and ``acc * corr + bf16(p) @ v``;
    then ``acc / l``. ``p`` is rounded relative to the running max, so in
    bf16 this differs from K3's plain version.
    """
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    m = torch.full((*qh.shape[:-1], 1), -torch.inf, device=q.device)
    den = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for c0 in range(0, q.shape[1], chunk):
        logits = (qh @ kh[:, :, c0:c0 + chunk].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(dt).float() @ vh[:, :, c0:c0 + chunk]
        m = m_new
    return (acc / den).to(dt).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def load_online() -> ctypes.CDLL:
    """Build (at first use) and load K3′'s library."""
    lib = ctypes.CDLL(native.build_cuda("flash_attention_online").path)
    ptr = ctypes.c_void_p
    lib.pigeon_flash_attention_online.argtypes = [ptr] * 4 + [
        ctypes.c_int] * 3 + [ptr]
    lib.pigeon_flash_attention_online.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_online(q, k, v):
    """K3′: online-softmax attention, ``(B, S, H, dh)`` q/k/v ->
    ``(B, S, H, dh)``.

    CPU tensors run the plain version; CUDA tensors (bf16, head_dim 64,
    any S) launch the kernel on PyTorch's current stream and count the
    launch in ``flash_attention_online.launches``; any other device
    raises.
    """
    if q.device.type == "cpu":
        return flash_attention_online_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_online: no kernel for {q.device}")
    lib = load_online()
    _check_operands(q, k, v, max_seq=q.shape[1])
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pigeon_flash_attention_online(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, stream)
    if rc != 0:
        raise RuntimeError(
            "flash_attention_online launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    flash_attention_online.launches += 1
    return out


flash_attention_online.launches = 0


def flash_attention_backward_reference(q, k, v, g):
    """Plain PyTorch K4: ``(dq, dk, dv)``, each ``(B, S, H, dh)`` in
    ``q.dtype``, for the output cotangent ``g`` of K3.

    The arithmetic of `flash_attention.py::_attn_bwd_kernel`:
    ``u = exp(s - max s)`` in f32 with the denominator deferred;
    ``dv = bf16(u)^T bf16(g / den)``; ``dp = g v^T`` in f32 and
    ``r = sum(dp u) / den`` from the f32 ``u``;
    ``dl = bf16(u (dp - r) scale / den)``; ``dq = dl k`` and
    ``dk = dl^T q``. Every product takes its operands at their rounded
    values and sums in f32.
    """
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, gh = (t.to(dt).transpose(1, 2).float() for t in (q, k, v, g))
    logits = (qh @ kh.transpose(-1, -2)) * scale
    u = torch.exp(logits - logits.amax(-1, keepdim=True))
    den = u.sum(-1, keepdim=True)
    g_n = (gh / den).to(dt).float()
    dv = (u.to(dt).float().transpose(-1, -2) @ g_n).to(dt)
    dp = gh @ vh.transpose(-1, -2)
    r = (dp * u).sum(-1, keepdim=True) / den
    dl = (u * (dp - r) * (scale / den)).to(dt).float()
    dq = (dl @ kh).to(dt)
    dk = (dl.transpose(-1, -2) @ qh).to(dt)
    return tuple(t.transpose(1, 2).contiguous() for t in (dq, dk, dv))


def flash_attention_backward_stats_reference(q, k, v, g,
                                             chunk: int = ONLINE_CHUNK):
    """Plain PyTorch K4 statistics pass: ``(3, B, H, S)`` f32, the rows'
    ``m``, ``den`` and ``r`` of :func:`flash_attention_backward_reference`
    (``m`` the max of ``s = q k^T * dh ** -0.5``, ``den = sum(exp(s -
    m))``, ``r = sum(dp exp(s - m)) / den`` with ``dp = g v^T``).

    The kernel's order: over ``chunk``-key steps, the running max ``m``,
    ``corr = exp(m - m_new)``, ``den = den * corr + sum(u)`` and ``num =
    num * corr + sum(dp u)`` with ``u = exp(s - m_new)``; then ``r = num /
    den``.
    """
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, gh = (t.transpose(1, 2).float() for t in (q, k, v, g))
    m = torch.full(qh.shape[:-1], -torch.inf, device=q.device)
    den = torch.zeros_like(m)
    num = torch.zeros_like(m)
    for c0 in range(0, q.shape[1], chunk):
        s = (qh @ kh[:, :, c0:c0 + chunk].transpose(-1, -2)) * scale
        dp = gh @ vh[:, :, c0:c0 + chunk].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1))
        u = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + u.sum(-1)
        num = num * corr + (dp * u).sum(-1)
        m = m_new
    return torch.stack([m, den, num / den])


class BackwardWorkspaces(NamedTuple):
    """K4's scratch: the row statistics ``(3, B, H, S)`` f32 (``m``,
    ``den``, ``r``), ``g_n = bf16(g / den)`` ``(B, S, H, dh)`` bf16, and
    dq's f32 sums ``(B, H, ceil(S / 64), 64 * dh)``, zeroed, each 64-query
    chunk a row-major tile whose 32-byte chunks the kernel permutes within
    a row."""

    stats: torch.Tensor
    g_n: torch.Tensor
    dq_acc: torch.Tensor


def dq_workspace(q) -> torch.Tensor:
    """K4's zeroed dq sums (`BackwardWorkspaces.dq_acc`) for ``(B, S, H,
    dh)`` operands like ``q``."""
    b, s, h, dh = q.shape
    return torch.zeros((b, h, -(-s // 64), 64 * dh), dtype=torch.float32,
                       device=q.device)


def backward_workspaces(q) -> BackwardWorkspaces:
    """K4's workspaces for ``(B, S, H, dh)`` operands like ``q``."""
    b, s, h, _ = q.shape
    return BackwardWorkspaces(
        torch.empty((3, b, h, s), dtype=torch.float32, device=q.device),
        torch.empty_like(q), dq_workspace(q))


@functools.lru_cache(maxsize=None)
def load_backward() -> ctypes.CDLL:
    """Build (at first use) and load K4's library."""
    lib = ctypes.CDLL(native.build_cuda("flash_attention_bwd").path)
    ptr = ctypes.c_void_p
    lib.pigeon_flash_attention_backward.argtypes = [ptr] * 10 + [
        ctypes.c_int] * 3 + [ptr]
    lib.pigeon_flash_attention_backward.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_backward(q, k, v, g):
    """K4: ``(dq, dk, dv)`` of K3 for the output cotangent ``g``, all
    ``(B, S, H, dh)``.

    CPU tensors run the plain version; CUDA tensors (bf16, head_dim 64)
    launch the kernel (its three passes) on PyTorch's current stream and
    count the launch in ``flash_attention_backward.launches``; any other
    device raises. The kernel's workspaces (:func:`backward_workspaces`)
    are allocated here.
    """
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, g)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_backward: no kernel for {q.device}")
    _check_operands(q, k, v, max_seq=q.shape[1])
    _check_operands(q, g, g, max_seq=q.shape[1])
    return _launch_backward(q, k, v, g, backward_workspaces(q))


def flash_attention_backward_into(q, k, v, g, ws: BackwardWorkspaces):
    """K4 on CUDA tensors with the caller's workspaces ``ws`` (from
    :func:`backward_workspaces`, ``dq_acc`` zeroed), which keep the
    statistics pass's output; counts the launch like
    :func:`flash_attention_backward`."""
    _check_operands(q, k, v, max_seq=q.shape[1])
    _check_operands(q, g, g, max_seq=q.shape[1])
    b, s, h, dh = q.shape
    want = {"stats": ((3, b, h, s), torch.float32),
            "g_n": (q.shape, q.dtype),
            "dq_acc": ((b, h, -(-s // 64), 64 * dh), torch.float32)}
    for name, t in zip(ws._fields, ws):
        shape, dtype = want[name]
        if t.shape != shape or t.dtype != dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"workspace {name}: {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, kernel takes {tuple(shape)} "
                             f"{dtype} on {q.device}, contiguous")
    return _launch_backward(q, k, v, g, ws)


def _launch_backward(q, k, v, g, ws: BackwardWorkspaces):
    lib = load_backward()
    b, s, h, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pigeon_flash_attention_backward(
            *(t.data_ptr() for t in (q, k, v, g, dq, dk, dv, *ws)), b, s, h,
            stream)
    if rc != 0:
        raise RuntimeError(
            "flash_attention_backward launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


#: K3 as a registered operator, ``torch.ops.pigeon.flash_attention``: the
#: remat policies tag its output ``attn_kernel_out``; where a policy keeps
#: it, the recompute pass of a checkpointed layer does not launch K3 again.
_LIBRARY = torch.library.Library("pigeon", "FRAGMENT")
_LIBRARY.define("flash_attention(Tensor q, Tensor k, Tensor v) -> Tensor")
_LIBRARY.impl("flash_attention", flash_attention, "CompositeExplicitAutograd")
FLASH_ATTENTION_OP = torch.ops.pigeon.flash_attention.default


class FlashAttention(torch.autograd.Function):
    """K3 (or K3′) forward and K4 backward as one differentiable operation
    on ``(B, S, H, dh)`` q/k/v: the VJP of `flash_attention.py::mha`,
    whose backward is K4 under either forward body."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return FLASH_ATTENTION_OP(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return flash_attention_backward(q, k, v,
                                        g.to(q.dtype).contiguous())
