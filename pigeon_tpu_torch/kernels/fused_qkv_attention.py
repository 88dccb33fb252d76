"""Fused QKV projection + attention (kernel K1) and its backward (K2),
for the H100.

K1 replaces `pigeon_tpu/kernels/flash_attention.py::_fused_qkv_kernel`
and K2 replaces `_fused_qkv_bwd_kernel`, reached through `fused_qkv_mha`
and its VJP once per encoder layer on the `flash_fused` routes. Both are
CUDA C++ for ``sm_90a`` (`csrc/fused_qkv_attention.cu`,
`csrc/fused_qkv_attention_bwd.cu`), built by ``nvcc`` at first use and
bound with ``ctypes``; their source notes say what bounds them on the
card and how the designs answer that. Both start with the same ``wgmma``
GEMM (`csrc/gemm_sm90.cuh`), which projects q/k/v into (B, S, P)
workspaces. K1 then runs K3's streaming forward on them
(`csrc/flash_fwd_sm90.cuh`); :func:`forward_workspaces` gives its
scratch. K2 runs K4's attention backward (`csrc/flash_bwd_sm90.cuh`) and
the dx product (the same GEMM); :func:`backward_workspaces` gives its
scratch.

Weights are in ``torch.nn.Linear`` layout, ``(P, D)`` with ``P = H * 64``,
so each head's rows are one contiguous block the kernels stream.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (:func:`fused_qkv_attention_reference`,
:func:`fused_qkv_attention_backward_reference`, which the CPU tests hold
against the JAX package); a CUDA tensor launches the kernel or raises.
Nothing falls back from a kernel to a plain version.

:class:`FusedQKVAttention` makes the pair one differentiable operation:
K1 forward, K2 backward (or, under ``PIGEON_FUSED_BWD=xla``, plain
projections around K4), the weight and bias gradients as plain matrix
products (the JAX package leaves those to XLA). Its forward goes through
the registered operator ``pigeon::fused_qkv_attention``, which is what the
``attn_kernel`` remat policy (`models/clip.py`) names to save K1's output
instead of launching K1 again.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from pigeon_tpu_torch import native
from pigeon_tpu_torch.kernels import attention
from pigeon_tpu_torch.kernels.attention import (
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
)

#: The head width the kernel is written for (ViT-B and ViT-L both use 64).
HEAD_DIM = 64
#: `_check_operands` takes D in multiples of this many columns, as the
#: JAX kernels do.
D_CHUNK = 64
#: K1's, K2's, K5's and K6's GEMMs take D and P in multiples of 128 (their
#: output tiles).
GEMM_TILE = 128


def fused_qkv_attention_reference(x, wq, wk, wv, bq, bk, bv,
                                  num_heads: int):
    """Plain PyTorch K1: ``(B, S, D) -> (B, S, P)``, heads concatenated.

    The projections accumulate in f32, add the bias in f32 and round to
    ``x.dtype``; the attention is K3's plain version
    (:func:`~pigeon_tpu_torch.kernels.attention.flash_attention_reference`:
    f32 softmax with the row max subtracted, ``p`` rounded to ``x.dtype``
    for the product with ``v``, the f32 denominator dividing the
    ``(S, dh)`` output) — the arithmetic of
    `flash_attention.py::_fused_qkv_kernel` and `_heads_attention`.
    """
    b, s, _ = x.shape
    p = wq.shape[0]
    xf = x.float()

    def proj(w, bias):
        y = xf @ w.float().t() + bias.float()
        return y.to(x.dtype).view(b, s, num_heads, p // num_heads)

    return flash_attention_reference(
        proj(wq, bq), proj(wk, bk), proj(wv, bv)).reshape(b, s, p)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("fused_qkv_attention").path)
    ptr = ctypes.c_void_p
    lib.pigeon_fused_qkv_attention.argtypes = [ptr] * 11 + [
        ctypes.c_int] * 4 + [ptr]
    lib.pigeon_fused_qkv_attention.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(x, weights, biases, num_heads: int, max_seq: int):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got {tuple(x.shape)}")
    b, s, d = x.shape
    p = num_heads * HEAD_DIM
    if d % D_CHUNK:
        raise ValueError(f"D={d} is not a multiple of {D_CHUNK}")
    if not 1 <= s <= max_seq:
        raise ValueError(f"S={s} outside the kernel's 1..{max_seq}")
    for name, t, shape in (
            [("x", x, (b, s, d))]
            + [(f"w{n}", w, (p, d)) for n, w in zip("qkv", weights)]
            + [(f"b{n}", bb, (p,)) for n, bb in zip("qkv", biases)]):
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)} != {shape} (H={num_heads}, "
                f"head_dim must be {HEAD_DIM})")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes bf16")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _check_gemm_operands(x, weights, biases, num_heads: int):
    """The operands of K1, K2, K5 and K6 (whose first stage after any
    LayerNorm is the projection GEMM): `_check_operands`'s at any S, and D
    and P multiples of `GEMM_TILE`."""
    _check_operands(x, weights, biases, num_heads, max_seq=x.shape[1])
    d, p = x.shape[2], num_heads * HEAD_DIM
    if d % GEMM_TILE or p % GEMM_TILE:
        raise ValueError(f"D={d} and P={p} must be multiples of {GEMM_TILE} "
                         "(an even head count)")


class ForwardWorkspaces(NamedTuple):
    """K1's scratch: the projected ``q``, ``k`` and ``v`` ``(B, S, P)``
    bf16, which K3's streaming forward reads as ``(B, S, H, 64)``."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor


def forward_workspaces(x, num_heads: int) -> ForwardWorkspaces:
    """K1's workspaces for ``x`` (B, S, D) and ``num_heads`` heads of 64,
    from PyTorch's allocator (uninitialised: the GEMM writes every row
    below B * S)."""
    b, s, _ = x.shape
    return ForwardWorkspaces(*(
        torch.empty((b, s, num_heads * HEAD_DIM), dtype=x.dtype,
                    device=x.device) for _ in range(3)))


def fused_qkv_attention(x, wq, wk, wv, bq, bk, bv, num_heads: int):
    """K1: fused q/k/v projection + softmax attention, ``(B, S, D) ->
    (B, S, P)`` before the output projection.

    CPU tensors run the plain version; CUDA tensors (bf16, head_dim 64,
    D and P multiples of 128, any S) launch the kernel's two stages (the
    projection GEMM into :func:`forward_workspaces`, allocated here on
    every call, then K3's streaming forward) on PyTorch's current stream
    and count one launch in ``fused_qkv_attention.launches``; any other
    device raises.
    """
    if x.device.type == "cpu":
        return fused_qkv_attention_reference(x, wq, wk, wv, bq, bk, bv,
                                             num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: no kernel for {x.device}")
    _check_gemm_operands(x, (wq, wk, wv), (bq, bk, bv), num_heads)
    lib = load()
    b, s, d = x.shape
    ws = forward_workspaces(x, num_heads)
    out = torch.empty_like(ws.q)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pigeon_fused_qkv_attention(
            *(t.data_ptr() for t in (x, wq, wk, wv, bq, bk, bv, out, *ws)),
            b, s, d, num_heads, stream)
    if rc != 0:
        raise RuntimeError(
            "fused_qkv_attention launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0


def fused_qkv_attention_backward_reference(x, wq, wk, wv, bq, bk, bv, g,
                                           num_heads: int):
    """Plain PyTorch K2: ``(dx (B, S, D), dq, dk, dv (B, S, P))`` for the
    output cotangent ``g`` (B, S, P).

    The arithmetic of `flash_attention.py::_fused_qkv_bwd_kernel`: q/k/v
    recomputed as in the forward (f32 bias add, rounded to ``x.dtype``);
    the attention backward of K4's plain version
    (:func:`~pigeon_tpu_torch.kernels.attention.flash_attention_backward_reference`:
    ``u = exp(s - max s)`` in f32 with the denominator deferred,
    ``dl = bf16(u (dp - r) scale / den)``, ``dq = dl k``, ``dk = dl^T q``,
    ``dv = bf16(u)^T bf16(g / den)``); and ``dx = dq Wq + dk Wk + dv Wv``
    accumulated in f32. Every product takes its operands at their rounded
    values and sums in f32.
    """
    b, s, _ = x.shape
    p = wq.shape[0]
    heads = (b, s, num_heads, p // num_heads)
    dt = x.dtype
    xf = x.float()

    def proj(w, bias):
        return (xf @ w.float().t() + bias.float()).to(dt).view(heads)

    dq, dk, dv = (t.reshape(b, s, p) for t in flash_attention_backward_reference(
        proj(wq, bq), proj(wk, bk), proj(wv, bv), g.reshape(heads)))
    dx = (dq.float() @ wq.float() + dk.float() @ wk.float()
          + dv.float() @ wv.float())
    return dx.to(dt), dq, dk, dv


@functools.lru_cache(maxsize=None)
def load_backward() -> ctypes.CDLL:
    """Build (at first use) and load K2's library."""
    lib = ctypes.CDLL(native.build_cuda("fused_qkv_attention_bwd").path)
    ptr = ctypes.c_void_p
    lib.pigeon_fused_qkv_attention_backward.argtypes = [ptr] * 18 + [
        ctypes.c_int] * 4 + [ptr]
    lib.pigeon_fused_qkv_attention_backward.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


class BackwardWorkspaces(NamedTuple):
    """K2's scratch: the projected ``q``, ``k`` and ``v`` ``(B, S, P)``
    bf16, and the workspaces of K4's passes that run on them (see
    :class:`~pigeon_tpu_torch.kernels.attention.BackwardWorkspaces`): the
    row statistics ``(3, B, H, S)`` f32, ``g_n`` ``(B, S, H, 64)`` bf16
    and dq's f32 sums ``(B, H, ceil(S / 64), 4096)``, zeroed."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    stats: torch.Tensor
    g_n: torch.Tensor
    dq_acc: torch.Tensor


def backward_workspaces(x, num_heads: int) -> BackwardWorkspaces:
    """K2's workspaces for ``x`` (B, S, D) and ``num_heads`` heads of 64;
    ``dq_acc`` comes zeroed, as every call needs it."""
    b, s, _ = x.shape
    q, k, v = forward_workspaces(x, num_heads)
    return BackwardWorkspaces(q, k, v, *attention.backward_workspaces(
        q.view(b, s, num_heads, HEAD_DIM)))


def _check_backward_operands(x, weights, biases, g, num_heads: int):
    _check_gemm_operands(x, weights, biases, num_heads)
    b, s, _ = x.shape
    p = num_heads * HEAD_DIM
    if tuple(g.shape) != (b, s, p):
        raise ValueError(f"g: shape {tuple(g.shape)} != {(b, s, p)}")
    if g.dtype != torch.bfloat16:
        raise TypeError(f"g: dtype {g.dtype}, kernel takes bf16")
    if g.device != x.device:
        raise ValueError(f"g on {g.device}, x on {x.device}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g is not contiguous and 16-byte aligned")


def fused_qkv_attention_backward(x, wq, wk, wv, bq, bk, bv, g,
                                 num_heads: int):
    """K2: ``(dx, dq, dk, dv)`` of K1 for the output cotangent ``g``.

    CPU tensors run the plain version; CUDA tensors (bf16, head_dim 64,
    D and P multiples of 128, any S) launch the kernel's three stages on
    PyTorch's current stream and count one launch in
    ``fused_qkv_attention_backward.launches``; any other device raises.
    The kernel's workspaces (:func:`backward_workspaces`) are allocated
    here, ``dq_acc`` zeroed, on every call.
    """
    if x.device.type == "cpu":
        return fused_qkv_attention_backward_reference(
            x, wq, wk, wv, bq, bk, bv, g, num_heads)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_qkv_attention_backward: no kernel for {x.device}")
    _check_backward_operands(x, (wq, wk, wv), (bq, bk, bv), g, num_heads)
    return _launch_backward(x, wq, wk, wv, bq, bk, bv, g, num_heads,
                            backward_workspaces(x, num_heads))


def fused_qkv_attention_backward_into(x, wq, wk, wv, bq, bk, bv, g,
                                      num_heads: int,
                                      ws: BackwardWorkspaces):
    """K2 on CUDA tensors with the caller's workspaces ``ws`` (from
    :func:`backward_workspaces`, ``dq_acc`` zeroed since its last use),
    which keep the projection and the statistics; counts the launch like
    :func:`fused_qkv_attention_backward`. A workspace of another shape,
    type or device raises."""
    _check_backward_operands(x, (wq, wk, wv), (bq, bk, bv), g, num_heads)
    b, s, _ = x.shape
    p = num_heads * HEAD_DIM
    want = {"q": ((b, s, p), x.dtype), "k": ((b, s, p), x.dtype),
            "v": ((b, s, p), x.dtype),
            "stats": ((3, b, num_heads, s), torch.float32),
            "g_n": ((b, s, num_heads, HEAD_DIM), x.dtype),
            "dq_acc": ((b, num_heads, -(-s // 64), 64 * HEAD_DIM),
                       torch.float32)}
    for name, t in zip(ws._fields, ws):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"workspace {name}: {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, kernel takes {shape} {dtype} "
                             f"on {x.device}, contiguous")
    return _launch_backward(x, wq, wk, wv, bq, bk, bv, g, num_heads, ws)


def _launch_backward(x, wq, wk, wv, bq, bk, bv, g, num_heads: int,
                     ws: BackwardWorkspaces):
    lib = load_backward()
    b, s, d = x.shape
    dx = torch.empty_like(x)
    dq, dk, dv = (torch.empty_like(ws.q) for _ in range(3))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pigeon_fused_qkv_attention_backward(
            *(t.data_ptr() for t in (x, wq, wk, wv, bq, bk, bv, g, dx, dq,
                                     dk, dv, *ws)),
            b, s, d, num_heads, stream)
    if rc != 0:
        raise RuntimeError(
            "fused_qkv_attention_backward launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    fused_qkv_attention_backward.launches += 1
    return dx, dq, dk, dv


fused_qkv_attention_backward.launches = 0


#: K1 as a registered operator, ``torch.ops.pigeon.fused_qkv_attention``.
#: The ``attn_kernel`` remat policy recognises it and keeps its output,
#: so the recompute pass of a checkpointed layer never launches K1 again.
#: (Registered with `torch.library.Library`: `torch.library.custom_op`
#: imports the compiler stack at its first call, seconds of start-up.)
_LIBRARY = torch.library.Library("pigeon", "FRAGMENT")
_LIBRARY.define("fused_qkv_attention(Tensor x, Tensor wq, Tensor wk, "
                "Tensor wv, Tensor bq, Tensor bk, Tensor bv, int num_heads) "
                "-> Tensor")
_LIBRARY.impl("fused_qkv_attention", fused_qkv_attention,
              "CompositeExplicitAutograd")
FUSED_QKV_ATTENTION_OP = torch.ops.pigeon.fused_qkv_attention.default


#: ``PIGEON_FUSED_BWD``: the backward of the fused projection + attention,
#: read at call time as the JAX package reads it (`_fused_qkv_bwd`).
FUSED_BWDS = ("kernel", "xla")


def fused_bwd() -> str:
    """The ``PIGEON_FUSED_BWD`` choice: ``kernel`` (default, K2) or
    ``xla`` (plain projections around K4); anything else raises."""
    value = os.environ.get("PIGEON_FUSED_BWD", "kernel")
    if value not in FUSED_BWDS:
        raise ValueError(f"PIGEON_FUSED_BWD={value!r}, not in {FUSED_BWDS}")
    return value


def fused_qkv_attention_grads(x, wq, wk, wv, bq, bk, bv, g, num_heads: int,
                              need):
    """The VJP of `flash_attention.py::fused_qkv_mha` (`_fused_qkv_bwd`)
    at ``x`` for the cotangent ``g``: ``(dx, dWq, dWk, dWv, dbq, dbk,
    dbv)``, each None where ``need`` (seven flags) says nobody wants it.

    ``PIGEON_FUSED_BWD=kernel``: K2 gives ``dx`` and the projection
    cotangents. ``xla``: q/k/v recomputed by plain products (f32
    accumulation, the bias added before one rounding), K4 on them, and
    ``dx = [dq|dk|dv] [Wq;Wk;Wv]`` as one plain product. ``dW* = d*^T x``
    (f32 accumulation, rounded to the weight dtype) and ``db* = sum d*``
    either way.
    """
    g = g.to(x.dtype).contiguous()
    if fused_bwd() == "kernel":
        dx, *dqkv = fused_qkv_attention_backward(x, wq, wk, wv, bq, bk, bv,
                                                 g, num_heads)
    else:
        b, s, _ = x.shape
        heads = (b, s, num_heads, wq.shape[0] // num_heads)
        q, k, v = (torch.nn.functional.linear(x, w, bias).view(heads)
                   for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
        dqkv = [t.reshape(b, s, -1) for t in flash_attention_backward(
            q, k, v, g.view(heads))]
        dx = (torch.cat(dqkv, -1) @ torch.cat((wq, wk, wv), 0)
              if need[0] else None)
    x_flat = x.reshape(-1, x.shape[-1])
    dws = [d.reshape(-1, d.shape[-1]).t() @ x_flat if need[1 + i]
           else None for i, d in enumerate(dqkv)]
    dbs = [d.sum((0, 1), dtype=torch.float32).to(bias.dtype)
           if need[4 + i] else None
           for i, (d, bias) in enumerate(zip(dqkv, (bq, bk, bv)))]
    return (dx if need[0] else None), *dws, *dbs


class FusedQKVAttention(torch.autograd.Function):
    """K1 forward and K2 backward as one differentiable operation:
    ``(x (B, S, D), W* (P, D), b* (P,)) -> (B, S, P)``.

    The backward is the VJP of `flash_attention.py::fused_qkv_mha`
    (:func:`fused_qkv_attention_grads`: K2, or K4 under
    ``PIGEON_FUSED_BWD=xla``); each weight and bias gradient is formed
    only when its input needs one (a frozen layer needs ``dx`` alone).
    """

    @staticmethod
    def forward(ctx, x, wq, wk, wv, bq, bk, bv, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, wq, wk, wv, bq, bk, bv)
        return FUSED_QKV_ATTENTION_OP(x, wq, wk, wv, bq, bk, bv, num_heads)

    @staticmethod
    def backward(ctx, g):
        return (*fused_qkv_attention_grads(*ctx.saved_tensors, g,
                                           ctx.num_heads,
                                           ctx.needs_input_grad[:7]), None)
