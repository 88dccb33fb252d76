"""LayerNorm + fused QKV projection + attention (kernel K5), for the H100.

K5 replaces `pigeon_tpu/kernels/flash_attention.py::_fused_ln_qkv_kernel`
(launcher `_fused_ln_qkv_forward`), reached through `fused_ln_qkv_mha`
once per encoder layer on the ``flash_fused_ln`` and ``flash_fused_mlp``
routes: K1 with LN1 folded in, so the layer's raw input goes in. It is
CUDA C++ for ``sm_90a`` (`csrc/fused_ln_qkv_attention.cu`), built by
``nvcc`` at first use and bound with ``ctypes``: a LayerNorm kernel
writes the normalised ``xn`` to a workspace, then K1's two stages (the
``wgmma`` projection GEMM, K3's streaming forward) run on it. The source
note says what bounds it on the card and how the design answers that;
:func:`forward_workspaces` gives its scratch.

The LayerNorm is Flax's fast-variance form in its association order
(:func:`flax_layer_norm_f32`, the JAX package's `_layer_norm_f32`), which
the int8 towers of `models/clip.py` also take.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (:func:`fused_ln_qkv_attention_reference`); a CUDA tensor launches
the kernel or raises. :class:`FusedLNQKVAttention` is the differentiable
face: K5 forward; the backward rematerialises LN1 and reuses K1's
(`fused_qkv_attention_grads`: K2, or K4 under ``PIGEON_FUSED_BWD=xla``),
as `_fused_ln_qkv_bwd`. Its forward goes through the registered operator
``pigeon::fused_ln_qkv_attention``, which the ``attn_kernel`` remat policy
names to save K5's output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pigeon_tpu_torch import native
from pigeon_tpu_torch.kernels import fused_qkv_attention as k1


def flax_layer_norm_f32(x, scale, bias, eps: float):
    """LayerNorm in Flax's form, in f32 (`flash_attention.py::
    _layer_norm_f32`): f32 mean and ``var = max(E[x^2] - E[x]^2, 0)``,
    then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * scale
    return (xf - mean) * mul + bias


def fused_ln_qkv_attention_reference(x, ln_scale, ln_bias, wq, wk, wv, bq,
                                     bk, bv, num_heads: int, eps: float):
    """Plain PyTorch K5: raw ``(B, S, D) -> (B, S, P)``: LN1 in f32,
    rounded to ``x.dtype``, then K1's plain version
    (`_fused_ln_qkv_kernel`'s arithmetic)."""
    xn = flax_layer_norm_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    return k1.fused_qkv_attention_reference(xn, wq, wk, wv, bq, bk, bv,
                                            num_heads)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("fused_ln_qkv_attention").path)
    ptr = ctypes.c_void_p
    lib.pigeon_fused_ln_qkv_attention.argtypes = [ptr] * 14 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ptr]
    lib.pigeon_fused_ln_qkv_attention.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_ln_params(x, ln_scale, ln_bias):
    """The LayerNorm parameters a kernel takes: f32 ``(D,)``, contiguous,
    on ``x``'s device."""
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        if tuple(t.shape) != (x.shape[-1],):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{(x.shape[-1],)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes f32")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} is not contiguous and 16-byte aligned")


class Workspaces(NamedTuple):
    """K5's scratch: the normalised ``xn`` ``(B, S, D)`` bf16, then K1's
    projected ``q``, ``k`` and ``v`` ``(B, S, P)`` bf16
    (`fused_qkv_attention.ForwardWorkspaces`)."""

    xn: torch.Tensor
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor


def forward_workspaces(x, num_heads: int) -> Workspaces:
    """K5's workspaces for raw ``x`` (B, S, D) and ``num_heads`` heads of
    64, from PyTorch's allocator (uninitialised: every stage writes all
    of its rows)."""
    return Workspaces(torch.empty(x.shape, dtype=x.dtype, device=x.device),
                      *k1.forward_workspaces(x, num_heads))


def fused_ln_qkv_attention(x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv,
                           num_heads: int, eps: float):
    """K5: LN1 + q/k/v projection + softmax attention, raw ``(B, S, D) ->
    (B, S, P)`` before the output projection.

    CPU tensors run the plain version; CUDA tensors (bf16 x, weights and
    biases, f32 LN parameters, head_dim 64, D and P multiples of 128, any
    S) launch the kernel's three stages (LN1 into ``xn``, the projection
    GEMM, K3's streaming forward; :func:`forward_workspaces`, allocated
    here on every call) on PyTorch's current stream and count one launch
    in ``fused_ln_qkv_attention.launches``; any other device raises.
    """
    if x.device.type == "cpu":
        return fused_ln_qkv_attention_reference(
            x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv, num_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv_attention: no kernel for {x.device}")
    k1._check_gemm_operands(x, (wq, wk, wv), (bq, bk, bv), num_heads)
    check_ln_params(x, ln_scale, ln_bias)
    lib = load()
    b, s, d = x.shape
    ws = forward_workspaces(x, num_heads)
    out = torch.empty_like(ws.q)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pigeon_fused_ln_qkv_attention(
            *(t.data_ptr() for t in (x, ln_scale, ln_bias, wq, wk, wv, bq,
                                     bk, bv, out, *ws)),
            b, s, d, num_heads, float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            "fused_ln_qkv_attention launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    fused_ln_qkv_attention.launches += 1
    return out


fused_ln_qkv_attention.launches = 0


#: K5 as a registered operator, ``torch.ops.pigeon.fused_ln_qkv_attention``:
#: the remat policies tag its output ``attn_kernel_out``; where a policy
#: keeps it, the recompute pass of a checkpointed layer does not launch K5
#: again.
_LIBRARY = torch.library.Library("pigeon", "FRAGMENT")
_LIBRARY.define("fused_ln_qkv_attention(Tensor x, Tensor ln_scale, "
                "Tensor ln_bias, Tensor wq, Tensor wk, Tensor wv, Tensor bq, "
                "Tensor bk, Tensor bv, int num_heads, float eps) -> Tensor")
_LIBRARY.impl("fused_ln_qkv_attention", fused_ln_qkv_attention,
              "CompositeExplicitAutograd")
FUSED_LN_QKV_ATTENTION_OP = torch.ops.pigeon.fused_ln_qkv_attention.default


class FusedLNQKVAttention(torch.autograd.Function):
    """K5 forward as one differentiable operation: ``(x (B, S, D) raw,
    ln_scale, ln_bias (D,), W* (P, D), b* (P,)) -> (B, S, P)``.

    The backward is `_fused_ln_qkv_bwd`: LN1 recomputed under autograd,
    K1's VJP at its output (:func:`~pigeon_tpu_torch.kernels.
    fused_qkv_attention.fused_qkv_attention_grads`), and the LayerNorm's
    VJP carrying ``dxn`` to ``dx``, ``d ln_scale`` and ``d ln_bias``.
    """

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv,
                num_heads, eps):
        ctx.num_heads, ctx.eps = num_heads, eps
        ctx.save_for_backward(x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv)
        return FUSED_LN_QKV_ATTENTION_OP(x, ln_scale, ln_bias, wq, wk, wv,
                                         bq, bk, bv, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, *proj = ctx.saved_tensors
        need = ctx.needs_input_grad
        ln_inputs = [t.detach().requires_grad_(n)
                     for t, n in zip((x, ln_scale, ln_bias), need[:3])]
        with torch.enable_grad():
            xn = flax_layer_norm_f32(*ln_inputs, ctx.eps).to(x.dtype)
        dxn, *dproj = k1.fused_qkv_attention_grads(
            xn.detach(), *proj, g, ctx.num_heads,
            (any(need[:3]), *need[3:9]))
        wanted = [t for t in ln_inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(xn, wanted, dxn) if wanted else ())
        dln = [next(grads) if t.requires_grad else None for t in ln_inputs]
        return (*dln, *dproj, None, None)
