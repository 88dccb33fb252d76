"""The attention half of a block in one call (kernel K6), for the H100:
``x + out_proj(attention(LN1(x)))``.

K6 replaces `pigeon_tpu/kernels/flash_attention.py::_block_attn_kernel`
(launcher `_fused_block_attn_forward`, entry `fused_block_attention`),
reached once per encoder layer on the ``flash_fused_block`` route, where
the layer is K6 and then K9 and adds no residual of its own. It is CUDA
C++ for ``sm_90a`` (`csrc/fused_block_attention.cu`), built by ``nvcc``
at first use and bound with ``ctypes``: K5's stages (a LayerNorm kernel
into ``xn``, the ``wgmma`` projection GEMM into q/k/v, K3's streaming
forward into ``ao``), then the same GEMM for the out-projection with a
bias + residual epilogue. The source note says what bounds it on the
card and how the design answers that; :func:`forward_workspaces` gives
its scratch.

Weights are in ``torch.nn.Linear`` layout, ``(D, D)`` each with
``D = H * 64``.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (:func:`fused_block_attention_reference`); a CUDA tensor launches
the kernel or raises. :class:`FusedBlockAttention` is the differentiable
face: K6 forward; the backward is `_fused_block_bwd`, the VJP of the
reference composition: LN1 recomputed under autograd, K1 run again for
the out-projection's input where Wo wants a gradient, K1's VJP
(`fused_qkv_attention_grads`: K2, or K4 under ``PIGEON_FUSED_BWD=xla``),
the out-projection's in f32. Its
forward goes through the registered operator
``pigeon::fused_block_attention``, which the ``attn_kernel`` remat policy
names to save K6's output (the JAX ``attn_out``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pigeon_tpu_torch import native
from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
from pigeon_tpu_torch.kernels import fused_ln_qkv_attention as k5
from pigeon_tpu_torch.kernels.fused_ln_qkv_attention import (
    check_ln_params,
    flax_layer_norm_f32,
)


def fused_block_attention_reference(x, ln_scale, ln_bias, wq, wk, wv, bq,
                                    bk, bv, wo, bo, num_heads: int,
                                    eps: float):
    """Plain PyTorch K6: raw ``(B, S, D) -> (B, S, D)`` with the arithmetic
    of `flash_attention.py::_fused_block_reference`: LN1 in f32 rounded to
    ``x.dtype``, K1's plain version, then ``x + (ao Wo^T + bo)`` summed in
    f32 and rounded once."""
    xn = flax_layer_norm_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    ao = k1.fused_qkv_attention_reference(xn, wq, wk, wv, bq, bk, bv,
                                          num_heads)
    return (x.float() + (ao.float() @ wo.float().t() + bo.float())) \
        .to(x.dtype)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("fused_block_attention").path)
    ptr = ctypes.c_void_p
    lib.pigeon_fused_block_attention.argtypes = [ptr] * 17 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ptr]
    lib.pigeon_fused_block_attention.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


class Workspaces(NamedTuple):
    """K6's scratch, each ``(B, S, D)`` bf16: K5's normalised ``xn`` and
    projected ``q``, ``k``, ``v`` (`fused_ln_qkv_attention.Workspaces`),
    then the attention output ``ao`` the out-projection reads."""

    xn: torch.Tensor
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    ao: torch.Tensor


def forward_workspaces(x, num_heads: int) -> Workspaces:
    """K6's workspaces for raw ``x`` (B, S, D) and ``num_heads`` heads of
    64 (D = H * 64), from PyTorch's allocator (uninitialised: every stage
    writes all of its rows)."""
    return Workspaces(*k5.forward_workspaces(x, num_heads),
                      torch.empty_like(x))


def _check_operands(x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv, wo, bo,
                    num_heads: int):
    """K1's and K5's operands (`_check_gemm_operands`: any S, D and P
    multiples of 128), D = H * 64, and Wo (D, D), bo (D,)."""
    k1._check_gemm_operands(x, (wq, wk, wv), (bq, bk, bv), num_heads)
    d = x.shape[-1]
    if num_heads * k1.HEAD_DIM != d:
        raise ValueError(f"D={d} must be H * {k1.HEAD_DIM} (H={num_heads})")
    for name, t, shape in (("wo", wo, (d, d)), ("bo", bo, (d,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes bf16")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} is not contiguous and 16-byte aligned")
    check_ln_params(x, ln_scale, ln_bias)


def fused_block_attention(x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv, wo,
                          bo, num_heads: int, eps: float):
    """K6: ``x + out_proj(attention(LN1(x)))``, raw ``(B, S, D) -> (B, S,
    D)``, the residual included.

    CPU tensors run the plain version; CUDA tensors (bf16 x, weights and
    biases, f32 LN parameters, head_dim 64, D = H * 64 a multiple of 128,
    any S) launch the kernel's four stages (LN1 into ``xn``, the
    projection GEMM, K3's streaming forward into ``ao``, the
    out-projection GEMM; :func:`forward_workspaces`, allocated here on
    every call) on PyTorch's current stream and count one launch in
    ``fused_block_attention.launches``; any other device raises.
    """
    if x.device.type == "cpu":
        return fused_block_attention_reference(
            x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv, wo, bo, num_heads,
            eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_attention: no kernel for {x.device}")
    _check_operands(x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv, wo, bo,
                    num_heads)
    lib = load()
    b, s, d = x.shape
    out = torch.empty_like(x)
    ws = forward_workspaces(x, num_heads)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pigeon_fused_block_attention(
            *(t.data_ptr() for t in (x, ln_scale, ln_bias, wq, wk, wv, bq,
                                     bk, bv, wo, bo, out, *ws)),
            b, s, d, num_heads, float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            "fused_block_attention launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    fused_block_attention.launches += 1
    return out


fused_block_attention.launches = 0


#: K6 as a registered operator, ``torch.ops.pigeon.fused_block_attention``:
#: the ``attn_kernel`` remat policy keeps its output, so the recompute pass
#: of a checkpointed layer never launches K6 again.
_LIBRARY = torch.library.Library("pigeon", "FRAGMENT")
_LIBRARY.define("fused_block_attention(Tensor x, Tensor ln_scale, "
                "Tensor ln_bias, Tensor wq, Tensor wk, Tensor wv, Tensor bq, "
                "Tensor bk, Tensor bv, Tensor wo, Tensor bo, int num_heads, "
                "float eps) -> Tensor")
_LIBRARY.impl("fused_block_attention", fused_block_attention,
              "CompositeExplicitAutograd")
FUSED_BLOCK_ATTENTION_OP = torch.ops.pigeon.fused_block_attention.default


class FusedBlockAttention(torch.autograd.Function):
    """K6 forward as one differentiable operation: ``(x (B, S, D) raw,
    ln_scale, ln_bias (D,), Wq, Wk, Wv (D, D), bq, bk, bv (D,), Wo (D,
    D), bo (D,)) -> (B, S, D)``.

    The backward is `_fused_block_bwd`, the VJP of
    `_fused_block_reference`: LN1 recomputed under autograd; where Wo
    wants a gradient, K1 launched again (the JAX VJP reruns
    `fused_qkv_mha`'s forward) for ``dWo = g^T ao``, the only reader of
    ``ao``; ``dao = g Wo`` and ``dbo = sum g`` in f32 (no TF32); K1's VJP
    at ``dao``; the LayerNorm's VJP; and the residual's ``g`` added to
    ``dx``.
    """

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv, wo, bo,
                num_heads, eps):
        ctx.num_heads, ctx.eps = num_heads, eps
        ctx.save_for_backward(x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv,
                              wo, bo)
        return FUSED_BLOCK_ATTENTION_OP(x, ln_scale, ln_bias, wq, wk, wv, bq,
                                        bk, bv, wo, bo, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, *proj, wo, bo = ctx.saved_tensors
        need = ctx.needs_input_grad
        ln_inputs = [t.detach().requires_grad_(n)
                     for t, n in zip((x, ln_scale, ln_bias), need[:3])]
        with torch.enable_grad():
            xn = flax_layer_norm_f32(*ln_inputs, ctx.eps).to(x.dtype)
        gf = g.float()
        d = x.shape[-1]
        dao = (gf @ wo.float()).to(x.dtype)
        dwo = None
        if need[9]:
            ao = k1.fused_qkv_attention(xn.detach(), *proj, ctx.num_heads)
            dwo = (gf.reshape(-1, d).t() @ ao.float().reshape(-1, d)) \
                .to(wo.dtype)
        dbo = gf.sum((0, 1)).to(bo.dtype) if need[10] else None
        dxn, *dproj = k1.fused_qkv_attention_grads(
            xn.detach(), *proj, dao, ctx.num_heads,
            (any(need[:3]), *need[3:9]))
        wanted = [t for t in ln_inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(xn, wanted, dxn) if wanted else ())
        dln = [next(grads) if t.requires_grad else None for t in ln_inputs]
        if dln[0] is not None:
            dln[0] = dln[0] + g.to(x.dtype)
        return (*dln, *dproj, dwo, dbo, None, None)
