"""LayerNorm + quick-GELU MLP + residual (kernel K9), for the H100.

K9 replaces `pigeon_tpu/kernels/fused_mlp.py::_fused_ln_mlp_kernel`
(launcher `_fused_ln_mlp_forward`), reached through `fused_ln_mlp` once
per encoder layer on the ``flash_fused_mlp`` and ``flash_fused_block``
routes: the whole MLP half ``x + fc2(quick_gelu(fc1(LN2(x))))``. It is
CUDA C++ for ``sm_90a`` (`csrc/fused_mlp.cu`), built by ``nvcc`` at first
use and bound with ``ctypes``: a LayerNorm kernel writes ``xn`` to a
workspace, then the ``wgmma`` GEMM of `csrc/gemm_sm90.cuh` runs fc1 with
a bias + quick-GELU epilogue into the hidden workspace ``h`` and fc2 with
a bias + residual one. The source note says what bounds it on the card
and how the design answers that; :func:`forward_workspaces` gives its
scratch.

Weights are in ``torch.nn.Linear`` layout: ``w1`` (I, D), ``w2`` (D, I).

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (:func:`fused_ln_mlp_reference`, at the kernel's rounding
points); a CUDA tensor launches the kernel or raises.
:class:`FusedLNMLP` is the differentiable face: K9 forward, and as
backward the VJP of the plain composition (:func:`ln_mlp_composition`,
the JAX package's `_reference_ln_mlp`) recomputed under autograd, as
`_fused_ln_mlp_bwd`. Its forward goes through the registered operator
``pigeon::fused_ln_mlp``, whose output the ``attn_kernel`` remat policy
keeps: it is the next layer's input, kept anyway.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pigeon_tpu_torch import native
from pigeon_tpu_torch.kernels.fused_ln_qkv_attention import (
    check_ln_params,
    flax_layer_norm_f32,
)

#: K9's GEMMs take D and the intermediate width in 128-wide tiles.
TILE = 128


def quick_gelu(x):
    """CLIP's activation: ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def fused_ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           eps: float):
    """Plain PyTorch K9: ``(B, S, D) -> (B, S, D)`` at the rounding points
    of `fused_mlp.py::_fused_ln_mlp_kernel`: ``xn = LN_f32(x)`` rounded to
    ``x.dtype``; ``h = quick_gelu(xn W1^T + b1)`` in f32, rounded;
    ``out = x + b2 + h W2^T`` in f32, rounded. Products take their
    operands at their rounded values and sum in f32."""
    dt = x.dtype
    xn = flax_layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    h = quick_gelu(xn.float() @ w1.float().t() + b1.float()).to(dt)
    return (x.float() + b2.float() + h.float() @ w2.float().t()).to(dt)


def ln_mlp_composition(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float):
    """The MLP half as plain ops in ``x.dtype`` (`fused_mlp.py::
    _reference_ln_mlp`): the composition whose VJP is K9's backward."""
    dt = x.dtype
    xn = flax_layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    h = quick_gelu(F.linear(xn, w1, b1).float()).to(dt)
    return (x.float() + F.linear(h, w2, b2).float()).to(dt)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("fused_mlp").path)
    ptr = ctypes.c_void_p
    lib.pigeon_fused_ln_mlp.argtypes = [ptr] * 10 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ptr]
    lib.pigeon_fused_ln_mlp.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


class Workspaces(NamedTuple):
    """K9's scratch: the normalised ``xn`` ``(B*S, D)`` and the hidden
    ``h`` ``(B*S, I)``, both bf16."""

    xn: torch.Tensor
    h: torch.Tensor


def forward_workspaces(x, inter: int) -> Workspaces:
    """K9's workspaces for ``x`` (B, S, D) and ``inter`` hidden columns,
    from PyTorch's allocator (uninitialised: every stage writes all of its
    rows)."""
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    return Workspaces(*(torch.empty((rows, n), dtype=x.dtype,
                                    device=x.device) for n in (d, inter)))


def _check_operands(x, ln_scale, ln_bias, w1, b1, w2, b2):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got {tuple(x.shape)}")
    d, inter = x.shape[-1], w1.shape[0]
    if d % TILE or inter % TILE:
        raise ValueError(f"D={d} and I={inter} must be multiples of {TILE}")
    for name, t, shape in (("x", x, tuple(x.shape)), ("w1", w1, (inter, d)),
                           ("b1", b1, (inter,)), ("w2", w2, (d, inter)),
                           ("b2", b2, (d,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes bf16")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} is not contiguous and 16-byte aligned")
    check_ln_params(x, ln_scale, ln_bias)


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float):
    """K9: ``x + fc2(quick_gelu(fc1(LN(x))))``, ``(B, S, D) -> (B, S, D)``.

    CPU tensors run the plain version; CUDA tensors (bf16 x, weights and
    biases, f32 LN parameters, D and I multiples of 128) launch the
    kernel's three stages (LN2 into ``xn``, fc1 into ``h``, fc2;
    :func:`forward_workspaces`, allocated here on every call) on
    PyTorch's current stream and count one launch in
    ``fused_ln_mlp.launches``; any other device raises.
    """
    if x.device.type == "cpu":
        return fused_ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp: no kernel for {x.device}")
    lib = load()
    _check_operands(x, ln_scale, ln_bias, w1, b1, w2, b2)
    rows, d, inter = x.numel() // x.shape[-1], x.shape[-1], w1.shape[0]
    out = torch.empty_like(x)
    ws = forward_workspaces(x, inter)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pigeon_fused_ln_mlp(
            *(t.data_ptr() for t in (x, ln_scale, ln_bias, w1, b1, w2, b2,
                                     *ws, out)),
            rows, d, inter, float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            "fused_ln_mlp launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0


#: K9 as a registered operator, ``torch.ops.pigeon.fused_ln_mlp``.
_LIBRARY = torch.library.Library("pigeon", "FRAGMENT")
_LIBRARY.define("fused_ln_mlp(Tensor x, Tensor ln_scale, Tensor ln_bias, "
                "Tensor w1, Tensor b1, Tensor w2, Tensor b2, float eps) "
                "-> Tensor")
_LIBRARY.impl("fused_ln_mlp", fused_ln_mlp, "CompositeExplicitAutograd")
FUSED_LN_MLP_OP = torch.ops.pigeon.fused_ln_mlp.default


class FusedLNMLP(torch.autograd.Function):
    """K9 forward as one differentiable operation; the backward is the VJP
    of :func:`ln_mlp_composition` at the saved inputs
    (`fused_mlp.py::_fused_ln_mlp_bwd`)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        return FUSED_LN_MLP_OP(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:7]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ln_mlp_composition(*inputs, ctx.eps)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None)
