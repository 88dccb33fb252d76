"""One-pass LayerNorm, residual add + LayerNorm, quick-GELU, SwiGLU and
LayerScale'd residual add + LayerNorm, for the H100: the element-wise chain
of each encoder layer's inference forward.

These replace no TPU kernel: XLA fuses this chain on the TPU. On the card
`models/clip.py`'s `TransformerLayer` ran it as eager PyTorch kernels
through f32 round trips (``x.float()``, ``F.layer_norm``, ``.to``; three
kernels for quick-GELU); with grad mode off it now launches these instead
(the layer's docstring says where). They are CUDA C++ for ``sm_90a``
(`csrc/eltwise.cu`), built by ``nvcc`` at first use and bound with
``ctypes``; the source note says what bounds them and how the design
answers that:

* :func:`layer_norm_bf16`: ``LN(x)``, f32 statistics, bf16 in and out;
* :func:`add_layer_norm_bf16`: ``s = x + a`` and ``LN(s)`` in one pass;
* :func:`quick_gelu_bf16`: ``x * sigmoid(1.702 x)`` in one pass;
* :func:`swiglu_bf16`: ``silu(u1) * u2`` of the fc-in output ``u = [u1 |
  u2]`` in one pass (DINOv2's gated MLP);
* :func:`scale_add_layer_norm_bf16`: ``s = x + gamma * a`` and ``LN(s)`` in
  one pass (a LayerScale'd residual, DINOv2's).

Each rounds where the eager composition rounds, and each has that
composition beside it as its plain version (:func:`layer_norm_reference`,
:func:`add_layer_norm_reference`, :func:`quick_gelu`, :func:`swiglu`,
:func:`scale_add_layer_norm_reference`). Dispatch is by the tensor's
device: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel (bf16 activations, f32 LayerNorm parameters and LayerScale) or
raises. None has a backward: training keeps the eager chain.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pigeon_tpu_torch import native
from pigeon_tpu_torch.kernels.fused_ln_qkv_attention import check_ln_params

#: The row kernels hold a row in registers, 8 bf16 a vector and at most 8
#: vectors a lane of its warp.
MAX_DIM = 2048


def quick_gelu(x):
    """CLIP's activation: ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm_reference(x, weight, bias, eps: float):
    """LayerNorm with f32 statistics, rounded back to ``x.dtype``: the
    composition `layer_norm_bf16` runs in one pass."""
    return F.layer_norm(x.float(), weight.shape, weight, bias,
                        eps).to(x.dtype)


def add_layer_norm_reference(x, a, weight, bias, eps: float):
    """``s = x + a`` in ``x.dtype`` and `layer_norm_reference` of ``s``:
    returns ``(s, LN(s))``."""
    s = x + a
    return s, layer_norm_reference(s, weight, bias, eps)


def swiglu(u):
    """DINOv2's gated MLP activation on the fc-in output ``u = [u1 | u2]``
    (``(..., 2I)``): ``silu(u1) * u2``, ``(..., I)``."""
    u1, u2 = u.chunk(2, dim=-1)
    return F.silu(u1) * u2


def scale_add(x, a, gamma):
    """``x + gamma * a`` in ``x.dtype``, LayerScale's ``gamma`` (f32, per
    channel) cast to it first, as the layers cast their parameters."""
    return x + a * gamma.to(x.dtype)


def scale_add_layer_norm_reference(x, a, gamma, weight, bias, eps: float):
    """`scale_add` and `layer_norm_reference` of the sum: returns ``(s,
    LN(s))``."""
    s = scale_add(x, a, gamma)
    return s, layer_norm_reference(s, weight, bias, eps)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("eltwise").path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pigeon_layer_norm_bf16.argtypes = [ptr] * 4 + [i32, i32, f32, ptr]
    lib.pigeon_add_layer_norm_bf16.argtypes = [ptr] * 6 + [i32, i32, f32,
                                                           ptr]
    lib.pigeon_quick_gelu_bf16.argtypes = [ptr, ptr, ctypes.c_int64, ptr]
    lib.pigeon_swiglu_bf16.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.pigeon_scale_add_layer_norm_bf16.argtypes = [ptr] * 7 + [
        i32, i32, f32, ptr]
    for fn in (lib.pigeon_layer_norm_bf16, lib.pigeon_add_layer_norm_bf16,
               lib.pigeon_quick_gelu_bf16, lib.pigeon_swiglu_bf16,
               lib.pigeon_scale_add_layer_norm_bf16):
        fn.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_activations(name, *tensors):
    """Raise unless the activations lie on one CUDA device, share a shape
    and are bf16, contiguous and 16-byte aligned."""
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    for t in tensors:
        if tuple(t.shape) != tuple(x.shape) or t.device != x.device:
            raise ValueError(f"{name}: operands of shape {tuple(t.shape)} "
                             f"on {t.device}, x {tuple(x.shape)} on "
                             f"{x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes bf16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operand is not contiguous and "
                             f"16-byte aligned")


def _check_rows(name, weight, bias, *activations):
    """`_check_activations`, a width the row kernels take, and the LN
    parameters."""
    _check_activations(name, *activations)
    d = activations[0].shape[-1]
    if d % 8 or d > MAX_DIM:
        raise ValueError(f"{name}: D={d} must be a multiple of 8, at most "
                         f"{MAX_DIM}")
    check_ln_params(activations[0], weight, bias)


def _launch(name, fn, *args):
    lib = load()
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")


def layer_norm_bf16(x, weight, bias, eps: float):
    """``LN(x)`` over the last dimension, ``(..., D) -> (..., D)``.

    CPU tensors run :func:`layer_norm_reference`; CUDA tensors (bf16
    ``x``, f32 ``weight`` and ``bias`` of ``(D,)``, D a multiple of 8 up
    to `MAX_DIM`) launch one kernel on PyTorch's current stream and count
    one launch in ``layer_norm_bf16.launches``.
    """
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    _check_rows("layer_norm_bf16", weight, bias, x)
    out = torch.empty_like(x)
    d = x.shape[-1]
    _launch("layer_norm_bf16", "pigeon_layer_norm_bf16", x, weight, bias,
            out, x.numel() // d, d, float(eps))
    layer_norm_bf16.launches += 1
    return out


layer_norm_bf16.launches = 0


def add_layer_norm_bf16(x, a, weight, bias, eps: float):
    """``s = x + a`` and ``LN(s)`` over the last dimension: returns ``(s,
    LN(s))``, each shaped as ``x``.

    CPU tensors run :func:`add_layer_norm_reference`; CUDA tensors (``x``
    and ``a`` bf16 of one shape, the LN parameters as `layer_norm_bf16`
    takes them) launch one kernel and count one launch in
    ``add_layer_norm_bf16.launches``.
    """
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, a, weight, bias, eps)
    _check_rows("add_layer_norm_bf16", weight, bias, x, a)
    s, out = torch.empty_like(x), torch.empty_like(x)
    d = x.shape[-1]
    _launch("add_layer_norm_bf16", "pigeon_add_layer_norm_bf16", x, a,
            weight, bias, s, out, x.numel() // d, d, float(eps))
    add_layer_norm_bf16.launches += 1
    return s, out


add_layer_norm_bf16.launches = 0


def quick_gelu_bf16(x):
    """:func:`quick_gelu` of ``x``, any shape.

    CPU tensors run :func:`quick_gelu`; a CUDA tensor (bf16, contiguous,
    16-byte aligned) launches one kernel and counts one launch in
    ``quick_gelu_bf16.launches``.
    """
    if x.device.type == "cpu":
        return quick_gelu(x)
    _check_activations("quick_gelu_bf16", x)
    out = torch.empty_like(x)
    _launch("quick_gelu_bf16", "pigeon_quick_gelu_bf16", x, out, x.numel())
    quick_gelu_bf16.launches += 1
    return out


quick_gelu_bf16.launches = 0


def swiglu_bf16(u):
    """:func:`swiglu` of ``u`` ``(..., 2I)``: returns ``(..., I)``.

    CPU tensors run :func:`swiglu`; a CUDA ``u`` (bf16, contiguous, 16-byte
    aligned, I a multiple of 8) launches one kernel and counts one launch
    in ``swiglu_bf16.launches``.
    """
    if u.device.type == "cpu":
        return swiglu(u)
    _check_activations("swiglu_bf16", u)
    inter = u.shape[-1] // 2
    if u.shape[-1] % 16:
        raise ValueError(f"swiglu_bf16: width {u.shape[-1]} must be 2I, I "
                         f"a multiple of 8")
    out = u.new_empty((*u.shape[:-1], inter))
    _launch("swiglu_bf16", "pigeon_swiglu_bf16", u, out,
            u.numel() // u.shape[-1], inter)
    swiglu_bf16.launches += 1
    return out


swiglu_bf16.launches = 0


def scale_add_layer_norm_bf16(x, a, gamma, weight, bias, eps: float):
    """``s = x + gamma * a`` and ``LN(s)`` over the last dimension: returns
    ``(s, LN(s))``, each shaped as ``x``.

    CPU tensors run :func:`scale_add_layer_norm_reference`; CUDA tensors
    (``x`` and ``a`` bf16 of one shape, ``gamma`` and the LN parameters as
    `layer_norm_bf16` takes its parameters) launch one kernel and count one
    launch in ``scale_add_layer_norm_bf16.launches``.
    """
    if x.device.type == "cpu":
        return scale_add_layer_norm_reference(x, a, gamma, weight, bias, eps)
    _check_rows("scale_add_layer_norm_bf16", weight, bias, x, a)
    if (tuple(gamma.shape) != (x.shape[-1],) or gamma.dtype != torch.float32
            or gamma.device != x.device or not gamma.is_contiguous()
            or gamma.data_ptr() % 16):
        raise ValueError("scale_add_layer_norm_bf16: gamma must be f32 of "
                         "shape (D,) on x's device, contiguous and 16-byte "
                         "aligned")
    s, out = torch.empty_like(x), torch.empty_like(x)
    d = x.shape[-1]
    _launch("scale_add_layer_norm_bf16", "pigeon_scale_add_layer_norm_bf16",
            x, a, gamma, weight, bias, s, out, x.numel() // d, d, float(eps))
    scale_add_layer_norm_bf16.launches += 1
    return s, out


scale_add_layer_norm_bf16.launches = 0
