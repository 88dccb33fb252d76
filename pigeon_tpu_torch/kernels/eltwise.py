"""One-pass LayerNorm, residual add + LayerNorm, quick-GELU, SwiGLU and
LayerScale'd residual add + LayerNorm, for the H100: the element-wise chain
of each encoder layer; and the backwards of the first three, for training.

These replace no TPU kernel: XLA fuses this chain on the TPU. On the card
`models/clip.py`'s `TransformerLayer` ran it as eager PyTorch kernels
through f32 round trips (``x.float()``, ``F.layer_norm``, ``.to``; three
kernels for quick-GELU), and autograd ran their backwards, as many again;
it now launches these instead (the layer's docstring says where). They
are CUDA C++ for ``sm_90a`` (`csrc/eltwise.cu`), built by ``nvcc`` at
first use and bound with ``ctypes``; the source note says what bounds them
and how the design answers that:

* :func:`layer_norm_bf16`: ``LN(x)``, f32 statistics, bf16 in and out;
  with ``stats``, each row's f32 mean and rstd for the backward;
* :func:`add_layer_norm_bf16`: ``s = x + a`` and ``LN(s)`` in one pass;
* :func:`quick_gelu_bf16`: ``x * sigmoid(1.702 x)`` in one pass;
* :func:`swiglu_bf16`: ``silu(u1) * u2`` of the fc-in output ``u = [u1 |
  u2]`` in one pass (DINOv2's gated MLP);
* :func:`scale_add_layer_norm_bf16`: ``s = x + gamma * a`` and ``LN(s)`` in
  one pass (a LayerScale'd residual, DINOv2's);
* :func:`layer_norm_bwd_bf16`: LN's input gradient from the saved
  statistics, and its scale and bias gradients where they train;
* :func:`add_layer_norm_bwd_bf16`: ``ds + LN'(s) dh``, the gradient of
  both addends, in one pass;
* :func:`quick_gelu_bwd_bf16`: quick-GELU's gradient from its input alone.

Each rounds where the eager composition, or eager autograd, rounds, and
each has that composition beside it as its plain version
(:func:`layer_norm_reference`, :func:`add_layer_norm_reference`,
:func:`quick_gelu`, :func:`swiglu`, :func:`scale_add_layer_norm_reference`,
:func:`layer_norm_backward_reference`,
:func:`add_layer_norm_backward_reference`,
:func:`quick_gelu_backward_reference`). Dispatch is by the tensor's
device: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel (bf16 activations, f32 LayerNorm parameters and LayerScale) or
raises.

Training reaches the backwards through three autograd functions,
:class:`LayerNormBF16`, :class:`AddLayerNormBF16` and
:class:`QuickGeluBF16`, whose forwards are the registered operators
``pigeon::layer_norm``, ``pigeon::add_layer_norm`` and
``pigeon::quick_gelu``: the remat policies see and recompute those, so a
checkpointed layer's recompute launches the forward kernels too. SwiGLU
and the LayerScale'd add have no backward: DINOv2's layers train on the
eager chain.
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


def layer_norm_stats_reference(x, weight, bias, eps: float):
    """`layer_norm_reference` and each row's f32 mean and rstd as
    ``F.layer_norm`` computes them (``torch.native_layer_norm``, which it
    calls): returns ``(LN(x), stats)``, ``stats`` ``(2, rows)`` f32, the
    means in row 0 and the rstds in row 1."""
    out, mean, rstd = torch.native_layer_norm(x.float(), weight.shape,
                                              weight, bias, eps)
    return out.to(x.dtype), torch.stack([mean.reshape(-1),
                                         rstd.reshape(-1)])


def layer_norm_backward_reference(x, dy, weight, bias, stats,
                                  weight_grads: bool):
    """The gradient of `layer_norm_reference` at ``x`` for ``dy``, as
    autograd forms it: ``dy`` cast to f32, ``F.layer_norm``'s backward on
    the forward's ``stats`` (`layer_norm_stats_reference`), the input
    gradient rounded to ``x.dtype``. Returns ``(dx, dweight, dbias)``, the
    last two f32 where ``weight_grads`` asks for them, else None."""
    shape = (*x.shape[:-1], 1)
    dx, dw, db = torch.ops.aten.native_layer_norm_backward(
        dy.float(), x.float(), list(weight.shape), stats[0].reshape(shape),
        stats[1].reshape(shape), weight, bias,
        [True, weight_grads, weight_grads])
    return dx.to(x.dtype), dw, db


def add_layer_norm_backward_reference(s, ds, dh, weight, bias, stats,
                                      weight_grads: bool):
    """The gradient of `add_layer_norm_reference` for ``ds`` (of the sum
    ``s``) and ``dh`` (of ``LN(s)``): `layer_norm_backward_reference`'s
    input gradient, rounded, plus ``ds`` in ``s.dtype``, which is both
    addends' gradient. Returns ``(dx, dweight, dbias)``."""
    dx, dw, db = layer_norm_backward_reference(s, dh, weight, bias, stats,
                                               weight_grads)
    return ds + dx, dw, db


def quick_gelu_backward_reference(u, dy):
    """The gradient of :func:`quick_gelu` at ``u`` for ``dy``, as autograd
    forms it on ``u * s``, ``s = sigmoid(t)``, ``t = 1.702 u``: ``dy s``
    and, through ``dy u``, ``sigmoid_backward`` and ``1.702``, the second
    path, each product rounded to ``u.dtype``, then their sum."""
    s = torch.sigmoid(1.702 * u)
    dt = torch.ops.aten.sigmoid_backward(dy * u, s)
    return dy * s + dt * 1.702


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
    lib.pigeon_layer_norm_bf16.argtypes = [ptr] * 4 + [i32, i32, f32, ptr,
                                                       ptr]
    lib.pigeon_add_layer_norm_bf16.argtypes = [ptr] * 6 + [i32, i32, f32,
                                                           ptr, ptr]
    lib.pigeon_quick_gelu_bf16.argtypes = [ptr, ptr, ctypes.c_int64, ptr]
    lib.pigeon_swiglu_bf16.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.pigeon_scale_add_layer_norm_bf16.argtypes = [ptr] * 7 + [
        i32, i32, f32, ptr]
    lib.pigeon_layer_norm_bwd_bf16.argtypes = [ptr] * 9 + [i32, i32, i32,
                                                           ptr]
    lib.pigeon_quick_gelu_bwd_bf16.argtypes = [ptr, ptr, ptr,
                                               ctypes.c_int64, ptr]
    for fn in (lib.pigeon_layer_norm_bf16, lib.pigeon_add_layer_norm_bf16,
               lib.pigeon_quick_gelu_bf16, lib.pigeon_swiglu_bf16,
               lib.pigeon_scale_add_layer_norm_bf16,
               lib.pigeon_layer_norm_bwd_bf16,
               lib.pigeon_quick_gelu_bwd_bf16):
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


def _check_stats(name, stats, x):
    """Raise unless ``stats`` is f32 ``(2, rows)`` of ``x``, contiguous on
    its device."""
    rows = x.numel() // x.shape[-1]
    if (tuple(stats.shape) != (2, rows) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"{name}: stats must be f32 (2, {rows}) on "
                         f"{x.device}, contiguous; got {stats.dtype} "
                         f"{tuple(stats.shape)} on {stats.device}")


def _launch(name, fn, *args):
    """``fn`` of the library on PyTorch's current stream; a tensor passes
    its pointer, None a null one."""
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


def _plain_layer_norm(x, weight, bias, eps: float, stats):
    """:func:`layer_norm_reference`, and with ``stats`` the row statistics
    of :func:`layer_norm_stats_reference` written there."""
    if stats is None:
        return layer_norm_reference(x, weight, bias, eps)
    out, got = layer_norm_stats_reference(x, weight, bias, eps)
    stats.copy_(got)
    return out


def layer_norm_bf16(x, weight, bias, eps: float, stats=None):
    """``LN(x)`` over the last dimension, ``(..., D) -> (..., D)``; with
    ``stats`` (f32 ``(2, rows)``), each row's mean and rstd are written
    there too (the backward's, :func:`layer_norm_bwd_bf16`).

    CPU tensors run :func:`layer_norm_reference` (with ``stats``,
    :func:`layer_norm_stats_reference`); CUDA tensors (bf16 ``x``, f32
    ``weight`` and ``bias`` of ``(D,)``, D a multiple of 8 up to
    `MAX_DIM`) launch one kernel on PyTorch's current stream and count one
    launch in ``layer_norm_bf16.launches``.
    """
    if x.device.type == "cpu":
        return _plain_layer_norm(x, weight, bias, eps, stats)
    _check_rows("layer_norm_bf16", weight, bias, x)
    if stats is not None:
        _check_stats("layer_norm_bf16", stats, x)
    out = torch.empty_like(x)
    d = x.shape[-1]
    _launch("layer_norm_bf16", "pigeon_layer_norm_bf16", x, weight, bias,
            out, x.numel() // d, d, float(eps), stats)
    layer_norm_bf16.launches += 1
    return out


layer_norm_bf16.launches = 0


def add_layer_norm_bf16(x, a, weight, bias, eps: float, stats=None):
    """``s = x + a`` and ``LN(s)`` over the last dimension: returns ``(s,
    LN(s))``, each shaped as ``x``; ``stats`` as `layer_norm_bf16` takes
    it, of ``s``.

    CPU tensors run :func:`add_layer_norm_reference`; CUDA tensors (``x``
    and ``a`` bf16 of one shape, the LN parameters as `layer_norm_bf16`
    takes them) launch one kernel and count one launch in
    ``add_layer_norm_bf16.launches``.
    """
    if x.device.type == "cpu":
        s = x + a
        return s, _plain_layer_norm(s, weight, bias, eps, stats)
    _check_rows("add_layer_norm_bf16", weight, bias, x, a)
    if stats is not None:
        _check_stats("add_layer_norm_bf16", stats, x)
    s, out = torch.empty_like(x), torch.empty_like(x)
    d = x.shape[-1]
    _launch("add_layer_norm_bf16", "pigeon_add_layer_norm_bf16", x, a,
            weight, bias, s, out, x.numel() // d, d, float(eps), stats)
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def param_grad_blocks(rows: int, device) -> int:
    """The blocks that take ``rows`` where the LayerNorm's own gradients
    are formed: two a multiprocessor (their column sums in registers hold
    two blocks of eight warps on one), at most one a row's warp group."""
    return min(-(-rows // (256 // 32)), 2 * _sm_count(device.index or 0))


def _ln_backward(name, x, ds, dy, weight, bias, stats, weight_grads: bool):
    """`layer_norm_bwd_bf16` and `add_layer_norm_bwd_bf16` on CUDA
    tensors: one call of the C entry point (a second launch sums the
    blocks' column sums where ``weight_grads``)."""
    _check_rows(name, weight, bias, x, dy, *(() if ds is None else (ds,)))
    _check_stats(name, stats, x)
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    partial = dw = db = None
    blocks = 0
    if weight_grads:
        blocks = param_grad_blocks(rows, x.device)
        partial = torch.empty((blocks, 2, d), dtype=torch.float32,
                              device=x.device)
        dw, db = torch.empty_like(weight), torch.empty_like(bias)
    _launch(name, "pigeon_layer_norm_bwd_bf16", x, dy, ds, stats, weight,
            dx, partial, dw, db, rows, d, blocks)
    return dx, dw, db


def layer_norm_bwd_bf16(x, dy, weight, bias, stats, weight_grads: bool):
    """The gradient of ``LN(x)`` for ``dy`` from the forward's ``stats``
    (`layer_norm_bf16`'s): returns ``(dx, dweight, dbias)``, the last two
    f32 ``(D,)`` where ``weight_grads``, else None.

    CPU tensors run :func:`layer_norm_backward_reference`; CUDA tensors
    (``x`` and ``dy`` bf16 of one shape, the LN parameters as
    `layer_norm_bf16` takes them) launch one kernel (two with
    ``weight_grads``) and count one launch in
    ``layer_norm_bwd_bf16.launches``.
    """
    if x.device.type == "cpu":
        return layer_norm_backward_reference(x, dy, weight, bias, stats,
                                             weight_grads)
    out = _ln_backward("layer_norm_bwd_bf16", x, None, dy, weight, bias,
                       stats, weight_grads)
    layer_norm_bwd_bf16.launches += 1
    return out


layer_norm_bwd_bf16.launches = 0


def add_layer_norm_bwd_bf16(s, ds, dh, weight, bias, stats,
                            weight_grads: bool):
    """The gradient of ``(s, LN(s))``, ``s = x + a``, for ``ds`` and
    ``dh``: ``dx = da = ds + LN'(s) dh`` in one pass, with
    ``(dweight, dbias)`` as :func:`layer_norm_bwd_bf16` gives them.

    CPU tensors run :func:`add_layer_norm_backward_reference`; CUDA
    tensors (bf16 ``s``, ``ds``, ``dh`` of one shape) launch one kernel
    (two with ``weight_grads``) and count one launch in
    ``add_layer_norm_bwd_bf16.launches``.
    """
    if s.device.type == "cpu":
        return add_layer_norm_backward_reference(s, ds, dh, weight, bias,
                                                 stats, weight_grads)
    out = _ln_backward("add_layer_norm_bwd_bf16", s, ds, dh, weight, bias,
                       stats, weight_grads)
    add_layer_norm_bwd_bf16.launches += 1
    return out


add_layer_norm_bwd_bf16.launches = 0


def quick_gelu_bwd_bf16(u, dy):
    """The gradient of :func:`quick_gelu` at ``u`` for ``dy``, any shape.

    CPU tensors run :func:`quick_gelu_backward_reference`; CUDA tensors
    (bf16 of one shape, contiguous, 16-byte aligned) launch one kernel and
    count one launch in ``quick_gelu_bwd_bf16.launches``.
    """
    if u.device.type == "cpu":
        return quick_gelu_backward_reference(u, dy)
    _check_activations("quick_gelu_bwd_bf16", u, dy)
    du = torch.empty_like(u)
    _launch("quick_gelu_bwd_bf16", "pigeon_quick_gelu_bwd_bf16", u, dy, du,
            u.numel())
    quick_gelu_bwd_bf16.launches += 1
    return du


quick_gelu_bwd_bf16.launches = 0


def _layer_norm_op(x, weight, bias, eps: float):
    stats = torch.empty((2, x.numel() // x.shape[-1]), dtype=torch.float32,
                        device=x.device)
    return layer_norm_bf16(x, weight, bias, eps, stats), stats


def _add_layer_norm_op(x, a, weight, bias, eps: float):
    stats = torch.empty((2, x.numel() // x.shape[-1]), dtype=torch.float32,
                        device=x.device)
    return (*add_layer_norm_bf16(x, a, weight, bias, eps, stats), stats)


def _quick_gelu_op(x):
    return quick_gelu_bf16(x)


#: The forwards with their saved statistics as registered operators,
#: ``torch.ops.pigeon.layer_norm``, ``.add_layer_norm`` and
#: ``.quick_gelu``: the remat policies see them (`models/clip.py::
#: _remat_policy`) and recompute them, so a checkpointed layer's
#: recompute launches these kernels, not the eager chain.
_LIBRARY = torch.library.Library("pigeon", "FRAGMENT")
_LIBRARY.define("layer_norm(Tensor x, Tensor weight, Tensor bias, "
                "float eps) -> (Tensor, Tensor)")
_LIBRARY.impl("layer_norm", _layer_norm_op, "CompositeExplicitAutograd")
_LIBRARY.define("add_layer_norm(Tensor x, Tensor a, Tensor weight, "
                "Tensor bias, float eps) -> (Tensor, Tensor, Tensor)")
_LIBRARY.impl("add_layer_norm", _add_layer_norm_op,
              "CompositeExplicitAutograd")
_LIBRARY.define("quick_gelu(Tensor x) -> Tensor")
_LIBRARY.impl("quick_gelu", _quick_gelu_op, "CompositeExplicitAutograd")
LAYER_NORM_OP = torch.ops.pigeon.layer_norm.default
ADD_LAYER_NORM_OP = torch.ops.pigeon.add_layer_norm.default
QUICK_GELU_OP = torch.ops.pigeon.quick_gelu.default


class LayerNormBF16(torch.autograd.Function):
    """`layer_norm_bf16` forward, saving ``x`` and the row statistics, and
    `layer_norm_bwd_bf16` backward: ``(x, weight, bias, eps) -> LN(x)``.
    The weight and bias gradients are formed only where they train."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        out, stats = LAYER_NORM_OP(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, bias, stats)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, db = layer_norm_bwd_bf16(x, dy.contiguous(), weight, bias,
                                         stats, need[1] or need[2])
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None)


class AddLayerNormBF16(torch.autograd.Function):
    """`add_layer_norm_bf16` forward, saving the sum and the statistics,
    and `add_layer_norm_bwd_bf16` backward: ``(x, a, weight, bias, eps) ->
    (s, LN(s))``, ``s = x + a``; both addends take the one gradient."""

    @staticmethod
    def forward(ctx, x, a, weight, bias, eps):
        s, out, stats = ADD_LAYER_NORM_OP(x, a, weight, bias, eps)
        ctx.save_for_backward(s, weight, bias, stats)
        ctx.set_materialize_grads(False)
        return s, out

    @staticmethod
    def backward(ctx, ds, dh):
        s, weight, bias, stats = ctx.saved_tensors
        need = ctx.needs_input_grad
        wants = need[2] or need[3]
        dw = db = None
        if dh is None:
            dx = ds
        elif ds is None:
            dx, dw, db = layer_norm_bwd_bf16(s, dh.contiguous(), weight,
                                             bias, stats, wants)
        else:
            dx, dw, db = add_layer_norm_bwd_bf16(
                s, ds.contiguous(), dh.contiguous(), weight, bias, stats,
                wants)
        return (dx if need[0] else None, dx if need[1] else None,
                dw if need[2] else None, db if need[3] else None, None)


class QuickGeluBF16(torch.autograd.Function):
    """`quick_gelu_bf16` forward, saving its input alone, and
    `quick_gelu_bwd_bf16` backward, which computes ``t`` and ``s`` again."""

    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return QUICK_GELU_OP(u)

    @staticmethod
    def backward(ctx, dy):
        (u,) = ctx.saved_tensors
        return quick_gelu_bwd_bf16(u, dy.contiguous())
