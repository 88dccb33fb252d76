"""The attention-backward tuning variants of `scripts/bench_attn_bwd.py`
(kernels V1-V5), for the H100.

Each replaces one Pallas body of that TPU script, on the port's
``(B, S, H, 64)`` q/k/v/g layout (K4's, `kernels/attention.py`), so a
body that wins can take K4's place without a transpose:

- V1 :func:`bwd_r_from_o` (`bwd_r_from_o`): K4's ``(dq, dk, dv)`` with
  ``r = rowsum(g * o_rec)``, ``o_rec = (bf16(u) v) / den``;
- V2 :func:`attention_dq` (`dq_body`) and V3 :func:`attention_dkv`
  (`dkv_body`): the script's ``split4``, dq and ``(dk, dv)`` in separate
  calls, each finding its own softmax statistics;
- V4 :func:`bwd_dots_only` (`dots_only`) and V5 :func:`bwd_vpu_only`
  (`vpu_only`): diagnostics, K4's products without the softmax chain and
  the chain without the output products.

All are CUDA C++ for ``sm_90a`` in `csrc/attention_bwd_variants.cu`,
built by ``nvcc`` at first use and bound with ``ctypes``; the source note
says what bounds each on the card and how the designs answer that.
All run on K4's ``wgmma`` passes (`csrc/flash_bwd_sm90.cuh`), each under
its own tag:

- V1 behind a statistics pass of its own, which sweeps the keys twice
  (the exact row max, then ``u``, ``den`` and ``o_rec`` on ``wgmma``) and
  takes ``r`` from ``o_rec``, then K4's gradient and dq passes, on K4's
  workspaces (`attention.backward_workspaces`);
- V2 behind K4's statistics pass, then a query-major dq pass that keeps
  each row's dq in registers (2 + 3 walks against the TPU body's 3);
- V3 behind K4's statistics pass, then K4's gradient pass without its dq
  product (2 + 4 walks against the TPU body's 4);
- V4 on K4's gradient pass alone, its softmax chain replaced by casts
  (``u = s``, ``dl = s dp``; no statistics pass), then K4's dq cast, on a
  zeroed ``dq_acc``: K4's gradient time minus V4's is what the exps cost;
- V5 on K4's statistics pass without the ``G V^T`` product (``dp`` the
  scaled scores; its ``g_n`` is V5's dv), then one query-major sweep for
  ``dl``, on a statistics workspace: K4's statistics time minus V5's is
  what the dp product costs.

A TPU body holds a head's whole score block in VMEM and finds each row's
max, den and r in it; a Hopper block holds 128 rows and 128 keys at a
time, so V2 and V3 take the statistics first, in a pass of their own.
V2 and V3 take K4's statistics and ``g_n`` workspaces, not its f32
``dq_acc``: V2's dq is summed in one order, the same bits every call.
The TPU script times them; on the card `scripts/bench_torch_attn_bwd.py`
does.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (``*_reference``, the arithmetic of the TPU body, which the CPU
tests hold against the script's own body in interpret mode); a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pigeon_tpu_torch import native
from pigeon_tpu_torch.kernels.attention import (
    HEAD_DIM,
    _check_operands,
    backward_workspaces,
    dq_workspace,
)


def _heads(dt, *tensors):
    """``(B, S, H, dh)`` tensors as f32 ``(B, H, S, dh)`` of their values
    rounded to ``dt``."""
    return tuple(t.to(dt).transpose(1, 2).float() for t in tensors)


def _tokens(*tensors):
    return tuple(t.transpose(1, 2).contiguous() for t in tensors)


def _softmax(qh, kh, scale):
    """``(logits, u, den)``: the scaled f32 scores, ``exp(s - max s)`` and
    its row sum."""
    logits = (qh @ kh.transpose(-1, -2)) * scale
    u = torch.exp(logits - logits.amax(-1, keepdim=True))
    return logits, u, u.sum(-1, keepdim=True)


def _r_from_output(gh, vh, u, den, dt):
    """V1's ``r = sum(g * o_rec)``, ``o_rec = (bf16(u) v) / den`` in f32."""
    return (gh * ((u.to(dt).float() @ vh) / den)).sum(-1, keepdim=True)


def bwd_r_from_o_reference(q, k, v, g):
    """Plain V1: ``(dq, dk, dv)``, each ``(B, S, H, dh)`` in ``q.dtype``.

    The arithmetic of `scripts/bench_attn_bwd.py::bwd_r_from_o`: K4's
    (`attention.flash_attention_backward_reference`) but for ``r``:
    ``o_rec = (bf16(u) v) / den`` in f32 and ``r = sum(g * o_rec)``,
    where K4 takes ``sum(dp * u) / den``."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, gh = _heads(dt, q, k, v, g)
    _, u, den = _softmax(qh, kh, scale)
    u_lo = u.to(dt).float()
    dv = (u_lo.transpose(-1, -2) @ (gh / den).to(dt).float()).to(dt)
    r = _r_from_output(gh, vh, u, den, dt)
    dp = gh @ vh.transpose(-1, -2)
    dl = (u * (dp - r) * (scale / den)).to(dt).float()
    dq = (dl @ kh).to(dt)
    dk = (dl.transpose(-1, -2) @ qh).to(dt)
    return _tokens(dq, dk, dv)


def bwd_r_from_o_stats_reference(q, k, v, g):
    """Plain V1's row statistics, ``(3, B, H, S)`` f32 in K4's workspace
    layout: ``m`` (the max of ``s = q k^T * dh ** -0.5``), ``den =
    sum(exp(s - m))`` and ``r`` of :func:`bwd_r_from_o_reference`."""
    dt = q.dtype
    qh, kh, vh, gh = _heads(dt, q, k, v, g)
    logits, u, den = _softmax(qh, kh, q.shape[-1] ** -0.5)
    r = _r_from_output(gh, vh, u, den, dt)
    return torch.stack([logits.amax(-1), den[..., 0], r[..., 0]])


def _k4_dl(qh, kh, vh, gh, dt):
    """K4's ``(u, den, dl)``: ``r = sum(dp * u) / den`` from the f32 ``u``
    and ``dl = bf16(u (dp - r) scale / den)``."""
    scale = qh.shape[-1] ** -0.5
    _, u, den = _softmax(qh, kh, scale)
    dp = gh @ vh.transpose(-1, -2)
    r = (dp * u).sum(-1, keepdim=True) / den
    return u, den, (u * (dp - r) * (scale / den)).to(dt).float()


def attention_dq_reference(q, k, v, g):
    """Plain V2: dq ``(B, S, H, dh)``, the arithmetic of
    `scripts/bench_attn_bwd.py::dq_body` (K4's dq)."""
    dt = q.dtype
    qh, kh, vh, gh = _heads(dt, q, k, v, g)
    _, _, dl = _k4_dl(qh, kh, vh, gh, dt)
    return _tokens((dl @ kh).to(dt))[0]


def attention_dkv_reference(q, k, v, g):
    """Plain V3: ``(dk, dv)``, the arithmetic of
    `scripts/bench_attn_bwd.py::dkv_body` (K4's dk and dv)."""
    dt = q.dtype
    qh, kh, vh, gh = _heads(dt, q, k, v, g)
    u, den, dl = _k4_dl(qh, kh, vh, gh, dt)
    dv = (u.to(dt).float().transpose(-1, -2)
          @ (gh / den).to(dt).float()).to(dt)
    dk = (dl.transpose(-1, -2) @ qh).to(dt)
    return _tokens(dk, dv)


def bwd_dots_only_reference(q, k, v, g):
    """Plain V4: ``(dq, dk, dv)`` of `scripts/bench_attn_bwd.py::dots_only`
    (a diagnostic): ``s = q k^T`` unscaled in f32, ``dv = bf16(s)^T g``,
    ``dp = g v^T``, ``dl = bf16(s * dp)``, ``dq = dl k``,
    ``dk = dl^T q``."""
    dt = q.dtype
    qh, kh, vh, gh = _heads(dt, q, k, v, g)
    s = qh @ kh.transpose(-1, -2)
    dv = (s.to(dt).float().transpose(-1, -2) @ gh).to(dt)
    dl = (s * (gh @ vh.transpose(-1, -2))).to(dt).float()
    dq = (dl @ kh).to(dt)
    dk = (dl.transpose(-1, -2) @ qh).to(dt)
    return _tokens(dq, dk, dv)


def bwd_vpu_only_reference(q, k, v, g):
    """Plain V5: ``(dq, dk, dv, dl_abs)`` of
    `scripts/bench_attn_bwd.py::vpu_only` (a diagnostic): the softmax
    chain with ``dp`` the scaled scores, ``dl = u (dp - r) scale / den``
    in f32, ``dq = bf16(q + bf16(dl[:, :64]))``, ``dk = k``,
    ``dv = bf16(g / den)``; ``dl_abs`` ``(B, H, S)`` f32 is each row's
    ``sum(|dl|)`` over all keys, the side output that keeps the kernel's
    S-wide chain alive. Needs S >= 64."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    qh, kh, gh = _heads(dt, q, k, g)
    logits, u, den = _softmax(qh, kh, scale)
    r = (logits * u).sum(-1, keepdim=True) / den
    dl = u * (logits - r) * (scale / den)
    dq = (qh + dl[..., :HEAD_DIM].to(dt).float()).to(dt)
    dv = (gh / den).to(dt)
    dq, dv = _tokens(dq, dv)
    return dq, k.to(dt).clone(), dv, dl.abs().sum(-1)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the variants' library."""
    lib = ctypes.CDLL(native.build_cuda("attention_bwd_variants").path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptrs in (("bwd_r_from_o", 10), ("dq", 7), ("dkv", 8),
                       ("bwd_dots_only", 8), ("bwd_vpu_only", 9)):
        entry = getattr(lib, f"pigeon_attention_{fn}")
        entry.argtypes = [ptr] * n_ptrs + [i32] * 3 + [ptr]
        entry.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(q, k, v, g, min_seq: int = 1) -> None:
    """Raise unless q/k/v/g are operands the CUDA variants take: K4's
    (`attention._check_operands`) and S >= ``min_seq``."""
    _check_operands(q, k, v, max_seq=q.shape[1])
    _check_operands(q, g, g, max_seq=q.shape[1])
    if q.shape[1] < min_seq:
        raise ValueError(f"S={q.shape[1]} below {min_seq}: the TPU body "
                         f"slices {min_seq} key columns")


def _on_card(name: str, q, k, v, g, min_seq: int = 1) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    check_operands(q, k, v, g, min_seq)


def _launch(name: str, q, *tensors) -> None:
    """Launch ``pigeon_attention_<name>`` on ``q``'s current stream with
    the tensors' pointers and q's (B, S, H); raise on its error."""
    lib = load()
    b, s, h, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"pigeon_attention_{name}")(
            q.data_ptr(), *(t.data_ptr() for t in tensors), b, s, h, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.pigeon_cuda_error_string(rc).decode()} "
                           f"(CUDA error {rc})")


def _stats(q) -> torch.Tensor:
    """K4's row-statistics workspace (3, B, H, S) f32, which V2, V3 and V5
    take."""
    b, s, h, _ = q.shape
    return torch.empty((3, b, h, s), dtype=torch.float32, device=q.device)


def _stats_workspaces(q) -> tuple:
    """K4's row-statistics (3, B, H, S) f32 and ``g_n`` (B, S, H, 64)
    workspaces, which V2 and V3 take (not its ``dq_acc``)."""
    return _stats(q), torch.empty_like(q)


def bwd_r_from_o(q, k, v, g):
    """V1: ``(dq, dk, dv)`` of softmax attention, ``r`` from the recomputed
    output; CPU tensors run :func:`bwd_r_from_o_reference`. K4's
    workspaces (statistics, ``g_n``, zeroed ``dq_acc``) are allocated
    here."""
    if q.device.type == "cpu":
        return bwd_r_from_o_reference(q, k, v, g)
    _on_card("bwd_r_from_o", q, k, v, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("bwd_r_from_o", q, k, v, g, dq, dk, dv, *backward_workspaces(q))
    bwd_r_from_o.launches += 1
    return dq, dk, dv


bwd_r_from_o.launches = 0


def attention_dq(q, k, v, g):
    """V2: dq alone, its row statistics found by K4's statistics pass;
    CPU tensors run :func:`attention_dq_reference`."""
    if q.device.type == "cpu":
        return attention_dq_reference(q, k, v, g)
    _on_card("attention_dq", q, k, v, g)
    dq = torch.empty_like(q)
    _launch("dq", q, k, v, g, dq, *_stats_workspaces(q))
    attention_dq.launches += 1
    return dq


attention_dq.launches = 0


def attention_dkv(q, k, v, g):
    """V3: ``(dk, dv)`` alone, its row statistics found by a pass of its
    own; CPU tensors run :func:`attention_dkv_reference`."""
    if q.device.type == "cpu":
        return attention_dkv_reference(q, k, v, g)
    _on_card("attention_dkv", q, k, v, g)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch("dkv", q, k, v, g, dk, dv, *_stats_workspaces(q))
    attention_dkv.launches += 1
    return dk, dv


attention_dkv.launches = 0


def bwd_dots_only(q, k, v, g):
    """V4 (diagnostic): ``(dq, dk, dv)`` of K4's products with casts for
    the softmax chain; CPU tensors run :func:`bwd_dots_only_reference`.
    K4's zeroed ``dq_acc`` is allocated here, not its statistics or
    ``g_n``."""
    if q.device.type == "cpu":
        return bwd_dots_only_reference(q, k, v, g)
    _on_card("bwd_dots_only", q, k, v, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("bwd_dots_only", q, k, v, g, dq, dk, dv, dq_workspace(q))
    bwd_dots_only.launches += 1
    return dq, dk, dv


bwd_dots_only.launches = 0


def bwd_vpu_only(q, k, v, g):
    """V5 (diagnostic): ``(dq, dk, dv, dl_abs)`` of the softmax chain
    alone; CPU tensors run :func:`bwd_vpu_only_reference`. Needs
    S >= 64. K4's statistics workspace is allocated here; dv is its
    statistics pass's ``g_n``."""
    if q.device.type == "cpu":
        return bwd_vpu_only_reference(q, k, v, g)
    _on_card("bwd_vpu_only", q, k, v, g, min_seq=HEAD_DIM)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    b, s, h, _ = q.shape
    dl_abs = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("bwd_vpu_only", q, k, v, g, dq, dk, dv, dl_abs, _stats(q))
    bwd_vpu_only.launches += 1
    return dq, dk, dv, dl_abs


bwd_vpu_only.launches = 0
