"""The attention kernels on a rank's local heads: Megatron tensor
parallelism over the mesh's ``model`` axis.

Counterpart of `pigeon_tpu/kernels/flash_attention.py:1087-1260`
(`sharded_mha`, `sharded_fused_qkv_mha`, `sharded_fused_qkv_mha_int8`).
The JAX package wraps each kernel in `jax.shard_map`; here every rank
holds its shard of the weights as a plain tensor (`train/mesh.py::
shard_params`) and calls the same kernel a one-card run calls, at
``num_heads // tp`` local heads, so the kernels never see a DTensor:

* K1 (`sharded_fused_qkv_attention`): the rank's column shard of
  Wq/Wk/Wv and of the biases, ``P = D / tp``; its backward K2 gives a
  partial ``dx``, which `copy_to_model`'s backward all-reduces over the
  ``model`` axis (the psum JAX's transpose of the replicated x inserts);
* K3, and K4 behind it (`sharded_mha`): the rank's heads of q/k/v from
  its column-parallel projections, called as on one card: attention is
  independent per head, so no collective runs;
* K8 (`sharded_fused_qkv_attention_int8`): column shards of the int8
  weights, of their per-channel scales and of the biases; the activation
  scale is replicated and each rank quantizes x itself (the same x_q
  everywhere).

The all-reduces around a row-parallel product are `reduce_from_model`
(forward all-reduce, identity backward) and `copy_to_model` (identity
forward, backward all-reduce), Megatron's ``g`` and ``f``;
`gather_from_model` joins column-parallel outputs (the geocell logits).
A `ModelAxis` names the group; a layer holds one where the model is
sharded (`train/mesh.py::tensor_parallel`), in place of the JAX
package's process-wide `set_attention_mesh`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from pigeon_tpu_torch.kernels.fused_qkv_attention import FusedQKVAttention
from pigeon_tpu_torch.kernels.fused_qkv_attention_int8 import (
    fused_qkv_attention_int8,
)


class ModelAxis(NamedTuple):
    """The ``model`` axis a rank belongs to: its process group, size and
    this rank's position in it."""

    group: object
    size: int
    rank: int


def _all_reduce(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather_along(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) joined along ``dim`` in rank
    order by one `all_gather_into_tensor`. gloo gathers no CUDA tensor
    (ranks sharing one card): there each rank writes its chunk into
    zeros of the whole and the ranks all-reduce (adding zeros is
    exact)."""
    dim = dim % x.dim()
    ranks = dist.get_world_size(group)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        shape = list(x.shape)
        n = shape[dim]
        shape[dim] = n * ranks
        out = x.new_zeros(shape)
        out.narrow(dim, dist.get_rank(group) * n, n).copy_(x)
        dist.all_reduce(out, group=group)
        return out
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((ranks * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_gather_along(x, axis.group, -1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, dim=-1)[ctx.axis.rank].contiguous(), \
            None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x``, replicated over the ``model`` axis, entering a
    column-parallel product: the forward is the identity, the backward
    all-reduces the gradient's partial sums."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The partial sums of a row-parallel product, all-reduced over the
    ``model`` axis; the backward passes the gradient through."""
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Column shards ``(..., N / tp)`` joined to ``(..., N)`` in rank
    order; the backward keeps the rank's columns of the gradient."""
    return _GatherFromModel.apply(x, axis)


def local_heads(num_heads: int, axis) -> int:
    """The heads of one rank: ``num_heads / tp`` (``axis`` None: all)."""
    if axis is None:
        return num_heads
    if num_heads % axis.size:
        raise ValueError(f"{num_heads} heads do not split over a "
                         f"{axis.size}-way model axis")
    return num_heads // axis.size


def sharded_fused_qkv_attention(x, wq, wk, wv, bq, bk, bv, num_heads: int,
                                axis: ModelAxis):
    """K1 (K2 in the backward) on the rank's heads
    (`flash_attention.py::sharded_fused_qkv_mha`): ``x`` (B, S, D)
    replicated over the axis, ``w*`` the rank's ``(D / tp, D)`` rows,
    ``b*`` its ``(D / tp,)`` entries, ``num_heads`` the GLOBAL count.
    Returns the rank's ``(B, S, D / tp)`` heads."""
    return FusedQKVAttention.apply(copy_to_model(x, axis).contiguous(),
                                   wq, wk, wv, bq, bk, bv,
                                   local_heads(num_heads, axis))


def sharded_fused_qkv_attention_int8(x, act_scale, wq, sq, bq, wk, sk, bk,
                                     wv, sv, bv, num_heads: int,
                                     axis: ModelAxis):
    """K8 on the rank's heads (`flash_attention.py::
    sharded_fused_qkv_mha_int8`): ``x`` replicated and quantized on each
    rank by the replicated ``act_scale``; ``w*`` the rank's int8 rows,
    ``s*`` and ``b*`` their scales and biases. Returns the rank's
    ``(B, S, D / tp)`` heads."""
    return fused_qkv_attention_int8(x.contiguous(), act_scale, wq, sq, bq,
                                    wk, sk, bk, wv, sv, bv,
                                    local_heads(num_heads, axis))


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             axis: ModelAxis) -> torch.Tensor:
    """An embedding lookup over the rank's ``(V / tp, D)`` rows of the
    table (the text tower's ``token_embed``, sharded by vocabulary):
    ids outside the rank's rows look up zeros, and the all-reduce over
    the ``model`` axis gives every rank the full ``(..., D)`` rows."""
    rows = weight.shape[0]
    local = ids - axis.rank * rows
    outside = (local < 0) | (local >= rows)
    found = torch.nn.functional.embedding(local.clamp(0, rows - 1), weight)
    return reduce_from_model(found.masked_fill(outside[..., None], 0.0),
                             axis)
