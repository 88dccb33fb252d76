"""The device mesh and the sharding rules: the port's scale-out backend.

Counterpart of `pigeon_tpu/train/mesh.py`. The JAX package runs one
GSPMD program over a `jax.sharding.Mesh` with a ``data`` and a ``model``
axis; the port runs one process per card (`torchrun`) over a
`torch.distributed.device_mesh.DeviceMesh` with the same two axes:

* ``data``: DDP, or FSDP2 (`fully_shard` per encoder layer and at the
  root) under ``--fsdp``; each rank takes its contiguous slice of the
  global batch (`shard_batch`);
* ``model``: Megatron tensor parallelism written by hand
  (`tensor_parallel`): each rank keeps its shard of the weights as a
  plain tensor (`shard_params`, by `DEFAULT_RULES`) and the layers call
  the one-card kernels on their local heads (`kernels/sharded.py`).

Ranks are laid out as JAX's ``devices.reshape(n // tp, tp)``: the ranks
of one model group are consecutive. Without a process group (no
`torchrun`) the mesh is one rank and nothing is wrapped.

Deviations from the JAX layout: FSDP2 shards every parameter's dim 0
(JAX's `fsdp_param_specs` shards a leaf's largest free dim above 2^14
elements; no number changes), and a layer whose widths the model axis
does not divide stays replicated (GSPMD would pad; JAX's sharded
attention drops the head axis the same way).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pigeon_tpu_torch.kernels.sharded import ModelAxis, all_gather_along
from pigeon_tpu_torch.train.multihost import distributed, host_slice

#: Routes whose kernels have no sharded hosting in the JAX package
#: (`pigeon_tpu/cli/run.py:137-140`): K5, K6, K7 and K9.
UNSHARDED_ROUTES = ("fused_ln", "fused_mlp", "block")

#: (regex over a parameter's dotted name, the mesh axis of each of the
#: tensor's dims in torch's layout) -- first match wins, no match
#: replicates. Megatron's split, as `pigeon_tpu/train/mesh.py:58-68`:
#: q/k/v and fc1 by output features (torch's dim 0), out_proj and fc2 by
#: input features (dim 1), the cell layer by cells, the text token table
#: by vocabulary. An int8 layer's per-channel ``scale`` follows its rows.
DEFAULT_RULES: Sequence[Tuple[str, tuple]] = (
    (r".*encoder\.layers\.\d+\.attn\.(q_proj|k_proj|v_proj)\.weight",
     ("model", None)),
    (r".*encoder\.layers\.\d+\.attn\.(q_proj|k_proj|v_proj)\.(bias|scale)",
     ("model",)),
    (r".*encoder\.layers\.\d+\.attn\.out_proj\.weight", (None, "model")),
    (r".*encoder\.layers\.\d+\.fc1\.weight", ("model", None)),
    (r".*encoder\.layers\.\d+\.fc1\.(bias|scale)", ("model",)),
    (r".*encoder\.layers\.\d+\.fc2\.weight", (None, "model")),
    (r".*head\.cell_layer\.weight", ("model", None)),
    (r".*head\.cell_layer\.bias", ("model",)),
    (r".*token_embed\.weight", ("model", None)),
)


def launched_by_torchrun() -> bool:
    """Whether this process was started by `torchrun` (it sets both)."""
    return "LOCAL_RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device="cuda") -> torch.device:
    """Join the process group of this run and return the rank's device.

    * A group the caller already made (a test, the smoke) is used as it
      is; a CUDA rank keeps the current card.
    * Under `torchrun` the group is made: gloo for ``--device cpu``;
      for CUDA ``cpu:gloo,cuda:nccl`` (NCCL for the card's tensors, gloo
      for the CPU flags and object gathers) on ``cuda:LOCAL_RANK``.
    * Otherwise the run is one process, with no group, on ``device``.
    """
    device = torch.device(device)
    if distributed():
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not launched_by_torchrun():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        dist.init_process_group("cpu:gloo,cuda:nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of ranks: ``dp`` x ``tp``, this rank's
    place in it, and the `DeviceMesh` (None for one process without a
    group). A pipeline's mesh (`train/pipeline.py::create_pipeline_mesh`)
    is ``(data, stage, model)``, ``pp`` stages between the two."""

    dp: int = 1
    tp: int = 1
    data_rank: int = 0
    model_rank: int = 0
    device_mesh: object = None
    pp: int = 1
    stage_rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        if self.pp > 1:
            return {"data": self.dp, "stage": self.pp, "model": self.tp}
        return {"data": self.dp, "model": self.tp}

    @property
    def data_group(self):
        return (None if self.device_mesh is None
                else self.device_mesh.get_group("data"))

    @property
    def stage_group(self):
        """The ranks that hold the other stages of this rank's layers
        (same data and model coordinates), in stage order."""
        return (None if self.pp == 1
                else self.device_mesh.get_group("stage"))

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """The `ModelAxis` of this rank, or None where ``tp`` is 1."""
        if self.tp == 1:
            return None
        return ModelAxis(self.device_mesh.get_group("model"), self.tp,
                         self.model_rank)


def create_mesh(tp: int = 1, device_type: str = "cpu") -> Mesh:
    """The ``(world / tp, tp)`` mesh over every rank of the process group
    (`pigeon_tpu/train/mesh.py::create_mesh`); ``tp`` must divide the
    world size. One process without a group is the 1 x 1 mesh."""
    world = dist.get_world_size() if distributed() else 1
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} must divide the world size {world}")
    if not distributed():
        return Mesh()
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, (world // tp, tp),
                                   mesh_dim_names=("data", "model"))
    rank = dist.get_rank()
    return Mesh(dp=world // tp, tp=tp, data_rank=rank // tp,
                model_rank=rank % tp, device_mesh=device_mesh)


def spec_for_path(name: str,
                  rules: Sequence[Tuple[str, tuple]] = DEFAULT_RULES
                  ) -> tuple:
    """The per-dim mesh axes of the parameter ``name`` (``()``:
    replicated)."""
    for pattern, spec in rules:
        if re.fullmatch(pattern, name):
            return spec
    return ()


def param_specs(state: Dict[str, torch.Tensor],
                rules: Sequence[Tuple[str, tuple]] = DEFAULT_RULES
                ) -> Dict[str, tuple]:
    """The spec of every entry of a state dict."""
    return {name: spec_for_path(name, rules) for name in state}


def model_dim(spec: tuple) -> Optional[int]:
    """The dim a spec splits over ``model``, or None."""
    return spec.index("model") if "model" in spec else None


def shard_params(state: Dict[str, torch.Tensor], mesh: Mesh,
                 specs: Optional[Dict[str, tuple]] = None
                 ) -> Dict[str, torch.Tensor]:
    """This rank's shard of a full state dict (the port's names, as
    `models/jax_bridge.py` gives them): every entry whose spec names
    ``model`` keeps the rank's equal chunk of that dim, the rest stays
    whole (`pigeon_tpu/train/mesh.py::shard_params`)."""
    specs = param_specs(state) if specs is None else specs
    out = {}
    for name, t in state.items():
        dim = model_dim(specs.get(name, ()))
        if dim is not None and mesh.tp > 1:
            if t.shape[dim] % mesh.tp:
                raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} "
                                 f"does not split over tp={mesh.tp}")
            # A storage of its own: a view would keep the whole tensor.
            t = t.chunk(mesh.tp, dim)[mesh.model_rank].clone(
                memory_format=torch.contiguous_format)
        out[name] = t
    return out


def gather_params(local: Dict[str, torch.Tensor], mesh: Mesh,
                  specs: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """The full state dict from each rank's `shard_params` (an
    all-gather over ``model`` for every split entry); the inverse of
    `shard_params`, bit for bit."""
    axis = mesh.model_axis
    out = {}
    for name, t in local.items():
        dim = model_dim(specs.get(name, ()))
        if dim is not None and axis is not None:
            t = all_gather_along(t, axis.group, dim)
        out[name] = t
    return out


def full_parameters(model: nn.Module, mesh: Mesh,
                    trainable_only: bool = False) -> Dict[str, torch.Tensor]:
    """A sharded model's parameters, whole, on every rank: FSDP2's shards
    gathered over ``data``, the tensor-parallel ones over ``model``."""
    local = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
             .detach() for n, p in model.named_parameters()
             if p.requires_grad or not trainable_only}
    return gather_params(local, mesh, getattr(model, "tp_specs", {}))


def tp_specs(model: nn.Module, tp: int,
             rules: Sequence[Tuple[str, tuple]] = DEFAULT_RULES
             ) -> Dict[str, tuple]:
    """The specs `tensor_parallel` shards ``model`` by: `DEFAULT_RULES`,
    less every layer whose widths ``tp`` does not divide. An attention
    layer whose heads ``tp`` does not divide keeps all of them, as
    `sharded_fused_qkv_mha` drops its head axis
    (`pigeon_tpu/kernels/flash_attention.py:1149-1151`)."""
    from pigeon_tpu_torch.models.clip import MultiHeadAttention

    state = model.state_dict()
    specs = {n: s for n, s in param_specs(state, rules).items()
             if model_dim(s) is not None}
    for name, module in model.named_modules():
        if isinstance(module, MultiHeadAttention) and module.num_heads % tp:
            specs = {n: s for n, s in specs.items()
                     if not n.startswith(f"{name}.")}
    return {n: s for n, s in specs.items()
            if state[n].shape[model_dim(s)] % tp == 0}


def _set_tensor(model: nn.Module, name: str, value: torch.Tensor) -> None:
    path, _, leaf = name.rpartition(".")
    module = model.get_submodule(path)
    if leaf in module._parameters:
        old = module._parameters[leaf]
        module._parameters[leaf] = nn.Parameter(
            value, requires_grad=old.requires_grad)
    else:
        module._buffers[leaf] = value


def check_widths(model: nn.Module, mesh: Mesh, device) -> None:
    """Stop what the model axis cannot run: a route without a sharded
    hosting (K5, K6, K7, K9), and on the card a fused route whose local
    heads are not a multiple of 128 wide (K1's, K2's and K8's GEMMs take
    P in multiples of 128: for 64-wide heads, two heads a rank at least,
    so tp = 16 stops ViT-L/14)."""
    from pigeon_tpu_torch.kernels.fused_qkv_attention import GEMM_TILE
    from pigeon_tpu_torch.models.clip import FUSED_IMPLS, MultiHeadAttention

    if mesh.tp == 1:
        return
    for module in model.modules():
        if not isinstance(module, MultiHeadAttention):
            continue
        if module.attn_impl in UNSHARDED_ROUTES:
            raise ValueError(
                f"route {module.attn_impl!r} (kernels K5/K6/K7/K9) has no "
                f"sharded hosting: --tp {mesh.tp} runs the flash_fused, "
                "flash or xla routes only, as in the JAX package")
        width = module.q_proj.weight.shape[0]
        local = width // mesh.tp
        if (torch.device(device).type == "cuda"
                and module.attn_impl in FUSED_IMPLS
                and module.num_heads % mesh.tp == 0
                and local % GEMM_TILE):
            raise ValueError(
                f"--tp {mesh.tp} leaves {local}-wide local heads: the "
                f"kernels K1, K2 and K8 take P in multiples of {GEMM_TILE} "
                "(two 64-wide heads a rank at least)")


def tensor_parallel(model: nn.Module, mesh: Mesh, device="cpu"
                    ) -> Dict[str, tuple]:
    """Shard ``model`` in place over ``mesh``'s ``model`` axis: each
    parameter (and int8 buffer) that `tp_specs` splits keeps this rank's
    chunk, and each layer that holds one gets the `ModelAxis` its
    forward reads (attention, MLP, geocell head, text token table).
    Load the full weights first. Returns the specs, which
    ``model.tp_specs`` also keeps (the gradient norm and the checkpoints
    read them)."""
    from pigeon_tpu_torch.models.clip import (
        CLIPTextTower,
        MultiHeadAttention,
        TransformerLayer,
    )
    from pigeon_tpu_torch.models.geocell_head import GeocellHead

    specs = {}
    if mesh.tp > 1:
        check_widths(model, mesh, device)
        specs = tp_specs(model, mesh.tp)
        local = shard_params(model.state_dict(), mesh, specs)
        for name in specs:
            _set_tensor(model, name, local[name])
        axis = mesh.model_axis
        owners = ((MultiHeadAttention, "q_proj.weight"),
                  (TransformerLayer, "fc1.weight"),
                  (GeocellHead, "cell_layer.weight"),
                  (CLIPTextTower, "token_embed.weight"))
        for name, module in model.named_modules():
            for kind, leaf in owners:
                key = f"{name}.{leaf}" if name else leaf
                if isinstance(module, kind) and key in specs:
                    module.tp = axis
    model.tp_specs = specs
    return specs


def fully_shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """FSDP2 over the ``data`` axis: `fully_shard` on every encoder layer
    (a layer's frozen and trainable parameters together) and at the root
    (`pigeon_tpu/train/mesh.py::fsdp_param_specs`; FSDP2 shards dim 0).
    Optimizer moments made after this are sharded like their
    parameters."""
    from torch.distributed.fsdp import fully_shard

    from pigeon_tpu_torch.models.clip import TransformerLayer

    data_mesh = mesh.device_mesh["data"]
    for module in model.modules():
        if isinstance(module, TransformerLayer):
            fully_shard(module, mesh=data_mesh)
    # FSDP2 takes no 0-d parameter (CLIP's logit scale): it stays whole
    # on every rank, its gradient averaged over ``data`` as DDP would.
    scalars = {p for p in model.parameters() if p.dim() == 0}
    fully_shard(model, mesh=data_mesh, ignored_params=scalars or None)
    for p in scalars:
        if p.requires_grad:
            p.register_post_accumulate_grad_hook(functools.partial(
                _average_grad, group=mesh.data_group, ranks=mesh.dp))
    return model


def _average_grad(p, group, ranks: int) -> None:
    dist.all_reduce(p.grad, group=group)
    p.grad.div_(ranks)


def data_parallel(model: nn.Module, mesh: Mesh, fsdp: bool = False,
                  device=None) -> nn.Module:
    """The module a train step runs ``model`` through: ``model`` itself
    in one process, FSDP2 under ``fsdp`` (in place), else DDP over the
    ``data`` group. DDP registers hooks on the trainable parameters only
    (frozen layers have none) and finds the heads a batch leaves unused
    (a month term is absent where a batch has no month labels)."""
    if mesh.device_mesh is None:
        return model
    if fsdp:
        return fully_shard_model(model, mesh)
    from torch.nn.parallel import DistributedDataParallel

    device = torch.device(device) if device is not None else None
    ids = [device] if device is not None and device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids,
                                   process_group=mesh.data_group,
                                   find_unused_parameters=True)


def batch_slice(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``n``: its data rank's
    `host_slice` (`pigeon_tpu/train/mesh.py::shard_batch`)."""
    return host_slice(n, mesh.data_rank, mesh.dp)


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh
                ) -> Dict[str, np.ndarray]:
    """A global batch cut to this rank's rows (every leaf's leading axis
    by `batch_slice`; 0-d leaves as they are)."""
    out = {}
    for key, value in batch.items():
        if getattr(value, "ndim", 0) == 0:
            out[key] = value
        else:
            out[key] = value[batch_slice(len(value), mesh)]
    return out


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (FSDP2), or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def global_grad_norm(params, mesh: Mesh, tp_params) -> torch.Tensor:
    """The gradients' global norm over every shard, each replicated
    parameter counted once (optax's ``global_norm`` on the JAX package's
    sharded tree). The squares are summed by kind: FSDP2's disjoint
    shards (DTensors) summed over ``data``, the plain gradients (DDP's,
    already averaged, and the 0-d ones FSDP2 leaves whole) not; of
    either, the tensor-parallel shards (the ids in ``tp_params``) summed
    over ``model``."""
    grads = [(p.grad, id(p) in tp_params) for p in params
             if p.grad is not None]
    device = local_shard(grads[0][0]).device
    # sums[over data?][over model?]
    sums = torch.zeros(2, 2, dtype=torch.float32, device=device)
    for g, split in grads:
        sums[int(hasattr(g, "to_local")), int(split)] += \
            local_shard(g).float().square().sum()
    if mesh.device_mesh is not None:
        if any(hasattr(g, "to_local") for g, _ in grads):
            shards = sums[1].clone()
            dist.all_reduce(shards, group=mesh.data_group)
            sums = torch.stack([sums[0], shards])
        if mesh.tp > 1:
            split = sums[:, 1].clone()
            dist.all_reduce(split, group=mesh.model_axis.group)
            sums = torch.stack([sums[:, 0], split], dim=1)
    return sums.sum().sqrt()


def use_global_norm(optimizer, model: nn.Module, mesh: Mesh) -> None:
    """Give ``optimizer`` (`train_loop.AdamW`) the norm over ``mesh``'s
    shards for its clipping and the step's ``grad_norm``; one process
    keeps its own sum."""
    if mesh.device_mesh is None:
        return
    specs = getattr(model, "tp_specs", {})
    tp_params = {id(p) for n, p in model.named_parameters() if n in specs}
    optimizer.norm_fn = functools.partial(global_grad_norm, mesh=mesh,
                                          tp_params=tp_params)


def mean_over_data(values: Dict[str, torch.Tensor], mesh: Mesh
                   ) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the ``data`` axis (the global batch's
    mean where every rank holds as many rows), so every rank logs and
    checks the same numbers."""
    if mesh is None or mesh.device_mesh is None or mesh.dp == 1:
        return values
    keys = sorted(values)
    stacked = torch.stack([values[k].float() for k in keys])
    dist.all_reduce(stacked, group=mesh.data_group)
    stacked = stacked / mesh.dp
    return {k: stacked[i] for i, k in enumerate(keys)}


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_along(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        rank = dist.get_rank(ctx.group)
        return g.chunk(dist.get_world_size(ctx.group))[rank], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (the same row count each) concatenated in rank
    order, differentiably: the backward sums each rank's gradient of the
    whole and keeps this rank's rows (all-reduce, then a slice: gloo has
    no reduce-scatter of CUDA tensors)."""
    return _GatherRows.apply(x, group)
