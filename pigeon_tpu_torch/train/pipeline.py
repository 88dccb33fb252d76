"""Pipeline parallelism over the ViT encoder: a GPipe schedule by hand.

Counterpart of `pigeon_tpu/train/pipeline.py`. The JAX package shards
its scan-stacked encoder over a ``stage`` mesh axis and runs the
fill/drain schedule in `shard_map`, one `ppermute` hop a step, its
backward the transpose JAX derives. Here every rank is one process:

* the mesh is ``(data, stage, model)`` (`create_pipeline_mesh`, on
  `train/mesh.py::Mesh`), ranks laid out as JAX's ``devices.reshape(n //
  (pp * tp), pp, tp)``: a model group's ranks are consecutive, and the
  ranks of one stage group hold the same data rows;
* each stage rank keeps its contiguous slice of the layers
  (`shard_pipeline_params`: the others are dropped; the kept ones keep
  their names, ``encoder.layers.<i>``), and with ``tp`` > 1 its Megatron
  shards of them (`train/mesh.py::tensor_parallel`), on the routes the
  model axis takes;
* the schedule is written over plain local tensors, so the kernels never
  see a DTensor (K1 and K3 run inside each stage's layers, K2 and K4 in
  their backward): GPipe fills and drains over M microbatches, each
  stage receiving a microbatch's activations from the stage before it
  and sending its output on (`torch.distributed` point-to-point calls on
  the ``stage`` group), then runs every backward in reverse, gradients
  travelling back the same way; the last stage's output reaches every
  stage by a broadcast, as JAX's `psum` replicates it;
* the patch embedding and pre-LN run on every stage before the pipeline,
  the post-LN and the head after it, as in JAX; only stage 0's pre-LN
  output enters it, so `sync_pipeline_grads` gives every stage stage 0's
  gradients of those parameters.

gloo's point-to-point calls take no CUDA tensor (on the H100's machine,
torch 2.11, `scripts/probe_gloo_cuda.py`: `send`/`recv` break the
connection, `isend`/`irecv` abort the process; `broadcast` and
`all_reduce` work): on a group without NCCL (two ranks sharing one
card) each hop crosses through pinned host copies. The bubble is the
usual (pp - 1) / (M + pp - 1) of a step.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from pigeon_tpu_torch.config import HeadConfig
from pigeon_tpu_torch.models.embedder import token_mean_embedding
from pigeon_tpu_torch.models.geocell_head import GeocellOutput
from pigeon_tpu_torch.train.mesh import Mesh, mean_over_data
from pigeon_tpu_torch.train.multihost import distributed

#: The tower's parameters that feed the pipeline (stage 0's input).
PRE_PIPELINE = ("patch_embed", "cls_token", "pos_embed", "pre_ln")


def create_pipeline_mesh(pp: int, tp: int = 1,
                         device_type: str = "cpu") -> Mesh:
    """The ``(world / (pp * tp), pp, tp)`` mesh of ``data``, ``stage`` and
    ``model`` over every rank of the process group
    (`pigeon_tpu/train/pipeline.py::create_pipeline_mesh`)."""
    world = dist.get_world_size() if distributed() else 1
    if pp < 1 or tp < 1 or world % (pp * tp):
        raise ValueError(f"pp*tp={pp * tp} must divide device count "
                         f"{world}")
    if world == 1:
        return Mesh()
    from torch.distributed.device_mesh import init_device_mesh

    dp = world // (pp * tp)
    device_mesh = init_device_mesh(device_type, (dp, pp, tp),
                                   mesh_dim_names=("data", "stage", "model"))
    rank = dist.get_rank()
    return Mesh(dp=dp, tp=tp, data_rank=rank // (pp * tp),
                model_rank=rank % tp, device_mesh=device_mesh, pp=pp,
                stage_rank=(rank // tp) % pp)


def stage_layers(num_layers: int, pp: int, stage: int) -> range:
    """The layers stage ``stage`` of ``pp`` runs: its contiguous slice
    (ValueError where ``pp`` does not divide ``num_layers``)."""
    if num_layers % pp:
        raise ValueError(f"{num_layers} layers not divisible by pp={pp}")
    per = num_layers // pp
    return range(stage * per, (stage + 1) * per)


def vision_tower(model: nn.Module) -> nn.Module:
    """The CLIP vision tower of ``model`` (a `SuperGuessr`), or ``model``
    itself."""
    return getattr(model, "vision", model)


def shard_pipeline_params(model: nn.Module, mesh: Mesh, device="cpu"
                          ) -> nn.Module:
    """Keep this stage's slice of the tower's layers, in place (the rest
    are dropped; ``encoder.num_layers`` keeps the whole count and the
    kept layers their names), then Megatron-shard what is left over
    ``model`` (`train/mesh.py::tensor_parallel`, its route checks
    included). Load the full weights first."""
    from pigeon_tpu_torch.train.mesh import tensor_parallel

    encoder = vision_tower(model).encoder
    layers = encoder.layers
    num = len(layers)
    keep = stage_layers(num, mesh.pp, mesh.stage_rank)
    if mesh.pp > 1:
        encoder.layers = nn.ModuleDict({str(i): layers[i] for i in keep})
    encoder.num_layers = num
    tensor_parallel(model, mesh, device)
    return model


def _lookup(layers) -> Dict[int, nn.Module]:
    if isinstance(layers, nn.ModuleDict):
        return {int(k): v for k, v in layers.items()}
    return dict(enumerate(layers))


def _run(layers, layer_fn: Callable, h: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        h = layer_fn(layer, h)
    return h


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a hop of ``t`` over ``group`` crosses through host memory:
    a CUDA tensor where the group has no NCCL (gloo's send and recv take
    CPU tensors only)."""
    return t.is_cuda and "nccl" not in str(dist.get_backend(group))


class _Hops:
    """Point-to-point hops on the ``stage`` group: sends are posted
    without waiting (their buffers kept until `wait`), receives wait."""

    def __init__(self, mesh: Mesh):
        self.group = mesh.stage_group
        self.ranks = [dist.get_global_rank(self.group, s)
                      for s in range(mesh.pp)]
        self.pending = []

    def send(self, t: torch.Tensor, stage: int, tag: int) -> None:
        t = t.detach().contiguous()
        if _staged(t, self.group):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = host.copy_(t)
        self.pending.append((dist.isend(t, self.ranks[stage],
                                        group=self.group, tag=tag), t))

    def recv(self, like: torch.Tensor, stage: int, tag: int) -> torch.Tensor:
        staged = _staged(like, self.group)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device,
                          pin_memory=staged)
        dist.recv(buf, self.ranks[stage], group=self.group, tag=tag)
        return buf.to(like.device) if staged else buf

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        """``t`` of stage ``stage`` on every stage, in place (gloo takes
        CUDA tensors here)."""
        dist.broadcast(t, self.ranks[stage], group=self.group)
        return t

    def wait(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending = []


class _Schedule:
    """GPipe over one stage's layers: ``forward`` fills and drains the M
    microbatches (keeping each one's graph), ``backward`` runs their
    backwards in reverse."""

    def __init__(self, layers, layer_fn: Callable, mesh: Mesh, m: int):
        self.layers, self.layer_fn, self.m = layers, layer_fn, m
        self.stage, self.pp = mesh.stage_rank, mesh.pp
        self.hops = _Hops(mesh)
        self.ins, self.outs = [], []

    def run(self, h):
        return _run(self.layers, self.layer_fn, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, last = self.stage == 0, self.stage == self.pp - 1
        chunks = x.detach().chunk(self.m)
        for i, chunk in enumerate(chunks):
            if first:
                h_in = chunk.requires_grad_(x.requires_grad)
            else:
                h_in = self.hops.recv(chunk, self.stage - 1, i)
                h_in.requires_grad_(torch.is_grad_enabled())
            h = self.run(h_in)
            if not last:
                self.hops.send(h, self.stage + 1, i)
            self.ins.append(h_in)
            self.outs.append(h)
        y = (torch.cat(self.outs).detach() if last
             else torch.empty_like(x))
        y = self.hops.broadcast(y, self.pp - 1)
        self.hops.wait()
        if not torch.is_grad_enabled():
            self.ins, self.outs = [], []
        return y

    def backward(self, g: torch.Tensor) -> Optional[torch.Tensor]:
        last = self.stage == self.pp - 1
        grads = g.chunk(self.m) if last else [None] * self.m
        for i in reversed(range(self.m)):
            out = self.outs[i]
            gi = (grads[i].contiguous() if last
                  else self.hops.recv(out, self.stage + 1, self.m + i))
            if out.requires_grad:
                torch.autograd.backward(out, gi)
            if self.stage > 0:
                dx = self.ins[i].grad
                self.hops.send(torch.zeros_like(out) if dx is None else dx,
                               self.stage - 1, self.m + i)
        self.hops.wait()
        ins, self.ins, self.outs = self.ins, [], []
        if self.stage == 0 and ins[0].requires_grad:
            return torch.cat([h.grad for h in ins])
        return None


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: its forward runs the stage's
    graphs under grad, its backward runs theirs (parameters' gradients
    accumulate there). ``anchor`` requires grad so that every stage's
    loss reaches the backward, also where its layers are frozen."""

    @staticmethod
    def forward(ctx, x, anchor, schedule):
        ctx.schedule = schedule
        with torch.enable_grad():
            return schedule.forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.schedule.backward(g), None, None


def pipeline_stack_apply(layer_fn: Callable, layers, x: torch.Tensor,
                         mesh: Mesh, num_microbatches: int,
                         num_layers: Optional[int] = None) -> torch.Tensor:
    """The stacked layers over ``x`` as a stage pipeline
    (`pigeon_tpu/train/pipeline.py::pipeline_stack_apply`).

    Args:
        layer_fn: ``(layer, h) -> h`` for one layer.
        layers: the whole stack in order, or a stage's layers by their
            index in it (an ``nn.ModuleDict`` keyed ``"<i>"``, as
            `shard_pipeline_params` leaves them, with ``num_layers``).
            Stage ``s`` runs ``[s L / pp, (s + 1) L / pp)``.
        x: this data rank's activations ``(B, ...)``, the same on every
            stage; B must divide by ``num_microbatches``.
        num_microbatches: GPipe's M.

    Returns:
        ``(B, ...)``, the sequential stack's output, on every stage;
        differentiable (the backward runs the reversed schedule).
    """
    pp = mesh.pp
    num = len(layers) if num_layers is None else num_layers
    span = stage_layers(num, pp, mesh.stage_rank)
    m, b = num_microbatches, x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    lookup = _lookup(layers)
    local = [lookup[i] for i in span]
    if pp == 1:
        return torch.cat([_run(local, layer_fn, c) for c in x.chunk(m)])
    schedule = _Schedule(local, layer_fn, mesh, m)
    if not torch.is_grad_enabled():
        return schedule.forward(x)
    anchor = torch.empty(0, device=x.device, requires_grad=True)
    return _Pipeline.apply(x, anchor, schedule)


def pipeline_vision_forward(tower: nn.Module, pixel_values: torch.Tensor,
                            mesh: Mesh, num_microbatches: int):
    """`CLIPVisionTower.forward` with its encoder pipelined
    (`pigeon_tpu/train/pipeline.py::pipeline_vision_forward`):
    ``(last_hidden, pooled)`` on every stage."""
    from pigeon_tpu_torch.models.clip import layer_norm

    encoder = tower.encoder
    x = pipeline_stack_apply(encoder.apply_layer, encoder.layers,
                             tower.embed(pixel_values), mesh,
                             num_microbatches,
                             getattr(encoder, "num_layers", None))
    return x, layer_norm(tower.post_ln, x[:, 0])


def pipeline_forward(model: nn.Module, pixel_values: torch.Tensor,
                     heading: Optional[torch.Tensor], mesh: Mesh,
                     num_microbatches: int) -> GeocellOutput:
    """`SuperGuessr.forward` with its tower pipelined: panoramas folded
    into the tower's batch, the token-mean embedding, the head."""
    b = pixel_values.shape[0]
    panorama = model.head_config.panorama
    pixels = (pixel_values.reshape(b * 4, *pixel_values.shape[2:])
              if panorama else pixel_values)
    hidden, _ = pipeline_vision_forward(model.vision, pixels, mesh,
                                        num_microbatches)
    embedding = token_mean_embedding(hidden)
    if panorama:
        embedding = embedding.reshape(b, 4, -1)
    return model.head(embedding, heading=heading)


@torch.no_grad()
def sync_pipeline_grads(model: nn.Module, mesh: Mesh) -> None:
    """Make every replicated parameter's gradient the same on every rank:
    the pre-pipeline parameters take stage 0's (the only stage whose
    input entered the pipeline), then every gradient is averaged over
    ``data`` (what DDP does). The post-LN's and the head's are the same
    on every stage already (each ran them on the broadcast output)."""
    if mesh.device_mesh is None:
        return
    if mesh.pp > 1:
        hops = _Hops(mesh)
        tower = vision_tower(model)
        for name in PRE_PIPELINE:
            part = getattr(tower, name)
            for p in (part.parameters() if isinstance(part, nn.Module)
                      else [part]):
                if p.requires_grad:
                    grad = torch.zeros_like(p) if p.grad is None else p.grad
                    p.grad = hops.broadcast(grad, 0)
    if mesh.dp > 1:
        for p in model.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad, group=mesh.data_group)
                p.grad.div_(mesh.dp)


def pipeline_grad_norm(params, mesh: Mesh, stage_ids: set,
                       tp_ids: set) -> torch.Tensor:
    """The global norm of the gradients over every stage and shard, each
    replicated gradient counted once: the squares of a stage's own
    parameters summed over ``stage``, of the tensor-parallel shards over
    ``model``."""
    device = params[0].grad.device
    sums = torch.zeros(2, 2, dtype=torch.float32, device=device)
    for p in params:
        sums[int(id(p) in stage_ids), int(id(p) in tp_ids)] += \
            p.grad.float().square().sum()
    if mesh.pp > 1:
        local = sums[1].clone()
        dist.all_reduce(local, group=mesh.stage_group)
        sums = torch.stack([sums[0], local])
    if mesh.tp > 1:
        split = sums[:, 1].clone()
        dist.all_reduce(split, group=mesh.model_axis.group)
        sums = torch.stack([sums[:, 0], split], dim=1)
    return sums.sum().sqrt()


def create_pipeline_train_state(model: nn.Module, optimizer_fn: Callable,
                                mesh: Mesh, device="cpu"):
    """A `train_loop.TrainState` of ``model`` (a `SuperGuessr`, full
    weights loaded) with its tower pipelined over ``mesh``
    (`pigeon_tpu/train/pipeline.py::create_pipeline_train_state`): this
    stage's layers (tensor-parallel shards of them under ``tp``), the
    optimizer over the rank's parameters, clipping by the norm over every
    stage and shard."""
    from pigeon_tpu_torch.train.train_loop import TrainState

    shard_pipeline_params(model, mesh, device)
    optimizer = optimizer_fn(model.parameters())
    if mesh.device_mesh is not None:
        specs = getattr(model, "tp_specs", {})
        optimizer.norm_fn = functools.partial(
            pipeline_grad_norm, mesh=mesh,
            stage_ids={id(p) for p in
                       vision_tower(model).encoder.layers.parameters()},
            tp_ids={id(p) for n, p in model.named_parameters()
                    if n in specs})
    return TrainState(model, optimizer, mesh=mesh)


@contextlib.contextmanager
def _same_draws(mesh: Mesh, device):
    """Random draws (the head's dropout) the same on every stage: the
    generators seeded from stage 0's for the block."""
    if mesh.pp == 1:
        yield
        return
    seed = torch.randint(0, 2**62, (1,), dtype=torch.int64)
    dist.broadcast(seed, dist.get_global_rank(mesh.stage_group, 0),
                   group=mesh.stage_group)
    devices = [device] if torch.device(device).type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(int(seed))
        yield


def make_pipeline_train_step(head_cfg: HeadConfig, geocells: torch.Tensor,
                             num_microbatches: int) -> Callable:
    """``train_step(state, batch) -> metrics`` with the tower pipelined
    (`pigeon_tpu/train/pipeline.py::make_pipeline_train_step`): the
    objective of `train_loop.make_train_step` (`geocell_loss`, K10's
    smoothed targets), the backward through the reversed schedule, the
    replicated gradients made equal (`sync_pipeline_grads`), AdamW. The
    metrics are the same on every rank."""
    from pigeon_tpu_torch.train.train_loop import output_loss

    def train_step(state, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        model, mesh = state.model, state.mesh
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with _same_draws(mesh, batch["inputs"].device):
            out = pipeline_forward(model, batch["inputs"],
                                   batch.get("heading"), mesh,
                                   num_microbatches)
            total, parts = output_loss(out, batch, geocells, head_cfg)
        total.backward()
        sync_pipeline_grads(model, mesh)
        params = [p for group in state.optimizer.param_groups
                  for p in group["params"] if p.grad is not None]
        parts["grad_norm"] = state.optimizer.grad_norm(params)
        state.optimizer.step()
        state.step += 1
        return mean_over_data({k: v.detach() for k, v in parts.items()},
                              mesh)

    return train_step
