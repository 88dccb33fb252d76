"""Train and eval steps for geocell training on pixels.

Counterpart of `pigeon_tpu/train/train_loop.py`: one eager step is the
forward, `geocell_loss`, the backward and the AdamW update. Frozen
parameters (``requires_grad`` False) get no gradient and are not in the
optimizer, so they never move, as the JAX package's gradient and update
masks keep them. Batches arrive as numpy arrays from the input pipeline
and cross to the device with `batch_to_device`; uint8 pixels are
normalised there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from pigeon_tpu_torch.config import HeadConfig
from pigeon_tpu_torch.data.image_ops import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    normalize_images,
)
from pigeon_tpu_torch.models.geocell_head import (
    GeocellOutput,
    geocell_loss,
    geocell_predictions,
    smoothed_targets,
)
from pigeon_tpu_torch.train import profiling
from pigeon_tpu_torch.train.mesh import mean_over_data


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of steps taken. Over a mesh
    (`train/mesh.py`) ``forward`` is the module a step runs the model
    through (DDP's wrapper; FSDP2 shards ``model`` itself) and ``mesh``
    the grid; checkpoints read ``model``."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    forward: Optional[nn.Module] = None
    mesh: object = None

    @property
    def runner(self) -> nn.Module:
        return self.model if self.forward is None else self.forward


def create_train_state(model: nn.Module, optimizer_fn: Callable, mesh,
                       device="cpu", fsdp: bool = False) -> TrainState:
    """A `TrainState` of ``model`` (its full weights loaded, on
    ``device``) over ``mesh`` (`pigeon_tpu/train/train_loop.py::
    create_train_state`): its tensor-parallel shards (`train.mesh.
    tensor_parallel`; a route or width the model axis cannot run raises
    ValueError), then DDP or, under ``fsdp``, FSDP2 on the data axis,
    then the optimizer ``optimizer_fn(parameters)`` over the rank's
    parameters, clipping by the norm over every shard. One process
    without a group: the model and its optimizer as they are."""
    from pigeon_tpu_torch.train.mesh import (
        data_parallel,
        tensor_parallel,
        use_global_norm,
    )

    tensor_parallel(model, mesh, device)
    forward = data_parallel(model, mesh, fsdp, device)
    optimizer = optimizer_fn(model.parameters())
    use_global_norm(optimizer, model, mesh)
    return TrainState(model, optimizer,
                      forward=None if forward is model else forward,
                      mesh=mesh)


class AdamW(torch.optim.AdamW):
    """torch's AdamW behind optax's ``clip_by_global_norm`` and
    ``MultiSteps`` (`pigeon_tpu.train.train_loop.adamw`).

    ``max_grad_norm``: each step's gradients ``g`` become ``g / |g| *
    max_grad_norm`` when their global norm ``|g|`` is not below it.
    ``accum_steps`` k > 1: each call of `step` folds the gradients into a
    running mean (optax's ``acc + (g - acc) / (n + 1)``), and every k-th
    call applies the clipped update to that mean and starts a new one;
    the others leave the parameters and Adam's moments as they are. The
    mean and its count are part of the state dict, so a checkpoint taken
    between updates resumes the accumulation. Under data parallelism each
    micro-step's gradients arrive averaged over the ranks; the running
    mean of those averages is the average of the ranks' running means
    (both are linear), so the micro-steps all-reduce as the updates do.

    ``norm_fn``: the global norm of a list of parameters' gradients, over
    every shard where the model is sharded (`train.mesh.use_global_norm`
    sets it); None sums this process's.

    ``schedule``: a learning rate by update, ``count -> lr``, that each
    update reads at the count of updates applied before it (optax's
    ``scale_by_learning_rate`` inside ``MultiSteps`` counts updates, not
    micro-batches); the count is then in the state dict too.
    """

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: Optional[float] = None,
                 accum_steps: int = 1,
                 schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        self.norm_fn: Optional[Callable] = None
        if accum_steps < 1:
            raise ValueError(f"accum_steps={accum_steps} < 1")
        self.max_grad_norm = max_grad_norm
        self.accum_steps = accum_steps
        self.mini_step = 0
        self.acc_grads: Dict[torch.Tensor, torch.Tensor] = {}
        self.schedule = schedule
        self.updates = 0

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def grad_norm(self, params) -> torch.Tensor:
        """The global norm of ``params``' gradients (`norm_fn`'s, else
        optax's ``global_norm``: the square root of the summed
        squares)."""
        if self.norm_fn is not None:
            return self.norm_fn(params)
        return torch.stack([p.grad.square().sum()
                            for p in params]).sum().sqrt()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        params = [p for p in self._params() if p.grad is not None]
        if self.accum_steps > 1:
            n = self.mini_step
            for p in params:
                acc = self.acc_grads.setdefault(p, torch.zeros_like(p.grad))
                acc.add_((p.grad - acc) / (n + 1))
            if n + 1 < self.accum_steps:
                self.mini_step = n + 1
                return None
            for p in params:
                p.grad = self.acc_grads[p]
            self.acc_grads, self.mini_step = {}, 0
        if self.max_grad_norm is not None and params:
            norm = self.grad_norm(params)
            if not norm < self.max_grad_norm:
                for p in params:
                    if hasattr(p.grad, "to_local"):     # an FSDP2 shard
                        g = p.grad.to_local()
                        g.copy_(g / norm.to(g.device, g.dtype)
                                * self.max_grad_norm)
                    else:
                        p.grad = p.grad / norm.to(p.grad.dtype) \
                            * self.max_grad_norm
        if self.schedule is not None:
            lr = float(self.schedule(self.updates))
            for group in self.param_groups:
                group["lr"] = lr
        self.updates += 1
        return super().step()

    def state_dict(self):
        out = super().state_dict()
        if self.schedule is not None:
            out["updates"] = self.updates
        if self.accum_steps > 1:
            index = {id(p): i for i, p in enumerate(self._params())}
            out["accumulation"] = {
                "mini_step": self.mini_step,
                "acc_grads": {index[id(p)]: g
                              for p, g in self.acc_grads.items()}}
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        acc = state_dict.pop("accumulation", None)
        self.updates = int(state_dict.pop("updates", 0))
        super().load_state_dict(state_dict)
        self.mini_step, self.acc_grads = 0, {}
        if acc is not None:
            params = self._params()
            self.mini_step = int(acc["mini_step"])
            self.acc_grads = {params[int(i)]: g.to(params[int(i)].device,
                                                   copy=True)
                              for i, g in acc["acc_grads"].items()}


def adamw(params: Iterable[nn.Parameter], learning_rate: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, max_grad_norm: Optional[float] = None,
          accum_steps: int = 1,
          schedule: Optional[Callable[[int], float]] = None) -> AdamW:
    """`AdamW` over the trainable ``params`` with the JAX wrapper's
    arguments and defaults (`pigeon_tpu.train.train_loop.adamw`): head
    training passes the learning rate alone; pretraining betas (0.9,
    0.98), eps 1e-6, weight decay 1e-3, ``max_grad_norm`` 1.0 and
    ``accum_steps`` 8, and a ``schedule`` by update in place of the
    constant ``learning_rate`` (`train.modes.pretrain_optimizer`). The
    weight decay is passed explicitly: torch's own default is 0.01, the
    JAX wrapper's 0.0."""
    trainable = [p for p in params if p.requires_grad]
    return AdamW(trainable, lr=learning_rate, betas=(b1, b2), eps=eps,
                 weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                 accum_steps=accum_steps, schedule=schedule)


def batch_to_device(batch: Dict[str, np.ndarray], device,
                    mean=CLIP_IMAGE_MEAN, std=CLIP_IMAGE_STD
                    ) -> Dict[str, torch.Tensor]:
    """A pipeline batch as tensors on ``device``; uint8 ``inputs`` are
    normalised there by ``mean`` and ``std``, CLIP's by default (a quarter
    of the bytes cross as uint8)."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value)).to(device)
        if key == "inputs" and t.dtype == torch.uint8:
            t = normalize_images(t, mean, std)
        out[key] = t
    return out


def output_loss(out: GeocellOutput, batch: Dict[str, torch.Tensor],
                geocells: torch.Tensor, head_cfg: HeadConfig,
                smooth_fn: Callable = smoothed_targets):
    """`geocell_loss` of a forward's ``out`` against ``batch``'s labels:
    ``(total, parts)``."""
    return geocell_loss(
        out, geocells, head_cfg,
        labels_lla=batch.get("labels"),
        labels_clf=batch.get("labels_clf"),
        labels_multi_task=batch.get("labels_multi_task"),
        labels_climate=batch.get("labels_climate"),
        labels_month=batch.get("labels_month"),
        smooth_fn=smooth_fn)


def batch_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
               geocells: torch.Tensor, head_cfg: HeadConfig,
               smooth_fn: Callable = smoothed_targets):
    """Forward and `geocell_loss` on a device batch:
    ``(output, total, parts)``."""
    out = model(batch["inputs"], heading=batch.get("heading"))
    total, parts = output_loss(out, batch, geocells, head_cfg, smooth_fn)
    return out, total, parts


def make_train_step(head_cfg: HeadConfig, geocells: torch.Tensor
                    ) -> Callable:
    """``train_step(state, batch) -> metrics`` on a device batch.

    The metrics are the loss parts and ``grad_norm`` (the global norm of
    the trainable gradients), as device scalars: reading them waits for
    the device, so the caller reads them when it needs them.

    While a torch profiler runs, each step records the span
    ``train.step`` and inside it ``train.forward`` (the forward, the
    label smoothing and the loss), ``train.backward`` and
    ``train.optimizer`` (``grad_norm`` and the update), each with the
    card's time (`train.profiling`).
    """

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        with profiling.span("train.step", device=True):
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            with profiling.span("train.forward", device=True):
                _, total, parts = batch_loss(state.runner, batch, geocells,
                                             head_cfg)
            with profiling.span("train.backward", device=True):
                total.backward()
            with profiling.span("train.optimizer", device=True):
                params = [p for group in state.optimizer.param_groups
                          for p in group["params"] if p.grad is not None]
                parts["grad_norm"] = state.optimizer.grad_norm(params)
                state.optimizer.step()
            state.step += 1
            return mean_over_data({k: v.detach() for k, v in parts.items()},
                                  state.mesh)

    return train_step


def make_eval_step(head_cfg: HeadConfig, geocells: torch.Tensor,
                   num_candidates: Optional[int] = None) -> Callable:
    """``eval_step(model, batch) -> (parts, predictions)``: the forward,
    the loss and what the metric suite reads (argmax cell and location,
    top-k cells and probabilities, embeddings, multi-task outputs). The
    top k is ``num_candidates`` wide (default: the head's).

    A batch with ``row_index`` (`train.multihost.iter_eval_batches`: a
    rank's rows, padded) takes its loss over the rows whose index is not
    -1, and ``parts["rows"]`` counts them."""
    k = num_candidates or head_cfg.num_candidates

    @torch.inference_mode()
    def eval_step(model: nn.Module, batch: Dict[str, torch.Tensor]):
        model.eval()
        out = model(batch["inputs"], heading=batch.get("heading"))
        if "row_index" in batch:
            keep = batch["row_index"] >= 0
            real = GeocellOutput(*(None if t is None else t[keep]
                                   for t in out))
            labels = {key: v[keep] for key, v in batch.items()
                      if key != "inputs"}
            _, parts = output_loss(real, labels, geocells, head_cfg)
            parts["rows"] = keep.sum()
        else:
            _, parts = output_loss(out, batch, geocells, head_cfg)
        preds = geocell_predictions(out.logits, geocells, k)
        preds.update(embedding=out.embedding, preds_mt=out.preds_mt,
                     preds_climate=out.preds_climate,
                     preds_month=out.preds_month)
        return parts, preds

    return eval_step
