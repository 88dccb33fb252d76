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
from typing import Callable, Dict, Iterable

import numpy as np
import torch
from torch import nn

from pigeon_tpu_torch.config import HeadConfig
from pigeon_tpu_torch.data.image_ops import normalize_images
from pigeon_tpu_torch.models.geocell_head import (
    geocell_loss,
    geocell_predictions,
    smoothed_targets,
)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def adamw(params: Iterable[nn.Parameter], learning_rate: float
          ) -> torch.optim.AdamW:
    """AdamW over the trainable ``params`` with the JAX wrapper's defaults
    (`pigeon_tpu.train.train_loop.adamw`). The weight decay is passed
    explicitly: torch's own default is 0.01, the JAX wrapper's 0.0."""
    trainable = [p for p in params if p.requires_grad]
    return torch.optim.AdamW(trainable, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A pipeline batch as tensors on ``device``; uint8 ``inputs`` are
    CLIP-normalised there (a quarter of the bytes cross as uint8)."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value)).to(device)
        if key == "inputs" and t.dtype == torch.uint8:
            t = normalize_images(t)
        out[key] = t
    return out


def batch_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
               geocells: torch.Tensor, head_cfg: HeadConfig,
               smooth_fn: Callable = smoothed_targets):
    """Forward and `geocell_loss` on a device batch:
    ``(output, total, parts)``."""
    out = model(batch["inputs"], heading=batch.get("heading"))
    total, parts = geocell_loss(
        out, geocells, head_cfg,
        labels_lla=batch.get("labels"),
        labels_clf=batch.get("labels_clf"),
        labels_multi_task=batch.get("labels_multi_task"),
        labels_climate=batch.get("labels_climate"),
        labels_month=batch.get("labels_month"),
        smooth_fn=smooth_fn)
    return out, total, parts


def make_train_step(head_cfg: HeadConfig, geocells: torch.Tensor
                    ) -> Callable:
    """``train_step(state, batch) -> metrics`` on a device batch.

    The metrics are the loss parts and ``grad_norm`` (the global norm of
    the trainable gradients), as device scalars: reading them waits for
    the device, so the caller reads them when it needs them.
    """

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        _, total, parts = batch_loss(state.model, batch, geocells, head_cfg)
        total.backward()
        grads = [p.grad for group in state.optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        parts["grad_norm"] = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in parts.items()}

    return train_step


def make_eval_step(head_cfg: HeadConfig, geocells: torch.Tensor
                   ) -> Callable:
    """``eval_step(model, batch) -> (parts, predictions)``: the forward,
    the loss and what the metric suite reads (argmax cell and location,
    top-k cells and probabilities, embeddings, multi-task outputs)."""

    @torch.inference_mode()
    def eval_step(model: nn.Module, batch: Dict[str, torch.Tensor]):
        model.eval()
        out, _, parts = batch_loss(model, batch, geocells, head_cfg)
        preds = geocell_predictions(out.logits, geocells,
                                    head_cfg.num_candidates)
        preds.update(embedding=out.embedding, preds_mt=out.preds_mt,
                     preds_climate=out.preds_climate,
                     preds_month=out.preds_month)
        return parts, preds

    return eval_step
