"""The epoch loop: training, an eval pass each epoch, the best checkpoint
and early stopping.

Counterpart of `pigeon_tpu/train/loop.py::train_model` and
`evaluate_model`. The best checkpoint is chosen on ``Geocell_accuracy``
(the reference's criterion), or on the negative eval loss when the eval
split has no geocell labels. Scalars go to ``<log_dir>/metrics.jsonl``
with the JAX package's tags (``train/loss``, ``eval/<metric>``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from pigeon_tpu_torch.train.checkpoints import save_checkpoint
from pigeon_tpu_torch.train.metrics import compute_geoguessr_metrics

logger = logging.getLogger("pigeon_tpu_torch.train")

#: Steps between writes of the train losses (each write waits for them).
LOG_EVERY = 10


class MetricWriter:
    """Scalars appended to ``<log_dir>/metrics.jsonl`` (nothing without a
    log directory)."""

    def __init__(self, log_dir: Optional[str]):
        self._file = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._file is not None:
            self._file.write(json.dumps(
                {"tag": tag, "value": float(value), "step": step}) + "\n")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


def evaluate_model(eval_step: Callable, model, batches: Iterable[Dict],
                   batch_to_device: Callable) -> Dict[str, float]:
    """Run the eval batches and compute the metric suite, plus
    ``Eval_loss``, the mean of the batches' losses."""
    acc: Dict[str, list] = {}

    def push(key, value):
        if value is not None:
            acc.setdefault(key, []).append(value)

    losses = []
    for batch in batches:
        parts, preds = eval_step(model, batch_to_device(batch))
        losses.append(parts["loss"])
        push("predictions", preds["pred_lla"])
        push("cell_preds", preds["pred_cell"])
        push("topk_cells", preds["topk_cells"])
        push("preds_climate", preds["preds_climate"])
        push("preds_month", preds["preds_month"])
        push("labels", batch.get("labels"))
        push("cell_labels", batch.get("labels_clf"))
        push("labels_climate", batch.get("labels_climate"))
        push("labels_month", batch.get("labels_month"))
    if not losses:
        raise ValueError("evaluate_model received no batches: empty eval "
                         "split? (check the metadata's `selection` column)")
    # Device values are read once, at the end, not per batch.
    cat = {k: np.concatenate([v.cpu().numpy() if torch.is_tensor(v) else v
                              for v in vs]) for k, vs in acc.items()}
    metrics = compute_geoguessr_metrics(
        predictions=cat["predictions"], labels=cat["labels"],
        cell_preds=cat.get("cell_preds"), cell_labels=cat.get("cell_labels"),
        topk_cells=cat.get("topk_cells"),
        preds_climate=cat.get("preds_climate"),
        labels_climate=cat.get("labels_climate"),
        preds_month=cat.get("preds_month"),
        labels_month=cat.get("labels_month"))
    metrics["Eval_loss"] = float(torch.stack(losses).mean())
    return metrics


def train_model(state, train_step: Callable, eval_step: Callable,
                train_batches_fn: Callable[[int], Iterable[Dict]],
                eval_batches_fn: Callable[[], Iterable[Dict]],
                num_epochs: int, batch_to_device: Callable,
                checkpoint_dir: Optional[str] = None,
                log_dir: Optional[str] = None,
                early_stopping_patience: int = 10):
    """Epochs of training, each followed by an eval pass.

    ``train_batches_fn(epoch)`` gives the epoch's batches (a fresh
    shuffle each epoch), ``eval_batches_fn()`` the eval batches. When the
    eval's geocell accuracy improves the state is checkpointed; after
    ``early_stopping_patience`` epochs without improvement training stops.
    Train losses stay on the device and are written every `LOG_EVERY`
    steps. Returns ``(state, history)``, the eval metrics of each epoch.
    """
    writer = MetricWriter(log_dir)
    best = -np.inf
    stale = 0
    history = []
    try:
        for epoch in range(num_epochs):
            t0 = time.time()
            pending = []
            for batch in train_batches_fn(epoch):
                metrics = train_step(state, batch_to_device(batch))
                pending.append((state.step, metrics["loss"]))
                if state.step % LOG_EVERY == 0:
                    for step, loss in pending:
                        writer.scalar("train/loss", float(loss), step)
                    pending.clear()
            for step, loss in pending:
                writer.scalar("train/loss", float(loss), step)

            eval_metrics = evaluate_model(eval_step, state.model,
                                          eval_batches_fn(), batch_to_device)
            history.append(eval_metrics)
            for key, value in eval_metrics.items():
                writer.scalar(f"eval/{key}", value, state.step)
            logger.info("epoch %d: loss=%.4f acc=%.4f median_km=%.1f "
                        "(%.1fs)", epoch, eval_metrics["Eval_loss"],
                        eval_metrics.get("Geocell_accuracy", float("nan")),
                        eval_metrics["Median_km_error"], time.time() - t0)

            score = eval_metrics.get("Geocell_accuracy",
                                     -eval_metrics["Eval_loss"])
            if score > best:
                best = score
                stale = 0
                if checkpoint_dir is not None:
                    save_checkpoint(checkpoint_dir, state)
            else:
                stale += 1
                if stale >= early_stopping_patience:
                    logger.info("early stopping at epoch %d", epoch)
                    break
    finally:
        writer.close()
    return state, history
