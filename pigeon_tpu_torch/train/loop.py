"""The epoch loop: training, an eval pass each epoch, the best checkpoint,
early stopping, rollback on divergence and graceful preemption.

Counterpart of `pigeon_tpu/train/loop.py::train_model` and
`evaluate_model`. The best checkpoint is chosen on ``Geocell_accuracy``
(the reference's criterion), or on the negative eval loss when the eval
split has no geocell labels, and written asynchronously through one
`CheckpointSession`. A non-finite train loss rolls the run back to the
last checkpoint; a SIGTERM saves the state and returns
(`train/preemption.py`); `ProfilerWindow` traces steps 4 to 14
(`train/profiling.py`). Scalars go to ``<log_dir>/metrics.jsonl`` with
the JAX package's tags (``train/loss``, ``eval/<metric>``); the JAX
package writes TensorBoard events where TensorFlow imports.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from pigeon_tpu_torch.train.checkpoints import CheckpointSession
from pigeon_tpu_torch.train.metrics import compute_geoguessr_metrics
from pigeon_tpu_torch.train.preemption import PreemptionGuard
from pigeon_tpu_torch.train.profiling import ProfilerWindow

logger = logging.getLogger("pigeon_tpu_torch.train")

#: Steps between writes of the train losses (each write waits for them,
#: and checks them for divergence).
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
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


def _gather_rows(cat: Dict[str, np.ndarray], sums: list, mesh):
    """Each data rank's rows and per-batch ``(loss * rows, rows)`` joined
    on every rank: the rows put back in dataset order by ``row_index``
    (padding, -1, dropped), each global batch's loss the row-weighted
    mean of its ranks' losses."""
    from pigeon_tpu_torch.train.multihost import gather_objects

    group = None if mesh is None else mesh.data_group
    parts = gather_objects((cat, sums), group)
    keys = cat.keys()
    joined = {k: np.concatenate([c[k] for c, _ in parts]) for k in keys}
    keep = joined["row_index"] >= 0
    order = np.argsort(joined["row_index"][keep], kind="stable")
    rows = {k: v[keep][order] for k, v in joined.items()}
    per_batch = np.array([s for _, s in parts], np.float64).sum(0)
    losses = [total / n for total, n in per_batch if n > 0]
    return rows, losses


def evaluate_model(eval_step: Callable, model, batches: Iterable[Dict],
                   batch_to_device: Callable,
                   refine_fn: Optional[Callable] = None, scaler=None,
                   country_index=None, mesh=None) -> Dict[str, float]:
    """Run the eval batches and compute the metric suite, plus
    ``Eval_loss``, the mean of the batches' losses.

    With ``refine_fn`` (`train.evaluate.build_refiner`) the refined
    location and cell replace the argmax ones; ``scaler`` and
    ``country_index`` add the multi-task errors and ``Country_accuracy``
    (`train.metrics.compute_geoguessr_metrics`).

    Batches with ``row_index`` (`train.multihost.iter_eval_batches`)
    hold a data rank's rows of each global batch: the rows of every rank
    of ``mesh``'s ``data`` axis are gathered (in dataset order) and every
    rank computes the same metrics.
    """
    acc: Dict[str, list] = {}

    def push(key, value):
        if value is not None:
            acc.setdefault(key, []).append(value)

    losses, sums = [], []
    for batch in batches:
        parts, preds = eval_step(model, batch_to_device(batch))
        losses.append(parts["loss"])
        if "row_index" in batch:
            push("row_index", batch["row_index"])
            sums.append(parts["rows"])
        pred_lla, pred_cell = preds["pred_lla"], preds["pred_cell"]
        if refine_fn is not None:
            refined = refine_fn(preds["embedding"], preds["pred_lla"],
                                preds["topk_cells"], preds["topk_probs"])
            pred_lla, pred_cell = refined["pred_lla"], refined["pred_cell"]
        push("predictions", pred_lla)
        push("cell_preds", pred_cell)
        push("topk_cells", preds["topk_cells"])
        push("preds_mt", preds["preds_mt"])
        push("preds_climate", preds["preds_climate"])
        push("preds_month", preds["preds_month"])
        push("labels", batch.get("labels"))
        push("cell_labels", batch.get("labels_clf"))
        push("labels_mt", batch.get("labels_multi_task"))
        push("labels_climate", batch.get("labels_climate"))
        push("labels_month", batch.get("labels_month"))
    if not losses:
        raise ValueError("evaluate_model received no batches: empty eval "
                         "split? (check the metadata's `selection` column)")
    # Device values are read once, at the end, not per batch.
    cat = {k: np.concatenate([v.cpu().numpy() if torch.is_tensor(v) else v
                              for v in vs]) for k, vs in acc.items()}
    if "row_index" in cat:
        rows = [int(n) for n in sums]
        sums = [(float(loss) * n if n else 0.0, n)
                for loss, n in zip(losses, rows)]
        cat, batch_losses = _gather_rows(cat, sums, mesh)
        eval_loss = float(np.mean(batch_losses))
    else:
        eval_loss = float(torch.stack(losses).mean())
    metrics = compute_geoguessr_metrics(
        predictions=cat["predictions"], labels=cat["labels"],
        cell_preds=cat.get("cell_preds"), cell_labels=cat.get("cell_labels"),
        topk_cells=cat.get("topk_cells"),
        preds_mt=cat.get("preds_mt"), labels_mt=cat.get("labels_mt"),
        preds_climate=cat.get("preds_climate"),
        labels_climate=cat.get("labels_climate"),
        preds_month=cat.get("preds_month"),
        labels_month=cat.get("labels_month"),
        scaler=scaler, country_index=country_index)
    metrics["Eval_loss"] = eval_loss
    return metrics


def train_model(state, train_step: Callable, eval_step: Callable,
                train_batches_fn: Callable[[int], Iterable[Dict]],
                eval_batches_fn: Callable[[], Iterable[Dict]],
                num_epochs: int, batch_to_device: Callable,
                checkpoint_dir: Optional[str] = None,
                log_dir: Optional[str] = None,
                profile_dir: Optional[str] = None,
                early_stopping_patience: int = 10,
                log_every: int = LOG_EVERY,
                divergence_guard: bool = True,
                max_recoveries: int = 3,
                preemption: bool = True):
    """Epochs of training, each followed by an eval pass.

    ``train_batches_fn(epoch)`` gives the epoch's batches (a fresh
    shuffle each epoch), ``eval_batches_fn()`` the eval batches. When the
    eval's geocell accuracy improves the state is checkpointed (the write
    overlaps the next epoch); after ``early_stopping_patience`` epochs
    without improvement training stops. Train losses stay on the device
    and are read every ``log_every`` steps and at the epoch's end.

    ``divergence_guard``: a non-finite loss at such a read restores the
    last checkpoint and goes on with the next epoch, at most
    ``max_recoveries`` times; with no checkpoint to go back to it raises.
    ``preemption``: a SIGTERM (`PreemptionGuard`) stops the run at the
    next step boundary, or before the epoch's eval, saves the state and
    waits for the write, and returns without that eval. Over several
    ranks the stop is collective: every rank polls `coordinated_flag` at
    the ``log_every`` boundaries and before each eval, so all of them
    stop at the same step and take the (collective) save together.
    Rank 0 alone writes the metrics. ``profile_dir``: a `ProfilerWindow`
    trace of steps 4 to 14.

    Returns ``(state, history)``, the eval metrics of each epoch that
    reached its eval.
    """
    from pigeon_tpu_torch.train.multihost import (
        coordinated_flag,
        is_primary,
        process_count,
    )

    nproc = process_count()
    mesh = getattr(state, "mesh", None)
    writer = MetricWriter(log_dir if is_primary() else None)
    profiler = ProfilerWindow(profile_dir)
    best = -np.inf
    stale = 0
    history = []
    recoveries = 0
    session = (CheckpointSession(checkpoint_dir)
               if checkpoint_dir is not None else None)
    guard = PreemptionGuard() if preemption else None

    def flush(pending) -> bool:
        """Write the pending losses; False if one is not finite."""
        ok = True
        for step, loss in pending:
            value = float(loss)
            writer.scalar("train/loss", value, step)
            if divergence_guard and not np.isfinite(value):
                logger.error("non-finite train loss %s at step %d",
                             value, step)
                ok = False
        pending.clear()
        return ok

    def recover():
        nonlocal recoveries
        recoveries += 1
        if recoveries > max_recoveries:
            raise RuntimeError(
                f"training diverged {recoveries} times; giving up")
        if session is None:
            raise RuntimeError(
                "training diverged with no checkpoint to roll back to")
        if session.latest_step() is None:
            raise RuntimeError(
                "training diverged before the first checkpoint")
        session.restore(state)
        logger.warning("rolled back to checkpoint step %d (recovery %d)",
                       state.step, recoveries)

    stack = contextlib.ExitStack()
    if guard is not None:
        stack.enter_context(guard)
    preempted = False
    try:
        for epoch in range(num_epochs):
            t0 = time.time()
            pending = []
            diverged = False
            batches = iter(train_batches_fn(epoch))
            try:
                for batch in batches:
                    # One process stops at any step; several agree at
                    # the log_every boundaries below (a rank breaking out
                    # alone would strand the others at a collective).
                    if nproc == 1 and guard is not None and guard.requested:
                        preempted = True
                        break
                    metrics = train_step(state, batch_to_device(batch))
                    profiler.step()
                    pending.append((state.step, metrics["loss"]))
                    if state.step % log_every == 0:
                        if not flush(pending):
                            diverged = True
                            break
                        if nproc > 1 and guard is not None and \
                                coordinated_flag(guard.requested):
                            preempted = True
                            break
            finally:
                if hasattr(batches, "close"):
                    batches.close()
            if not diverged and not flush(pending):
                diverged = True
            if diverged:
                recover()
                continue
            # Epoch-boundary poll: a signal after the last per-step poll
            # (during the final step or flush) still skips the eval.
            if not preempted and guard is not None and \
                    coordinated_flag(guard.requested):
                preempted = True
            if preempted:
                # The current state, not the best: resuming needs the
                # optimizer's continuity. Wait: the grace window is short.
                if session is not None:
                    saved = session.save(state, wait=True)
                    logger.warning("preempted at step %d: checkpoint "
                                   "saved, resume with the same name and "
                                   "--resume", saved)
                else:
                    logger.warning("preempted at step %d with no "
                                   "checkpoint directory: the state is "
                                   "lost unless the caller saves it",
                                   state.step)
                break

            eval_metrics = evaluate_model(eval_step, state.model,
                                          eval_batches_fn(), batch_to_device,
                                          mesh=mesh)
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
                if session is not None:
                    session.save(state)     # written during the next epoch
            else:
                stale += 1
                if stale >= early_stopping_patience:
                    logger.info("early stopping at epoch %d", epoch)
                    break
    finally:
        profiler.close()
        if session is not None:
            session.close()
        stack.close()
        writer.close()
    return state, history
