"""Geocell classification head and the logits -> coordinates lookup.

Counterpart of `pigeon_tpu/models/geocell_head.py`: the forward, the
predictions and the training loss (haversine-smoothed geocell targets
through kernel K10, the multi-task terms). Panorama views are aggregated
by their mean; heading features survive only in single-image mode
(`HeadConfig.input_dim`). Hierarchical view attention is not ported yet
and is refused.

The geocell centroid table is data, passed per call, not a parameter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from pigeon_tpu_torch.config import HeadConfig
from pigeon_tpu_torch.core.scoring import smooth_month_labels
from pigeon_tpu_torch.kernels.geodesy import smooth_labels_from_points
from pigeon_tpu_torch.models.clip import dense

#: Default compass heading (sin, cos) for single images: north.
DEFAULT_HEADING_SINGLE = (0.0, 1.0)


class GeocellOutput(NamedTuple):
    """Forward outputs of :class:`GeocellHead` (f32 logits and heads)."""

    logits: torch.Tensor                    # (B, num_cells)
    aggregated: torch.Tensor                # (B, input_dim)
    embedding: torch.Tensor                 # (B, D) or (B, 4, D)
    preds_mt: Optional[torch.Tensor]        # (B, 6)
    preds_climate: Optional[torch.Tensor]   # (B, 28)
    preds_month: Optional[torch.Tensor]     # (B, 12)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Sinusoidal positional table ``(length, dim)``; position i is added
    to view i (`pigeon_tpu.models.geocell_head.sinusoidal_positions`)."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                 * (-np.log(10000.0) / dim))
    table = np.zeros((length, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: dim // 2])
    return table.astype(np.float32)


class GeocellHead(nn.Module):
    """Geocell classifier over ``(B, D)`` or ``(B, 4, D)`` embeddings.

    Parameters are f32; the forward runs in ``dtype`` and returns f32.
    """

    def __init__(self, config: HeadConfig, dtype=torch.float32):
        super().__init__()
        if config.hierarchical:
            raise NotImplementedError(
                "hierarchical view aggregation is not ported yet")
        self.config = config
        self.dtype = dtype
        d_in = config.input_dim
        self.cell_layer = nn.Linear(d_in, config.num_cells)
        if config.multi_task:
            self.multi_task_head = nn.Linear(config.embed_dim,
                                             config.num_mt_vars)
            self.climate_layer = nn.Linear(d_in, config.num_climates)
            if config.predict_month:
                self.month_layer = nn.Linear(d_in, config.num_months)

    def forward(self, embedding: torch.Tensor,
                heading: Optional[torch.Tensor] = None) -> GeocellOutput:
        cfg = self.config
        emb = embedding.to(self.dtype)
        if cfg.panorama:
            if emb.dim() != 3:
                raise ValueError("panorama head expects (B, 4, D) "
                                 f"embeddings, got {tuple(emb.shape)}")
            # Mean over views, accumulated in f32; heading features do not
            # survive mean aggregation.
            agg = emb.float().mean(dim=1).to(self.dtype)
        else:
            if emb.dim() == 3:
                emb = emb[:, 0]
            agg = emb
            if cfg.heading:
                agg = torch.cat([agg, self._heading_features(emb, heading)],
                                dim=-1)

        def f32(t):
            return None if t is None else t.float()

        logits = dense(self.cell_layer, agg)
        preds_mt = preds_climate = preds_month = None
        if cfg.multi_task:
            # The regression head reads the embedding-width features.
            preds_mt = dense(self.multi_task_head, agg[..., :cfg.embed_dim])
            preds_climate = dense(self.climate_layer, agg)
            if cfg.predict_month:
                preds_month = dense(self.month_layer, agg)
        return GeocellOutput(logits=logits.float(), aggregated=agg,
                             embedding=embedding, preds_mt=f32(preds_mt),
                             preds_climate=f32(preds_climate),
                             preds_month=f32(preds_month))

    def _heading_features(self, emb, heading):
        """(sin, cos) heading features for single-image mode."""
        if heading is None:
            h = torch.tensor(DEFAULT_HEADING_SINGLE, dtype=self.dtype,
                             device=emb.device)
            return h.expand(emb.shape[0], 2)
        h = heading.to(self.dtype)
        return h[:, 0] if h.dim() == 3 else h   # (B, 4, 2): first view


def smoothed_targets(labels_lla: torch.Tensor, geocells: torch.Tensor,
                     tau_km: float) -> torch.Tensor:
    """Haversine-smoothed soft targets ``(B, C)``: kernel K10 on a CUDA
    tensor, its plain version on a CPU tensor."""
    return smooth_labels_from_points(labels_lla.float().contiguous(),
                                     geocells, tau_km)


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """``mean_B [-sum_c targets_c log_softmax(logits)_c]`` for (possibly
    unnormalised) targets: torch's `CrossEntropyLoss` on probability
    targets, the reference's loss with smoothed labels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(targets * logp).sum(-1).mean()


def int_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Cross entropy with integer class labels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def geocell_loss(output: GeocellOutput, geocells: torch.Tensor,
                 cfg: HeadConfig, labels_lla=None, labels_clf=None,
                 labels_multi_task=None, labels_climate=None,
                 labels_month=None, smooth_fn=smoothed_targets):
    """The training objective: ``(total, parts)``
    (`pigeon_tpu.models.geocell_head.geocell_loss`).

    The geocell term is the soft cross entropy against smoothed targets
    (``smooth_fn``, kernel K10 by default) or, without smoothing, the
    integer cross entropy on ``labels_clf``. Multi-task adds the squared
    regression error times 8, the climate term (integer or soft targets)
    times 2 and, with month labels, the month term times 1, hard or with
    cyclic month smoothing.
    """
    if cfg.smooth_labels:
        targets = smooth_fn(labels_lla, geocells, cfg.label_smoothing_km)
        loss_clf = soft_cross_entropy(output.logits, targets)
    else:
        loss_clf = int_cross_entropy(output.logits, labels_clf)
    parts = {"loss_clf": loss_clf}
    total = loss_clf

    if cfg.multi_task:
        loss_reg = ((output.preds_mt - labels_multi_task) ** 2).mean() \
            * cfg.regression_loss_scale
        if labels_climate.dim() == 1:
            loss_climate = int_cross_entropy(output.preds_climate,
                                             labels_climate)
        else:
            loss_climate = soft_cross_entropy(output.preds_climate,
                                              labels_climate)
        loss_climate = loss_climate * cfg.climate_loss_scale
        parts.update(loss_reg=loss_reg, loss_climate=loss_climate)
        total = total + loss_reg + loss_climate

        if cfg.predict_month and labels_month is not None:
            if cfg.month_smoothing > 0:
                loss_month = soft_cross_entropy(
                    output.preds_month,
                    smooth_month_labels(labels_month, cfg.num_months,
                                        cfg.month_smoothing))
            else:
                loss_month = int_cross_entropy(output.preds_month,
                                               labels_month)
            loss_month = loss_month * cfg.month_loss_scale
            parts["loss_month"] = loss_month
            total = total + loss_month

    parts["loss"] = total
    return total, parts


def geocell_predictions(logits: torch.Tensor, geocells: torch.Tensor,
                        num_candidates: int = 5) -> dict:
    """Geocell logits -> argmax centroid and top-k candidates.

    Returns ``probs`` (B, C), ``pred_cell`` (B,), ``pred_lla`` (B, 2)
    (lon, lat), ``topk_cells`` (B, k) and ``topk_probs`` (B, k).
    """
    probs = torch.softmax(logits, dim=-1)
    pred_cell = probs.argmax(dim=-1)
    topk_probs, topk_cells = torch.topk(
        probs, min(num_candidates, probs.shape[-1]), dim=-1)
    return {"probs": probs, "pred_cell": pred_cell,
            "pred_lla": geocells[pred_cell], "topk_cells": topk_cells,
            "topk_probs": topk_probs}
