"""Geocell classification head and the logits -> coordinates lookup.

Counterpart of `pigeon_tpu/models/geocell_head.py`: the forward, the
predictions and the training loss (haversine-smoothed geocell targets
through kernel K10, the multi-task terms). Panorama views are aggregated
by their mean, where heading features do not survive, or with
``HeadConfig.hierarchical`` by one multi-head self-attention layer over
the views (`ViewAttention`, in the form of Flax's
``MultiHeadDotProductAttention``, plain PyTorch operations: no kernel),
whose view 0 is the aggregate.

The geocell centroid table is data, passed per call, not a parameter.
Under tensor parallelism the cell layer holds the rank's cells and the
logits are gathered over the ``model`` axis before the loss
(`pigeon_tpu/models/geocell_head.py:186-206`); kernel K10 smooths the
rank's label rows against the whole table.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from pigeon_tpu_torch.config import HeadConfig
from pigeon_tpu_torch.core.scoring import smooth_month_labels
from pigeon_tpu_torch.kernels.geodesy import smooth_labels_from_points
from pigeon_tpu_torch.kernels.sharded import copy_to_model, gather_from_model
from pigeon_tpu_torch.models.clip import dense

#: Default compass headings (sin, cos): north for single images; north,
#: east, south and west for the 4 views of a panorama.
DEFAULT_HEADING_SINGLE = (0.0, 1.0)
DEFAULT_HEADING_MULTI = ((0.0, 1.0), (1.0, 0.0), (0.0, -1.0), (-1.0, 0.0))


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


class ViewAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` as self-attention over
    ``(B, V, F)``: q/k/v projections to ``(heads, F / heads)``, the query
    divided by ``sqrt(F / heads)``, softmax in the input dtype, attention
    dropout broadcast over batch and heads, the output projection.
    The projections are ``nn.Linear`` layers over the flattened
    ``(heads, head_dim)`` axis (`models/jax_bridge.py` maps Flax's
    ``DenseGeneral`` kernels)."""

    def __init__(self, features: int, num_heads: int, dropout: float):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"{features} features do not split into "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.query, self.key, self.value, self.out = (
            nn.Linear(features, features) for _ in range(4))

    def forward(self, x):
        b, v, f = x.shape
        heads = (b, v, self.num_heads, f // self.num_heads)
        q, k, val = (dense(p, x).view(heads)
                     for p in (self.query, self.key, self.value))
        q = q / torch.sqrt(torch.tensor(heads[-1], dtype=x.dtype))
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        if self.training and self.dropout > 0:
            keep = torch.bernoulli(torch.full(
                (1, 1, v, v), 1.0 - self.dropout, device=x.device))
            weights = weights * (keep.to(x.dtype)
                                 / torch.tensor(1.0 - self.dropout,
                                                dtype=x.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", weights, val)
        return dense(self.out, out.reshape(b, v, f))


class GeocellHead(nn.Module):
    """Geocell classifier over ``(B, D)`` or ``(B, 4, D)`` embeddings.

    Parameters are f32; the forward runs in ``dtype`` and returns f32.
    With ``hierarchical`` the views attend to each other
    (`ViewAttention`, dropout at ``attn_dropout`` in training mode), their
    headings concatenated and zero-padded to ``num_attention_heads``
    extra features with ``heading``, and the aggregate is
    ``embed_dim + num_attention_heads`` wide there (the JAX head's cell
    layer takes the width it is given; `HeadConfig.input_dim` says
    ``embed_dim + 2``).
    """

    def __init__(self, config: HeadConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        d_in = config.input_dim
        if config.panorama and config.hierarchical:
            d_in = config.embed_dim + (config.num_attention_heads
                                       if config.heading else 0)
            self.view_attention = ViewAttention(
                d_in, config.num_attention_heads, config.attn_dropout)
        self.cell_layer = nn.Linear(d_in, config.num_cells)
        #: The `kernels.sharded.ModelAxis` whose ranks hold the cell
        #: layer's output columns (`train.mesh.tensor_parallel`), or None.
        self.tp = None
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
            if cfg.hierarchical:
                agg = self._hierarchical_aggregate(emb, heading)
            else:
                # Mean over views, accumulated in f32; heading features do
                # not survive mean aggregation.
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

        if self.tp is None:
            logits = dense(self.cell_layer, agg)
        else:
            # Column-parallel cells, gathered before the loss.
            logits = gather_from_model(
                dense(self.cell_layer, copy_to_model(agg, self.tp)), self.tp)
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

    def _hierarchical_aggregate(self, emb, heading):
        """Self-attention over the views, view 0 taken
        (`pigeon_tpu.models.geocell_head.GeocellHead.
        _hierarchical_aggregate`): the headings concatenated with
        ``num_attention_heads - 2`` zeros, sinusoidal positions added,
        dropout, `ViewAttention`."""
        cfg = self.config
        b, views, _ = emb.shape
        x = emb
        if cfg.heading:
            if heading is None:
                h = torch.tensor(DEFAULT_HEADING_MULTI, dtype=self.dtype,
                                 device=emb.device).expand(b, 4, 2)
            else:
                h = heading.to(self.dtype).reshape(b, 4, 2)
            zeros = emb.new_zeros((b, 4, cfg.num_attention_heads - 2))
            x = torch.cat([x, h, zeros], dim=-1)
        table = torch.from_numpy(sinusoidal_positions(views, x.shape[-1]))
        x = x + table.to(device=x.device, dtype=self.dtype)
        x = nn.functional.dropout(x, cfg.attn_dropout, self.training)
        return self.view_attention(x)[:, 0]

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
