"""Model builders of the training modes.

Counterpart of `pigeon_tpu/train/modes.py::build_finetune_model` and
`build_embedding_model`.
"""

from __future__ import annotations

import torch

from pigeon_tpu_torch.config import PigeonConfig
from pigeon_tpu_torch.models.geocell_head import GeocellHead
from pigeon_tpu_torch.models.super_guessr import (
    SuperGuessr,
    freeze_all_but_last_layer,
)


def build_finetune_model(cfg: PigeonConfig, dtype=torch.bfloat16,
                         attn_impl: str = "fused",
                         remat: str = "attn_kernel") -> SuperGuessr:
    """SuperGuessr for finetuning on pixels: f32 parameters, ``dtype``
    compute, the tower on route ``attn_impl`` (default ``"fused"``: K1
    forward, K2 backward; ``"block"``: K6 and K9 forward;
    `cli.run.attn_impl` reads ``PIGEON_ATTN_IMPL``)
    and remat'd under ``remat``, one of `models.clip.REMATS` (default
    ``attn_kernel``: the attention kernel's and the attention outputs
    kept, the rest recomputed; ``cli.run.remat_policy`` reads
    ``PIGEON_REMAT``), every encoder layer but
    the last frozen (reference `train_modes.py:67-107`). The weights are
    uninitialised: see `models.super_guessr.init_weights`."""
    model = SuperGuessr(cfg.vision, cfg.head, dtype=dtype,
                        attn_impl=attn_impl, remat=remat)
    return freeze_all_but_last_layer(model)


def build_embedding_model(cfg: PigeonConfig) -> GeocellHead:
    """The geocell head alone, in f32, for head-only training on
    precomputed embeddings (``finetune --embeddings``; reference
    `train_modes.py:110-133`). Uninitialised, as above."""
    return GeocellHead(cfg.head, dtype=torch.float32)
