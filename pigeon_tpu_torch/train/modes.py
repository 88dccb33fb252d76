"""Model builders of the training modes.

Counterpart of `pigeon_tpu/train/modes.py::build_finetune_model`.
"""

from __future__ import annotations

import torch

from pigeon_tpu_torch.config import PigeonConfig
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
    and remat'd under ``attn_kernel`` (the attention kernel's and the
    attention outputs kept, the rest recomputed), every encoder layer but
    the last frozen (reference `train_modes.py:67-107`). The weights are
    uninitialised: see `models.super_guessr.init_weights`."""
    model = SuperGuessr(cfg.vision, cfg.head, dtype=dtype,
                        attn_impl=attn_impl, remat=remat)
    return freeze_all_but_last_layer(model)
