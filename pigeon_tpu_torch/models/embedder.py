"""Image embedding: the token mean of the vision tower's last hidden state.

Counterpart of `pigeon_tpu/models/embedder.py`. The embedding is the MEAN of
``last_hidden`` over all tokens (CLS included), not the pooled CLS; every
downstream artifact (head inputs, prototypes, refinement distances) lives in
this space.
"""

from __future__ import annotations

import torch
from torch import nn

from pigeon_tpu_torch.config import VisionConfig
from pigeon_tpu_torch.models.clip import CLIPVisionTower


def token_mean_embedding(last_hidden: torch.Tensor) -> torch.Tensor:
    """``(B, S, D) -> (B, D)`` mean over tokens, accumulated in f32."""
    return last_hidden.float().mean(dim=1)


class ClipEmbedder(nn.Module):
    """CLIP vision tower + token mean: NHWC CLIP-normalised pixels ->
    ``(B, D)`` f32 embeddings (`pigeon_tpu/models/embedder.py:26-48`).

    The tower is ``vision``, as in `SuperGuessr`, so the names of its
    state dict are those `models.hf_import.vision_tower_state` gives and
    ``models.quant.quantize_and_calibrate(..., tower_key="vision")`` makes
    it int8. ``attn_impl`` is the tower's route (`models/clip.py`).
    Panorama views are folded into the batch by the caller
    (`train/embed.py`).
    """

    def __init__(self, config: VisionConfig, dtype=torch.float32,
                 attn_impl: str = "fused"):
        super().__init__()
        self.vision = CLIPVisionTower(config, dtype=dtype,
                                      attn_impl=attn_impl)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        last_hidden, _ = self.vision(pixel_values)
        return token_mean_embedding(last_hidden)
