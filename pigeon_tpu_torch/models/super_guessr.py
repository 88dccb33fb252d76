"""SuperGuessr: CLIP vision tower + geocell head, pixels -> geocell logits.

Counterpart of `pigeon_tpu/models/super_guessr.py`. A panorama
``(B, 4, H, W, 3)`` is folded to ``(4B, H, W, 3)`` for one tower batch and
its token-mean embeddings are unfolded to ``(B, 4, D)`` for the head.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pigeon_tpu_torch.config import HeadConfig, VisionConfig
from pigeon_tpu_torch.models.clip import CLIPVisionTower, PatchEmbed
from pigeon_tpu_torch.models.embedder import token_mean_embedding
from pigeon_tpu_torch.models.geocell_head import GeocellHead, GeocellOutput

#: Flax's ``lecun_normal``: a normal truncated at two standard deviations,
#: rescaled by this constant so that its variance is ``1 / fan_in``.
_TRUNC_STD = 0.87962566103423978


class SuperGuessr(nn.Module):
    """End-to-end model: NHWC CLIP-normalised pixels -> `GeocellOutput`.

    Parameters are f32; the forward computes in ``dtype`` (bf16 on the
    card). ``attn_impl`` selects the tower's route (``"fused"``: kernels
    K1 and K2, or K8 when int8; ``"flash"``: separate projections and
    kernels K3 and K4; ``"plain"``: separate projections; ``"fused_ln"``:
    K5 with LN1 folded in; ``"fused_mlp"``: K5 and the MLP half as K9;
    `models/clip.py` states the precedence); ``remat`` the
    tower's training remat policy (``"none"`` or ``"attn_kernel"``);
    ``quant`` (False, ``"dynamic"`` or ``"static"``) an int8 tower
    (`models/quant.py`), which `models.quant.quantize_and_calibrate` also
    makes from a float model.
    """

    def __init__(self, vision_config: VisionConfig, head_config: HeadConfig,
                 dtype=torch.float32, attn_impl: str = "fused",
                 remat: str = "none", quant=False):
        super().__init__()
        self.head_config = head_config
        self.vision = CLIPVisionTower(vision_config, dtype=dtype,
                                      attn_impl=attn_impl, remat=remat,
                                      quant=quant)
        self.head = GeocellHead(head_config, dtype=dtype)

    def forward(self, pixel_values: torch.Tensor,
                heading: Optional[torch.Tensor] = None) -> GeocellOutput:
        b = pixel_values.shape[0]
        pixels = pixel_values
        if self.head_config.panorama:
            if pixel_values.dim() != 5 or pixel_values.shape[1] != 4:
                raise ValueError("panorama input must be (B, 4, H, W, 3); "
                                 f"got {tuple(pixel_values.shape)}")
            pixels = pixel_values.reshape(b * 4, *pixel_values.shape[2:])
        last_hidden, _ = self.vision(pixels)
        embedding = token_mean_embedding(last_hidden)
        if self.head_config.panorama:
            embedding = embedding.reshape(b, 4, -1)
        return self.head(embedding, heading=heading)


def freeze_all_but_last_layer(model: SuperGuessr) -> SuperGuessr:
    """Freeze every encoder layer but the last; the patch embedding, CLS
    token, positions, LayerNorms outside the layers and the head stay
    trainable (`pigeon_tpu.models.super_guessr.trainable_last_layer_mask`,
    reference `super_guessr.py:155-160`)."""
    for layer in model.vision.encoder.layers[:-1]:
        layer.requires_grad_(False)
    return model


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded initialisation with the JAX package's initialisers.

    Dense and patch kernels: lecun-normal (truncated normal, variance
    1 / fan_in); biases zero; LayerNorms one and zero; CLS token and
    positions N(0, 0.02). The numbers differ from the JAX package's for
    the same seed (another generator); the distributions are the same.
    """
    gen = torch.Generator().manual_seed(seed)

    def lecun_normal_(w, fan_in):
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=gen)

    for module in model.modules():
        if isinstance(module, nn.Linear):
            lecun_normal_(module.weight, module.in_features)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, PatchEmbed):
            lecun_normal_(module.weight, module.weight.shape[1])
        elif isinstance(module, CLIPVisionTower):
            nn.init.normal_(module.cls_token, std=0.02, generator=gen)
            nn.init.normal_(module.pos_embed, std=0.02, generator=gen)
    return model
