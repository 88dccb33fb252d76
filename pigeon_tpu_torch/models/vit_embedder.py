"""Generic (non-CLIP) ViT image embedder and its HF weight import.

Counterpart of `pigeon_tpu/models/vit_embedder.py:23-135`: a google/vit
style encoder, which differs from the CLIP tower in four places: the
patch embedding has a bias, there is no LayerNorm before the encoder, the
MLPs use the exact-erf GELU, and a final LayerNorm normalises every token
before pooling (the CLS token, or the mean of all tokens). The encoder is
the CLIP tower's `TransformerStack`, so its attention runs on the route
``attn_impl`` names (kernel K1 by default); kernel K9 fuses quick-GELU
only, so this tower's MLPs never run in it (`models/clip.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
from torch import nn

from pigeon_tpu_torch.config import VisionConfig
from pigeon_tpu_torch.models.clip import (
    PatchEmbed,
    TransformerStack,
    layer_norm,
)

#: The ViT embedder's poolings: the final-LN CLS token, or the token mean.
POOLS = ("cls", "mean")


class ViTEmbedder(nn.Module):
    """Standard ViT encoder: NHWC normalised pixels -> ``(B, D)`` f32
    embeddings. Parameters are f32, the forward computes in ``dtype``.
    ``config.hidden_act`` is ignored: the MLPs are exact GELU, as the JAX
    package's."""

    def __init__(self, config: VisionConfig, dtype=torch.float32,
                 pool: str = "cls", attn_impl: str = "fused"):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool={pool!r}, not in {POOLS}")
        config = dataclasses.replace(config, hidden_act="gelu")
        d = config.hidden_size
        self.config = config
        self.dtype = dtype
        self.pool = pool
        self.patch_embed = PatchEmbed(d, config.patch_size, bias=True)
        self.cls_token = nn.Parameter(torch.empty(d))
        self.pos_embed = nn.Parameter(torch.empty(config.seq_len, d))
        self.encoder = TransformerStack(config, attn_impl)
        self.final_ln = nn.LayerNorm(d, eps=config.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embed(pixel_values.to(self.dtype))
        b, _, d = patches.shape
        cls = self.cls_token.to(self.dtype).expand(b, 1, d)
        x = torch.cat([cls, patches], dim=1) + self.pos_embed.to(self.dtype)
        x = layer_norm(self.final_ln, self.encoder(x))
        if self.pool == "cls":
            return x[:, 0].float()
        return x.float().mean(dim=1)


#: HF `ViTLayer` names -> the port's, each with a weight and a bias.
_LAYER_MAP = (("layernorm_before", "ln1"), ("layernorm_after", "ln2"),
              ("attention.attention.query", "attn.q_proj"),
              ("attention.attention.key", "attn.k_proj"),
              ("attention.attention.value", "attn.v_proj"),
              ("attention.output.dense", "attn.out_proj"),
              ("intermediate.dense", "fc1"), ("output.dense", "fc2"))


def import_vit_params(state: Mapping[str, object],
                      num_layers: int) -> Dict[str, torch.Tensor]:
    """HF `ViTModel` state dict (``vit.``-prefixed or bare) -> the names
    of `ViTEmbedder`'s state dict, f32 (`pigeon_tpu/models/vit_embedder.py::
    import_vit_params`). The ``(D, C, P, P)`` patch conv is flattened in
    ``(p, p, c)`` order; the pooler and other tensors are not read."""

    def f32(name: str) -> torch.Tensor:
        return torch.as_tensor(s[name]).detach().to("cpu", torch.float32) \
            .contiguous()

    s = dict(state)
    if any(k.startswith("vit.") for k in s):
        s = {k[4:]: v for k, v in s.items() if k.startswith("vit.")}
    patch = f32("embeddings.patch_embeddings.projection.weight")
    out = {"patch_embed.weight": patch.permute(0, 2, 3, 1)
           .reshape(patch.shape[0], -1).contiguous(),
           "patch_embed.bias": f32("embeddings.patch_embeddings.projection."
                                   "bias"),
           "cls_token": f32("embeddings.cls_token").reshape(-1),
           "pos_embed": f32("embeddings.position_embeddings")[0]
           .contiguous()}
    for i in range(num_layers):
        for hf, port in _LAYER_MAP:
            for leaf in ("weight", "bias"):
                out[f"encoder.layers.{i}.{port}.{leaf}"] = f32(
                    f"encoder.layer.{i}.{hf}.{leaf}")
    for leaf in ("weight", "bias"):
        out[f"final_ln.{leaf}"] = f32(f"layernorm.{leaf}")
    return out


def hf_vit_state(model: ViTEmbedder) -> Dict[str, torch.Tensor]:
    """``model``'s parameters under HF `ViTModel`'s bare names, the inverse
    of `import_vit_params`: what an HF checkpoint of it holds (without a
    pooler)."""
    params = {k: v.detach().cpu() for k, v in model.named_parameters()}
    w = params["patch_embed.weight"]                         # (D, P*P*C)
    p = model.patch_embed.patch_size
    out = {"embeddings.patch_embeddings.projection.weight":
           w.reshape(w.shape[0], p, p, -1).permute(0, 3, 1, 2).contiguous(),
           "embeddings.patch_embeddings.projection.bias":
           params["patch_embed.bias"],
           "embeddings.cls_token": params["cls_token"].reshape(1, 1, -1),
           "embeddings.position_embeddings": params["pos_embed"][None]}
    for i in range(len(model.encoder.layers)):
        for hf, port in _LAYER_MAP:
            for leaf in ("weight", "bias"):
                out[f"encoder.layer.{i}.{hf}.{leaf}"] = params[
                    f"encoder.layers.{i}.{port}.{leaf}"]
    for leaf in ("weight", "bias"):
        out[f"layernorm.{leaf}"] = params[f"final_ln.{leaf}"]
    return out
