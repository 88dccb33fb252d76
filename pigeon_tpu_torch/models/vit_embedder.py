"""Generic (non-CLIP) ViT image embedder, DINOv2 with registers, and
their HF weight imports.

Counterpart of `pigeon_tpu/models/vit_embedder.py:23-135`: a google/vit
style encoder, which differs from the CLIP tower in four places: the
patch embedding has a bias, there is no LayerNorm before the encoder, the
MLPs use the exact-erf GELU, and a final LayerNorm normalises every token
before pooling (the CLS token, or the mean of all tokens). The encoder is
the CLIP tower's `TransformerStack`, so its attention runs on the route
``attn_impl`` names (kernel K1 by default); kernel K9 fuses quick-GELU
only, so this tower's MLPs never run in it (`models/clip.py`).

A `config.ViTVariant` changes the tower beyond its widths; the default is
the generic ViT above. `config.dinov2_variant` is DINOv2 with registers
(Oquab et al., arXiv:2304.07193; Darcet et al., arXiv:2309.16588; HF
`Dinov2WithRegistersModel`): SwiGLU MLPs and LayerScale on both residuals
(`models/clip.py` `TransformerLayer.forward`), register tokens
spliced in after the CLS token once the positions are added, ImageNet's
pixel normalisation (``pixel_mean``, ``pixel_std``, which
`train.embed.make_embed_step` reads). `import_dinov2_params` and
`hf_dinov2_state` map HF's names. The port has no DINOv2 counterpart in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
from torch import nn

from pigeon_tpu_torch.config import VisionConfig, ViTVariant
from pigeon_tpu_torch.models.clip import PatchEmbed, TransformerStack

#: The ViT embedder's poolings: the final-LN CLS token, or the token mean
#: (registers left out).
POOLS = ("cls", "mean")


class ViTEmbedder(nn.Module):
    """Standard ViT encoder: NHWC normalised pixels -> ``(B, D)`` f32
    embeddings. Parameters are f32, the forward computes in ``dtype``.
    Under the default ``variant`` ``config.hidden_act`` is ignored: the
    MLPs are exact GELU, as the JAX package's; a SwiGLU variant's MLPs
    read none."""

    def __init__(self, config: VisionConfig, dtype=torch.float32,
                 pool: str = "cls", attn_impl: str = "fused",
                 variant: ViTVariant = ViTVariant()):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool={pool!r}, not in {POOLS}")
        if variant.mlp == "gelu":
            config = dataclasses.replace(config, hidden_act="gelu")
        d = config.hidden_size
        self.config = config
        self.variant = variant
        self.dtype = dtype
        self.pool = pool
        self.pixel_mean, self.pixel_std = variant.pixel_mean, \
            variant.pixel_std
        self.patch_embed = PatchEmbed(d, config.patch_size, bias=True)
        self.cls_token = nn.Parameter(torch.empty(d))
        self.pos_embed = nn.Parameter(torch.empty(config.seq_len, d))
        n = variant.num_register_tokens
        self.register_tokens = nn.Parameter(torch.empty(n, d)) if n \
            else None
        self.encoder = TransformerStack(
            config, attn_impl, swiglu=variant.mlp == "swiglu",
            layer_scale=variant.layer_scale)
        self.final_ln = nn.LayerNorm(d, eps=config.layer_norm_eps)

    def tokens(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The encoder's input ``(B, 1 + R + N, D)``: the CLS token and
        the patches with their positions, the ``R`` registers spliced in
        after the CLS token without any."""
        patches = self.patch_embed(pixel_values.to(self.dtype))
        b, _, d = patches.shape
        cls = self.cls_token.to(self.dtype).expand(b, 1, d)
        x = torch.cat([cls, patches], dim=1) + self.pos_embed.to(self.dtype)
        if self.register_tokens is None:
            return x
        reg = self.register_tokens.to(self.dtype).expand(b, -1, d)
        return torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.encoder.forward_ln(self.tokens(pixel_values), self.final_ln)
        if self.pool == "cls":
            return x[:, 0].float()
        if self.register_tokens is not None:
            x = torch.cat([x[:, :1], x[:, 1 + len(self.register_tokens):]],
                          dim=1)
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


#: HF `Dinov2WithRegistersLayer` names -> the port's, each with a weight
#: and a bias; and its LayerScale vectors.
_DINOV2_LAYER_MAP = (("norm1", "ln1"), ("norm2", "ln2"),
                     ("attention.attention.query", "attn.q_proj"),
                     ("attention.attention.key", "attn.k_proj"),
                     ("attention.attention.value", "attn.v_proj"),
                     ("attention.output.dense", "attn.out_proj"),
                     ("mlp.weights_in", "w_in"), ("mlp.weights_out", "w_out"))
_DINOV2_SCALES = (("layer_scale1.lambda1", "gamma1"),
                  ("layer_scale2.lambda1", "gamma2"))
#: The prefix of the base model's tensors inside HF's classifier.
_DINOV2_PREFIX = "dinov2_with_registers."


def _dinov2_pairs(num_layers: int):
    """(HF name, port name) of every tensor but the patch embed's weight,
    which changes layout, and the tokens, which change shape."""
    yield "embeddings.patch_embeddings.projection.bias", "patch_embed.bias"
    for leaf in ("weight", "bias"):
        yield f"layernorm.{leaf}", f"final_ln.{leaf}"
    for i in range(num_layers):
        for hf, port in _DINOV2_LAYER_MAP:
            for leaf in ("weight", "bias"):
                yield (f"encoder.layer.{i}.{hf}.{leaf}",
                       f"encoder.layers.{i}.{port}.{leaf}")
        for hf, port in _DINOV2_SCALES:
            yield f"encoder.layer.{i}.{hf}", f"encoder.layers.{i}.{port}"


def import_dinov2_params(state: Mapping[str, object],
                         num_layers: int) -> Dict[str, torch.Tensor]:
    """HF `Dinov2WithRegistersModel` state dict (bare, or under the
    classifier's ``dinov2_with_registers.``) -> the names of a DINOv2
    `ViTEmbedder`'s state dict, f32. The ``(D, C, P, P)`` patch conv is
    flattened in ``(p, p, c)`` order; the mask token and the classifier
    are not read. Checked by a round trip through `hf_dinov2_state` on
    seeded tensors; a check against the published checkpoint waits until
    its files are at hand."""

    def f32(name: str) -> torch.Tensor:
        return torch.as_tensor(s[name]).detach().to("cpu", torch.float32) \
            .contiguous()

    s = dict(state)
    if any(k.startswith(_DINOV2_PREFIX) for k in s):
        s = {k[len(_DINOV2_PREFIX):]: v for k, v in s.items()
             if k.startswith(_DINOV2_PREFIX)}
    patch = f32("embeddings.patch_embeddings.projection.weight")
    out = {"patch_embed.weight": patch.permute(0, 2, 3, 1)
           .reshape(patch.shape[0], -1).contiguous(),
           "cls_token": f32("embeddings.cls_token").reshape(-1),
           "pos_embed": f32("embeddings.position_embeddings")[0]
           .contiguous(),
           "register_tokens": f32("embeddings.register_tokens")[0]
           .contiguous()}
    for hf, port in _dinov2_pairs(num_layers):
        out[port] = f32(hf)
    return out


def hf_dinov2_state(model: ViTEmbedder) -> Dict[str, torch.Tensor]:
    """A DINOv2 ``model``'s parameters under HF
    `Dinov2WithRegistersModel`'s bare names, the inverse of
    `import_dinov2_params` (without the mask token, which embedding never
    reads)."""
    params = {k: v.detach().cpu() for k, v in model.named_parameters()}
    w = params["patch_embed.weight"]                         # (D, P*P*C)
    p = model.patch_embed.patch_size
    out = {"embeddings.patch_embeddings.projection.weight":
           w.reshape(w.shape[0], p, p, -1).permute(0, 3, 1, 2).contiguous(),
           "embeddings.cls_token": params["cls_token"].reshape(1, 1, -1),
           "embeddings.position_embeddings": params["pos_embed"][None],
           "embeddings.register_tokens": params["register_tokens"][None]}
    for hf, port in _dinov2_pairs(len(model.encoder.layers)):
        out[hf] = params[port]
    return out
