"""Plain float32 DINOv2 ViT with registers: the embedding of one image.

From the published description (Oquab et al., arXiv:2304.07193; Darcet
et al., "Vision Transformers Need Registers", arXiv:2309.16588) as HF's
`Dinov2WithRegistersModel` computes it at inference:

* embeddings: ``x = cat(cls, conv_p(pixels) + bias) + pos``, then the
  registers spliced in after the CLS row, ``cat(x[:, :1], reg, x[:,
  1:])``: they take no position;
* each layer: ``x = x + gamma1 * O(MHA(LN1(x)))``, q, k, v and O with
  biases, scale ``1 / sqrt(head width)``; then ``x = x + gamma2 *
  W_out(silu(u1) * u2)`` with ``[u1 | u2] = W_in(LN2(x))``, the SwiGLU
  width ``(int(D * mlp_ratio * 2 / 3) + 7) // 8 * 8``;
* a final LayerNorm; the embedding is the CLS row;
* pixels normalised by the configuration's ``image_mean`` and
  ``image_std`` (ImageNet's).

Departures from HF's module: none at the configuration's own image size,
where the positions need no interpolation; dropout and drop-path are
identities at inference. The weights are those of `drivers/embed_dinov2`,
by the port's parameter names, with the patch weight ``(D, p*p*c)`` in
``(row, column, channel)`` order. ``fp8=True`` computes every dense
product on operands rounded to fp8 e4m3 (`model.fake_fp8`), the
attention's products in float32: the precision below bf16 that the
cell's check must catch.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.model import highest_precision, linear

__all__ = ["embed", "highest_precision", "normalize", "swiglu_width",
           "tower"]


def swiglu_width(cfg: dict) -> int:
    """The SwiGLU hidden width HF derives from the configuration."""
    return (int(cfg["hidden_size"] * cfg["mlp_ratio"] * 2 / 3) + 7) // 8 * 8


def normalize(pixels_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 NHWC -> f32 normalised by the configuration's mean and std."""
    x = pixels_u8.float() / 255.0
    mean = torch.tensor(cfg["image_mean"], device=x.device)
    std = torch.tensor(cfg["image_std"], device=x.device)
    return (x - mean) / std


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, (x.shape[-1],), w[prefix + ".weight"],
                        w[prefix + ".bias"], eps)


def _attention(x, w, base, heads, fp8):
    n, s, d = x.shape
    dh = d // heads
    q, k, v = (linear(x, w[f"{base}.{p}_proj.weight"],
                      w[f"{base}.{p}_proj.bias"], fp8)
               .view(n, s, heads, dh).transpose(1, 2) for p in "qkv")
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), -1)
    o = (probs @ v).transpose(1, 2).reshape(n, s, d)
    return linear(o, w[f"{base}.out_proj.weight"],
                  w[f"{base}.out_proj.bias"], fp8)


def tower(w: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
          fp8: bool = False) -> torch.Tensor:
    """Normalised NHWC pixels ``(N, H, W, 3)`` -> the final LayerNorm's
    output ``(N, 1 + R + P, D)``."""
    p, d = cfg["patch_size"], cfg["hidden_size"]
    c = cfg.get("num_channels", 3)
    eps = cfg["layer_norm_eps"]
    kernel = w["patch_embed.weight"].view(d, p, p, c).permute(0, 3, 1, 2)
    img = x.permute(0, 3, 1, 2)
    if fp8:
        patches = F.unfold(img, p, stride=p).transpose(1, 2)
        h = linear(patches, kernel.reshape(d, -1), w["patch_embed.bias"],
                   fp8)
    else:
        h = F.conv2d(img, kernel, w["patch_embed.bias"], stride=p) \
            .flatten(2).transpose(1, 2)
    n = h.shape[0]
    h = torch.cat([w["cls_token"].expand(n, 1, d), h], 1) + w["pos_embed"]
    reg = w["register_tokens"].expand(n, -1, d)
    h = torch.cat([h[:, :1], reg, h[:, 1:]], 1)
    for i in range(cfg["num_hidden_layers"]):
        base = f"encoder.layers.{i}"
        a = _attention(_ln(h, w, base + ".ln1", eps), w, base + ".attn",
                       cfg["num_attention_heads"], fp8)
        h = h + w[base + ".gamma1"] * a
        u = linear(_ln(h, w, base + ".ln2", eps), w[base + ".w_in.weight"],
                   w[base + ".w_in.bias"], fp8)
        u1, u2 = u.chunk(2, -1)
        m = linear(F.silu(u1) * u2, w[base + ".w_out.weight"],
                   w[base + ".w_out.bias"], fp8)
        h = h + w[base + ".gamma2"] * m
    return _ln(h, w, "final_ln", eps)


def embed(w, cfg: dict, pixels_u8: torch.Tensor, block: int = 16,
          fp8: bool = False) -> torch.Tensor:
    """CLS embeddings ``(N, D)`` of uint8 NHWC images, ``block`` at a
    time, without gradients."""
    with torch.no_grad():
        return torch.cat([tower(w, cfg, normalize(pixels_u8[i:i + block],
                                                  cfg), fp8)[:, 0]
                          for i in range(0, len(pixels_u8), block)])
