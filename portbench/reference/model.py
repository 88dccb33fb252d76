"""Plain float32 CLIP vision tower, PIGEON panorama head, smoothed-label
loss and AdamW.

The tower is CLIP's ViT (Radford et al. 2021; HF ``CLIPVisionModel``):
a patch convolution without bias, the class token and learned positions,
a LayerNorm before the encoder, pre-LN encoder layers of multi-head
self-attention and a quick-GELU MLP (``x * sigmoid(1.702 x)``). PIGEON
(Haas et al., arXiv:2307.05845) embeds a view as the mean of the last
hidden state over all tokens, averages a panorama's four views, and
classifies the average into geocells against haversine-smoothed targets
``exp(-(d - min d) / tau)``, with regression, climate and month terms.

``fp8=True`` computes every dense product (the patch embedding, q, k,
v, the output projection, fc1, fc2 and the head's layers) on operands
rounded to fp8 e4m3 with one scale a tensor (``max|x| / 448``), as fp8
training on the H100 does, the attention's products in float32 and the
gradient passed straight through the rounding: the step below bf16 that
the training cell's comparison must catch.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

#: OpenAI CLIP's pixel normalisation.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
#: WGS84 equatorial radius, km.
EARTH_RADIUS_KM = 6378.137


def highest_precision() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


#: The largest finite fp8 e4m3 value.
FP8_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` scaled by ``FP8_MAX / max|x|``, rounded to fp8 e4m3 and
    scaled back; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def linear(x, weight, bias=None, fp8: bool = False):
    if fp8:
        x, weight = fake_fp8(x), fake_fp8(weight)
    y = x @ weight.t()
    return y if bias is None else y + bias


def normalize(pixels_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> CLIP-normalised f32."""
    x = pixels_u8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, (x.shape[-1],), w[prefix + ".weight"],
                        w[prefix + ".bias"], eps)


def attention(x, w, base, heads: int, fp8: bool):
    n, s, d = x.shape
    dh = d // heads
    q, k, v = (linear(x, w[f"{base}.{p}_proj.weight"],
                      w[f"{base}.{p}_proj.bias"], fp8)
               .view(n, s, heads, dh).transpose(1, 2) for p in "qkv")
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), -1)
    o = (probs @ v).transpose(1, 2).reshape(n, s, d)
    return linear(o, w[f"{base}.out_proj.weight"],
                  w[f"{base}.out_proj.bias"], fp8)


def tower(w: Dict[str, torch.Tensor], vision: dict, x: torch.Tensor,
          fp8: bool = False) -> torch.Tensor:
    """CLIP-normalised NHWC pixels ``(N, H, W, 3)`` -> the last hidden
    state ``(N, S, D)``, before the post-LayerNorm."""
    p, d = vision["patch_size"], vision["hidden_size"]
    c = vision.get("num_channels", 3)
    eps = vision["layer_norm_eps"]
    # The patch weight (D, p*p*c) is a (D, c, p, p) convolution kernel
    # stored with each patch's pixels in (row, column, channel) order.
    kernel = w["vision.patch_embed.weight"].view(d, p, p, c) \
        .permute(0, 3, 1, 2)
    img = x.permute(0, 3, 1, 2)
    if fp8:
        patches = F.unfold(img, p, stride=p).transpose(1, 2)
        h = linear(patches, kernel.reshape(d, -1), None, fp8)
    else:
        h = F.conv2d(img, kernel, stride=p).flatten(2).transpose(1, 2)
    cls = w["vision.cls_token"].expand(h.shape[0], 1, d)
    h = torch.cat([cls, h], 1) + w["vision.pos_embed"]
    h = _ln(h, w, "vision.pre_ln", eps)
    act = vision["hidden_act"]
    if act != "quick_gelu":
        raise ValueError(f"hidden_act={act!r}: the reference has quick_gelu")
    for i in range(vision["num_hidden_layers"]):
        base = f"vision.encoder.layers.{i}"
        h = h + attention(_ln(h, w, base + ".ln1", eps), w, base + ".attn",
                          vision["num_attention_heads"], fp8)
        m = linear(_ln(h, w, base + ".ln2", eps), w[base + ".fc1.weight"],
                   w[base + ".fc1.bias"], fp8)
        m = m * torch.sigmoid(1.702 * m)
        h = h + linear(m, w[base + ".fc2.weight"], w[base + ".fc2.bias"],
                       fp8)
    return h


def embed(w, vision: dict, pixels_u8: torch.Tensor, block: int = 32,
          fp8: bool = False) -> torch.Tensor:
    """Token-mean embeddings ``(N, D)`` of uint8 NHWC views, ``block``
    views at a time, without gradients."""
    with torch.no_grad():
        return torch.cat([tower(w, vision, normalize(pixels_u8[i:i + block]),
                                fp8).mean(1)
                          for i in range(0, len(pixels_u8), block)])


def head(w, head_cfg: dict, views_emb: torch.Tensor,
         fp8: bool = False) -> Dict[str, torch.Tensor]:
    """The panorama head on ``(B, 4, D)`` view embeddings: their mean,
    then the geocell logits and the multi-task outputs."""
    agg = views_emb.mean(1)
    out = {"logits": linear(agg, w["head.cell_layer.weight"],
                            w["head.cell_layer.bias"], fp8)}
    if head_cfg.get("multi_task"):
        for key, layer in (("preds_mt", "multi_task_head"),
                           ("preds_climate", "climate_layer"),
                           ("preds_month", "month_layer")):
            if key == "preds_month" and not head_cfg.get("predict_month"):
                continue
            out[key] = linear(agg, w[f"head.{layer}.weight"],
                              w[f"head.{layer}.bias"], fp8)
    return out


def haversine_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """km between every (lon, lat) row of ``a`` and of ``b``."""
    a, b = torch.deg2rad(a.double()), torch.deg2rad(b.double())
    dlon = b[None, :, 0] - a[:, None, 0]
    dlat = b[None, :, 1] - a[:, None, 1]
    h = (torch.sin(dlat / 2) ** 2 + torch.cos(a[:, None, 1])
         * torch.cos(b[None, :, 1]) * torch.sin(dlon / 2) ** 2)
    return (2 * EARTH_RADIUS_KM * torch.asin(h.clamp(0, 1).sqrt())).float()


def smoothed_targets(labels, cells, tau_km: float) -> torch.Tensor:
    d = haversine_matrix(labels, cells)
    return torch.exp(-(d - d.amin(-1, keepdim=True)) / tau_km)


def sample_losses(out, batch, cells, head_cfg: dict) -> torch.Tensor:
    """Each sample's share of the objective, ``(B,)``: the batch's loss
    is their mean. Soft cross entropy against the smoothed targets; with
    the multi-task head, 8 x the mean squared regression error, 2 x the
    climate and 1 x the month cross entropy."""
    t = smoothed_targets(batch["labels"], cells,
                         head_cfg["label_smoothing_km"])
    loss = -(t * torch.log_softmax(out["logits"], -1)).sum(-1)
    if head_cfg.get("multi_task"):
        loss = loss + head_cfg["regression_loss_scale"] * (
            (out["preds_mt"] - batch["labels_multi_task"]) ** 2).mean(-1)
        loss = loss + head_cfg["climate_loss_scale"] * F.cross_entropy(
            out["preds_climate"], batch["labels_climate"].long(),
            reduction="none")
        if head_cfg.get("predict_month"):
            loss = loss + head_cfg["month_loss_scale"] * F.cross_entropy(
                out["preds_month"], batch["labels_month"].long(),
                reduction="none")
    return loss


def loss_and_grads(w, trained, vision, head_cfg, pixels_u8, batch, cells,
                   block: int = 2, fp8: bool = False):
    """The batch's mean loss and its gradients for the parameters named
    in ``trained``, ``block`` panoramas at a time (the loss is a mean over
    samples, so the blocks' gradients add up); and the loss with the
    geocell logits rounded to bf16, which the look at the program's loss
    gap reads."""
    params = {k: (v.detach().requires_grad_(True) if k in trained
                  else v.detach()) for k, v in w.items()}
    grads = {k: torch.zeros_like(params[k]) for k in trained}
    b, views = pixels_u8.shape[:2]
    total = rounded = 0.0
    for i in range(0, b, block):
        px = pixels_u8[i:i + block]
        n = px.shape[0]
        x = normalize(px.reshape(n * views, *px.shape[2:]))
        emb = tower(params, vision, x, fp8).mean(1).view(n, views, -1)
        out = head(params, head_cfg, emb, fp8)
        part = {k: v[i:i + block] for k, v in batch.items()}
        loss = sample_losses(out, part, cells, head_cfg).sum() / b
        got = torch.autograd.grad(loss, [params[k] for k in trained],
                                  allow_unused=True)
        for k, g in zip(trained, got):
            if g is not None:
                grads[k] += g
        total += loss.item()
        with torch.no_grad():
            bf16 = dict(out, logits=out["logits"].bfloat16().float())
            rounded += sample_losses(bf16, part, cells,
                                     head_cfg).sum().item() / b
    return total, grads, rounded


class AdamW:
    """``torch.optim.AdamW``'s update, written out: decoupled weight
    decay, bias-corrected moments, ``eps`` added to the corrected root."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p = params[k]
            p.mul_(1 - self.lr * self.wd)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)
