"""CLIP vision tower in PyTorch.

Counterpart of the vision side of `pigeon_tpu/models/clip.py`: a pre-LN
ViT with quick-GELU MLPs; `last_hidden` is returned WITHOUT the post-LN
(the embedding is its token mean) and `pooled` is post_LN(CLS).

Numerics follow the JAX package: parameters are f32 and are cast to the
compute dtype (bf16 when serving) at each use; LayerNorm statistics run
in f32 and round to the compute dtype; the attention softmax is f32.

Attention has two routes, with one parameter layout (``q_proj``,
``k_proj``, ``v_proj``, ``out_proj`` Linears):

* ``"fused"`` — the q/k/v projections and the attention run in kernel K1
  and its gradient in kernel K2 (`kernels/fused_qkv_attention.py`,
  `FusedQKVAttention`), the `flash_fused` route of the JAX package;
* ``"plain"`` — separate projections and plain PyTorch attention, the
  JAX package's `xla` route.

Training remats the tower layer by layer (``remat``, the JAX package's
`_remat_policy_names`):

* ``"none"`` — every activation is kept for the backward;
* ``"attn_kernel"`` — each layer is a non-reentrant
  `torch.utils.checkpoint` region that keeps its input, K1's output and
  the attention output (after ``out_proj``) and recomputes the rest in
  the backward: LN1 (K2 needs its output), the residual add and the MLP.
  K1 is never launched again.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from pigeon_tpu_torch.config import VisionConfig
from pigeon_tpu_torch.kernels.fused_qkv_attention import (
    FUSED_QKV_ATTENTION_OP,
    FusedQKVAttention,
)

ATTN_IMPLS = ("fused", "plain")
REMATS = ("none", "attn_kernel")

#: Set while a layer computes a tensor that the ``attn_kernel`` policy
#: saves by name (the JAX package's ``checkpoint_name``).
_SAVING = contextvars.ContextVar("pigeon_remat_saving", default=False)


@contextlib.contextmanager
def saved_by_remat():
    """Mark the operations run inside as saved by the remat policy."""
    token = _SAVING.set(True)
    try:
        yield
    finally:
        _SAVING.reset(token)


def _attn_kernel_policy(ctx, func, *args, **kwargs):
    """The ``attn_kernel`` save set: K1's output and what runs under
    `saved_by_remat`; everything else is recomputed."""
    if func is FUSED_QKV_ATTENTION_OP or _SAVING.get():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def quick_gelu(x):
    """CLIP's activation: ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def dense(layer: nn.Linear, x):
    """``layer`` applied in ``x.dtype`` (f32 parameters cast at use)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def layer_norm(layer: nn.LayerNorm, x):
    """LayerNorm with f32 statistics, rounded back to ``x.dtype``."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps).to(x.dtype)


def plain_attention(q, k, v):
    """``(B, S, H, dh)`` q/k/v -> ``(B, S, H, dh)``: products in the
    input dtype, softmax in f32 (`pigeon_tpu.models.clip.xla_attention`
    without a mask)."""
    scale = q.shape[-1] ** -0.5
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    logits = (q @ k.transpose(-1, -2)) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return (probs @ v).transpose(1, 2)


class PatchEmbed(nn.Module):
    """Patch embedding as space-to-depth + one matmul.

    ``weight`` is ``(D, P*P*C)`` with the input features flattened in
    ``(p, p, c)`` order (`pigeon_tpu/models/clip.py:93-95`), so a JAX
    ``(P, P, C, D)`` kernel maps to ``kernel.reshape(-1, D).T``.
    """

    def __init__(self, features: int, patch_size: int, channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(
            torch.empty(features, patch_size * patch_size * channels))

    def forward(self, x):
        """``(B, H, W, C)`` -> ``(B, N_patches, D)`` in ``x.dtype``."""
        p = self.patch_size
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        return F.linear(x, self.weight.to(x.dtype))


class MultiHeadAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 attn_impl: str = "fused"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}, not in {ATTN_IMPLS}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x):
        b, s, d = x.shape
        if self.attn_impl == "fused":
            projs = (self.q_proj, self.k_proj, self.v_proj)
            out = FusedQKVAttention.apply(
                x.contiguous(), *(p.weight.to(x.dtype) for p in projs),
                *(p.bias.to(x.dtype) for p in projs), self.num_heads)
        else:
            heads = (b, s, self.num_heads, d // self.num_heads)
            out = plain_attention(
                dense(self.q_proj, x).view(heads),
                dense(self.k_proj, x).view(heads),
                dense(self.v_proj, x).view(heads)).reshape(b, s, d)
        with saved_by_remat():
            return dense(self.out_proj, out)


class TransformerLayer(nn.Module):
    """Pre-LN block: ``x += attn(LN1(x)); x += fc2(gelu(fc1(LN2(x))))``."""

    def __init__(self, config: VisionConfig, attn_impl: str = "fused"):
        super().__init__()
        if config.hidden_act != "quick_gelu":
            raise ValueError(f"hidden_act={config.hidden_act!r}: the port "
                             "implements CLIP's quick_gelu only")
        d = config.hidden_size
        self.ln1 = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.attn = MultiHeadAttention(d, config.num_heads, attn_impl)
        self.ln2 = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.fc1 = nn.Linear(d, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, d)

    def forward(self, x):
        x = x + self.attn(layer_norm(self.ln1, x))
        h = quick_gelu(dense(self.fc1, layer_norm(self.ln2, x)))
        return x + dense(self.fc2, h)


class TransformerStack(nn.Module):
    def __init__(self, config: VisionConfig, attn_impl: str = "fused",
                 remat: str = "none"):
        super().__init__()
        if remat not in REMATS:
            raise ValueError(f"remat={remat!r}, not in {REMATS}")
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerLayer(config, attn_impl)
            for _ in range(config.num_layers))

    def forward(self, x):
        remat = self.remat == "attn_kernel" and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, use_reentrant=False,
                               context_fn=functools.partial(
                                   create_selective_checkpoint_contexts,
                                   _attn_kernel_policy))
            else:
                x = layer(x)
        return x


class CLIPVisionTower(nn.Module):
    """CLIP ViT encoder: NHWC CLIP-normalised pixels ->
    ``(last_hidden (B, S, D), pooled (B, D))`` in the compute dtype."""

    def __init__(self, config: VisionConfig, dtype=torch.float32,
                 attn_impl: str = "fused", remat: str = "none"):
        super().__init__()
        d = config.hidden_size
        self.dtype = dtype
        self.patch_embed = PatchEmbed(d, config.patch_size)
        self.cls_token = nn.Parameter(torch.empty(d))
        self.pos_embed = nn.Parameter(torch.empty(config.seq_len, d))
        self.pre_ln = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.encoder = TransformerStack(config, attn_impl, remat)
        self.post_ln = nn.LayerNorm(d, eps=config.layer_norm_eps)

    def forward(self, pixel_values):
        """pixel_values: ``(B, H, W, 3)`` CLIP-normalised, NHWC."""
        patches = self.patch_embed(pixel_values.to(self.dtype))
        b, _, d = patches.shape
        cls = self.cls_token.to(self.dtype).expand(b, 1, d)
        x = torch.cat([cls, patches], dim=1) + self.pos_embed.to(self.dtype)
        x = self.encoder(layer_norm(self.pre_ln, x))
        return x, layer_norm(self.post_ln, x[:, 0])
