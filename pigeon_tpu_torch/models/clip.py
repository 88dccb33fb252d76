"""CLIP vision tower in PyTorch.

Counterpart of the vision side of `pigeon_tpu/models/clip.py`: a pre-LN
ViT with quick-GELU MLPs; `last_hidden` is returned WITHOUT the post-LN
(the embedding is its token mean) and `pooled` is post_LN(CLS).

Numerics follow the JAX package: parameters are f32 and are cast to the
compute dtype (bf16 when serving) at each use; LayerNorm statistics run
in f32 and round to the compute dtype; the attention softmax is f32.

Each layer has six routes, with one parameter layout (``ln1``,
``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``, ``ln2``, ``fc1``,
``fc2``), so a tree bridged from the JAX package loads under any of them:

* ``"fused"`` — the q/k/v projections and the attention run in kernel K1
  and its gradient in kernel K2 (`kernels/fused_qkv_attention.py`,
  `FusedQKVAttention`), the `flash_fused` route of the JAX package;
* ``"flash"`` — separate projections, then kernel K3 forward and kernel
  K4 backward (`kernels/attention.py`, `FlashAttention`), the JAX
  package's `flash` route;
* ``"plain"`` — separate projections and plain PyTorch attention, the
  JAX package's `xla` route;
* ``"fused_ln"`` — LN1 folded into the fused attention: kernel K5
  (`kernels/fused_ln_qkv_attention.py`) takes the layer's raw input, its
  gradient reuses K2; the JAX package's `flash_fused_ln`;
* ``"fused_mlp"`` — ``"fused_ln"`` plus the MLP half (LN2, fc1,
  quick-GELU, fc2, residual) as kernel K9 (`kernels/fused_mlp.py`); the
  JAX package's `flash_fused_mlp`;
* ``"block"`` — the whole attention half (LN1, q/k/v, attention,
  out_proj and the residual) as kernel K6
  (`kernels/fused_block_attention.py`, `FusedBlockAttention`), then K9:
  the layer adds no residual of its own; the JAX package's
  `flash_fused_block`.

``PIGEON_FLASH_FWD=online`` swaps K3 for K3′ wherever K3 runs
(`kernels/attention.py`).

The route is `MultiHeadAttention.attn_impl`, which `TransformerLayer`
reads; `set_route` switches a built model and `routes_of` reads it back.
The precedence follows `pigeon_tpu/models/clip.py:354-414`: in an int8
layer ``"fused_ln"`` and ``"fused_mlp"`` are ``"fused"``; ``"block"`` is
K7 in a static one and the ``"flash"`` projections in a dynamic one.

``quant`` makes the tower int8 (`models/quant.py`): every q/k/v/out/fc1/
fc2 Linear and the patch embed become `QuantLinear` layers. With
``"static"`` activation scales the ``"fused"`` route runs kernel K8
(`kernels/fused_qkv_attention_int8.py`) and then a static int8
``out_proj``, and ``"block"`` kernel K7
(`kernels/fused_block_attention_int8.py`: LN1 to residual in int8, the
MLP as int8 products); with ``"dynamic"`` scales (the calibration
forward) every route projects separately and ``"fused"`` and ``"block"``
attend through K3, as the JAX package's precedence
(`pigeon_tpu/models/clip.py:188-311`). Where a
LayerNorm feeds a quantize (LN1 and LN2 of an int8 layer) it takes Flax's
variance, ``E[x^2] - E[x]^2`` in f32, so the requantize boundaries fall
where the JAX package's do.

Training remats the tower layer by layer (``remat``, the JAX package's
`_remat_policy_names`):

* ``"none"`` — every activation is kept for the backward;
* ``"attn_kernel"`` — each layer is a non-reentrant
  `torch.utils.checkpoint` region that keeps its input, the attention
  kernel's output (K1, K3 or K5) and the attention output (after
  ``out_proj``) and recomputes the rest in the backward: LN1 (K2 needs
  its output), the separate projections of ``"flash"`` (K4 needs them),
  the residual add and the MLP. On ``"fused_mlp"`` and ``"block"`` it
  also keeps K9's output, the next layer's input, which XLA's dead-code
  elimination spares the JAX package from recomputing; on ``"block"``
  K6's output is the attention output (the JAX ``attn_out``). No kernel
  forward is launched again (K6's backward launches K1 on purpose, as the
  JAX VJP does).
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
from pigeon_tpu_torch.kernels.attention import (
    FLASH_ATTENTION_OP,
    FlashAttention,
)
from pigeon_tpu_torch.kernels.fused_block_attention import (
    FUSED_BLOCK_ATTENTION_OP,
    FusedBlockAttention,
)
from pigeon_tpu_torch.kernels.fused_block_attention_int8 import (
    fused_block_attention_int8,
)
from pigeon_tpu_torch.kernels.fused_ln_qkv_attention import (
    FUSED_LN_QKV_ATTENTION_OP,
    FusedLNQKVAttention,
    flax_layer_norm_f32,
)
from pigeon_tpu_torch.kernels.fused_mlp import (
    FUSED_LN_MLP_OP,
    FusedLNMLP,
    quick_gelu,
)
from pigeon_tpu_torch.kernels.fused_qkv_attention import (
    FUSED_QKV_ATTENTION_OP,
    FusedQKVAttention,
)
from pigeon_tpu_torch.kernels.fused_qkv_attention_int8 import (
    fused_qkv_attention_int8,
)
from pigeon_tpu_torch.models.quant import (
    QuantLinear,
    QuantPatchEmbed,
    quant_mode,
)

ATTN_IMPLS = ("fused", "flash", "plain", "fused_ln", "fused_mlp", "block")
#: The routes whose attention is the fused projection + attention.
FUSED_IMPLS = ("fused", "fused_ln", "fused_mlp")
REMATS = ("none", "attn_kernel")
QUANTS = (False, "dynamic", "static")

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


#: The kernel forwards whose outputs ``attn_kernel`` keeps.
_SAVED_OPS = (FUSED_QKV_ATTENTION_OP, FLASH_ATTENTION_OP,
              FUSED_LN_QKV_ATTENTION_OP, FUSED_LN_MLP_OP,
              FUSED_BLOCK_ATTENTION_OP)


def _attn_kernel_policy(ctx, func, *args, **kwargs):
    """The ``attn_kernel`` save set: the kernel outputs of `_SAVED_OPS`
    and what runs under `saved_by_remat`; everything else is
    recomputed."""
    if func in _SAVED_OPS or _SAVING.get():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dense(layer: nn.Linear, x):
    """``layer`` applied in ``x.dtype`` (f32 parameters cast at use)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def layer_norm(layer: nn.LayerNorm, x):
    """LayerNorm with f32 statistics, rounded back to ``x.dtype``."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps).to(x.dtype)


def flax_layer_norm(layer: nn.LayerNorm, x):
    """LayerNorm in Flax's form (`flax.linen.LayerNorm`, the arithmetic K5
    and K9 fold in): f32 mean and ``var = max(E[x^2] - E[x]^2, 0)``, then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, rounded back to
    ``x.dtype``."""
    return flax_layer_norm_f32(x, layer.weight, layer.bias,
                               layer.eps).to(x.dtype)


def make_linear(in_features: int, out_features: int, quant=False):
    """An ``nn.Linear``, or a `QuantLinear` in mode ``quant``."""
    if quant not in QUANTS:
        raise ValueError(f"quant={quant!r}, not in {QUANTS}")
    if quant:
        return QuantLinear(in_features, out_features, mode=quant)
    return nn.Linear(in_features, out_features)


def linear(layer: nn.Module, x):
    """``layer`` applied in ``x.dtype``: `dense` for an ``nn.Linear``, the
    layer itself for a `QuantLinear`."""
    return layer(x) if isinstance(layer, QuantLinear) else dense(layer, x)


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
                 attn_impl: str = "fused", quant=False):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}, not in {ATTN_IMPLS}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.q_proj = make_linear(hidden_size, hidden_size, quant)
        self.k_proj = make_linear(hidden_size, hidden_size, quant)
        self.v_proj = make_linear(hidden_size, hidden_size, quant)
        self.out_proj = make_linear(hidden_size, hidden_size, quant)

    def forward(self, x, ln: nn.LayerNorm = None):
        """``x`` (B, S, D) -> (B, S, D) after ``out_proj``. With ``ln``
        (the JAX package's ``ln=``, only on a fused route in float), ``x``
        is the layer's raw input and LN runs inside kernel K5. A
        ``"block"`` layer comes here only in a dynamic int8 tower, and
        projects separately (`block` is its route otherwise)."""
        b, s, d = x.shape
        projs = (self.q_proj, self.k_proj, self.v_proj)
        quant = quant_mode(self.q_proj)
        fused = self.attn_impl in FUSED_IMPLS
        if ln is not None and (quant or not fused):
            raise ValueError(f"LN folds into the attention only on a fused "
                             f"float route, not {self.attn_impl!r} "
                             f"(quant={quant!r})")
        if fused and quant == "static":
            # q/k/v see the same input, so calibration freezes the same
            # scale for each; the kernel quantizes x once at their max.
            act_scale = torch.maximum(
                torch.maximum(self.q_proj.act_scale, self.k_proj.act_scale),
                self.v_proj.act_scale)
            out = fused_qkv_attention_int8(
                x.contiguous(), act_scale,
                *(t for p in projs for t in (p.weight, p.scale, p.bias)),
                self.num_heads)
        elif fused and not quant:
            weights = [p.weight.to(x.dtype) for p in projs]
            biases = [p.bias.to(x.dtype) for p in projs]
            if ln is None:
                out = FusedQKVAttention.apply(x.contiguous(), *weights,
                                              *biases, self.num_heads)
            else:
                out = FusedLNQKVAttention.apply(
                    x.contiguous(), ln.weight, ln.bias, *weights, *biases,
                    self.num_heads, ln.eps)
        else:
            heads = (b, s, self.num_heads, d // self.num_heads)
            attend = (plain_attention if self.attn_impl == "plain"
                      else FlashAttention.apply)
            out = attend(*(linear(p, x).view(heads) for p in projs)) \
                .reshape(b, s, d)
        with saved_by_remat():
            return linear(self.out_proj, out)

    def block(self, x, ln: nn.LayerNorm):
        """The ``"block"`` route: ``x + out_proj(attention(ln(x)))`` on the
        layer's raw input ``x`` (B, S, D), the residual included: kernel
        K6 in float, K7 in a static int8 tower."""
        projs = (self.q_proj, self.k_proj, self.v_proj, self.out_proj)
        if quant_mode(self.q_proj) == "static":
            # One shared q/k/v input scale, as K8's branch takes it.
            a_qkv = torch.maximum(
                torch.maximum(self.q_proj.act_scale, self.k_proj.act_scale),
                self.v_proj.act_scale)
            return fused_block_attention_int8(
                x.contiguous(), ln.weight, ln.bias, a_qkv,
                *(t for p in projs[:3] for t in (p.weight, p.scale, p.bias)),
                self.out_proj.act_scale, self.out_proj.weight,
                self.out_proj.scale, self.out_proj.bias, self.num_heads,
                ln.eps)
        weights = [p.weight.to(x.dtype) for p in projs]
        biases = [p.bias.to(x.dtype) for p in projs]
        return FusedBlockAttention.apply(
            x.contiguous(), ln.weight, ln.bias, *weights[:3], *biases[:3],
            weights[3], biases[3], self.num_heads, ln.eps)


class TransformerLayer(nn.Module):
    """Pre-LN block: ``x += attn(LN1(x)); x += fc2(gelu(fc1(LN2(x))))``,
    on the route of ``self.attn.attn_impl`` (the module docstring)."""

    def __init__(self, config: VisionConfig, attn_impl: str = "fused",
                 quant=False):
        super().__init__()
        if config.hidden_act != "quick_gelu":
            raise ValueError(f"hidden_act={config.hidden_act!r}: the port "
                             "implements CLIP's quick_gelu only")
        d = config.hidden_size
        self.ln1 = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.attn = MultiHeadAttention(d, config.num_heads, attn_impl, quant)
        self.ln2 = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.fc1 = make_linear(d, config.intermediate_size, quant)
        self.fc2 = make_linear(config.intermediate_size, d, quant)

    def forward(self, x):
        quant = quant_mode(self.fc1)
        # An int8 layer quantizes LN1's and LN2's outputs: Flax's form.
        norm = flax_layer_norm if quant else layer_norm
        route = self.attn.attn_impl
        if route == "block" and quant != "dynamic":
            x = self.attn.block(x, self.ln1)    # K6 / K7: residual included
        elif route in ("fused_ln", "fused_mlp") and not quant:
            x = x + self.attn(x, ln=self.ln1)
        else:
            x = x + self.attn(norm(self.ln1, x))
        if route in ("fused_mlp", "block") and not quant:
            return FusedLNMLP.apply(
                x.contiguous(), self.ln2.weight, self.ln2.bias,
                *(t.to(x.dtype) for fc in (self.fc1, self.fc2)
                  for t in (fc.weight, fc.bias)), self.ln2.eps)
        h = quick_gelu(linear(self.fc1, norm(self.ln2, x)))
        return x + linear(self.fc2, h)


class TransformerStack(nn.Module):
    def __init__(self, config: VisionConfig, attn_impl: str = "fused",
                 remat: str = "none", quant=False):
        super().__init__()
        if remat not in REMATS:
            raise ValueError(f"remat={remat!r}, not in {REMATS}")
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerLayer(config, attn_impl, quant)
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
    ``(last_hidden (B, S, D), pooled (B, D))`` in the compute dtype.
    ``quant`` (False, ``"dynamic"`` or ``"static"``) builds the int8 tower
    that `models.quant.quantize_tower` fills."""

    def __init__(self, config: VisionConfig, dtype=torch.float32,
                 attn_impl: str = "fused", remat: str = "none", quant=False):
        super().__init__()
        d = config.hidden_size
        self.config = config
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.patch_embed = (QuantPatchEmbed(d, config.patch_size, mode=quant)
                            if quant else PatchEmbed(d, config.patch_size))
        self.cls_token = nn.Parameter(torch.empty(d))
        self.pos_embed = nn.Parameter(torch.empty(config.seq_len, d))
        self.pre_ln = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.encoder = TransformerStack(config, attn_impl, remat, quant)
        self.post_ln = nn.LayerNorm(d, eps=config.layer_norm_eps)

    def forward(self, pixel_values):
        """pixel_values: ``(B, H, W, 3)`` CLIP-normalised, NHWC."""
        patches = self.patch_embed(pixel_values.to(self.dtype))
        b, _, d = patches.shape
        cls = self.cls_token.to(self.dtype).expand(b, 1, d)
        x = torch.cat([cls, patches], dim=1) + self.pos_embed.to(self.dtype)
        x = self.encoder(layer_norm(self.pre_ln, x))
        return x, layer_norm(self.post_ln, x[:, 0])


def set_route(model: nn.Module, route: str) -> None:
    """Switch every layer of a built ``model`` (a tower, or a module that
    holds one) to ``route``; the parameters stay as they are."""
    if route not in ATTN_IMPLS:
        raise ValueError(f"route={route!r}, not in {ATTN_IMPLS}")
    for m in model.modules():
        if isinstance(m, (MultiHeadAttention, CLIPVisionTower)):
            m.attn_impl = route


def routes_of(model: nn.Module) -> set:
    """The routes the layers of ``model`` run on."""
    return {m.attn_impl for m in model.modules()
            if isinstance(m, MultiHeadAttention)}
