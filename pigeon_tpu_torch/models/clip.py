"""CLIP in PyTorch: the vision tower, the text tower and the contrastive
model.

Counterpart of `pigeon_tpu/models/clip.py`: a pre-LN ViT with quick-GELU
MLPs; `last_hidden` is returned WITHOUT the post-LN (the embedding is its
token mean) and `pooled` is post_LN(CLS). The encoder layers also take
HF's exact-erf ``gelu`` (``VisionConfig.hidden_act``), which the generic
ViT embedder (`models/vit_embedder.py`) runs. `CLIPTextTower` (causal
mask, final LN, pooling at the first EOS), `clip_contrastive_loss` and
`CLIPModel` (both towers, bias-free projections, f32 L2 normalisation and
``logit_scale = exp(param)``) serve contrastive pretraining and zero-shot
classification (`train/modes.py`, `models/zeroshot.py`).

An attention given a ``mask`` (the text tower's causal one) takes the
plain path on every route, projections and MLP included, as the JAX
package's does (`pigeon_tpu/models/clip.py:188`, `:294`): every kernel
route needs ``mask is None``, so the text tower launches no kernel.

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

K9 fuses quick-GELU only: a ``gelu`` layer on ``"fused_mlp"`` or
``"block"`` keeps K5's or K6's attention and runs its MLP half in plain
PyTorch (`pigeon_tpu/models/clip.py:363-369`).

``PIGEON_FLASH_FWD=online`` swaps K3 for K3′ wherever K3 runs
(`kernels/attention.py`).

A float layer on ``"fused"``, ``"flash"`` or ``"fused_ln"`` runs its
element-wise chain on a CUDA bf16 activation as the one-pass kernels of
`kernels/eltwise.py` (`TransformerLayer.forward`), and so does the vision
tower's pre-LN (`CLIPVisionTower.embed`). With grad mode off (``embed``,
``serve``, ``evaluate``, ``predict``) they are the raw kernels; with grad
mode on (training) a CLIP layer takes their autograd versions, which save
what their hand-written backwards read, and which the remat recompute
launches again; DINOv2's SwiGLU and LayerScale layers keep the eager
chain there.

A layer built with ``swiglu`` or ``layer_scale`` (DINOv2's, through
`models/vit_embedder.py`'s `config.ViTVariant`) has a SwiGLU MLP
(``w_in``, ``w_out``) in place of ``fc1``/``fc2`` and per-channel
``gamma1``/``gamma2`` on its residuals (`TransformerLayer.forward`).
It runs on every route but ``"block"``, whose K6 adds the residual
unscaled; K9 never runs it, and it has no int8 twin.

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
`_remat_policy_names`). Each policy but ``none`` makes every layer a
non-reentrant `torch.utils.checkpoint` region that keeps its input and
the tensors the policy names, and recomputes the rest in the backward;
the names are the JAX package's ``checkpoint_name`` tags:

* ``"none"`` — no region: every activation is kept for the backward;
* ``"full"`` — nothing named: the attention kernel (K1, K3, K5 or K6)
  runs again in every layer's backward, since the MLP's backward needs
  the residual stream after the attention;
* ``"attn_out"`` — the attention output after ``out_proj`` (K6's
  post-residual output on ``"block"``): on the routes with a separate
  ``out_proj`` the kernel still runs again in every layer, where the
  recompute rebuilds ``out_proj``'s input (the JAX package reruns it for
  ``dWo``); on ``"block"`` nothing runs again;
* ``"attn_kernel"`` (the default) — ``attn_out`` and the attention
  kernel's output (``attn_kernel_out``: K1, K3 or K5); no kernel runs
  again. The recompute rebuilds LN1 (K2 needs its output), the separate
  projections of ``"flash"`` (K4 needs them), the residual add and the
  MLP;
* ``"attn_slim"`` — ``attn_kernel_out`` alone: ``x + out_proj(kernel
  output)`` is recomputed, one dense product and no kernel.

On ``"block"`` no pre-``out_proj`` tensor exists, so ``attn_kernel`` and
``attn_slim`` save ``attn_out``, as in the JAX package. Under every
policy but ``none`` the region also keeps K9's output (``mlp_out``, on
``"fused_mlp"`` and ``"block"``): it is the next layer's input, which
that layer's region holds anyway, and XLA's dead-code elimination spares
the JAX package the rerun that recomputing it would cost here. K6's
backward launches K1 where its ``Wo`` trains, as the JAX VJP does, under
every policy.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from pigeon_tpu_torch.config import TextConfig, VisionConfig
from pigeon_tpu_torch.kernels.attention import (
    FLASH_ATTENTION_OP,
    FlashAttention,
)
from pigeon_tpu_torch.kernels.eltwise import (
    AddLayerNormBF16,
    LayerNormBF16,
    QuickGeluBF16,
    add_layer_norm_bf16,
    layer_norm_bf16,
    layer_norm_reference,
    quick_gelu,
    quick_gelu_bf16,
    scale_add,
    scale_add_layer_norm_bf16,
    swiglu,
    swiglu_bf16,
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
from pigeon_tpu_torch.kernels.fused_mlp import FUSED_LN_MLP_OP, FusedLNMLP
from pigeon_tpu_torch.kernels.fused_qkv_attention import (
    FUSED_QKV_ATTENTION_OP,
    FusedQKVAttention,
)
from pigeon_tpu_torch.kernels.fused_qkv_attention_int8 import (
    fused_qkv_attention_int8,
)
from pigeon_tpu_torch.kernels.sharded import (
    copy_to_model,
    local_heads,
    reduce_from_model,
    sharded_fused_qkv_attention,
    sharded_fused_qkv_attention_int8,
    vocab_parallel_embedding,
)
from pigeon_tpu_torch.models.quant import (
    QuantLinear,
    QuantPatchEmbed,
    int8_matmul,
    quant_mode,
    quantize_static,
)

ATTN_IMPLS = ("fused", "flash", "plain", "fused_ln", "fused_mlp", "block")
#: ``VisionConfig.hidden_act`` values: CLIP's quick-GELU and HF's ``gelu``,
#: the exact erf form (`pigeon_tpu/models/clip.py:44-49`).
ACTIVATIONS = {"quick_gelu": quick_gelu,
               "gelu": functools.partial(F.gelu, approximate="none")}
#: The routes whose attention is the fused projection + attention.
FUSED_IMPLS = ("fused", "fused_ln", "fused_mlp")
#: The routes whose layers run the residual add + LN2 and quick-GELU as
#: `kernels/eltwise.py`'s kernels (LN1 too, where no kernel folds it in:
#: not on ``"fused_ln"``), and whose tower runs its pre-LN as one.
ELTWISE_IMPLS = ("fused", "flash", "fused_ln")
REMATS = ("none", "full", "attn_out", "attn_kernel", "attn_slim")
QUANTS = (False, "dynamic", "static")

#: The ``checkpoint_name`` of the tensors computed inside
#: `saved_by_remat` (the JAX package's tag), or None.
_SAVING = contextvars.ContextVar("pigeon_remat_saving", default=None)


@contextlib.contextmanager
def saved_by_remat(name: str):
    """Tag the operations run inside with the checkpoint name ``name``."""
    token = _SAVING.set(name)
    try:
        yield
    finally:
        _SAVING.reset(token)


#: The checkpoint name of each kernel forward's output.
_SAVED_OPS = {FUSED_QKV_ATTENTION_OP: "attn_kernel_out",
              FLASH_ATTENTION_OP: "attn_kernel_out",
              FUSED_LN_QKV_ATTENTION_OP: "attn_kernel_out",
              FUSED_BLOCK_ATTENTION_OP: "attn_out",
              FUSED_LN_MLP_OP: "mlp_out"}


def remat_saved_names(remat: str, attn_impl: str) -> tuple:
    """The checkpoint names policy ``remat`` keeps on route ``attn_impl``
    (`pigeon_tpu/models/clip.py::_remat_policy_names`, plus ``mlp_out``;
    the module docstring)."""
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}, not in {REMATS}")
    if remat == "none":
        return ()
    names = {"full": (), "attn_out": ("attn_out",),
             "attn_kernel": ("attn_out", "attn_kernel_out"),
             "attn_slim": ("attn_kernel_out",)}[remat]
    if attn_impl == "block" and names:
        names = ("attn_out",)
    return (*names, "mlp_out")


def _remat_policy(names, ctx, func, *args, **kwargs):
    """Keep what is tagged with one of ``names``, by `_SAVED_OPS` or
    `saved_by_remat`; recompute everything else. A view is always
    recomputed: a kept view holds its base's storage, and ``out_proj``'s
    reshape of the kernel output would keep that output alive under
    ``attn_out``, which recomputes it."""
    if not getattr(func, "is_view", False) \
            and _SAVED_OPS.get(func, _SAVING.get()) in names:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dense(layer: nn.Linear, x):
    """``layer`` applied in ``x.dtype`` (f32 parameters cast at use)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def layer_norm(layer: nn.LayerNorm, x):
    """LayerNorm with f32 statistics, rounded back to ``x.dtype``."""
    return layer_norm_reference(x, layer.weight, layer.bias, layer.eps)


def layer_norm_op(layer: nn.LayerNorm, x):
    """``layer`` on a float layer's `TransformerLayer.fast` path or a
    tower's pre-LN: `kernels/eltwise.py`'s `layer_norm_bf16`, its autograd
    version `LayerNormBF16` with grad mode on."""
    if torch.is_grad_enabled():
        return LayerNormBF16.apply(x.contiguous(), layer.weight, layer.bias,
                                   layer.eps)
    return layer_norm_bf16(x.contiguous(), layer.weight, layer.bias,
                           layer.eps)


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


def row_parallel(layer: nn.Module, x, axis):
    """``layer`` on the rank's input columns ``x`` (Megatron's
    row-parallel product, the JAX rules' out_proj and fc2 split by input
    rows): the partial products all-reduced over the ``model`` axis, then
    the bias once. An int8 layer all-reduces its int32 sums, which stay
    exact, so its output is the one-card output bit for bit; it needs
    static scales (the calibration forward runs before sharding)."""
    if axis is None:
        return linear(layer, x)
    if isinstance(layer, QuantLinear):
        if layer.mode != "static":
            raise ValueError("a row-parallel int8 layer needs frozen "
                             "activation scales: calibrate before sharding")
        acc = reduce_from_model(int8_matmul(
            quantize_static(x, layer.act_scale), layer.weight), axis)
        y = acc.float() * (layer.act_scale * layer.scale) + layer.bias
        return y.to(x.dtype)
    y = reduce_from_model(F.linear(x, layer.weight.to(x.dtype)), axis)
    return y + layer.bias.to(x.dtype)


def plain_attention(q, k, v, mask=None):
    """``(B, S, H, dh)`` q/k/v -> ``(B, S, H, dh)``: products in the
    input dtype, softmax in f32 (`pigeon_tpu.models.clip.xla_attention`).
    ``mask`` is additive, ``(1|B, 1, S, S)`` f32; the logits promote to
    f32 where it is added, as in JAX."""
    scale = q.shape[-1] ** -0.5
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    logits = (q @ k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return (probs @ v).transpose(1, 2)


class PatchEmbed(nn.Module):
    """Patch embedding as space-to-depth + one matmul.

    ``weight`` is ``(D, P*P*C)`` with the input features flattened in
    ``(p, p, c)`` order (`pigeon_tpu/models/clip.py:93-95`), so a JAX
    ``(P, P, C, D)`` kernel maps to ``kernel.reshape(-1, D).T``. CLIP's
    has no bias; ``bias=True`` adds one (the ViT embedder's).
    """

    def __init__(self, features: int, patch_size: int, channels: int = 3,
                 bias: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(
            torch.empty(features, patch_size * patch_size * channels))
        self.bias = nn.Parameter(torch.empty(features)) if bias else None

    def forward(self, x):
        """``(B, H, W, C)`` -> ``(B, N_patches, D)`` in ``x.dtype``."""
        p = self.patch_size
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 attn_impl: str = "fused", quant=False):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}, not in {ATTN_IMPLS}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        #: The `kernels.sharded.ModelAxis` whose ranks hold this layer's
        #: heads (`train.mesh.tensor_parallel`), or None: all heads here.
        self.tp = None
        self.q_proj = make_linear(hidden_size, hidden_size, quant)
        self.k_proj = make_linear(hidden_size, hidden_size, quant)
        self.v_proj = make_linear(hidden_size, hidden_size, quant)
        self.out_proj = make_linear(hidden_size, hidden_size, quant)

    def forward(self, x, ln: nn.LayerNorm = None, mask=None):
        """``x`` (B, S, D) -> (B, S, D) after ``out_proj``. With ``ln``
        (the JAX package's ``ln=``, only on a fused route in float), ``x``
        is the layer's raw input and LN runs inside kernel K5. A
        ``"block"`` layer comes here only in a dynamic int8 tower, or
        with a ``mask``, and projects separately (`block` is its route
        otherwise). With a ``mask`` every route projects separately and
        attends by `plain_attention`.

        Under tensor parallelism (``self.tp``) the layer holds its
        rank's heads: column shards of q/k/v (K1, K3 and K8 on the local
        heads, `kernels/sharded.py`) and the rank's input rows of
        ``out_proj``, whose partial sums are all-reduced."""
        b, s, d = x.shape
        projs = (self.q_proj, self.k_proj, self.v_proj)
        quant = quant_mode(self.q_proj)
        fused = self.attn_impl in FUSED_IMPLS and mask is None
        tp = self.tp
        if ln is not None and (quant or not fused or tp is not None):
            raise ValueError(f"LN folds into the attention only on a fused "
                             f"float route on one rank's heads, not "
                             f"{self.attn_impl!r} (quant={quant!r})")
        heads = local_heads(self.num_heads, tp)
        if fused and quant == "static":
            # q/k/v see the same input, so calibration freezes the same
            # scale for each; the kernel quantizes x once at their max.
            act_scale = torch.maximum(
                torch.maximum(self.q_proj.act_scale, self.k_proj.act_scale),
                self.v_proj.act_scale)
            args = (x.contiguous(), act_scale,
                    *(t for p in projs for t in (p.weight, p.scale, p.bias)))
            out = (fused_qkv_attention_int8(*args, self.num_heads)
                   if tp is None else sharded_fused_qkv_attention_int8(
                       *args, self.num_heads, tp))
        elif fused and not quant:
            weights = [p.weight.to(x.dtype) for p in projs]
            biases = [p.bias.to(x.dtype) for p in projs]
            if tp is not None:
                out = sharded_fused_qkv_attention(x, *weights, *biases,
                                                  self.num_heads, tp)
            elif ln is None:
                out = FusedQKVAttention.apply(x.contiguous(), *weights,
                                              *biases, self.num_heads)
            else:
                out = FusedLNQKVAttention.apply(
                    x.contiguous(), ln.weight, ln.bias, *weights, *biases,
                    self.num_heads, ln.eps)
        else:
            if tp is not None:
                x = copy_to_model(x, tp)
            shape = (b, s, heads, d // self.num_heads)
            qkv = [linear(p, x).view(shape) for p in projs]
            if mask is not None:
                out = plain_attention(*qkv, mask)
            elif self.attn_impl == "plain":
                out = plain_attention(*qkv)
            else:
                out = FlashAttention.apply(*qkv)
            out = out.reshape(b, s, heads * shape[-1])
        with saved_by_remat("attn_out"):
            return row_parallel(self.out_proj, out, tp)

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
    """Pre-LN block: ``x += attn(LN1(x)); x += fc2(act(fc1(LN2(x))))``,
    on the route of ``self.attn.attn_impl`` (the module docstring); ``act``
    is ``config.hidden_act``, one of `ACTIVATIONS`. ``config`` is a
    `VisionConfig` or a `TextConfig`: the layer reads the fields both
    have (``hidden_size``, ``num_heads``, ``intermediate_size``,
    ``layer_norm_eps``, ``hidden_act``).

    ``swiglu`` makes the MLP ``w_out(silu(u1) * u2)``, ``[u1 | u2] =
    w_in(LN2(x))`` with ``2 * intermediate_size`` outputs (``hidden_act``
    not read); ``layer_scale`` scales each residual branch by a
    per-channel ``gamma1``, ``gamma2``."""

    def __init__(self, config, attn_impl: str = "fused", quant=False,
                 swiglu: bool = False, layer_scale: bool = False):
        super().__init__()
        if not swiglu and config.hidden_act not in ACTIVATIONS:
            raise ValueError(f"hidden_act={config.hidden_act!r}, not in "
                             f"{sorted(ACTIVATIONS)}")
        if (swiglu or layer_scale) and quant:
            raise ValueError("a SwiGLU or LayerScale layer has no int8 twin")
        self.hidden_act = config.hidden_act
        self.swiglu = swiglu
        d, inter = config.hidden_size, config.intermediate_size
        self.ln1 = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.attn = MultiHeadAttention(d, config.num_heads, attn_impl, quant)
        self.ln2 = nn.LayerNorm(d, eps=config.layer_norm_eps)
        if swiglu:
            self.w_in = nn.Linear(d, 2 * inter)
            self.w_out = nn.Linear(inter, d)
        else:
            self.fc1 = make_linear(d, inter, quant)
            self.fc2 = make_linear(inter, d, quant)
        self.gamma1 = nn.Parameter(torch.empty(d)) if layer_scale else None
        self.gamma2 = nn.Parameter(torch.empty(d)) if layer_scale else None
        #: The `kernels.sharded.ModelAxis` whose ranks hold this layer's
        #: MLP columns (fc1's output, fc2's input), or None.
        self.tp = None

    @property
    def scaled(self) -> bool:
        """Whether the layer is DINOv2's: SwiGLU or LayerScale."""
        return self.swiglu or self.gamma1 is not None

    def mlp_branch(self, h, fast: bool = False):
        """The MLP of ``h = LN2(x)``: ``w_out(silu(u1) * u2)`` for a SwiGLU
        layer, else ``fc2(act(fc1(h)))`` on the rank's MLP columns under
        tensor parallelism. ``fast`` takes the one-pass SwiGLU or
        quick-GELU of `kernels/eltwise.py` (quick-GELU's autograd version
        with grad mode on)."""
        if self.swiglu:
            gate = swiglu_bf16 if fast else swiglu
            return dense(self.w_out, gate(dense(self.w_in, h)))
        if self.tp is not None:
            h = copy_to_model(h, self.tp)
        act = ACTIVATIONS[self.hidden_act]
        if fast and self.hidden_act == "quick_gelu":
            act = (QuickGeluBF16.apply if torch.is_grad_enabled()
                   else quick_gelu_bf16)
        h = act(linear(self.fc1, h))
        return row_parallel(self.fc2, h, self.tp)

    def fast(self, x, mask=None) -> bool:
        """Whether a float layer's call runs its element-wise chain through
        `kernels/eltwise.py`: a bf16 ``x``, no ``mask``, on ``"fused"``,
        ``"flash"`` or ``"fused_ln"``; with grad mode on, a CLIP layer
        only (a SwiGLU or LayerScale one has no backward kernels)."""
        return (self.attn.attn_impl in ELTWISE_IMPLS and mask is None
                and x.dtype == torch.bfloat16
                and not (self.scaled and torch.is_grad_enabled()))

    def _residual(self, x, a, gamma):
        return x + a if gamma is None else scale_add(x, a, gamma)

    def _residual_ln(self, x, a, gamma, ln: nn.LayerNorm):
        """``(s, LN(s))`` of ``s = x + gamma * a`` (``x + a`` where
        ``gamma`` is None) in one kernel launch (the plain version on a
        CPU ``x``), the autograd version with grad mode on."""
        args = (x.contiguous(), a.contiguous())
        if gamma is not None:
            return scale_add_layer_norm_bf16(*args, gamma, ln.weight,
                                             ln.bias, ln.eps)
        if torch.is_grad_enabled():
            return AddLayerNormBF16.apply(*args, ln.weight, ln.bias, ln.eps)
        return add_layer_norm_bf16(*args, ln.weight, ln.bias, ln.eps)

    def forward(self, x, mask=None, h=None, next_ln: nn.LayerNorm = None):
        """One layer. A float layer's forward of a bf16 ``x`` on
        ``"fused"``, ``"flash"`` or ``"fused_ln"`` with no ``mask``
        (`fast`) runs LN1 (where no kernel folds it in), the residual with
        LN2, and the activation (quick-GELU or SwiGLU) through
        `kernels/eltwise.py`: the one-pass kernels for a CUDA ``x``, their
        plain versions (the eager chain) for a CPU one. With grad mode on
        these are the autograd versions (`layer_norm_op`), for a CLIP
        layer only; a ``gelu`` layer keeps its activation either way. The
        second residual stays one eager add (scale-add), and the int8
        layers, the DINOv2 layers under grad mode and the other routes
        keep the eager chain.

        For `TransformerStack.forward_ln`, on the `fast` path only:
        ``h``, where given, is LN1(x), computed by the caller, and with
        ``next_ln`` the second residual runs in one kernel with
        ``next_ln`` and the layer returns ``(x, next_ln(x))``. A SwiGLU
        or LayerScale layer refuses route ``"block"``, whose K6 adds the
        residual unscaled and whose K9 runs quick-GELU."""
        quant = False if self.swiglu else quant_mode(self.fc1)
        # An int8 layer quantizes LN1's and LN2's outputs: Flax's form.
        norm = flax_layer_norm if quant else layer_norm
        route = self.attn.attn_impl
        if route == "block" and self.scaled:
            raise ValueError("route 'block' adds the attention residual "
                             "unscaled (K6) and runs quick-GELU MLPs (K9): "
                             "a SwiGLU or LayerScale layer takes the others")
        if mask is not None:                    # plain on every route
            x = self._residual(x, self.attn(norm(self.ln1, x), mask=mask),
                               self.gamma1)
            return self._residual(x, self.mlp_branch(norm(self.ln2, x)),
                                  self.gamma2)
        fast = not quant and self.fast(x)
        if route == "block" and quant != "dynamic":
            x = self.attn.block(x, self.ln1)    # K6 / K7: residual included
        else:
            if h is not None:
                a = self.attn(h)
            elif route in ("fused_ln", "fused_mlp") and not quant:
                a = self.attn(x, ln=self.ln1)
            elif fast:
                a = self.attn(layer_norm_op(self.ln1, x))
            else:
                a = self.attn(norm(self.ln1, x))
            if fast:
                x, h = self._residual_ln(x, a, self.gamma1, self.ln2)
                m = self.mlp_branch(h, fast=True)
                if next_ln is not None:
                    return self._residual_ln(x, m, self.gamma2, next_ln)
                return self._residual(x, m, self.gamma2)
            x = self._residual(x, a, self.gamma1)
        if (route in ("fused_mlp", "block") and not quant and not self.scaled
                and self.hidden_act == "quick_gelu"):
            return FusedLNMLP.apply(
                x.contiguous(), self.ln2.weight, self.ln2.bias,
                *(t.to(x.dtype) for fc in (self.fc1, self.fc2)
                  for t in (fc.weight, fc.bias)), self.ln2.eps)
        return self._residual(x, self.mlp_branch(norm(self.ln2, x)),
                              self.gamma2)


class TransformerStack(nn.Module):
    """``config.num_layers`` `TransformerLayer`s, remat'd layer by layer
    under ``remat`` while gradients are on; ``swiglu`` and ``layer_scale``
    go to each layer."""

    def __init__(self, config, attn_impl: str = "fused",
                 remat: str = "none", quant=False, swiglu: bool = False,
                 layer_scale: bool = False):
        super().__init__()
        if remat not in REMATS:
            raise ValueError(f"remat={remat!r}, not in {REMATS}")
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerLayer(config, attn_impl, quant, swiglu, layer_scale)
            for _ in range(config.num_layers))

    def apply_layer(self, layer: "TransformerLayer", x, mask=None):
        """One layer's forward, remat'd under ``remat`` while gradients
        are on (the pipeline's stages run their layers through it)."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return layer(x, mask)
        names = remat_saved_names(self.remat, layer.attn.attn_impl)
        return checkpoint(layer, x, mask, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              functools.partial(_remat_policy, names)))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = self.apply_layer(layer, x, mask)
        return x

    def forward_ln(self, x, ln: nn.LayerNorm):
        """``ln(self(x))``. Where every layer is a SwiGLU or LayerScale one
        on its `fast` path, on ``"fused"`` or ``"flash"``, each layer's MLP
        residual runs in one kernel with the next layer's LN1, and the
        last layer's with ``ln``: one `layer_norm_bf16` and two
        `scale_add_layer_norm_bf16` a layer."""
        layers = list(self.layers)
        if not all(layer.scaled and layer.fast(x)
                   and layer.attn.attn_impl in ("fused", "flash")
                   for layer in layers) or not layers:
            return layer_norm(ln, self(x))
        first = layers[0].ln1
        h = layer_norm_bf16(x.contiguous(), first.weight, first.bias,
                            first.eps)
        for layer, nxt in zip(layers, [m.ln1 for m in layers[1:]] + [ln]):
            x, h = layer(x, h=h, next_ln=nxt)
        return h


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

    def embed(self, pixel_values):
        """The encoder's input: patches, the CLS token and positions,
        then the pre-LN (`train/pipeline.py` runs it before the stages):
        on a float tower's `ELTWISE_IMPLS` route with a bf16 activation,
        `layer_norm_op`."""
        patches = self.patch_embed(pixel_values.to(self.dtype))
        b, _, d = patches.shape
        cls = self.cls_token.to(self.dtype).expand(b, 1, d)
        x = torch.cat([cls, patches], dim=1) + self.pos_embed.to(self.dtype)
        if (self.attn_impl in ELTWISE_IMPLS and x.dtype == torch.bfloat16
                and not isinstance(self.patch_embed, QuantPatchEmbed)):
            return layer_norm_op(self.pre_ln, x)
        return layer_norm(self.pre_ln, x)

    def forward(self, pixel_values):
        """pixel_values: ``(B, H, W, 3)`` CLIP-normalised, NHWC."""
        x = self.encoder(self.embed(pixel_values))
        return x, layer_norm(self.post_ln, x[:, 0])


def causal_mask(s: int, device=None) -> torch.Tensor:
    """The additive causal mask ``(1, 1, S, S)`` in f32: -1e9 above the
    diagonal (finite, so a bf16 sum stays finite), 0 elsewhere."""
    return torch.triu(torch.full((s, s), -1e9, dtype=torch.float32,
                                 device=device), diagonal=1)[None, None]


class CLIPTextTower(nn.Module):
    """CLIP text encoder: ``(B, S)`` token ids (S <= 77) ->
    ``(last_hidden (B, S, D), pooled (B, D))`` in the compute dtype, with a
    causal mask, the final LN and pooling at the FIRST ``eos_token_id``
    of each row (position 0 where a row has none), as HF's
    `CLIPTextTransformer` after #24773 (`pigeon_tpu/models/clip.py:578-624`)."""

    def __init__(self, config: TextConfig, dtype=torch.float32,
                 eos_token_id: int = 49407, attn_impl: str = "fused"):
        super().__init__()
        d = config.hidden_size
        self.config = config
        self.dtype = dtype
        self.eos_token_id = eos_token_id
        self.token_embed = nn.Embedding(config.vocab_size, d)
        #: The `kernels.sharded.ModelAxis` whose ranks hold the
        #: vocabulary rows of ``token_embed``, or None.
        self.tp = None
        self.pos_embed = nn.Parameter(
            torch.empty(config.max_position_embeddings, d))
        self.encoder = TransformerStack(config, attn_impl)
        self.final_ln = nn.LayerNorm(d, eps=config.layer_norm_eps)

    def forward(self, input_ids):
        s = input_ids.shape[-1]
        tokens = (self.token_embed(input_ids) if self.tp is None else
                  vocab_parallel_embedding(input_ids,
                                           self.token_embed.weight, self.tp))
        x = tokens.to(self.dtype) + self.pos_embed[:s].to(self.dtype)
        x = self.encoder(x, causal_mask(s, input_ids.device))
        x = layer_norm(self.final_ln, x)
        eos = (input_ids == self.eos_token_id).to(torch.int32).argmax(-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        return x, pooled


def clip_contrastive_loss(image_embeds, text_embeds, logit_scale):
    """Symmetric InfoNCE over L2-normalised projections: the mean of the
    text-to-image and image-to-text cross entropies with the diagonal as
    labels (`pigeon_tpu/models/clip.py:627-642`, HF `CLIPModel`
    ``return_loss=True``)."""
    logits = logit_scale * text_embeds @ image_embeds.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2.0


#: The logit scale's initial parameter, log(1 / 0.07).
LOGIT_SCALE_INIT = math.log(1.0 / 0.07)


class CLIPModel(nn.Module):
    """Contrastive CLIP: both towers, bias-free projections in the compute
    dtype, f32 L2 normalisation, and ``logit_scale = exp(param)``
    (`pigeon_tpu/models/clip.py:645-693`). The vision tower takes
    ``attn_impl`` and ``remat``; the text tower takes the route too, and
    its causal mask sends it down the plain path."""

    def __init__(self, vision_config: VisionConfig, text_config: TextConfig,
                 dtype=torch.float32, eos_token_id: int = 49407,
                 attn_impl: str = "fused", remat: str = "none",
                 logit_scale_init: float = LOGIT_SCALE_INIT):
        super().__init__()
        self.vision_config = vision_config
        self.text_config = text_config
        self.dtype = dtype
        self.vision = CLIPVisionTower(vision_config, dtype=dtype,
                                      attn_impl=attn_impl, remat=remat)
        self.text = CLIPTextTower(text_config, dtype=dtype,
                                  eos_token_id=eos_token_id,
                                  attn_impl=attn_impl)
        self.visual_projection = nn.Linear(
            vision_config.hidden_size, vision_config.projection_dim,
            bias=False)
        self.text_projection = nn.Linear(
            text_config.hidden_size, text_config.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(float(logit_scale_init)))

    @property
    def eos_token_id(self) -> int:
        return self.text.eos_token_id

    def forward(self, pixel_values, input_ids, return_loss: bool = False):
        """``(B, H, W, 3)`` CLIP-normalised pixels and ``(B, S)`` ids ->
        ``image_embeds``, ``text_embeds`` (f32, unit rows),
        ``logit_scale``, ``logits_per_image`` and, with ``return_loss``,
        ``loss``."""
        _, vision_pooled = self.vision(pixel_values)
        _, text_pooled = self.text(input_ids)
        image = F.linear(vision_pooled,
                         self.visual_projection.weight.to(self.dtype))
        text = F.linear(text_pooled,
                        self.text_projection.weight.to(self.dtype))
        image = image / torch.linalg.vector_norm(
            image.float(), dim=-1, keepdim=True)
        text = text / torch.linalg.vector_norm(
            text.float(), dim=-1, keepdim=True)
        logit_scale = self.logit_scale.exp()
        out = {"image_embeds": image, "text_embeds": text,
               "logit_scale": logit_scale,
               "logits_per_image": logit_scale * image @ text.T}
        if return_loss:
            out["loss"] = clip_contrastive_loss(image, text, logit_scale)
        return out


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
