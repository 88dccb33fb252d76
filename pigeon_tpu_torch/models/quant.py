"""Int8 (W8A8) inference for the vision tower.

Counterpart of `pigeon_tpu/models/quant.py`, with its scheme:

* weights: symmetric per-output-channel int8, ``scale = amax / 127``
  (1.0 where a channel is all zero), converted from trained float
  weights by :func:`quantize_tower`;
* activations: int8 with a per-token scale taken at run time
  (``"dynamic"``, the calibration forward) or one frozen per-tensor
  ``act_scale`` (``"static"``, serving), frozen by
  :func:`calibrate_act_scales` from one observed batch;
* products accumulate in int32 and are dequantized in f32:
  ``y = f32(x_q @ W^T) * (a_scale * scale) + bias``, rounded to the
  compute dtype.

The int8 products outside the attention kernels (out_proj, fc1, fc2, the
patch embed) are library products, as the JAX package leaves them to XLA:
``torch._int_mm`` on a CUDA tensor, an int32 matmul on the CPU. Both sum
exactly in int32: at fc2 a dot product runs over K = 4096 terms of up to
127^2, ~6.6e7 > 2^24, which an f32 sum would round.

Layouts follow ``torch.nn.Linear``: ``weight`` is int8 ``(out, in)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

MODES = ("dynamic", "static")


def quantize_channelwise(w: torch.Tensor, axis: int = 0):
    """Symmetric per-channel int8 along ``axis`` (the output channel; 0 in
    the ``nn.Linear`` layout). Returns ``(w_q int8, scale f32)`` with
    ``w ≈ w_q * scale`` broadcast on ``axis``; ``scale`` is 1.0 for an
    all-zero channel. Round half to even, as `jnp.round`."""
    w = w.float()
    axis = axis % w.dim()
    dims = [i for i in range(w.dim()) if i != axis]
    amax = w.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale.reshape(w.shape[axis])


def dynamic_quant_tokens(x: torch.Tensor):
    """Per-token (last-dim row) symmetric int8: ``(x_q, scale (..., 1),
    amax (..., 1))``. ``amax`` is the TRUE row max: the zero guard maps an
    all-zero row to scale 1.0, and a scale-derived max would let one such
    row inflate a frozen per-tensor scale to >= 127."""
    x = x.float()
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    x_q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return x_q, scale, amax


def quantize_static(x: torch.Tensor, act_scale: torch.Tensor):
    """``clip(round(f32(x) / act_scale), -127, 127)`` as int8: a true
    division, rounded half to even."""
    return torch.clamp(torch.round(x.float() / act_scale), -127,
                       127).to(torch.int8)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (..., K) int8 @ w (N, K) int8 ^T -> (..., N) int32``, summed
    exactly in int32. CUDA: ``torch._int_mm`` (K and N multiples of 8; a
    batch of 16 rows or fewer is zero-padded to its minimum of 17). CPU:
    an int32 matmul. Under `torch.export` the CUDA form is traced on any
    device (CPU has ``torch._int_mm`` too), so an exported int8 program
    moved to the card keeps an op that runs there (`serve/export.py`)."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a2.device.type == "cuda" or torch.compiler.is_exporting():
        m = a2.shape[0]
        if m <= 16:
            a2 = F.pad(a2, (0, 0, 0, 17 - m))
        out = torch._int_mm(a2, w.t())[:m]
    else:
        out = a2.to(torch.int32) @ w.to(torch.int32).t()
    return out.reshape(*lead, w.shape[0])


class QuantLinear(nn.Module):
    """``nn.Linear`` with an int8 weight and int8 activations
    (`pigeon_tpu.models.quant.QuantDense`).

    Buffers: ``weight`` int8 ``(out, in)``, ``scale`` f32 ``(out,)``,
    ``act_scale`` f32 ``()`` and, with ``bias=True``, ``bias`` f32
    ``(out,)``. ``mode``: ``"dynamic"`` quantizes each input row with its
    own scale and records the batch amax in ``observed_amax`` (the running
    max over calls, for :func:`calibrate_act_scales`); ``"static"``
    quantizes with the frozen ``act_scale``. The output has the input's
    dtype.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, mode: str = "dynamic"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode={mode!r}, not in {MODES}")
        self.in_features = in_features
        self.out_features = out_features
        self.mode = mode
        self.observed_amax: Optional[torch.Tensor] = None
        self.register_buffer(
            "weight", torch.zeros(out_features, in_features,
                                  dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("act_scale", torch.ones(()))
        self.register_buffer("bias", torch.zeros(out_features)
                             if bias else None)

    def forward(self, x):
        if self.mode == "static":
            x_q, a_scale = quantize_static(x, self.act_scale), self.act_scale
        else:
            x_q, a_scale, amax = dynamic_quant_tokens(x)
            amax = amax.max()
            self.observed_amax = (amax if self.observed_amax is None
                                  else torch.maximum(self.observed_amax, amax))
        y = int8_matmul(x_q, self.weight).float() * (a_scale * self.scale)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def padded_features(k: int) -> int:
    """``k`` rounded up to a multiple of 8, the width ``torch._int_mm``
    takes (the ViT-L/14 patch embed's 14*14*3 = 588 becomes 592)."""
    return -(-k // 8) * 8


class QuantPatchEmbed(QuantLinear):
    """`models.clip.PatchEmbed` with an int8 weight
    (`pigeon_tpu.models.quant.QuantPatchEmbed`): space-to-depth, then one
    int8 product, no bias.

    ``weight`` is ``(D, padded_features(P*P*C))``: the features in
    ``(p, p, c)`` order, then zero columns, which the patches get too;
    zero padding leaves every integer product unchanged.
    """

    def __init__(self, features: int, patch_size: int, channels: int = 3,
                 mode: str = "dynamic"):
        self.patch_size = patch_size
        self.patch_features = patch_size * patch_size * channels
        super().__init__(padded_features(self.patch_features), features,
                         bias=False, mode=mode)

    def forward(self, x):
        """``(B, H, W, C)`` -> ``(B, N_patches, D)`` in ``x.dtype``."""
        p = self.patch_size
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), self.patch_features)
        return super().forward(
            F.pad(x, (0, self.in_features - self.patch_features)))


def quant_mode(layer: nn.Module):
    """``"dynamic"`` or ``"static"`` for a quantized layer, else False."""
    return layer.mode if isinstance(layer, QuantLinear) else False


@torch.no_grad()
def quantize_tower(tower: nn.Module, mode: str = "dynamic") -> nn.Module:
    """The float `CLIPVisionTower` ``tower`` as an int8 tower in ``mode``,
    on the same device (`pigeon_tpu.models.quant.quantize_tower_params`):
    each q/k/v/out/fc1/fc2 Linear of every layer and the patch embed
    become a `QuantLinear` with per-output-channel int8 weights and an
    ``act_scale`` of 1.0 until calibration; everything else is copied."""
    from pigeon_tpu_torch.models.clip import CLIPVisionTower

    device = tower.pos_embed.device
    qtower = CLIPVisionTower(tower.config, dtype=tower.dtype,
                             attn_impl=tower.attn_impl, quant=mode).to(device)
    state = dict(tower.state_dict())
    for name, layer in qtower.named_modules():
        if not isinstance(layer, QuantLinear):
            continue
        w_q, scale = quantize_channelwise(state.pop(f"{name}.weight"))
        state[f"{name}.weight"] = F.pad(
            w_q, (0, layer.in_features - w_q.shape[1]))
        state[f"{name}.scale"] = scale
        state[f"{name}.act_scale"] = torch.ones((), device=device)
    qtower.load_state_dict(state, strict=True)
    return qtower


def set_quant_mode(model: nn.Module, mode: str) -> nn.Module:
    """Put every quantized layer of ``model`` in ``mode``."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}, not in {MODES}")
    for layer in model.modules():
        if isinstance(layer, QuantLinear):
            layer.mode = mode
    return model


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, sample_pixels: torch.Tensor,
                         margin: float = 1.0) -> nn.Module:
    """Freeze every quantized layer's ``act_scale`` from one batch and
    switch the model to ``"static"``.

    One dynamic forward over ``sample_pixels`` records each layer's batch
    amax; ``act_scale = amax * margin / 127`` (1.0 where the amax is 0).
    ``margin > 1`` leaves headroom above the observed max, for a small or
    synthetic calibration batch. A layer the forward did not reach keeps
    its scale.
    """
    set_quant_mode(model, "dynamic")
    layers = [m for m in model.modules() if isinstance(m, QuantLinear)]
    for layer in layers:
        layer.observed_amax = None
    model(sample_pixels)
    for layer in layers:
        amax = layer.observed_amax
        if amax is not None:
            layer.act_scale.copy_(torch.where(
                amax == 0, torch.ones_like(amax), amax * margin / 127.0))
        layer.observed_amax = None
    return set_quant_mode(model, "static")


def quantize_and_calibrate(model: nn.Module, calib_pixels: torch.Tensor,
                           tower_key: Optional[str] = None,
                           margin: float = 1.0) -> nn.Module:
    """The whole int8 recipe (`pigeon_tpu.models.quant.
    quantize_and_calibrate`): quantize the tower's weights, calibrate its
    activation scales on ``calib_pixels`` (CLIP-normalised f32) with one
    dynamic forward of ``model``, and return the model, now ``"static"``.
    ``tower_key`` names the tower inside ``model`` (``"vision"`` in a
    `SuperGuessr`); None when ``model`` is the tower itself."""
    if tower_key is None:
        model = quantize_tower(model)
    else:
        setattr(model, tower_key, quantize_tower(getattr(model, tower_key)))
    return calibrate_act_scales(model, calib_pixels, margin=margin)
