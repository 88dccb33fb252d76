"""Weights carried across: a JAX `SuperGuessr` parameter tree -> a state
dict that `pigeon_tpu_torch.models.super_guessr.SuperGuessr` loads with
``strict=True``; likewise a `ClipEmbedder`'s (`state_dict_from_jax`), a
head-only `GeocellHead`'s (`head_state_dict_from_jax`), a
`ViTEmbedder`'s (`vit_state_dict_from_jax`) and a contrastive
`CLIPModel`'s (`clip_state_dict_from_jax`: both towers, the two bias-free
projections and ``logit_scale``).

The input is the Flax tree as nested dicts of numpy arrays (what
``jax.device_get(params)`` gives); this module imports no JAX. The
conversions:

* the encoder's ``nn.scan`` layer axis L is unstacked into the
  ``ModuleList``;
* Dense kernels ``(in, out)`` become ``nn.Linear`` weights ``(out, in)``,
  so each attention head's 64 rows are contiguous, which is the layout
  kernel K1 streams;
* the patch kernel ``(P, P, C, D)`` is flattened in ``(p, p, c)`` order to
  ``(D, P*P*C)``;
* LayerNorm ``scale`` becomes ``weight``;
* the text tower's ``token_embed/embedding`` ``(V, D)`` is the
  ``nn.Embedding`` weight as it is;
* a hierarchical head's ``view_attention`` (Flax ``DenseGeneral``
  kernels ``(F, H, dh)`` for query, key and value, ``(H, dh, F)`` for
  out) becomes four ``nn.Linear`` layers over the flattened ``H * dh``
  axis, their biases flattened alike.

A quantized tree (`pigeon_tpu.models.quant.quantize_and_calibrate`) goes
into a model built with ``quant`` (`models/quant.py`): its int8 kernels
stay int8 (every other leaf becomes f32), transposed and flattened as
above; the patch kernel is padded with zero columns to the width
`QuantPatchEmbed` takes; each layer's ``scale`` and ``bias`` are carried
as they are, the stacked ``act_scale (L,)`` is split per layer, and the
patch embed has a ``scale`` and ``act_scale`` but no bias.

Every leaf of the input must be consumed, or the bridge raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from pigeon_tpu_torch.models.quant import padded_features

_LAYER = "vision/encoder/layers"
_LAYER_DENSE = ("attn/q_proj", "attn/k_proj", "attn/v_proj",
                "attn/out_proj", "fc1", "fc2")
_LAYER_NORMS = ("ln1", "ln2")
_HEAD_DENSE = ("cell_layer", "multi_task_head", "climate_layer",
               "month_layer")
#: Flax ``MultiHeadDotProductAttention``'s projections.
_VIEW_ATTENTION = ("query", "key", "value", "out")
#: Leaves a quantized dense or patch embed carries beside its kernel.
_QUANT_LEAVES = ("scale", "act_scale")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


class _Leaves:
    """The leaves of a JAX tree by path, each taken once, and the torch
    state dict made of them."""

    def __init__(self, params: Mapping):
        self.leaves = _flatten(params)
        self.out: Dict[str, torch.Tensor] = {}

    def take(self, path: str) -> np.ndarray:
        if path not in self.leaves:
            raise KeyError(f"JAX params have no leaf {path!r}")
        return self.leaves.pop(path)

    def put(self, name: str, array: np.ndarray) -> None:
        dtype = np.int8 if array.dtype == np.int8 else np.float32
        # ascontiguousarray makes a 0-d leaf (logit_scale) 1-d: reshape.
        self.out[name] = torch.tensor(np.ascontiguousarray(
            array, dtype).reshape(np.shape(array)))

    def group(self, path: str, required: tuple) -> Dict[str, np.ndarray]:
        """The leaves of one (maybe quantized) layer at ``path``."""
        quant = tuple(q for q in _QUANT_LEAVES
                      if f"{path}/{q}" in self.leaves)
        return {leaf: self.take(f"{path}/{leaf}")
                for leaf in required + quant}

    def dense(self, dst: str, layer: Dict[str, np.ndarray]) -> None:
        for leaf, value in layer.items():
            if leaf == "kernel":
                self.put(f"{dst}.weight", value.T)
            else:
                self.put(f"{dst}.{leaf}", value)

    def norm(self, dst: str, src: str) -> None:
        self.put(f"{dst}.weight", self.take(f"{src}/scale"))
        self.put(f"{dst}.bias", self.take(f"{src}/bias"))

    def patch(self, dst: str, src: str, required: tuple) -> None:
        """The patch kernel ``(P, P, C, D)`` flattened to ``(D, P*P*C)``;
        a quantized one padded with zero columns."""
        patch = self.group(src, required)
        kernel = patch["kernel"]
        weight = kernel.reshape(-1, kernel.shape[-1]).T
        if "scale" in patch:
            k = weight.shape[1]
            weight = np.pad(weight, ((0, 0), (0, padded_features(k) - k)))
        self.dense(dst, {**patch, "kernel": weight.T})

    def encoder(self, dst: str, src: str) -> None:
        """The ``nn.scan`` stack under ``src`` (a leading layer axis L on
        every leaf) unstacked into ``dst.{i}``."""
        stacked = {name: self.group(f"{src}/{name}", ("kernel", "bias"))
                   for name in _LAYER_DENSE}
        norms = {name: (self.take(f"{src}/{name}/scale"),
                        self.take(f"{src}/{name}/bias"))
                 for name in _LAYER_NORMS}
        for i in range(stacked["fc1"]["kernel"].shape[0]):
            for name, layer in stacked.items():
                self.dense(f"{dst}.{i}.{name.replace('/', '.')}",
                           {leaf: v[i] for leaf, v in layer.items()})
            for name, (scale, bias) in norms.items():
                self.put(f"{dst}.{i}.{name}.weight", scale[i])
                self.put(f"{dst}.{i}.{name}.bias", bias[i])

    def head(self, dst: str, src: str) -> None:
        """Whichever geocell-head linears the tree has, and a
        hierarchical head's ``view_attention``."""
        for name in _HEAD_DENSE:
            if f"{src}{name}/kernel" in self.leaves:
                self.dense(f"{dst}{name}",
                           self.group(f"{src}{name}", ("kernel", "bias")))
        if f"{src}view_attention/out/kernel" not in self.leaves:
            return
        for name in _VIEW_ATTENTION:
            path = f"{src}view_attention/{name}"
            kernel, bias = self.take(f"{path}/kernel"), self.take(f"{path}/bias")
            features = kernel.shape[-1] if name == "out" else kernel.shape[0]
            kernel = (kernel.reshape(-1, features) if name == "out"
                      else kernel.reshape(features, -1))
            self.dense(f"{dst}view_attention.{name}",
                       {"kernel": kernel, "bias": bias.reshape(-1)})

    def done(self) -> Dict[str, torch.Tensor]:
        if self.leaves:
            raise ValueError(f"JAX params not consumed: {sorted(self.leaves)}")
        return self.out


def _vision_tower(t: _Leaves) -> None:
    """The CLIP vision tower under ``vision/`` into ``vision.*``."""
    t.patch("vision.patch_embed", "vision/patch_embed", ("kernel",))
    t.put("vision.cls_token", t.take("vision/cls_token"))
    t.put("vision.pos_embed", t.take("vision/pos_embed"))
    for name in ("pre_ln", "post_ln"):
        t.norm(f"vision.{name}", f"vision/{name}")
    t.encoder("vision.encoder.layers", _LAYER)


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `SuperGuessr` params ``{"vision": ..., "head": ...}`` -> a
    torch state dict (f32, or int8 for quantized kernels; contiguous). A
    tree without ``head`` is a `ClipEmbedder`'s."""
    t = _Leaves(params)
    _vision_tower(t)
    t.head("head.", "head/")
    return t.done()


def clip_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `CLIPModel` params (``vision``, ``text``,
    ``visual_projection``, ``text_projection``, ``logit_scale``) -> the
    state dict of the port's `models.clip.CLIPModel`."""
    t = _Leaves(params)
    _vision_tower(t)
    t.put("text.token_embed.weight", t.take("text/token_embed/embedding"))
    t.put("text.pos_embed", t.take("text/pos_embed"))
    t.encoder("text.encoder.layers", "text/encoder/layers")
    t.norm("text.final_ln", "text/final_ln")
    for name in ("visual_projection", "text_projection"):
        t.put(f"{name}.weight", t.take(f"{name}/kernel").T)
    t.put("logit_scale", t.take("logit_scale"))
    return t.done()


def head_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `GeocellHead` params (the head-only model of ``finetune
    --embeddings``: ``cell_layer`` and, with multi-task, the other
    linears at the top of the tree) -> the state dict of the port's
    `GeocellHead`."""
    t = _Leaves(params)
    t.head("", "")
    return t.done()


def vit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `ViTEmbedder` params -> the state dict of the port's
    `models.vit_embedder.ViTEmbedder`: the biased patch embed, CLS token,
    positions, encoder and ``final_ln``."""
    t = _Leaves(params)
    t.patch("patch_embed", "patch_embed", ("kernel", "bias"))
    t.put("cls_token", t.take("cls_token"))
    t.put("pos_embed", t.take("pos_embed"))
    t.encoder("encoder.layers", "encoder/layers")
    t.norm("final_ln", "final_ln")
    return t.done()
