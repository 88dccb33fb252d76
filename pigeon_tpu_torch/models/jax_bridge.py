"""Weights carried across: a JAX `SuperGuessr` parameter tree -> a state
dict that `pigeon_tpu_torch.models.super_guessr.SuperGuessr` loads with
``strict=True``.

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
* LayerNorm ``scale`` becomes ``weight``.

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

_LAYER = "vision/encoder/layers/"
_LAYER_DENSE = ("attn/q_proj", "attn/k_proj", "attn/v_proj",
                "attn/out_proj", "fc1", "fc2")
_LAYER_NORMS = ("ln1", "ln2")
_HEAD_DENSE = ("cell_layer", "multi_task_head", "climate_layer",
               "month_layer")
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


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `SuperGuessr` params ``{"vision": ..., "head": ...}`` -> a
    torch state dict (f32, or int8 for quantized kernels; contiguous)."""
    leaves = _flatten(params)
    out: Dict[str, torch.Tensor] = {}

    def take(path: str) -> np.ndarray:
        if path not in leaves:
            raise KeyError(f"JAX params have no leaf {path!r}")
        return leaves.pop(path)

    def put(name: str, array: np.ndarray) -> None:
        dtype = np.int8 if array.dtype == np.int8 else np.float32
        out[name] = torch.tensor(np.ascontiguousarray(array, dtype))

    def group(path: str, required: tuple) -> Dict[str, np.ndarray]:
        """The leaves of one (maybe quantized) layer at ``path``."""
        quant = tuple(q for q in _QUANT_LEAVES if f"{path}/{q}" in leaves)
        return {leaf: take(f"{path}/{leaf}") for leaf in required + quant}

    def dense(dst: str, layer: Dict[str, np.ndarray]) -> None:
        for leaf, value in layer.items():
            if leaf == "kernel":
                put(f"{dst}.weight", value.T)
            else:
                put(f"{dst}.{leaf}", value)

    def norm(dst: str, scale: np.ndarray, bias: np.ndarray) -> None:
        put(f"{dst}.weight", scale)
        put(f"{dst}.bias", bias)

    patch = group("vision/patch_embed", ("kernel",))
    kernel = patch["kernel"]                                # (P, P, C, D)
    weight = kernel.reshape(-1, kernel.shape[-1]).T         # (D, P*P*C)
    if "scale" in patch:                        # quantized: pad the columns
        k = weight.shape[1]
        weight = np.pad(weight, ((0, 0), (0, padded_features(k) - k)))
    dense("vision.patch_embed", {**patch, "kernel": weight.T})
    put("vision.cls_token", take("vision/cls_token"))
    put("vision.pos_embed", take("vision/pos_embed"))
    for name in ("pre_ln", "post_ln"):
        norm(f"vision.{name}", take(f"vision/{name}/scale"),
             take(f"vision/{name}/bias"))

    # The encoder's leaves carry a leading layer axis (nn.scan).
    stacked = {name: group(f"{_LAYER}{name}", ("kernel", "bias"))
               for name in _LAYER_DENSE}
    norms = {name: (take(f"{_LAYER}{name}/scale"),
                    take(f"{_LAYER}{name}/bias"))
             for name in _LAYER_NORMS}
    for i in range(stacked["fc1"]["kernel"].shape[0]):
        dst = f"vision.encoder.layers.{i}"
        for name, layer in stacked.items():
            dense(f"{dst}.{name.replace('/', '.')}",
                  {leaf: v[i] for leaf, v in layer.items()})
        for name, (s, b) in norms.items():
            norm(f"{dst}.{name}", s[i], b[i])

    for name in _HEAD_DENSE:
        if f"head/{name}/kernel" in leaves:
            dense(f"head.{name}", group(f"head/{name}", ("kernel", "bias")))

    if leaves:
        raise ValueError(f"JAX params not consumed: {sorted(leaves)}")
    return out
