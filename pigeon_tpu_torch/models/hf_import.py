"""PyTorch CLIP checkpoints -> the port's parameter names (``--base``).

Counterpart of `pigeon_tpu/models/hf_import.py` (`import_vision_tower_params`,
`import_text_tower_params`, `import_clip_params`,
`import_super_guessr_params`, `merge_params`) and of the JAX CLI's
`_load_base_checkpoint`. These layouts are read:

* an HF `CLIPVisionModel` state dict (``vision_model.*``, or the same
  names without the prefix);
* the reference's SuperGuessr ``.model`` state dict: a ``base_model.*``
  CLIP vision tower and the head linears ``cell_layer``,
  ``multi_task_head``, ``climate_layer`` and ``month_layer``;
* an HF `CLIPTextModel` state dict (``text_model.*``, `text_tower_state`)
  and a full HF `CLIPModel` one (both towers, ``visual_projection``,
  ``text_projection`` and ``logit_scale``, `clip_state`) for
  `models.clip.CLIPModel` (``evaluate --zeroshot -b``).

The port keeps torch's layouts, so the import is a key map. Linears keep
their ``(out, in)`` weights; the patch embed's ``(D, C, P, P)`` conv
weight is flattened in ``(p, p, c)`` order to ``(D, P*P*C)``, the order
`models.clip.PatchEmbed` unfolds patches in. Every tensor becomes f32.
Tensors the layouts do not name (HF's ``position_ids``, projections) are
not read.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping

import torch
from torch import nn

logger = logging.getLogger("pigeon_tpu_torch.models")

#: HF encoder-layer names -> the port's, each with a weight and a bias.
_LAYER_MAP = (("layer_norm1", "ln1"), ("layer_norm2", "ln2"),
              ("self_attn.q_proj", "attn.q_proj"),
              ("self_attn.k_proj", "attn.k_proj"),
              ("self_attn.v_proj", "attn.v_proj"),
              ("self_attn.out_proj", "attn.out_proj"),
              ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2"))
#: The HF patch embed, a (D, C, P, P) conv weight.
_PATCH = "embeddings.patch_embedding.weight"
#: The reference SuperGuessr's head linears (the port's names are theirs).
_HEAD_LINEARS = ("cell_layer", "multi_task_head", "climate_layer",
                 "month_layer")


def _f32(t) -> torch.Tensor:
    """A checkpoint tensor as a contiguous f32 CPU tensor."""
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def _strip_prefix(state: Mapping[str, object], prefix: str) -> Dict:
    """Keep the keys under ``prefix``, stripped; all keys if none has it."""
    if any(k.startswith(prefix) for k in state):
        return {k[len(prefix):]: v for k, v in state.items()
                if k.startswith(prefix)}
    return dict(state)


def _vision_pairs(num_layers: int):
    """(HF name, port name) of every vision-tower tensor but the patch
    embed, the port's names under ``vision.``."""
    yield "embeddings.class_embedding", "cls_token"
    yield "embeddings.position_embedding.weight", "pos_embed"
    for hf, port in (("pre_layrnorm", "pre_ln"),       # HF's spelling
                     ("post_layernorm", "post_ln")):
        for leaf in ("weight", "bias"):
            yield f"{hf}.{leaf}", f"{port}.{leaf}"
    for i in range(num_layers):
        for hf, port in _LAYER_MAP:
            for leaf in ("weight", "bias"):
                yield (f"encoder.layers.{i}.{hf}.{leaf}",
                       f"encoder.layers.{i}.{port}.{leaf}")


def vision_tower_state(state: Mapping[str, object],
                       num_layers: int) -> Dict[str, torch.Tensor]:
    """HF ``vision_model.*`` state dict -> the port's ``vision.*`` names."""
    s = _strip_prefix(state, "vision_model.")
    patch = _f32(s[_PATCH])                                   # (D, C, P, P)
    out = {"vision.patch_embed.weight": patch.permute(0, 2, 3, 1)
           .reshape(patch.shape[0], -1).contiguous()}
    for hf, port in _vision_pairs(num_layers):
        out[f"vision.{port}"] = _f32(s[hf])
    return out


def text_tower_state(state: Mapping[str, object],
                     num_layers: int) -> Dict[str, torch.Tensor]:
    """HF ``text_model.*`` state dict -> the port's ``text.*`` names
    (`pigeon_tpu/models/hf_import.py::import_text_tower_params`)."""
    s = _strip_prefix(state, "text_model.")
    out = {"text.token_embed.weight":
           _f32(s["embeddings.token_embedding.weight"]),
           "text.pos_embed": _f32(s["embeddings.position_embedding.weight"])}
    for leaf in ("weight", "bias"):
        out[f"text.final_ln.{leaf}"] = _f32(s[f"final_layer_norm.{leaf}"])
    for i in range(num_layers):
        for hf, port in _LAYER_MAP:
            for leaf in ("weight", "bias"):
                out[f"text.encoder.layers.{i}.{port}.{leaf}"] = _f32(
                    s[f"encoder.layers.{i}.{hf}.{leaf}"])
    return out


def clip_state(state: Mapping[str, object], vision_layers: int,
               text_layers: int) -> Dict[str, torch.Tensor]:
    """Full HF `CLIPModel` state dict -> the state dict of the port's
    `models.clip.CLIPModel` (`pigeon_tpu/models/hf_import.py::
    import_clip_params`); the projections keep their ``(out, in)``
    weights."""
    out = {**vision_tower_state(state, vision_layers),
           **text_tower_state(state, text_layers)}
    for name in ("visual_projection", "text_projection"):
        out[f"{name}.weight"] = _f32(state[f"{name}.weight"])
    out["logit_scale"] = _f32(state["logit_scale"]).reshape(())
    return out


def clip_hf_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A `models.clip.CLIPModel`'s parameters under HF `CLIPModel`'s
    names, the inverse of `clip_state`: what a full HF CLIP checkpoint of
    it holds."""
    params = {k: v.detach().cpu() for k, v in model.named_parameters()}
    w = params["vision.patch_embed.weight"]                  # (D, P*P*C)
    p = model.vision.patch_embed.patch_size
    out = {"vision_model." + _PATCH: w.reshape(w.shape[0], p, p, -1)
           .permute(0, 3, 1, 2).contiguous(),
           "text_model.embeddings.token_embedding.weight":
               params["text.token_embed.weight"],
           "text_model.embeddings.position_embedding.weight":
               params["text.pos_embed"],
           "logit_scale": params["logit_scale"]}
    for hf, port in _vision_pairs(len(model.vision.encoder.layers)):
        out["vision_model." + hf] = params[f"vision.{port}"]
    for leaf in ("weight", "bias"):
        out[f"text_model.final_layer_norm.{leaf}"] = \
            params[f"text.final_ln.{leaf}"]
    for i in range(len(model.text.encoder.layers)):
        for hf, port in _LAYER_MAP:
            for leaf in ("weight", "bias"):
                out[f"text_model.encoder.layers.{i}.{hf}.{leaf}"] = \
                    params[f"text.encoder.layers.{i}.{port}.{leaf}"]
    for name in ("visual_projection", "text_projection"):
        out[f"{name}.weight"] = params[f"{name}.weight"]
    return out


def super_guessr_state(state: Mapping[str, object],
                       num_layers: int) -> Dict[str, torch.Tensor]:
    """Reference SuperGuessr state dict -> the port's names: the vision
    tower (``base_model.*`` or ``vision_model.*``) and whichever head
    linears the file has."""
    vision = {k[len("base_model."):] if k.startswith("base_model.") else k: v
              for k, v in state.items()
              if k.startswith(("base_model.", "vision_model."))}
    out = vision_tower_state(vision, num_layers) if vision else {}
    for name in _HEAD_LINEARS:
        if f"{name}.weight" in state:
            out[f"head.{name}.weight"] = _f32(state[f"{name}.weight"])
            out[f"head.{name}.bias"] = _f32(state[f"{name}.bias"])
    return out


def import_state(state: Mapping[str, object],
                 num_layers: int) -> Dict[str, torch.Tensor]:
    """Either layout, told apart as the JAX CLI does: a ``cell_layer.*``
    or ``base_model.*`` key means a SuperGuessr checkpoint."""
    if any(k.startswith(("cell_layer.", "base_model.")) for k in state):
        return super_guessr_state(state, num_layers)
    return vision_tower_state(state, num_layers)


def reference_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s parameters under the reference SuperGuessr's names
    (``base_model.vision_model.*`` and the head linears), the inverse of
    `super_guessr_state`: what a reference checkpoint of it holds."""
    params = {k: v.detach().cpu() for k, v in model.named_parameters()}
    tower = "base_model.vision_model."
    w = params["vision.patch_embed.weight"]                  # (D, P*P*C)
    p = model.vision.patch_embed.patch_size
    out = {tower + _PATCH: w.reshape(w.shape[0], p, p, -1)
           .permute(0, 3, 1, 2).contiguous()}
    for hf, port in _vision_pairs(len(model.vision.encoder.layers)):
        out[tower + hf] = params[f"vision.{port}"]
    for name in _HEAD_LINEARS:
        for leaf in ("weight", "bias"):
            if f"head.{name}.{leaf}" in params:
                out[f"{name}.{leaf}"] = params[f"head.{name}.{leaf}"]
    return out


@torch.no_grad()
def merge_state(model: nn.Module, loaded: Mapping[str, torch.Tensor]
                ) -> list:
    """Copy ``loaded`` into ``model``'s parameters in place (an optimizer
    built on them sees the values); parameters with no key in ``loaded``
    keep theirs, as `merge_params` overlays. Every shape is checked
    before anything is copied: a mismatch raises and changes nothing.
    Returns the names the model has no parameter for (not loaded)."""
    params = dict(model.named_parameters())
    for name, value in loaded.items():
        if name in params and params[name].shape != value.shape:
            raise ValueError(
                f"shape mismatch for {name}: checkpoint "
                f"{tuple(value.shape)} vs model {tuple(params[name].shape)}")
    unused = []
    for name, value in loaded.items():
        if name in params:
            params[name].copy_(value)
        else:
            unused.append(name)
    return unused


def load_base(model: nn.Module, path: str) -> Dict[str, torch.Tensor]:
    """Overlay the torch checkpoint at ``path`` (either layout) onto a
    `SuperGuessr` (`pigeon_tpu/cli/run.py::_load_base_checkpoint`);
    returns the mapped tensors."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    loaded = import_state(state, len(model.vision.encoder.layers))
    unused = merge_state(model, loaded)
    groups = sorted({k.split(".")[0] for k in loaded})
    logger.warning("loaded checkpoint %s (%s)%s", path, "+".join(groups),
                   f"; the model has no {unused}" if unused else "")
    return loaded
