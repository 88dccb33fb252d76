"""The program under test, as the drivers build it: `pigeon_tpu_torch`'s
configuration objects from a configuration file, its models built on
the device and loaded with the benchmark's weights, and its kernels'
launch counters."""

from __future__ import annotations

import torch

#: The JAX package's route names (``PIGEON_ATTN_IMPL``) -> the port's.
ROUTES = {"flash_fused": "fused", "flash": "flash", "xla": "plain",
          "flash_fused_ln": "fused_ln", "flash_fused_mlp": "fused_mlp",
          "flash_fused_block": "block"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pigeon_config(cfg: dict):
    """The port's `PigeonConfig` for a configuration file."""
    from pigeon_tpu_torch.config import HeadConfig, PigeonConfig, VisionConfig

    vision = VisionConfig(
        image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        projection_dim=cfg["projection_dim"],
        layer_norm_eps=cfg["layer_norm_eps"], hidden_act=cfg["hidden_act"])
    head = HeadConfig(
        num_cells=cfg["num_cells"], embed_dim=cfg["hidden_size"],
        panorama=cfg["panorama"], hierarchical=cfg["hierarchical"],
        smooth_labels=True, label_smoothing_km=cfg["label_smoothing_km"],
        multi_task=cfg["multi_task"], heading=cfg["heading"],
        predict_month=cfg["predict_month"],
        num_candidates=cfg["num_candidates"],
        num_mt_vars=cfg["num_mt_vars"], num_climates=cfg["num_climates"],
        num_months=cfg["num_months"],
        regression_loss_scale=cfg["regression_loss_scale"],
        climate_loss_scale=cfg["climate_loss_scale"],
        month_loss_scale=cfg["month_loss_scale"])
    return PigeonConfig(vision=vision, head=head)


def route(cfg: dict) -> str:
    return ROUTES[cfg["attn_impl"]]


def dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["compute_dtype"]]


def build(make, device) -> torch.nn.Module:
    """``make()`` built without storage, then given uninitialised storage
    on ``device`` (the weights are loaded next)."""
    with torch.device("meta"):
        model = make()
    return model.to_empty(device=device)


@torch.no_grad()
def load(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``model``; their names must be the model's
    state-dict names, all of them."""
    state = model.state_dict()
    missing, extra = set(state) - set(weights), set(weights) - set(state)
    if missing or extra:
        raise KeyError(f"weights do not match the model: missing "
                       f"{sorted(missing)[:4]}, extra {sorted(extra)[:4]}")
    for name, tensor in state.items():
        tensor.copy_(weights[name])


def launches() -> dict:
    """The launch counters of K1 and K2."""
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k

    return {"K1": k.fused_qkv_attention.launches,
            "K2": k.fused_qkv_attention_backward.launches}
