"""Serving artifacts: the serving program traced once by `torch.export`.

Counterpart of `pigeon_tpu/serve/export.py`: the serving forward (uint8
or f32 wire -> CLIP normalisation -> vision tower -> geocell head -> top-k
geocells) traced once, with a symbolic batch unless one is fixed, and
written beside its weights, its geocell table and a JSON manifest. A
serving host loads the artifact and runs it without the model's code or
config, and the program that was checked is the program that serves.

Artifact layout (one directory)::

    serving.pt2     `torch.export.save` of the traced program
    params.npz      the model's state dict: names -> arrays
    geocells.npy    (num_cells, 2) centroid table
    manifest.json   shapes, wire dtype, platforms, versions

The program takes ``(params, pixels, geocells)``: the weights are an
argument, not state baked into the program (as the JAX artifact keeps
them), so ``serving.pt2`` holds the graph alone and ``params.npz`` is the
one copy of the weights. The loader passes its arrays to every call: an
artifact serves new weights of the same names and shapes without a new
export, and a missing, extra or reshaped array is refused.

The artifact's attention is the plain route: the kernels' operators
(``torch.ops.pigeon.*``) are this package's, built at run time, and a
program that named them would need the package where it is served. The
export refuses a program that reaches one. The fused kernels stay a live
``serve`` optimisation, as the JAX artifact keeps Pallas out of its
StableHLO. ``platforms`` name torch device types (``cuda``, ``cpu``): the
program is traced on the CPU and moved to the serving device at load
(`torch.export.passes.move_to_device_pass`).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from pigeon_tpu_torch.data.image_ops import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from pigeon_tpu_torch.models.clip import routes_of
from pigeon_tpu_torch.models.geocell_head import geocell_predictions

MODULE_FILE = "serving.pt2"
PARAMS_FILE = "params.npz"
GEOCELLS_FILE = "geocells.npy"
MANIFEST_FILE = "manifest.json"
ARTIFACT_VERSION = 1
WIRE_DTYPES = {"uint8": torch.uint8, "float32": torch.float32}
OUTPUTS = ("pred_lla", "topk_cells", "topk_probs", "embedding")
#: The kernels' operator namespace, which no exported program may reach.
KERNEL_NAMESPACE = "pigeon"


def check_platforms(platforms: Sequence[str]) -> tuple:
    """``platforms`` as a tuple of torch device types; a name torch does
    not know as one (``tpu`` among them) raises ValueError."""
    out = []
    for name in platforms:
        try:
            device = torch.device(name)
        except RuntimeError:
            device = None
        if device is None or device.type != name:
            raise ValueError(f"platform {name!r} is not a torch device type "
                             "(cuda, cpu)")
        out.append(name)
    if not out:
        raise ValueError("no platform named")
    return tuple(out)


class ServingProgram(nn.Module):
    """The traced forward: ``(params, pixels, geocells) -> dict`` of
    `OUTPUTS`, the model run on ``params`` (its state dict's names) by
    `torch.func.functional_call`. The model is held outside the module's
    registry, so the exported program carries no weights. uint8 pixels
    are CLIP-normalised by buffers of this module (a tensor made inside
    the forward would be traced onto the trace's device)."""

    def __init__(self, model: nn.Module, num_candidates: int):
        super().__init__()
        object.__setattr__(self, "model", model)
        self.num_candidates = num_candidates
        self.register_buffer("mean", torch.tensor(CLIP_IMAGE_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(CLIP_IMAGE_STD),
                             persistent=False)

    def forward(self, params, pixels, geocells):
        if pixels.dtype == torch.uint8:
            pixels = (pixels.to(torch.float32) / 255.0 - self.mean) / self.std
        out = torch.func.functional_call(self.model, params, (pixels,))
        preds = geocell_predictions(out.logits, geocells,
                                    self.num_candidates)
        return {"pred_lla": preds["pred_lla"],
                "topk_cells": preds["topk_cells"],
                "topk_probs": preds["topk_probs"],
                "embedding": out.embedding}


def kernel_ops(graph_module) -> list:
    """The ``pigeon::`` operators the nodes of ``graph_module`` call."""
    found = []
    for node in graph_module.graph.nodes:
        if node.op != "call_function":
            continue
        name = getattr(node.target, "name", None)
        name = name() if callable(name) else str(node.target)
        if name.split("::")[0] == KERNEL_NAMESPACE \
                or str(node.target).startswith(f"{KERNEL_NAMESPACE}."):
            found.append(name)
    return found


def export_serving_artifact(model: nn.Module, head_cfg, geocells,
                            out_dir: str, image_size: int,
                            panorama: bool = False,
                            batch: Optional[int] = None,
                            wire_dtype: str = "uint8",
                            platforms: Sequence[str] = ("cuda", "cpu"),
                            ) -> dict:
    """Export the serving forward of ``model`` (a `SuperGuessr` on the
    ``"plain"`` route, float or static int8) into ``out_dir``.

    Args:
        batch: fixed batch size, or None for a symbolic batch.
        wire_dtype: ``uint8`` (normalisation inside the program) or
            ``float32`` (CLIP-normalised pixels).
        platforms: the torch device types the artifact may be served on.

    Returns the manifest dict.
    """
    platforms = check_platforms(platforms)
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype={wire_dtype!r}, not in "
                         f"{sorted(WIRE_DTYPES)}")
    if routes_of(model) - {"plain"}:
        raise ValueError(f"the artifact runs the plain route; the model "
                         f"has {sorted(routes_of(model))}")
    model = model.to("cpu").eval()
    program = ServingProgram(model, head_cfg.num_candidates)
    views = (4,) if panorama else ()
    example_b = 2 if batch is None else int(batch)
    pixels = torch.zeros((example_b, *views, image_size, image_size, 3),
                         dtype=WIRE_DTYPES[wire_dtype])
    cells = torch.as_tensor(np.asarray(geocells, np.float32))
    state = {k: v.detach() for k, v in model.state_dict().items()}
    dynamic = None
    if batch is None:
        dynamic = {"params": {k: None for k in state},
                   "pixels": {0: torch.export.Dim("batch", min=1)},
                   "geocells": None}
    with torch.no_grad():
        exported = torch.export.export(program, (state, pixels, cells),
                                       dynamic_shapes=dynamic)
    found = kernel_ops(exported.graph_module)
    if found:
        raise ValueError(f"the exported program calls kernel operators "
                         f"{sorted(set(found))}")
    # The example inputs hold the weights: keep them out of serving.pt2.
    exported.example_inputs = None

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, MODULE_FILE))
    np.savez(os.path.join(out_dir, PARAMS_FILE),
             **{k: v.numpy() for k, v in state.items()})
    np.save(os.path.join(out_dir, GEOCELLS_FILE), cells.numpy())
    manifest = {
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "wire_dtype": wire_dtype,
        "image_size": int(image_size),
        "panorama": bool(panorama),
        "batch": ("symbolic" if batch is None else int(batch)),
        "num_cells": int(cells.shape[0]),
        "num_candidates": int(head_cfg.num_candidates),
        "num_params": int(sum(v.numel() for v in state.values())),
        "outputs": list(OUTPUTS),
    }
    with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


def load_serving_artifact(artifact_dir: str, device="cuda"):
    """Load an exported artifact onto ``device``; returns ``(serve_fn,
    manifest)``.

    ``serve_fn(pixels) -> dict`` of `OUTPUTS` as tensors on ``device``
    follows `serve.server.make_serving_fn`'s contract (``serve_fn.device``
    included), so `PredictionService` and `MicroBatcher` serve an
    artifact as they serve a model. A wrong ``artifact_version`` or a
    device type the manifest's ``platforms`` lack raises ValueError.
    """
    device = torch.device(device)
    with open(os.path.join(artifact_dir, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if manifest["artifact_version"] != ARTIFACT_VERSION:
        raise ValueError(
            f"artifact version {manifest['artifact_version']} != "
            f"supported {ARTIFACT_VERSION}")
    if device.type not in manifest["platforms"]:
        raise ValueError(f"the artifact was exported for "
                         f"{manifest['platforms']}, not {device.type}")
    exported = torch.export.load(os.path.join(artifact_dir, MODULE_FILE))
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    program = exported.module()
    with np.load(os.path.join(artifact_dir, PARAMS_FILE)) as z:
        params = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
    cells = torch.from_numpy(
        np.load(os.path.join(artifact_dir, GEOCELLS_FILE))).to(device)
    wire = WIRE_DTYPES[manifest["wire_dtype"]]

    @torch.inference_mode()
    def serve_fn(pixels):
        if not isinstance(pixels, torch.Tensor):
            pixels = torch.tensor(np.asarray(pixels))
        return program(params, pixels.to(device, wire), cells)

    serve_fn.program = program
    serve_fn.params = params
    serve_fn.device = device
    return serve_fn, manifest
