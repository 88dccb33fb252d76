"""Image preprocessing: host resize + crop, device normalise.

Counterpart of `pigeon_tpu/data/image_ops.py::resize_crop_pil`,
`normalize_images`, `clip_preprocess_pil` and `heading_to_sincos`. Views cross to the device as
uint8 (a quarter of the bytes of f32) and are CLIP-normalised there.
"""

from __future__ import annotations

import numpy as np
import torch

#: OpenAI CLIP normalisation constants.
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_crop_pil(image, image_size: int = 336) -> np.ndarray:
    """PIL image -> ``(S, S, 3)`` uint8: bicubic resize of the shortest
    edge to ``image_size``, then a centre crop (no normalisation)."""
    from PIL import Image

    image = image.convert("RGB")
    w, h = image.size
    short = min(w, h)
    new_w = int(round(w * image_size / short))
    new_h = int(round(h * image_size / short))
    image = image.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - image_size) // 2
    top = (new_h - image_size) // 2
    image = image.crop((left, top, left + image_size, top + image_size))
    return np.asarray(image, dtype=np.uint8)


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` uint8 -> CLIP-normalised f32, on the tensor's device."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


def clip_preprocess_pil(image, image_size: int = 336) -> np.ndarray:
    """PIL image -> CLIP-normalised ``(S, S, 3)`` f32 numpy array: the
    resize and crop of `resize_crop_pil`, then `normalize_images`."""
    return normalize_images(
        torch.tensor(resize_crop_pil(image, image_size))).numpy()


def heading_to_sincos(heading_deg) -> np.ndarray:
    """Compass heading (degrees) -> ``(..., 4, 2)`` per-view (sin, cos):
    view i looks at ``heading + i * 90`` degrees
    (`pigeon_tpu.data.image_ops.heading_to_sincos`)."""
    heading = np.deg2rad(np.asarray(heading_deg, dtype=np.float64))
    offsets = np.arange(4) * (np.pi / 2.0)
    angles = (heading[..., None] + offsets) % (2.0 * np.pi)
    return np.stack([np.sin(angles), np.cos(angles)], axis=-1) \
        .astype(np.float32)
