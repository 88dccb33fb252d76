"""Weights and inputs made from ``--seed``, on the device, in a few
large calls.

Both sides of the comparison get these tensors: the harness loads them
into the program's model, and the reference regenerates them from the
same seed. Names are the state-dict names of the model the cell builds;
shapes follow from the configuration alone.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

#: Cells and labels lie where StreetView coverage is: longitude over the
#: globe, latitude between these bounds.
LAT_RANGE = (-60.0, 75.0)


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one stream of ``seed``'s draws."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def weight_specs(vision: dict, head: dict = None
                 ) -> List[Tuple[str, tuple, float, float]]:
    """``(name, shape, scale, shift)`` of every parameter, in a fixed
    order: a tensor is ``shift + scale * N(0, 1)``. Dense and patch
    weights have variance ``1 / fan_in``; biases, the class token and the
    positions N(0, 0.02^2); LayerNorm scales 1 + N(0, 0.02^2)."""
    d, i = vision["hidden_size"], vision["intermediate_size"]
    p, c = vision["patch_size"], vision.get("num_channels", 3)
    s = (vision["image_size"] // p) ** 2 + 1
    specs, prefix = [], "vision."

    def dense(name, n_out, n_in):
        specs.append((f"{name}.weight", (n_out, n_in), n_in ** -0.5, 0.0))
        specs.append((f"{name}.bias", (n_out,), 0.02, 0.0))

    def norm(name, n):
        specs.append((f"{name}.weight", (n,), 0.02, 1.0))
        specs.append((f"{name}.bias", (n,), 0.02, 0.0))

    specs.append((f"{prefix}cls_token", (d,), 0.02, 0.0))
    specs.append((f"{prefix}pos_embed", (s, d), 0.02, 0.0))
    specs.append((f"{prefix}patch_embed.weight", (d, p * p * c),
                  (p * p * c) ** -0.5, 0.0))
    norm(f"{prefix}pre_ln", d)
    norm(f"{prefix}post_ln", d)
    for layer in range(vision["num_hidden_layers"]):
        base = f"{prefix}encoder.layers.{layer}."
        norm(base + "ln1", d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(base + "attn." + proj, d, d)
        norm(base + "ln2", d)
        dense(base + "fc1", i, d)
        dense(base + "fc2", d, i)
    if head is not None:
        dense("head.cell_layer", head["num_cells"], d)
        if head.get("multi_task"):
            dense("head.multi_task_head", head["num_mt_vars"], d)
            dense("head.climate_layer", head["num_climates"], d)
            if head.get("predict_month"):
                dense("head.month_layer", head["num_months"], d)
    return specs


def make_weights(vision: dict, head: dict, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The f32 weights of ``weight_specs`` from one normal draw of
    ``seed`` on ``device``."""
    specs = weight_specs(vision, head)
    total = sum(torch.Size(shape).numel() for _, shape, _, _ in specs)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device)
    out, offset = {}, 0
    for name, shape, scale, shift in specs:
        n = torch.Size(shape).numel()
        out[name] = flat[offset:offset + n].view(shape).mul(scale).add(shift)
        offset += n
    return out


def pixels(seed: int, purpose: str, shape: tuple, device) -> torch.Tensor:
    """uint8 pixels, uniform over 0-255."""
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                         generator=generator(seed, purpose, device))


def points(seed: int, purpose: str, n: int, device) -> torch.Tensor:
    """``(n, 2)`` f32 (lon, lat) degrees, uniform in the box."""
    u = torch.rand((n, 2), generator=generator(seed, purpose, device),
                   device=device)
    lo = torch.tensor([-180.0, LAT_RANGE[0]], device=device)
    hi = torch.tensor([180.0, LAT_RANGE[1]], device=device)
    return lo + u * (hi - lo)


def train_labels(seed: int, purpose: str, b: int, head: dict, device
                 ) -> Dict[str, torch.Tensor]:
    """A train batch's targets: (lon, lat), the multi-task regression
    targets, climate and month classes, and each view's heading."""
    g = generator(seed, purpose, device)
    angle = torch.rand((b, 4), generator=g, device=device) * 6.283185307
    return {
        "labels": points(seed, purpose + ".lla", b, device),
        "labels_multi_task": torch.randn((b, head["num_mt_vars"]),
                                         generator=g, device=device),
        "labels_climate": torch.randint(0, head["num_climates"], (b,),
                                        generator=g, device=device),
        "labels_month": torch.randint(0, head["num_months"], (b,),
                                      generator=g, device=device),
        "heading": torch.stack([angle.sin(), angle.cos()], -1),
    }


#: The fixed order of the schedule's gaps, the same for every seed.
ORDER_SEED = 0


def arrival_times(arrivals: dict, seconds: float) -> list:
    """Due times (s from the window's start) of an open loop over
    ``seconds``: ``process`` ``poisson``, exponential gaps at ``rate``
    requests/s. Every run gets the same schedule: the exponential's
    quantiles at (i + 0.5) / n, scaled to fill the span exactly, in one
    fixed shuffled order (`ORDER_SEED`), so that the seed changes the
    images and the weights and not the load."""
    if arrivals["process"] != "poisson":
        raise ValueError(f"no arrival process {arrivals['process']!r}")
    rate = float(arrivals["rate"])
    n = int(round(rate * seconds))
    q = (np.arange(n) + 0.5) / max(n, 1)
    gaps = -np.log1p(-q) / rate
    if n:
        gaps *= seconds / gaps.sum()
    order = np.random.default_rng(ORDER_SEED).permutation(n)
    return np.cumsum(gaps[order]).tolist()


def bank(seed: int, cfg: dict, rows: int, device):
    """A refiner's bank: ``rows`` seeded embeddings (f32, N(0, 1)) on
    ``device`` and their (lon, lat), and each cell's 1-3 clusters of 2-256
    member rows as ``(cell, lng, lat, members)``, the cluster's location
    the mean of its members'."""
    emb = torch.randn((rows, cfg["hidden_size"]), device=device,
                      generator=generator(seed, "bank.emb", device))
    lla = points(seed, "bank.lla", rows, device).cpu().numpy()
    rng = np.random.default_rng(sub_seed(seed, "bank.clusters"))
    clusters = []
    for cell in range(cfg["num_cells"]):
        for _ in range(rng.integers(1, 4)):
            idx = rng.choice(rows, int(rng.integers(2, 257)), replace=False)
            lng, lat = lla[idx].mean(0).tolist()
            clusters.append((cell, lng, lat, idx.tolist()))
    return emb, lla, clusters
