"""A tiny configuration of the PIGEON preset in a root of its own,
found by name beside the benchmark's files, for the CPU tests."""

import json
import os

from portbench.harness import ROOT

#: The tiny preset: 2 views of 32 px in patches of 16 (5 tokens), width
#: 128 (2 heads of 64), 2 layers, 50 cells.
TINY = dict(image_size=32, patch_size=16, hidden_size=128,
            intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=2, projection_dim=64, num_cells=50,
            batch_size_per_device=4, embed_batch_size_per_device=8)
#: Limits for the tiny cells (bf16 against float32 at this size reads
#: ~1e-3 to ~1e-2; every planted fault reads 0.1 or more).
TINY_LIMITS = {"tiny-train": {"loss_gap": 0.03, "grad_gap": 0.05,
                              "update_gap": 0.05},
               "tiny-embed": {"embedding_error": 0.05},
               "tiny-serve": {"embedding_error": 0.05, "head_gap": 0.1,
                              "refine_mismatch": 0}}


def tiny_config() -> dict:
    with open(os.path.join(ROOT, "configs", "pigeon-vitl14-336.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    return cfg


def tiny_spec() -> dict:
    """The benchmark's entries with the tiny cells added."""
    with open(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"] += [
        {"name": "tiny-train", "config": "tiny", "traffic": "finetune",
         "chips": 1, "why": "tiny"},
        {"name": "tiny-embed", "config": "tiny", "traffic": "embed",
         "chips": 1, "why": "tiny"},
        {"name": "tiny-serve", "config": "tiny", "traffic": "serve-r80",
         "chips": 1, "why": "tiny"}]
    for metric in spec["end_to_end"]:
        if metric["name"] == "train_images_per_s":
            metric["workloads"].append("tiny-train")
        if metric["name"] == "embed_images_per_s":
            metric["workloads"].append("tiny-embed")
    if "serve_p95_ms" not in {m["name"] for m in spec["end_to_end"]}:
        spec["end_to_end"].append({"name": "serve_p95_ms", "unit": "ms",
                                   "better": "lower", "bound": 0.25,
                                   "source": "host_clock", "workloads": []})
    for metric in spec["end_to_end"]:
        if metric["name"] == "serve_p95_ms":
            metric["workloads"].append("tiny-serve")
    return spec


def write_tiny_root(tmp_path):
    """A root holding the tiny configuration and its cells' limits."""
    for kind in ("configs", "limits"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    for name, limits in TINY_LIMITS.items():
        (tmp_path / "limits" / f"{name}.json").write_text(json.dumps(limits))
    return tmp_path
