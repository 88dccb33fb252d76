"""Benchmark evaluation: refiner presets, `build_refiner` and
`evaluate_benchmark`.

Counterpart of `pigeon_tpu/train/evaluate.py` (that package imports JAX,
so the presets are restated here; a test holds the two dicts equal).
Evaluation widens the candidate pool to `EVAL_NUM_CANDIDATES`; the
packed prototype bank may be cached as an npz file.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from pigeon_tpu_torch.config import RefinerConfig
from pigeon_tpu_torch.models.refiner import (
    ProtoBank,
    build_proto_bank,
    make_refine_fn,
)

_STREETVIEW = RefinerConfig(topk=5, max_refinement_km=1000.0,
                            temperature=1.6)

#: Per-benchmark-family refiner settings: StreetView (topk 5, 1000 km,
#: T=1.6); planet-scale (topk 20-40, effectively unbounded, T=0.6-1.0).
REFINER_PRESETS: Dict[str, RefinerConfig] = {
    "streetview": _STREETVIEW,
    "geoguessr": _STREETVIEW,
    "gws15k": _STREETVIEW,
    "im2gps": RefinerConfig(topk=20, max_refinement_km=10000.0,
                            temperature=1.0),
    "im2gps3k": RefinerConfig(topk=20, max_refinement_km=10000.0,
                              temperature=1.0),
    "yfcc4k": RefinerConfig(topk=40, max_refinement_km=100000.0,
                            temperature=0.6),
    "yfcc26k": RefinerConfig(topk=40, max_refinement_km=100000.0,
                             temperature=0.6),
}


#: Candidate pool width at eval time (reference `evaluate.py:44`).
EVAL_NUM_CANDIDATES = 50
#: The bank's fields in an npz cache, and the dtype each is stored in (the
#: JAX package's cache, which this reads and writes).
_CACHE_DTYPES = {"proto_emb": np.float32, "proto_lla": np.float32,
                 "proto_count": np.int32, "member_idx": np.int32,
                 "bank_emb": np.float32, "bank_lla": np.float32}


def refiner_preset(benchmark: str) -> RefinerConfig:
    """The benchmark family's refiner settings (StreetView by default)."""
    return REFINER_PRESETS.get(benchmark, _STREETVIEW)


def build_refiner(proto_rows, bank_emb: np.ndarray, bank_lla: np.ndarray,
                  num_cells: int, cfg: RefinerConfig,
                  cache_path: Optional[str] = None,
                  device="cpu") -> Callable:
    """Pack the prototype bank on ``device`` (or load it from the npz
    ``cache_path``, which a first call writes) and return the batched
    refine function."""
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as data:
            bank = ProtoBank(**{
                f: torch.from_numpy(data[f]).to(
                    device, torch.int64 if f == "member_idx" else None)
                for f in _CACHE_DTYPES})
    else:
        bank = build_proto_bank(proto_rows, bank_emb, bank_lla, num_cells,
                                max_protos=cfg.max_protos_per_cell,
                                max_members=cfg.max_members_per_cluster,
                                device=device)
        if cache_path:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            np.savez(cache_path, **{
                f: getattr(bank, f).cpu().numpy().astype(dtype)
                for f, dtype in _CACHE_DTYPES.items()})
    return make_refine_fn(bank, cfg)


def evaluate_benchmark(eval_step: Callable, model, batches: Iterable[dict],
                       batch_to_device: Callable,
                       refine_fn: Optional[Callable] = None,
                       scaler=None, country_index=None,
                       mesh=None) -> Dict[str, float]:
    """One benchmark end to end: the forward, the refiner if given, and
    the metric suite (`train.loop.evaluate_model`; over ``mesh``'s data
    axis, on the rows every rank gathers)."""
    from pigeon_tpu_torch.train.loop import evaluate_model

    return evaluate_model(eval_step, model, batches, batch_to_device,
                          refine_fn=refine_fn, scaler=scaler,
                          country_index=country_index, mesh=mesh)
