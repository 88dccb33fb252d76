"""CLI of the port: the ``serve``, ``finetune``, ``evaluate``, ``predict``,
``embed``, ``augment``, ``export``, ``pretrain``, ``geocells`` and
``prototypes`` subcommands.

Counterpart of `pigeon_tpu/cli/run.py::cmd_serve` (with
``--serve-batch`` and ``--artifact``), `cmd_finetune` (on pixels, and on
embeddings with ``--embeddings``), `cmd_evaluate` (with ``--zeroshot``),
`cmd_predict`, `cmd_embed`, `cmd_augment`, `cmd_export`,
`cmd_pretrain`, `cmd_geocells` and `cmd_prototypes`, with their flags for
these paths. Models
are built in bf16 with f32 parameters, on the attention
route that ``PIGEON_ATTN_IMPL`` names in the JAX package's words
(:func:`attn_impl`; ``PIGEON_QUANT_ATTN_IMPL`` under ``--quant``,
:func:`quant_attn_impl`): by default ``flash_fused``, kernel K1 (and K2
in the backward); ``PIGEON_FLASH_FWD`` picks the body of K3 where it runs
(:func:`flash_fwd`).

``serve``, ``evaluate`` and ``predict`` take their weights by one policy
(:func:`init_and_restore`): the newest checkpoint under
``--checkpoint-dir/NAME`` (the model that ``finetune`` wrote), else the
torch state dict ``--base`` names (an HF CLIP vision tower or the
reference's SuperGuessr ``.model``, `models/hf_import.py`), else a seeded
initialisation. ``finetune`` overlays ``--base`` on its seeded
initialisation before ``--resume``. Under ``--quant`` the tower becomes
int8: the weights quantized per output channel, the activation scales
calibrated by one dynamic forward (attention through kernel K3); every
later forward runs each layer's attention through kernel K8. ``serve``
calibrates on ``--calib-images`` or a seeded synthetic batch,
``evaluate`` and ``predict`` on the first real batch.

``finetune`` trains under the remat policy ``PIGEON_REMAT`` names
(:func:`remat_policy`), evaluates each epoch, keeps the best checkpoint
under ``--checkpoint-dir/NAME`` (written while the next epoch trains) and
continues from it with ``--resume``; a non-finite loss rolls it back to
that checkpoint, and a SIGTERM saves the state and ends the command
(`train/loop.py`). Its ``--metadata`` takes a comma-separated list (the
train rows concatenated, val from the first file); under ``-m`` a file
without the multi-task columns goes through the GeoAugmentor of
``--aux-dir`` first. ``augment`` writes that enrichment to a CSV.
``finetune --embeddings DIR`` trains the geocell head alone on a bank
``embed`` wrote (:func:`build_head_finetune`).
``evaluate`` scores benchmarks of the registry (``-l``) or the
metadata's test split (``-t``) with the full metric suite, refined by
the preset of each benchmark's family, into ``--output`` JSON;
``predict`` writes one CSV row of coordinates per image. ``embed`` runs
each split of ``--metadata`` through the CLIP embedder (or the generic
ViT one, ``--embedder``), int8 with ``--quant``, into ``{split}.npy``
banks (:func:`cmd_embed`).
``serve --serve-batch N`` coalesces concurrent requests into one forward
at a bucket of a power-of-two ladder (`serve/batching.py`); ``export``
traces the serving forward on the plain route into an artifact that
``serve --artifact DIR`` serves without the model's code
(`serve/export.py`). ``pretrain`` trains the contrastive `CLIPModel`
(both towers) on captioned metadata (`train/modes.py`,
`data/pretrain.py`); ``evaluate --zeroshot`` classifies images against
one CLIP text prompt a geocell (`models/zeroshot.py`). ``--landmarks``
selects the PIGEOTTO-with-landmarks preset and lets the refinement flags
list datasets comma-separated (:func:`load_refine_assets`); ``--model
vit-b32`` swaps in the ViT-B/32 towers, and ``embed --model
dinov2-g14-reg`` embeds with DINOv2 ViT-g/14 with registers at 518 px
(the final-LN CLS row; ``--base`` an HF `Dinov2WithRegistersModel` state
dict).

Under `torchrun` (one process a card; ``--device cpu`` runs gloo
ranks) ``finetune``, ``pretrain``, ``embed``, ``evaluate`` and
``predict`` run over a ``(data, model)`` mesh (`train/mesh.py`):
``--tp N`` shards the tower's heads and MLP, the geocell layer and the
text vocabulary over N ranks (kernels K1, K2, K3 and K8 on the local
heads; the K5/K6/K7/K9 routes stop), ``--fsdp`` shards the trained
state over the data axis (FSDP2) where DDP would replicate it.
``--batch-size`` is the global batch, each rank taking its slice; rank
0 alone writes metrics, checkpoints (DCP directories, `train/
checkpoints.py`), banks, predictions and ``evaluate``'s JSON.
``serve`` and ``export`` stay on one card, as in the JAX CLI.

``geocells`` and ``prototypes`` build the two tables every other command
reads, on the host alone (no device, no process group): semantic
geocells balanced by OPTICS (`geocell/creation.py`), then each cell's
prototype clusters (`geocell/prototypes.py`), the C++ geo kernels
(`geocell/geokernels.py`) where they build.
Geocell, prototype and serving metadata CSVs are read with the stdlib
``csv`` module, training and evaluation metadata with pandas, embeddings
with numpy.

Usage:
    python -m pigeon_tpu_torch.cli.run serve pigeon --panorama -m \
        --heading --geocells data/geocells.csv [--base B.pt] \
        [--prototypes P.csv --embeddings DIR --metadata META.csv \
        [--hedge]] [--quant [--calib-images DIR]]
    python -m pigeon_tpu_torch.cli.run finetune myrun \
        --metadata M.csv[,M2.csv] --images DIR --geocells C.csv \
        --panorama -m --heading [--aux-dir DIR] [--base B.pt] \
        [--batch-size N] [--epochs N] [--resume]
    python -m pigeon_tpu_torch.cli.run augment --metadata M.csv \
        [--aux-dir DIR] [--output OUT.csv]
    python -m pigeon_tpu_torch.cli.run evaluate myrun -l sample20 \
        --geocells C.csv [--base B.pt] [--prototypes P.csv \
        --embeddings DIR --metadata META.csv] [--scaler S.json] \
        [--countries C.geojson] [--quant] [--output R.json]
    python -m pigeon_tpu_torch.cli.run predict myrun --images DIR \
        --geocells C.csv [--base B.pt] [--quant] [--output P.csv]
    python -m pigeon_tpu_torch.cli.run embed myrun --metadata M.csv \
        --images DIR [--panorama] [--embedder auto|clip|vit] [--base B.pt] \
        [-s N] [--quant] [--batch-size N] [--output DIR]
    python -m pigeon_tpu_torch.cli.run embed myrun --model dinov2-g14-reg \
        --metadata M.csv --images DIR [--base DINOV2.pt] [--batch-size N] \
        [--output DIR]
    python -m pigeon_tpu_torch.cli.run finetune myrun --metadata M.csv \
        --geocells C.csv --embeddings DIR [--panorama] [--batch-size N] \
        [--epochs N]
    python -m pigeon_tpu_torch.cli.run serve pigeon ... --serve-batch 8
    python -m pigeon_tpu_torch.cli.run export pigeon --geocells C.csv \
        [--panorama] [--quant [--calib-images DIR]] [--batch-size N] \
        [--platforms cuda,cpu] [--output DIR]
    python -m pigeon_tpu_torch.cli.run serve --artifact DIR \
        [--prototypes P.csv --embeddings DIR --metadata M.csv [--hedge]]
    python -m pigeon_tpu_torch.cli.run pretrain myrun --metadata M.csv \
        --images DIR [--yfcc|--landmarks] [-a] [--batch-size N] \
        [--epochs N]
    python -m pigeon_tpu_torch.cli.run evaluate myrun --zeroshot \
        --model vit-b32 -b CLIP.pt -l sample20 --geocells C.csv
    torchrun --standalone --nproc-per-node 2 -m pigeon_tpu_torch.cli.run \
        finetune myrun ... [--tp 2] [--fsdp] [--device cpu]
    python -m pigeon_tpu_torch.cli.run geocells --metadata M.csv \
        [--load ADMIN2.geojson] [--yfcc|--landmarks] [--output C.csv]
    python -m pigeon_tpu_torch.cli.run prototypes --metadata M.csv[,M2.csv] \
        --geocells C.csv [--output P.csv[,P2.csv]]
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import functools
import glob
import itertools
import json
import logging
import os
import sys
from http.server import ThreadingHTTPServer
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pigeon_tpu_torch.config import (
    TextConfig,
    VisionConfig,
    dinov2_g14_reg_vision,
    landmarks_config,
    pigeon_config,
    pigeotto_config,
    vit_b32_text,
    vit_b32_vision,
)
from pigeon_tpu_torch.data.pipeline import iter_batches
from pigeon_tpu_torch.train.embed import embedding_batches, load_embeddings

logger = logging.getLogger("pigeon_tpu_torch.cli")
#: ``--model``'s DINOv2 ViT-g/14 with registers, an embedder.
DINOV2 = "dinov2-g14-reg"

#: Seed of the initial weights (the JAX CLI initialises from PRNGKey(0)).
INIT_SEED = 0
#: Seed of the synthetic calibration batch of ``serve --quant`` without
#: ``--calib-images`` (the JAX CLI draws it from PRNGKey(3)).
CALIB_SEED = 3
#: At most this many ``--calib-images`` are read (`run.py:1408-1442`).
MAX_CALIB_IMAGES = 32
#: ``evaluate`` and ``predict`` calibrate on at most this many samples of
#: their first batch, with this margin over the observed maxima.
EVAL_CALIB_SAMPLES, EVAL_CALIB_MARGIN = 8, 1.0
#: Image files ``predict --images`` finds.
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")
#: The columns of ``predict``'s CSV.
PREDICT_COLUMNS = ("image", "lat", "lng", "geocell_idx", "top1_prob")
#: ``--sample``'s seed: the reference's global training seed
#: (`pigeon_tpu/cli/run.py::_sample_dataset`).
SAMPLE_SEED = 330
#: ``embed --quant`` calibrates on at most this many samples of the first
#: non-empty split (`pigeon_tpu/cli/run.py:826-857`).
EMBED_CALIB_SAMPLES = 8

#: The commands that run over a mesh (``--tp``, ``--fsdp``, `torchrun`).
MESH_COMMANDS = ("finetune", "pretrain", "embed", "evaluate", "predict")

#: ``PIGEON_ATTN_IMPL`` values, the JAX package's route names, and the
#: port's route for each (`models/clip.py`).
ATTN_ROUTES = {"flash_fused": "fused", "flash": "flash", "xla": "plain",
               "flash_fused_ln": "fused_ln", "flash_fused_mlp": "fused_mlp",
               "flash_fused_block": "block"}


def _route(name: str, variable: str) -> str:
    """The port's route for the JAX route ``name`` read from ``variable``;
    a name with no meaning stops the command."""
    if name not in ATTN_ROUTES:
        raise SystemExit(f"{variable}={name!r}: not one of "
                         f"{sorted(ATTN_ROUTES)}")
    return ATTN_ROUTES[name]


def _attn_name() -> str:
    return os.environ.get("PIGEON_ATTN_IMPL") or "flash_fused"


def attn_impl() -> str:
    """The bf16 route of ``serve`` and ``finetune``: ``PIGEON_ATTN_IMPL``
    (a JAX route name, default ``flash_fused``) mapped to the port's
    (`pigeon_tpu/cli/run.py::_attn_impl`). Unlike the JAX CLI, which
    takes ``xla`` off the TPU, the port honours the variable on the CPU
    too, where the kernels' plain versions run."""
    return _route(_attn_name(), "PIGEON_ATTN_IMPL")


def quant_attn_impl() -> str:
    """The route of ``serve --quant``
    (`pigeon_tpu/cli/run.py::_quant_attn_impl`): ``PIGEON_QUANT_ATTN_IMPL``
    if set, else the bf16 route with every ``flash_fused*`` name taken as
    ``flash_fused`` (kernel K8; the LN and MLP fusions have no int8
    kernel, and the JAX CLI keeps its int8 block kernel opt-in).
    ``flash`` stays ``flash``: static int8 projections, then kernel K3 per
    request. ``PIGEON_QUANT_ATTN_IMPL=flash_fused_block`` is the ``block``
    route, kernel K7. An unknown name is refused before the downgrade."""
    override = os.environ.get("PIGEON_QUANT_ATTN_IMPL")
    if override:
        name, variable = override, "PIGEON_QUANT_ATTN_IMPL"
    else:
        name, variable = _attn_name(), "PIGEON_ATTN_IMPL"
        _route(name, variable)
        if name.startswith("flash_fused"):
            name = "flash_fused"
    route = _route(name, variable)
    return "fused" if route in ("fused_ln", "fused_mlp") else route


def flash_fwd() -> str:
    """The ``PIGEON_FLASH_FWD`` body of kernel K3 (``monolithic``, the
    default, or ``online``: K3′), checked when ``serve`` and ``finetune``
    start; an unknown value stops the command (the JAX package takes it
    as ``monolithic``). The kernels read the variable at each call."""
    from pigeon_tpu_torch.kernels.attention import flash_fwd as resolve

    try:
        return resolve()
    except ValueError as err:
        raise SystemExit(str(err)) from None


def remat_policy() -> str:
    """The training remat policy of ``finetune``: ``PIGEON_REMAT``
    (`pigeon_tpu/cli/run.py::_remat_override`), default ``attn_kernel``,
    one of `models.clip.REMATS` (``none``, ``full``, ``attn_out``,
    ``attn_kernel``, ``attn_slim``). Any other value stops the command,
    where the JAX package would fall back to full remat without a
    word."""
    from pigeon_tpu_torch.models.clip import REMATS

    value = os.environ.get("PIGEON_REMAT") or "attn_kernel"
    if value not in REMATS:
        raise SystemExit(f"PIGEON_REMAT={value!r}: the port has the remat "
                         f"policies {REMATS}")
    return value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pigeon_tpu_torch",
        description="PIGEON geolocation in PyTorch on an NVIDIA GPU.")
    p.add_argument("function",
                   choices=["serve", "finetune", "evaluate", "predict",
                            "embed", "augment", "export", "pretrain",
                            "geocells", "prototypes"],
                   help="operation to run")
    p.add_argument("name", nargs="?", default="pigeon", help="run name")
    p.add_argument("-l", "--load", default=None,
                   help="evaluate: comma-separated benchmark names "
                        "(default im2gps3k); predict: a metadata CSV of "
                        "images; geocells: an admin-2 boundary GeoJSON")
    p.add_argument("-b", "--base", default=None,
                   help="torch state dict to start from: an HF CLIP "
                        "vision tower or a reference SuperGuessr .model "
                        "(a run's checkpoint comes first); embed: an HF "
                        "CLIP vision tower, an HF ViT for --embedder "
                        "vit, or an HF DINOv2 with registers for --model "
                        "dinov2-g14-reg")
    p.add_argument("-s", "--sample", type=int, default=None,
                   help="embed, finetune: a seeded random subsample of "
                        "this many rows of each split (finetune: of "
                        "train), in their original order")
    p.add_argument("-a", "--auxiliary", action="store_true",
                   help="pretrain: auxiliary caption sentences (climate, "
                        "driving side, compass, month)")
    p.add_argument("-t", "--test", action="store_true",
                   help="evaluate: the test split of --metadata (comma-"
                        "separated files concatenate)")
    p.add_argument("--benchmarks", default=None,
                   help="evaluate: benchmark registry JSON (default: the "
                        "config's)")
    p.add_argument("--scaler", default=None,
                   help="evaluate: RegressionScaler JSON for the "
                        "multi-task errors in physical units")
    p.add_argument("--countries", default=None,
                   help="evaluate: country-boundary GeoJSON for "
                        "Country_accuracy")
    p.add_argument("--output", default=None,
                   help="evaluate: metrics JSON; predict: CSV (default "
                        "predictions.csv); embed: the banks' directory "
                        "(default --embeddings, else data/embeddings); "
                        "augment: CSV (default <metadata>_augmented.csv); "
                        "geocells: CSV (default data/geocells.csv); "
                        "prototypes: comma-separated CSVs, one a "
                        "--metadata (default data/prototypes.csv)")
    p.add_argument("--geocells", default=None, help="geocell CSV path")
    p.add_argument("--prototypes", default=None, help="prototype CSV path")
    p.add_argument("--embeddings", default=None,
                   help="embedding directory (train.npy, "
                        "train_indices.npy); finetune: train the head "
                        "alone on its train and val banks")
    p.add_argument("--embedder", default="auto",
                   choices=["auto", "clip", "vit"],
                   help="embed: the CLIP tower or the generic ViT (auto: "
                        "ViT when the run name holds 'vit')")
    p.add_argument("--metadata", default=None,
                   help="metadata CSV path; finetune: a comma-separated "
                        "list (train rows concatenated, val from the "
                        "first)")
    p.add_argument("--aux-dir", default="data",
                   help="augment, finetune -m: auxiliary data for the "
                        "GeoAugmentor (boundaries/, koppen_geiger/, "
                        "elevation/, pop_density/, worldclim/, "
                        "driving_side.json)")
    p.add_argument("--images", default="", help="image directory")
    p.add_argument("--checkpoint-dir", default="saved_models")
    p.add_argument("--batch-size", type=int, default=None,
                   help="finetune: batch (default: the preset's); "
                        "evaluate, predict: default_batch's; embed: the "
                        "preset's sweep batch (512), default_batch's "
                        "with --quant")
    p.add_argument("--epochs", type=int, default=None,
                   help="finetune: epochs (default: the preset's)")
    p.add_argument("-r", "--resume", action="store_true",
                   help="finetune: continue from the latest checkpoint")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="finetune: a torch.profiler Chrome trace of train "
                        "steps 4 to 14 under DIR, every thread's spans in "
                        "it")
    p.add_argument("--hedge", action="store_true",
                   help="hedge refined guesses for competitive play")
    p.add_argument("--quant", action="store_true",
                   help="int8 W8A8 vision tower (activation scales "
                        "calibrated at start-up: serve on --calib-images "
                        "or a synthetic batch, evaluate and predict on "
                        "the first real batch)")
    p.add_argument("--calib-images", default=None,
                   help="serve --quant: calibrate on up to 32 images of "
                        "this directory (default: a synthetic batch)")
    p.add_argument("--serve-batch", type=int, default=0,
                   help="serve: micro-batch up to N concurrent requests "
                        "into one forward (0 or 1: serialized, one at a "
                        "time)")
    p.add_argument("--artifact", default=None,
                   help="serve: an artifact directory (from `export`) to "
                        "serve in place of a model")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="export: comma-separated torch device types the "
                        "artifact may be served on")
    p.add_argument("--zeroshot", action="store_true",
                   help="evaluate: CLIP zero-shot geocell classification "
                        "through one text prompt a geocell (-b: a full HF "
                        "CLIP state dict)")
    p.add_argument("--model", default=None,
                   choices=["vit-l14-336", "vit-b32", DINOV2],
                   help="CLIP tower size (default: the preset's "
                        "ViT-L/14-336; --tiny wins), or for embed "
                        "DINOv2 ViT-g/14 with registers at 518 px (with "
                        "--tiny: its layer at the tiny widths)")
    p.add_argument("--landmarks", action="store_true",
                   help="the PIGEOTTO + Google Landmarks preset; "
                        "--metadata/--embeddings/--prototypes may list "
                        "comma-separated datasets whose banks concatenate")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size: the mesh's model axis (must "
                   "divide the ranks torchrun starts)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard the trained state over the data axis "
                   "(FSDP2) instead of replicating it (DDP)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--panorama", action="store_true",
                   help="4-view StreetView panorama input")
    p.add_argument("-m", "--multitask", action="store_true",
                   help="enable multi-task heads")
    p.add_argument("--heading", action="store_true",
                   help="use compass headings")
    p.add_argument("--yfcc", action="store_true",
                   help="PIGEOTTO (planet-scale single image) preset")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (smoke tests)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p


def make_config(args):
    """The preset (``--landmarks``: `landmarks_config`, else ``--yfcc``'s
    or PIGEON's), with the head's flags as given, ``--model vit-b32``'s
    towers and ``--tiny``'s, which win (`pigeon_tpu/cli/run.py:
    make_config`)."""
    if getattr(args, "landmarks", False):
        cfg = landmarks_config()
    else:
        cfg = pigeotto_config() if args.yfcc else pigeon_config()
    head = dataclasses.replace(cfg.head, multi_task=args.multitask,
                               heading=args.heading,
                               panorama=args.panorama)
    cfg = cfg.replace(head=head)
    if getattr(args, "model", None) == DINOV2:
        vision = dinov2_g14_reg_vision()
        cfg = cfg.replace(vision=vision, head=dataclasses.replace(
            cfg.head, embed_dim=vision.hidden_size))
    if getattr(args, "model", None) == "vit-b32":
        vision = vit_b32_vision()
        cfg = cfg.replace(
            vision=vision, text=vit_b32_text(),
            head=dataclasses.replace(cfg.head,
                                     embed_dim=vision.hidden_size))
    if args.tiny:
        cfg = cfg.replace(
            vision=VisionConfig(image_size=64, patch_size=16,
                                hidden_size=64, intermediate_size=128,
                                num_layers=2, num_heads=4,
                                projection_dim=32),
            text=TextConfig(vocab_size=1024, hidden_size=64,
                            intermediate_size=128, num_layers=2,
                            num_heads=4, max_position_embeddings=32,
                            projection_dim=32),
            head=dataclasses.replace(cfg.head, embed_dim=64))
    return cfg


def _read_csv(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def load_geocells(args) -> np.ndarray:
    """``(C, 2)`` (lon, lat) geocell centroids from ``--geocells``."""
    if args.geocells is None:
        raise SystemExit("--geocells CSV is required for this command")
    rows = _read_csv(args.geocells)
    return np.array([(float(r["lng"]), float(r["lat"])) for r in rows],
                    np.float32).reshape(-1, 2)


def sample_dataset(ds, n):
    """``ds`` cut to a seeded random sample of ``n`` rows in their
    original order, when ``n`` is given and below its length
    (`pigeon_tpu/cli/run.py::_sample_dataset`: ``df.sample`` at seed
    330, then ``sort_index``)."""
    if n and n < len(ds.df):
        ds.df = ds.df.sample(int(n), random_state=SAMPLE_SEED) \
            .sort_index().reset_index(drop=True)
    return ds


def load_refine_assets(args):
    """``(proto_rows, bank_emb, bank_lla)`` from ``--prototypes``,
    ``--embeddings`` and ``--metadata``, or None without them
    (`pigeon_tpu/cli/run.py::_load_refine_assets`). Each flag may list
    datasets comma-separated (``--landmarks``' YFCC and landmark pair):
    the banks concatenate, and each dataset's prototype member indices
    shift by the bank rows before it. Lists of different lengths, or a
    bank whose length is not its metadata's train rows, stop the
    command."""
    if not (args.prototypes and args.embeddings and args.metadata):
        return None
    from pigeon_tpu_torch.models.refiner import parse_indices

    metas = args.metadata.split(",")
    embdirs = args.embeddings.split(",")
    protos = args.prototypes.split(",")
    if not (len(metas) == len(embdirs) == len(protos)):
        raise SystemExit("--metadata/--embeddings/--prototypes must list "
                         "the same number of comma-separated datasets")
    rows, embs, llas, offset = [], [], [], 0
    for meta_path, emb_dir, proto_path in zip(metas, embdirs, protos):
        meta = _read_csv(meta_path)
        if meta and "selection" in meta[0]:
            meta = [r for r in meta if r["selection"] == "train"]
        lla = np.array([(float(r["lng"]), float(r["lat"])) for r in meta],
                       np.float32).reshape(-1, 2)
        emb = load_embeddings(emb_dir, "train")
        if emb.ndim == 3:
            emb = emb.mean(1)
        if len(emb) != len(lla):
            # Prototype member indices address both by the same row
            # number, after the offset.
            raise SystemExit(f"{emb_dir}: {len(emb)} embeddings vs "
                             f"{len(lla)} metadata train rows in "
                             f"{meta_path} (embedded with --sample? use "
                             "the sampled metadata CSV written beside "
                             "the embeddings)")
        for r in _read_csv(proto_path):
            rows.append({"geocell_idx": int(float(r["geocell_idx"])),
                         "lng": float(r["lng"]), "lat": float(r["lat"]),
                         "count": int(float(r["count"])),
                         "indices": [i + offset for i in
                                     parse_indices(r["indices"])]})
        embs.append(emb)
        llas.append(lla)
        offset += len(emb)
    return rows, np.concatenate(embs), np.concatenate(llas)


def serve_calibration_batch(args, cfg):
    """``(N, [4,] S, S, 3)`` CLIP-normalised f32 calibration pixels from
    up to 32 images of ``--calib-images``, each tiled over the 4 views of
    a panorama model; None without the flag
    (`pigeon_tpu/cli/run.py::_serve_calibration_batch`)."""
    if not args.calib_images:
        return None
    from PIL import Image

    from pigeon_tpu_torch.data.image_ops import clip_preprocess_pil

    files = sorted(
        f for f in glob.glob(os.path.join(args.calib_images, "*"))
        if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
    )[:MAX_CALIB_IMAGES]
    if not files:
        raise SystemExit(f"--calib-images {args.calib_images}: no images "
                         "found")
    pixels = []
    for f in files:
        with Image.open(f) as im:
            pixels.append(clip_preprocess_pil(im, cfg.vision.image_size))
    batch = np.stack(pixels)
    if cfg.head.panorama:
        batch = np.repeat(batch[:, None], 4, axis=1)
    return torch.from_numpy(batch)


def quantize_model(model, calib: torch.Tensor, margin: float, device,
                   source: str):
    """``model`` on ``device`` with an int8 tower: weights quantized per
    output channel, activation scales calibrated by one dynamic forward
    over the CLIP-normalised ``calib`` batch with ``margin`` headroom
    (`pigeon_tpu/cli/run.py::_quantize_for_inference`). ``source`` says
    what the batch is, for the log."""
    from pigeon_tpu_torch.models.quant import quantize_and_calibrate

    model = quantize_and_calibrate(model.to(device), calib.to(device),
                                   tower_key="vision", margin=margin)
    logger.warning("int8 W8A8 tower enabled (activation scales calibrated "
                   "on %s, margin %s)", source, margin)
    return model


def quantize_for_serving(args, cfg, model, device):
    """``serve --quant``: :func:`quantize_model` on ``--calib-images``
    (margin 1.1) or on a seeded N(0, 1) batch of 2 inputs (margin 1.25:
    synthetic activations lack real tails) (`pigeon_tpu/cli/run.py::
    cmd_serve`)."""
    calib = serve_calibration_batch(args, cfg)
    if calib is None:
        views = (4,) if cfg.head.panorama else ()
        size = cfg.vision.image_size
        calib = torch.randn((2, *views, size, size, 3),
                            generator=torch.Generator().manual_seed(
                                CALIB_SEED))
        margin, source = 1.25, "a synthetic batch (pass --calib-images " \
            "DIR for real-data calibration)"
    else:
        margin, source = 1.1, f"{calib.shape[0]} real images"
    return quantize_model(model, calib, margin, device, source)


def quantize_on_batch(model, batch: dict, device, source: str):
    """``evaluate --quant`` and ``predict --quant``: :func:`quantize_model`
    on the first `EVAL_CALIB_SAMPLES` samples of a real uint8 batch,
    margin `EVAL_CALIB_MARGIN` (`pigeon_tpu/cli/run.py:1070-1083`,
    `:1208-1215`)."""
    from pigeon_tpu_torch.data.image_ops import normalize_images

    pixels = torch.from_numpy(batch["inputs"][:EVAL_CALIB_SAMPLES])
    return quantize_model(model, normalize_images(pixels),
                          EVAL_CALIB_MARGIN, device,
                          f"{pixels.shape[0]} real {source} images")


def init_and_restore(args, model) -> None:
    """The weights of ``serve``, ``evaluate`` and ``predict``
    (`pigeon_tpu/cli/run.py::_init_and_restore`): the newest checkpoint
    under ``--checkpoint-dir/NAME`` (``strict``) if there is one, else
    ``--base`` overlaid on ``model``'s seeded values, else those."""
    from pigeon_tpu_torch.models.hf_import import load_base
    from pigeon_tpu_torch.train.checkpoints import restore_model

    ckpt_dir = os.path.join(args.checkpoint_dir, args.name)
    step = restore_model(ckpt_dir, model)
    if step is not None:
        logger.warning("restored checkpoint step %d from %s", step, ckpt_dir)
    elif args.base:
        load_base(model, args.base)
    else:
        logger.warning("weights: seeded initialisation (seed %d); no "
                       "checkpoint under %s and no --base", INIT_SEED,
                       ckpt_dir)


def build_model(args, quant: bool = False, route: str = None):
    """``(cells, cfg, model)``: the geocells, the preset sized to them and
    a bf16 `SuperGuessr` (f32 parameters, on the CPU) on ``route``, by
    default that of :func:`attn_impl`, or of :func:`quant_attn_impl` for
    a tower about to become int8, its weights from
    :func:`init_and_restore`."""
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr, init_weights

    route = route or (quant_attn_impl() if quant else attn_impl())
    forward_body = flash_fwd()
    cells = load_geocells(args)
    cfg = make_config(args)
    cfg = cfg.replace(head=dataclasses.replace(cfg.head,
                                               num_cells=len(cells)))
    model = init_weights(
        SuperGuessr(cfg.vision, cfg.head, dtype=torch.bfloat16,
                    attn_impl=route), INIT_SEED)
    logger.warning("attention route: %s (PIGEON_FLASH_FWD=%s)", route,
                   forward_body)
    init_and_restore(args, model)
    return cells, cfg, model


def default_batch(quant: bool) -> int:
    """The batch of ``evaluate`` and ``predict`` without ``--batch-size``:
    the JAX CLI's defaults by route (`pigeon_tpu/cli/run.py::
    _default_batch`), int8 48 on K8's and K7's routes and 24 elsewhere,
    bf16 56 on the ``flash_fused*`` routes and 32 elsewhere. They were
    tuned for the TPU; the port's own optimum on the card is not
    measured."""
    if quant:
        return 48 if quant_attn_impl() in ("fused", "block") else 24
    return 56 if _attn_name().startswith("flash_fused") else 32


def serving_refiner(args, num_cells: int, device):
    """``serve``'s refiner: the ``geoguessr`` preset with ``--hedge`` on
    :func:`load_refine_assets`' bank, or None without the assets (where
    ``--hedge`` stops the command)."""
    from pigeon_tpu_torch.train.evaluate import build_refiner, refiner_preset

    assets = load_refine_assets(args)
    if assets is None:
        if args.hedge:
            raise SystemExit("--hedge requires --prototypes/--embeddings/"
                             "--metadata (hedging applies to refined "
                             "guesses)")
        return None
    preset = dataclasses.replace(refiner_preset("geoguessr"),
                                 hedge=args.hedge)
    logger.warning("refinement enabled (topk=%d, hedge=%s, %d bank rows)",
                   preset.topk, args.hedge, len(assets[1]))
    return build_refiner(*assets, num_cells=num_cells, cfg=preset,
                         device=device)


def warm_and_serve(args, serve_fn, refine_fn, sample_shape, image_size: int,
                   panorama: bool, batch: int = 1,
                   block: bool = True) -> ThreadingHTTPServer:
    """Warm ``serve_fn`` (and the refiner) up at ``batch`` (kernel and
    decoder builds, first launches) before taking traffic, build and warm
    the `MicroBatcher` of ``--serve-batch`` N > 1, and start the HTTP
    server."""
    from PIL import Image

    from pigeon_tpu_torch.data import native_decode
    from pigeon_tpu_torch.serve import MicroBatcher, PredictionService, serve

    device = serve_fn.device
    logger.warning("image decode: %s", "native libjpeg, then PIL"
                   if native_decode.available() else "PIL")
    # PIL decodes what the native decoder cannot; loading its plugin
    # registry here keeps that cost out of the first request.
    Image.init()
    out = serve_fn(np.zeros((batch, *sample_shape), np.uint8))
    if refine_fn is not None:
        refine_fn(out["embedding"], out["pred_lla"], out["topk_cells"],
                  out["topk_probs"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    batcher = None
    if args.serve_batch > 1:
        batcher = MicroBatcher(serve_fn, refine_fn=refine_fn,
                               max_batch=args.serve_batch)
        batcher.warm(sample_shape, torch.uint8)
        logger.warning("micro-batching up to %d requests a forward "
                       "(buckets %s)", batcher.max_batch, batcher.buckets)
    logger.warning("warmup done")
    service = PredictionService(serve_fn, image_size=image_size,
                                panorama=panorama, refine_fn=refine_fn,
                                game_log=os.path.join("runs", "games.jsonl"),
                                batcher=batcher)
    return serve(service, host=args.host, port=args.port, block=block)


def start_server(args, block: bool = True) -> ThreadingHTTPServer:
    """Build the model (int8 with ``--quant``), serving forward and
    refiner on ``--device``, warm them up, and start the HTTP server;
    with ``--artifact``, :func:`start_artifact_server`."""
    from pigeon_tpu_torch.serve.server import make_serving_fn

    if args.artifact:
        return start_artifact_server(args, block=block)
    device = _device(args)
    cells, cfg, model = build_model(args, quant=args.quant)
    if args.quant:
        model = quantize_for_serving(args, cfg, model, device)
    serve_fn = make_serving_fn(model, cfg.head, cells, device)
    refine_fn = serving_refiner(args, len(cells), device)
    views = (4,) if cfg.head.panorama else ()
    size = cfg.vision.image_size
    return warm_and_serve(args, serve_fn, refine_fn, (*views, size, size, 3),
                          size, cfg.head.panorama, block=block)


def start_artifact_server(args, block: bool = True) -> ThreadingHTTPServer:
    """``serve --artifact DIR``: the artifact's program and weights on
    ``--device``, no model built (`pigeon_tpu/cli/run.py::
    _serve_artifact`), with the refiner of ``--prototypes/--embeddings/
    --metadata`` and ``--hedge``; warmed up before it takes traffic."""
    from pigeon_tpu_torch.serve.export import load_serving_artifact

    device = _device(args)
    try:
        serve_fn, manifest = load_serving_artifact(args.artifact, device)
    except ValueError as err:
        raise SystemExit(f"--artifact {args.artifact}: {err}") from None
    logger.warning("serving artifact %s: %d params, cells=%d, wire=%s, "
                   "platforms=%s", args.artifact, manifest["num_params"],
                   manifest["num_cells"], manifest["wire_dtype"],
                   manifest["platforms"])
    refine_fn = serving_refiner(args, manifest["num_cells"], device)
    size = manifest["image_size"]
    views = (4,) if manifest["panorama"] else ()
    batch = 1 if manifest["batch"] == "symbolic" else manifest["batch"]
    if batch != 1 and args.serve_batch > 1:
        raise SystemExit("--serve-batch needs an artifact exported with a "
                         "symbolic batch (export without --batch-size)")
    return warm_and_serve(args, serve_fn, refine_fn, (*views, size, size, 3),
                          size, manifest["panorama"], batch=batch,
                          block=block)


def cmd_export(args) -> int:
    """The serving artifact (`serve/export.py`;
    `pigeon_tpu/cli/run.py::cmd_export`): the model of
    :func:`init_and_restore` on the plain route (the JAX artifact's XLA
    attention), int8 under ``--quant`` (calibrated as ``serve --quant``:
    ``--calib-images`` at margin 1.1, else a synthetic batch at 1.25),
    traced with a symbolic batch or ``--batch-size``'s, for
    ``--platforms``, into ``--output`` (default
    ``--checkpoint-dir/NAME_artifact``)."""
    from pigeon_tpu_torch.serve.export import (
        check_platforms,
        export_serving_artifact,
    )

    try:
        platforms = check_platforms(args.platforms.split(","))
    except ValueError as err:
        raise SystemExit(f"--platforms {args.platforms}: {err}") from None
    cells, cfg, model = build_model(args, quant=args.quant, route="plain")
    if args.quant:
        # Calibrated on --device; the trace itself runs on the CPU.
        model = quantize_for_serving(args, cfg, model, _device(args))
    out_dir = args.output or os.path.join(args.checkpoint_dir,
                                          f"{args.name}_artifact")
    manifest = export_serving_artifact(
        model, cfg.head, cells, out_dir, image_size=cfg.vision.image_size,
        panorama=cfg.head.panorama, batch=args.batch_size,
        platforms=platforms)
    logger.warning("exported %s: %d params, %d cells, batch=%s, "
                   "platforms=%s; serve it with: pigeon_tpu_torch serve "
                   "--artifact %s", out_dir, manifest["num_params"],
                   manifest["num_cells"], manifest["batch"],
                   manifest["platforms"], out_dir)
    return 0


def cmd_serve(args) -> int:
    start_server(args, block=True)
    return 0


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    return device


def run_mesh(args):
    """``(device, mesh)`` of this rank: the process group `torchrun` (or
    the caller) set up and the ``(world / --tp, --tp)`` mesh over it
    (`train/mesh.py`); without either, the one-process mesh on
    ``--device``. Made once a command; a ``--tp`` that does not divide
    the ranks stops it."""
    from pigeon_tpu_torch.train.mesh import (
        UNSHARDED_ROUTES,
        create_mesh,
        init_distributed,
    )

    if getattr(args, "_run_mesh", None) is None:
        device = init_distributed(_device(args))
        try:
            mesh = create_mesh(args.tp, device.type)
        except ValueError as e:
            raise SystemExit(f"--tp {args.tp}: {e} (start the ranks with "
                             "torchrun --nproc-per-node N)") from None
        route = quant_attn_impl() if args.quant else attn_impl()
        if mesh.tp > 1 and route in UNSHARDED_ROUTES:
            raise SystemExit(
                f"--tp {args.tp}: route {route!r} (kernels K5/K6/K7/K9) has "
                "no sharded hosting, as in the JAX package: under --tp run "
                "PIGEON_ATTN_IMPL=flash_fused, flash or xla")
        if mesh.device_mesh is not None:
            logger.warning("rank %d of %d on %s: mesh %s",
                           torch.distributed.get_rank(),
                           torch.distributed.get_world_size(), device,
                           mesh.shape)
        args._run_mesh = (device, mesh)
    return args._run_mesh


def shard_model(model, mesh, device):
    """``model`` (on ``device``) sharded over ``mesh``'s model axis
    (`train.mesh.tensor_parallel`); a route or width the axis cannot run
    stops the command."""
    from pigeon_tpu_torch.train.mesh import tensor_parallel

    try:
        tensor_parallel(model, mesh, device)
    except ValueError as e:
        raise SystemExit(f"--tp {mesh.tp}: {e}") from None
    return model


def parallel_state(model, optimizer_fn, mesh, device, fsdp: bool):
    """`train.train_loop.create_train_state` over ``mesh``; a route or
    width the model axis cannot run stops the command."""
    from pigeon_tpu_torch.train.train_loop import create_train_state

    try:
        return create_train_state(model, optimizer_fn, mesh, device, fsdp)
    except ValueError as e:
        raise SystemExit(f"--tp {mesh.tp}: {e}") from None


def global_batch(args, default: int, mesh) -> int:
    """``--batch-size`` (else ``default``), the global batch; one the
    data axis does not divide stops the command."""
    from pigeon_tpu_torch.train.multihost import check_global_batch

    batch = args.batch_size or default
    try:
        check_global_batch(batch, mesh)
    except ValueError as e:
        raise SystemExit(f"--batch-size: {e}") from None
    return batch


class Finetune(NamedTuple):
    """What `build_finetune` sets up for a finetuning run."""

    cfg: object            # PigeonConfig, head sized to the geocells
    device: torch.device
    geocells: torch.Tensor  # (C, 2) on the device
    state: object          # TrainState, restored with --resume
    train_batches: Callable  # epoch -> that epoch's training batches
    eval_batches: Callable   # () -> the val split's batches in order
    checkpoint_dir: str


def _augment_frame(df, args, source: str):
    """``df`` through the GeoAugmentor of the sources under ``--aux-dir``
    (`geocell.augmentor.build_augmentor`), or ``df`` as it is where there
    are none (`pigeon_tpu/cli/run.py::_augment_frame`)."""
    from pigeon_tpu_torch.geocell.augmentor import build_augmentor

    aug = build_augmentor(args.aux_dir)
    if aug is None:
        logger.warning("no auxiliary data under %s: %s is not augmented "
                       "(fetch it with scripts/get_auxiliary_data.sh, or "
                       "pass --aux-dir)", args.aux_dir, source)
        return df
    return aug.augment(df)


def _maybe_augment_multitask(df, args, source: str):
    """Under ``-m``, a metadata frame without the multi-task columns goes
    through the GeoAugmentor, as the reference's finetune dataset build
    does (`pigeon_tpu/cli/run.py::_maybe_augment_multitask`); a column
    still missing after it stops the command."""
    from pigeon_tpu_torch.data.pipeline import MT_COLUMNS

    if not args.multitask:
        return df
    missing = [c for c in (*MT_COLUMNS, "climate_zone_idx")
               if c not in df.columns]
    if not missing:
        return df
    logger.warning("%s lacks multi-task columns %s: running the "
                   "GeoAugmentor", source, missing)
    df = _augment_frame(df, args, source)
    still = [c for c in missing if c not in df.columns]
    if still:
        # -m without the label columns would crash inside the loss.
        raise SystemExit(
            f"--multitask needs columns {still} that {source} lacks and "
            f"augmentation could not supply from --aux-dir={args.aux_dir} "
            "(fetch sources with scripts/get_auxiliary_data.sh, or run "
            "`python -m pigeon_tpu_torch.cli.run augment` with the needed "
            "rasters), or drop -m")
    return df


def _split_frames(args):
    """Train and val frames of ``--metadata``, a comma-separated list of
    CSVs (`pigeon_tpu/cli/run.py::_finetune_on_pixels`): each file
    augmented under ``-m`` where it lacks the multi-task columns, the
    train rows of every file concatenated, the val rows from the first
    (by the ``selection`` column; a file without one is all train, and
    the first is also all val)."""
    import pandas as pd

    if args.metadata is None:
        raise SystemExit("--metadata CSV is required for this command")
    paths = args.metadata.split(",")
    train, val = [], None
    for i, path in enumerate(paths):
        df = _maybe_augment_multitask(pd.read_csv(path), args, path)
        if i == 0:
            val = (df[df["selection"] == "val"] if "selection" in df.columns
                   else df).reset_index(drop=True)
        if "selection" in df.columns:
            df = df[df["selection"] == "train"]
        train.append(df)
    train = pd.concat(train, ignore_index=True)
    if len(paths) > 1:
        logger.warning("training on %d concatenated datasets (%d rows); "
                       "val from %s", len(paths), len(train), paths[0])
    return train, val


def cmd_augment(args) -> int:
    """Offline metadata enrichment (`pigeon_tpu/cli/run.py::cmd_augment`):
    ``--metadata`` (with ``lng`` and ``lat``) through the GeoAugmentor
    of ``--aux-dir``'s sources, written to ``--output`` or
    ``<metadata>_augmented.csv``; a missing source skips its columns."""
    import pandas as pd

    if args.metadata is None:
        raise SystemExit("--metadata CSV is required")
    df = pd.read_csv(args.metadata)
    if not {"lng", "lat"} <= set(df.columns):
        raise SystemExit(f"{args.metadata} needs lng/lat columns")
    before = set(df.columns)
    out_df = _augment_frame(df, args, args.metadata)
    out = args.output or (os.path.splitext(args.metadata)[0]
                          + "_augmented.csv")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    out_df.to_csv(out, index=False)
    logger.warning("wrote %s (+%s)", out,
                   sorted(set(out_df.columns) - before) or "no columns")
    return 0


def cmd_geocells(args) -> int:
    """Semantic geocells from training metadata
    (`pigeon_tpu/cli/run.py::cmd_geocells`): ``--metadata``'s train rows
    seeded one cell per admin-2 area of ``--load`` (a GeoJSON; without
    it, one area), balanced to the preset's cell sizes on the OPTICS
    ladder of PIGEON (StreetView), or of PIGEOTTO under ``--yfcc`` or
    ``--landmarks``, written to ``--output`` (default
    ``data/geocells.csv``). Host work only."""
    import pandas as pd

    from pigeon_tpu_torch.geocell.boundaries import BoundarySet
    from pigeon_tpu_torch.geocell.cells import (
        OPTICS_PARAMS_PLANET,
        OPTICS_PARAMS_STREETVIEW,
    )
    from pigeon_tpu_torch.geocell.creation import GeocellCreator

    if args.metadata is None:
        raise SystemExit("--metadata CSV is required")
    df = pd.read_csv(args.metadata)
    cfg = make_config(args)
    admin2 = BoundarySet.from_geojson(args.load) if args.load else None
    creator = GeocellCreator(df, admin_2=admin2)
    out = args.output or "data/geocells.csv"
    ladder = (OPTICS_PARAMS_PLANET if (args.yfcc or args.landmarks)
              else OPTICS_PARAMS_STREETVIEW)
    cells = creator.generate(cfg.geocell.min_cell_size,
                             cfg.geocell.max_cell_size,
                             optics_params=ladder, output_csv=out)
    logger.warning("wrote %d geocells to %s", len(cells), out)
    return 0


def cmd_prototypes(args) -> int:
    """The prototype table of each ``--metadata`` file
    (`pigeon_tpu/cli/run.py::cmd_prototypes`): OPTICS clusters of each
    geocell's train rows, one row per cluster, to ``--output``.
    ``--metadata`` and ``--output`` pair comma-separated lists (the
    ``--landmarks`` convention: each file's member ``indices`` are its
    own train rows). A file without ``geocell_idx`` is labelled from
    ``--geocells`` (covering cell, else the nearest centroid). Host work
    only."""
    import pandas as pd

    from pigeon_tpu_torch.geocell.prototypes import build_prototypes

    if args.metadata is None:
        raise SystemExit("--metadata CSV is required")
    metas = args.metadata.split(",")
    if args.output:
        outs = args.output.split(",")
    elif len(metas) == 1:
        outs = ["data/prototypes.csv"]
    else:
        outs = [f"data/prototypes_{i}.csv" for i in range(len(metas))]
    if len(outs) != len(metas):
        raise SystemExit("--output must list one CSV per --metadata "
                         "entry (comma-separated, --landmarks pairing)")

    assigner = None
    for meta_path, out in zip(metas, outs):
        df = pd.read_csv(meta_path)
        if "geocell_idx" not in df.columns:
            if args.geocells is None:
                raise SystemExit(
                    f"{meta_path} has no geocell_idx column — pass "
                    "--geocells CSV to assign cells")
            from pigeon_tpu_torch.geocell.assignment import CellAssigner

            if assigner is None:
                assigner = CellAssigner.from_csv(args.geocells)
            df = df.copy()
            df["geocell_idx"] = assigner.assign(
                df[["lng", "lat"]].to_numpy(np.float64))
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        table = build_prototypes(df, output_csv=out)
        logger.warning("wrote %d prototype clusters across %d cells to "
                       "%s", len(table),
                       table["geocell_idx"].nunique() if len(table) else 0,
                       out)
    return 0


def build_finetune(args) -> Finetune:
    """The model, optimizer, datasets and checkpoint directory of a
    ``finetune`` run on pixels: the preset at full width (``--tiny``:
    the smoke-test config), a seeded initialisation with ``--base``
    overlaid (before ``--resume``), every encoder layer but the last
    frozen, the tower on the route of :func:`attn_impl` and
    remat'd under :func:`remat_policy`."""
    from pigeon_tpu_torch.data.pipeline import TabularImageDataset
    from pigeon_tpu_torch.models.hf_import import load_base
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.checkpoints import (
        latest_step,
        restore_checkpoint,
    )
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.multihost import (
        iter_eval_batches,
        iter_host_batches,
    )
    from pigeon_tpu_torch.train.train_loop import adamw

    device, mesh = run_mesh(args)
    if args.embeddings:
        return build_head_finetune(args, device)
    route = attn_impl()
    forward_body = flash_fwd()
    remat = remat_policy()
    cells = load_geocells(args)
    cfg = make_config(args)
    cfg = cfg.replace(head=dataclasses.replace(cfg.head,
                                               num_cells=len(cells)))
    train_df, val_df = _split_frames(args)
    tcfg = cfg.train
    model = init_weights(build_finetune_model(cfg, attn_impl=route,
                                              remat=remat),
                         tcfg.seed).to(device)
    logger.warning("attention route: %s (PIGEON_FLASH_FWD=%s), remat %s",
                   route, forward_body, remat)
    ckpt_dir = os.path.join(args.checkpoint_dir, args.name)
    if args.base:
        load_base(model, args.base)
    state = parallel_state(
        model, lambda params: adamw(params, tcfg.learning_rate), mesh,
        device, args.fsdp)
    if args.resume and latest_step(ckpt_dir) is not None:
        restore_checkpoint(ckpt_dir, state)
        logger.warning("resumed from step %d", state.step)
    kw = dict(image_dir=args.images, image_size=cfg.vision.image_size,
              panorama=cfg.head.panorama)
    train = sample_dataset(TabularImageDataset(train_df, **kw), args.sample)
    val = TabularImageDataset(val_df, **kw)
    batch = global_batch(args, tcfg.batch_size_per_device, mesh)
    if mesh.device_mesh is None:
        # Shuffled by the epoch's seed, the tail that does not fill a
        # batch dropped; val in order, whole.
        train_batches = lambda epoch: iter_batches(  # noqa: E731
            train, batch, shuffle=True, seed=epoch, drop_last=True)
        eval_batches = lambda: iter_batches(val, batch)  # noqa: E731
    else:
        # The same global batches, each rank decoding its rows.
        train_batches = lambda epoch: iter_host_batches(  # noqa: E731
            train, batch, mesh, shuffle=True, seed=epoch, drop_last=True)
        eval_batches = lambda: iter_eval_batches(  # noqa: E731
            val, batch, mesh)
    return Finetune(
        cfg=cfg, device=device,
        geocells=torch.as_tensor(cells, device=device), state=state,
        train_batches=train_batches, eval_batches=eval_batches,
        checkpoint_dir=ckpt_dir)


def build_head_finetune(args, device) -> Finetune:
    """``finetune --embeddings``: the geocell head alone, in f32, trained
    on the ``train`` and ``val`` banks under ``--embeddings``
    (`pigeon_tpu/cli/run.py::_finetune_on_embeddings`). The splits'
    rows come from ``--metadata``'s ``selection`` column (without one,
    both are the whole frame); a panorama bank ``(N, 4, D)`` is averaged
    over its views for a single-image head; the head's input width is the
    bank's. The JAX CLI ignores ``--base``, ``--resume`` and ``--sample``
    here, and its loss fails on ``-m`` (the batches carry no multi-task
    labels): the port stops on each."""
    import pandas as pd

    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.mesh import shard_batch
    from pigeon_tpu_torch.train.modes import build_embedding_model
    from pigeon_tpu_torch.train.multihost import local_eval_batches
    from pigeon_tpu_torch.train.train_loop import adamw

    for flag, given, why in (
            ("--base", args.base, "the head trains from its seeded "
             "initialisation"),
            ("--resume", args.resume, "the head trains from its seeded "
             "initialisation"),
            ("--multitask", args.multitask, "its batches carry no "
             "multi-task labels"),
            ("--sample", args.sample, "sample the rows when embedding "
             "them (embed -s)")):
        if given:
            raise SystemExit(f"finetune --embeddings does not take {flag}: "
                             f"{why}")
    if args.metadata is None:
        raise SystemExit("--metadata CSV is required for this command")
    cells = load_geocells(args)
    cfg = make_config(args)
    meta = pd.read_csv(args.metadata)
    splits = {}
    for split in ("train", "val"):
        rows = meta[meta["selection"] == split].reset_index(drop=True) \
            if "selection" in meta.columns else meta
        emb = load_embeddings(args.embeddings, split)
        if emb.ndim == 3 and not cfg.head.panorama:
            emb = emb.mean(1)
        if len(emb) != len(rows):
            raise SystemExit(f"{args.embeddings}: {len(emb)} {split} "
                             f"embeddings vs {len(rows)} {split} rows in "
                             f"{args.metadata}")
        splits[split] = (emb.astype(np.float32), rows)
    cfg = cfg.replace(head=dataclasses.replace(
        cfg.head, num_cells=len(cells),
        embed_dim=splits["train"][0].shape[-1]))
    tcfg = cfg.train
    model = init_weights(build_embedding_model(cfg), tcfg.seed).to(device)
    logger.warning("head-only training on %s: %d train and %d val "
                   "embeddings of width %d", args.embeddings,
                   len(splits["train"][0]), len(splits["val"][0]),
                   cfg.head.embed_dim)
    _, mesh = run_mesh(args)
    batch = global_batch(args, tcfg.batch_size_per_device, mesh)
    state = parallel_state(
        model, lambda params: adamw(params, tcfg.learning_rate), mesh,
        device, args.fsdp)

    def train_batches(epoch):
        for b in embedding_batches(*splits["train"], batch,
                                   shuffle_seed=epoch):
            yield b if mesh.device_mesh is None else shard_batch(b, mesh)

    def eval_batches():
        batches = embedding_batches(*splits["val"], batch)
        return (batches if mesh.device_mesh is None
                else local_eval_batches(batches, mesh))

    return Finetune(
        cfg=cfg, device=device,
        geocells=torch.as_tensor(cells, device=device), state=state,
        # Full batches only, in training and in evaluation (the JAX CLI's).
        train_batches=train_batches, eval_batches=eval_batches,
        checkpoint_dir=os.path.join(args.checkpoint_dir, args.name))


def train_finetune(run: Finetune, num_epochs: int, name: str,
                   profile_dir: Optional[str] = None) -> list:
    """Train ``run`` for ``num_epochs`` epochs, each with an eval pass;
    checkpoints go to ``run.checkpoint_dir`` and scalars to
    ``runs/NAME/metrics.jsonl``; ``profile_dir``: a trace of steps 4 to
    14 (`train.profiling.ProfilerWindow`). Returns the per-epoch eval
    metrics."""
    from pigeon_tpu_torch.train.loop import train_model
    from pigeon_tpu_torch.train.train_loop import (
        batch_to_device,
        make_eval_step,
        make_train_step,
    )

    head = run.cfg.head
    _, history = train_model(
        run.state, make_train_step(head, run.geocells),
        make_eval_step(head, run.geocells), run.train_batches,
        run.eval_batches, num_epochs=num_epochs,
        batch_to_device=functools.partial(batch_to_device,
                                          device=run.device),
        checkpoint_dir=run.checkpoint_dir,
        log_dir=os.path.join("runs", name), profile_dir=profile_dir,
        early_stopping_patience=run.cfg.train.early_stopping_patience)
    return history


def cmd_finetune(args) -> int:
    run = build_finetune(args)
    history = train_finetune(run, args.epochs or run.cfg.train.num_epochs,
                             args.name, profile_dir=args.profile)
    logger.warning("final metrics: %s", history[-1] if history else {})
    return 0


def eval_datasets(args, cfg) -> dict:
    """``evaluate``'s datasets by name: the registry's benchmarks ``-l``
    names (default ``im2gps3k``), or with ``-t`` and no ``-l`` the
    ``test`` rows of ``--metadata`` (comma-separated files
    concatenate)."""
    import pandas as pd

    from pigeon_tpu_torch.data.pipeline import (
        BenchmarkDataset,
        TabularImageDataset,
    )

    size = cfg.vision.image_size
    if args.load is None and args.test:
        if args.metadata is None:
            raise SystemExit("evaluate -t needs --metadata")
        frames = [pd.read_csv(m) for m in args.metadata.split(",")]
        frames = [f[f["selection"] == "test"] if "selection" in f.columns
                  else f for f in frames]
        return {"test": TabularImageDataset(
            pd.concat(frames, ignore_index=True), args.images,
            image_size=size, panorama=cfg.head.panorama)}
    registry = args.benchmarks or cfg.paths.benchmark_registry
    return {name: BenchmarkDataset(name, registry, image_size=size)
            for name in (args.load or "im2gps3k").split(",")}


class Evaluation(NamedTuple):
    """What `build_evaluation` sets up for an ``evaluate`` run."""

    model: torch.nn.Module  # int8 tower with --quant, on the device
    datasets: dict         # benchmark name -> dataset
    refiners: dict         # benchmark name -> refine_fn, or None
    eval_step: object      # make_eval_step's, EVAL_NUM_CANDIDATES wide
    to_device: object      # host batch -> device batch
    batch_size: int
    scaler: object         # RegressionScaler, or None
    country_index: object  # CountryIndex, or None
    mesh: object = None    # train.mesh.Mesh: each rank a slice of a batch


def build_evaluation(args) -> Evaluation:
    """The model (calibrated int8 with ``--quant``, on the first batch of
    the first dataset), datasets, refiners (the preset of each
    benchmark's family, where ``--prototypes/--embeddings/--metadata``
    are given), eval step, scaler and country index of an ``evaluate``
    run on ``--device``; over a mesh the model is sharded after the
    calibration, which every rank runs whole."""
    from pigeon_tpu_torch.train.evaluate import (
        EVAL_NUM_CANDIDATES,
        build_refiner,
        refiner_preset,
    )
    from pigeon_tpu_torch.train.metrics import CountryIndex, RegressionScaler
    from pigeon_tpu_torch.train.train_loop import (
        batch_to_device,
        make_eval_step,
    )

    device, mesh = run_mesh(args)
    if args.zeroshot and args.quant:
        raise SystemExit("--zeroshot and --quant are exclusive (the int8 "
                         "path quantizes the SuperGuessr tower)")
    if args.zeroshot:
        cells = load_geocells(args)
        cfg = make_config(args)
        model = None
        eval_step = build_zeroshot_eval_step(args, cfg, cells, device)
    else:
        cells, cfg, model = build_model(args, quant=args.quant)
        eval_step = make_eval_step(
            cfg.head, torch.as_tensor(cells, device=device),
            num_candidates=EVAL_NUM_CANDIDATES)
    datasets = eval_datasets(args, cfg)
    assets = load_refine_assets(args)
    if assets is not None and args.zeroshot:
        logger.warning("--zeroshot skips refinement: the prototype bank "
                       "holds vision-tower embeddings, zero-shot images "
                       "live in the CLIP projection space")
        assets = None
    scaler = RegressionScaler.load(args.scaler) if args.scaler else None
    countries = CountryIndex(args.countries) if args.countries else None
    if args.quant:
        first = next(iter(datasets))
        with contextlib.closing(iter_batches(
                datasets[first], min(EVAL_CALIB_SAMPLES, args.batch_size
                                     or EVAL_CALIB_SAMPLES))) as batches:
            model = quantize_on_batch(model, next(batches), device, first)
    if model is not None:
        model = shard_model(model.to(device), mesh, device)
    return Evaluation(
        model=model, datasets=datasets,
        refiners={name: None if assets is None else build_refiner(
            *assets, num_cells=len(cells), cfg=refiner_preset(name),
            device=device) for name in datasets},
        eval_step=eval_step,
        to_device=functools.partial(batch_to_device, device=device),
        batch_size=args.batch_size or default_batch(args.quant),
        scaler=scaler, country_index=countries, mesh=mesh)


def build_clip_model(cfg, tokenizer, device, remat: str = "none"):
    """A bf16 `CLIPModel` (f32 parameters) on the route of
    :func:`attn_impl` (its vision tower; the text tower's causal mask
    takes the plain path), with the tokenizer's EOS id, seeded, on
    ``device``. An EOS id outside the text vocabulary stops the
    command."""
    from pigeon_tpu_torch.models.clip import CLIPModel
    from pigeon_tpu_torch.models.super_guessr import init_weights

    eos = tokenizer.eos_id
    if eos >= cfg.text.vocab_size:
        raise SystemExit(f"tokenizer eos id {eos} exceeds the text vocab "
                         f"({cfg.text.vocab_size}); use matching vocab "
                         "assets")
    route = attn_impl()
    forward_body = flash_fwd()
    model = init_weights(CLIPModel(cfg.vision, cfg.text,
                                   dtype=torch.bfloat16, eos_token_id=eos,
                                   attn_impl=route, remat=remat),
                         cfg.train.pretrain_seed)
    logger.warning("CLIP model, attention route: %s (PIGEON_FLASH_FWD=%s), "
                   "remat %s", route, forward_body, remat)
    return model.to(device)


def build_zeroshot_eval_step(args, cfg, cells, device):
    """``evaluate --zeroshot``'s eval step
    (`pigeon_tpu/cli/run.py::_build_zeroshot_eval_step`): a `CLIPModel`
    (``-b``: a full HF CLIP state dict overlaid), one prompt a geocell
    of ``--geocells`` tokenized at ``min(max_position_embeddings, 77)``
    (the tokenizer truncates and keeps the EOS), the prompts' text
    embeddings, and the cosine classifier over them."""
    from pigeon_tpu_torch.data.tokenizer import load_tokenizer
    from pigeon_tpu_torch.models.hf_import import clip_state, merge_state
    from pigeon_tpu_torch.models.zeroshot import (
        embed_prompts,
        geocell_prompts,
        make_zero_shot_eval_step,
    )
    from pigeon_tpu_torch.train.evaluate import EVAL_NUM_CANDIDATES

    max_tokens = min(cfg.text.max_position_embeddings, 77)
    tokenizer = load_tokenizer(context_len=max_tokens,
                               fallback_vocab_size=cfg.text.vocab_size)
    model = build_clip_model(cfg, tokenizer, "cpu")
    if args.base:
        state = torch.load(args.base, map_location="cpu", weights_only=True)
        merge_state(model, clip_state(state, cfg.vision.num_layers,
                                      cfg.text.num_layers))
        logger.warning("loaded full CLIP checkpoint %s", args.base)
    model = model.to(device)
    prompts = geocell_prompts(_read_csv(args.geocells))
    text_embeds = embed_prompts(model, tokenizer(prompts))
    logger.warning("zero-shot: %d geocell prompts embedded", len(prompts))
    return make_zero_shot_eval_step(model, text_embeds, cells,
                                    num_candidates=EVAL_NUM_CANDIDATES)


def run_evaluation(ev: Evaluation) -> dict:
    """Each dataset of ``ev`` through its model, refined by its refiner
    and scored by the full metric suite; the metrics by benchmark, also
    in the log. Over a mesh each data rank runs its rows of every batch
    and every rank scores the gathered rows."""
    from pigeon_tpu_torch.train.evaluate import evaluate_benchmark
    from pigeon_tpu_torch.train.multihost import iter_eval_batches

    results = {}
    for name, dataset in ev.datasets.items():
        batches = (iter_batches(dataset, ev.batch_size)
                   if ev.mesh is None or ev.mesh.device_mesh is None
                   else iter_eval_batches(dataset, ev.batch_size, ev.mesh))
        results[name] = evaluate_benchmark(
            ev.eval_step, ev.model, batches, ev.to_device,
            refine_fn=ev.refiners[name], scaler=ev.scaler,
            country_index=ev.country_index, mesh=ev.mesh)
        logger.warning("%s: %s", name, results[name])
    return results


def cmd_evaluate(args) -> int:
    """`run_evaluation` of `build_evaluation`'s run; the metrics by
    benchmark go to ``--output`` (JSON), written by rank 0."""
    from pigeon_tpu_torch.train.multihost import is_primary

    results = run_evaluation(build_evaluation(args))
    if args.output and is_primary():
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return 0


def predict_images(args, panorama: bool):
    """``(frame, names)``: the rows ``predict`` reads and the name of each
    in its CSV. ``-l CSV`` gives metadata rows (``image`` and, for a
    panorama, ``image_2..4``, relative to ``--images``); ``--images DIR``
    alone every image file under DIR, recursively, by path."""
    import pandas as pd

    if args.load:
        df = pd.read_csv(args.load)
        return df, df["image"].astype(str).tolist()
    if not args.images:
        raise SystemExit("predict needs --images DIR or -l CSV")
    names = sorted(p for p in glob.glob(os.path.join(args.images, "**"),
                                        recursive=True)
                   if p.lower().endswith(IMAGE_EXTS))
    if not names:
        raise SystemExit(f"no images under {args.images}")
    if panorama:
        raise SystemExit("--panorama predict needs -l CSV with "
                         "image..image_4 columns")
    return pd.DataFrame({"image": names}), names


def cmd_predict(args) -> int:
    """One CSV row per image (`PREDICT_COLUMNS`): the refined location and
    cell where refinement assets are given (the ``geoguessr`` preset for a
    panorama model, else ``im2gps3k``), else the argmax cell's; the top
    candidate's probability, unrefined. Each batch's results are read
    back after the next batch is enqueued. Over a mesh each data rank
    predicts its rows of every batch and rank 0 writes them all, in
    order."""
    import pandas as pd

    from pigeon_tpu_torch.data.pipeline import TabularImageDataset
    from pigeon_tpu_torch.serve.server import make_serving_fn
    from pigeon_tpu_torch.train.evaluate import build_refiner, refiner_preset
    from pigeon_tpu_torch.train.multihost import (
        gather_objects,
        is_primary,
        iter_eval_batches,
    )

    device, mesh = run_mesh(args)
    cells, cfg, model = build_model(args, quant=args.quant)
    df, names = predict_images(args, cfg.head.panorama)
    ds = TabularImageDataset(df, args.images if args.load else "",
                             image_size=cfg.vision.image_size,
                             panorama=cfg.head.panorama)
    batch_size = args.batch_size or default_batch(args.quant)
    if args.quant:
        # Every rank calibrates on the first global batch, whole.
        with contextlib.closing(iter_batches(ds, batch_size)) as first:
            model = quantize_on_batch(model, next(first), device, "predict")
    batches = (iter_batches(ds, batch_size) if mesh.device_mesh is None
               else iter_eval_batches(ds, batch_size, mesh))
    serve_fn = make_serving_fn(shard_model(model.to(device), mesh, device),
                               cfg.head, cells, device)
    refine_fn = None
    assets = load_refine_assets(args)
    if assets is not None:
        family = "geoguessr" if cfg.head.panorama else "im2gps3k"
        refine_fn = build_refiner(*assets, num_cells=len(cells),
                                  cfg=refiner_preset(family), device=device)
        logger.warning("refinement enabled (%s preset)", family)

    def enqueue(batch):
        """The batch's forward and refinement enqueued and the copies of
        its results to the host started; returns them, the batch's row
        index and an event that completes with the copies (None on the
        CPU)."""
        out = serve_fn(batch["inputs"])
        lla, cell = out["pred_lla"], out["topk_cells"][:, 0]
        if refine_fn is not None:
            refined = refine_fn(out["embedding"], out["pred_lla"],
                                out["topk_cells"], out["topk_probs"])
            lla, cell = refined["pred_lla"], refined["pred_cell"]
        host = [t.to("cpu", non_blocking=True)
                for t in (lla, cell, out["topk_probs"][:, 0])]
        copied = None
        if device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record()
        return host, batch.get("row_index"), copied

    results = []    # (row_index, lla, cell, prob) of each batch

    def emit(host, row_index, copied) -> None:
        if copied is not None:
            copied.synchronize()
        lla, cell, prob = (t.numpy() for t in host)
        if row_index is None:
            seen = sum(len(r[0]) for r in results)
            row_index = np.arange(seen, seen + len(cell))
        results.append((row_index, lla, cell, prob))

    prev = None
    for batch in batches:
        out = enqueue(batch)
        if prev is not None:
            emit(*prev)
        prev = out
    if prev is not None:
        emit(*prev)
    if not results:
        results.append((np.zeros(0, np.int64), np.zeros((0, 2)),
                        np.zeros(0, np.int64), np.zeros(0)))
    joined = [np.concatenate(part) for part in zip(*results)]
    if mesh.device_mesh is not None:
        gathered = gather_objects(joined, mesh.data_group)
        joined = [np.concatenate(part) for part in zip(*gathered)]
    row_index, lla, cell, prob = joined
    keep = row_index >= 0
    order = np.argsort(row_index[keep], kind="stable")
    row_index, lla, cell, prob = (a[keep][order] for a in joined)
    lla, prob = lla.astype(np.float64), prob.astype(np.float64)
    rows = [{"image": names[j], "lat": lla[i, 1], "lng": lla[i, 0],
             "geocell_idx": int(cell[i]), "top1_prob": prob[i]}
            for i, j in enumerate(row_index)]
    out_path = args.output or "predictions.csv"
    if is_primary():
        pd.DataFrame(rows, columns=list(PREDICT_COLUMNS)).to_csv(
            out_path, index=False)
        logger.warning("wrote %d predictions to %s", len(rows), out_path)
    return 0


def use_vit_embedder(args) -> bool:
    """``--embedder``, or with ``auto`` the reference's routing by run
    name: a name holding ``vit`` takes the generic ViT embedder
    (`pigeon_tpu/cli/run.py:755-763`); ``--model dinov2-g14-reg`` always
    does."""
    if getattr(args, "model", None) == DINOV2:
        if args.embedder == "clip":
            raise SystemExit(f"--model {DINOV2} is a ViT embedder, not "
                             "--embedder clip")
        return True
    if args.embedder != "auto":
        return args.embedder == "vit"
    return "vit" in (args.name or "").lower()


def build_embedder(args, cfg):
    """``embed``'s model: a bf16 `ClipEmbedder` (f32 parameters) on the
    route of :func:`attn_impl`, or of :func:`quant_attn_impl` for a tower
    about to become int8, or a `ViTEmbedder` (``--model dinov2-g14-reg``:
    DINOv2's variant, CLS pooling); seeded, then overlaid with ``--base``
    (an HF ``vision_model.*`` state dict, an HF ViT one for the ViT, an
    HF DINOv2 with registers one for DINOv2), as the JAX ``cmd_embed``
    reads it (`:781-791`)."""
    from pigeon_tpu_torch.config import dinov2_variant
    from pigeon_tpu_torch.models.embedder import ClipEmbedder
    from pigeon_tpu_torch.models.hf_import import (
        merge_state,
        vision_tower_state,
    )
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.models.vit_embedder import (
        ViTEmbedder,
        import_dinov2_params,
        import_vit_params,
    )

    vit = use_vit_embedder(args)
    dinov2 = getattr(args, "model", None) == DINOV2
    if vit and args.quant:
        raise SystemExit("embed --quant supports the CLIP embedder only "
                         "(the ViT tower has no quant twin)")
    route = quant_attn_impl() if args.quant else attn_impl()
    forward_body = flash_fwd()
    if dinov2:
        model = ViTEmbedder(cfg.vision, dtype=torch.bfloat16,
                            attn_impl=route, variant=dinov2_variant())
    else:
        model = (ViTEmbedder if vit else ClipEmbedder)(
            cfg.vision, dtype=torch.bfloat16, attn_impl=route)
    model = init_weights(model, INIT_SEED)
    logger.warning("%s embedder, attention route: %s (PIGEON_FLASH_FWD=%s)",
                   "DINOv2" if dinov2 else "ViT" if vit else "CLIP", route,
                   forward_body)
    if args.base:
        state = torch.load(args.base, map_location="cpu", weights_only=True)
        layers = cfg.vision.num_layers
        read = (import_dinov2_params if dinov2 else import_vit_params
                if vit else vision_tower_state)
        merge_state(model, read(state, layers))
        logger.warning("loaded vision tower from %s", args.base)
    return model


def embed_splits(args, cfg) -> dict:
    """``embed``'s non-empty splits of ``--metadata`` by name (``train``,
    ``val``, ``test`` by ``selection``; without the column each is the
    whole frame), each cut by ``--sample``."""
    import pandas as pd

    from pigeon_tpu_torch.data.pipeline import TabularImageDataset

    if args.metadata is None:
        raise SystemExit("--metadata CSV is required for this command")
    df = pd.read_csv(args.metadata)
    splits = {}
    for split in ("train", "val", "test"):
        rows = df[df["selection"] == split] if "selection" in df.columns \
            else df
        ds = sample_dataset(TabularImageDataset(
            rows, args.images, image_size=cfg.vision.image_size,
            panorama=cfg.head.panorama), args.sample)
        if len(ds):
            splits[split] = ds
    return splits


def cmd_embed(args) -> int:
    """Each split of :func:`embed_splits` through :func:`build_embedder`'s
    model on ``--device``, into ``{split}.npy`` and ``{split}_indices.npy``
    under ``--output`` (`train/embed.py`); with ``--sample`` also the
    sampled rows as ``metadata_sampled.csv``, the frame that matches the
    banks' row numbers. With ``--quant`` the tower is int8, calibrated on
    the first `EMBED_CALIB_SAMPLES` samples of the first split (margin
    1.0), and the batch defaults to :func:`default_batch`'s int8 one."""
    import pandas as pd

    from pigeon_tpu_torch.data.image_ops import normalize_images
    from pigeon_tpu_torch.train.embed import embed_splits_to_disk
    from pigeon_tpu_torch.train.multihost import is_primary

    device, mesh = run_mesh(args)
    cfg = make_config(args)
    model = build_embedder(args, cfg)
    out = args.output or args.embeddings or "data/embeddings"
    splits = embed_splits(args, cfg)
    if args.sample and is_primary():
        os.makedirs(out, exist_ok=True)
        sampled = os.path.join(out, "metadata_sampled.csv")
        pd.concat([d.df for d in splits.values()],
                  ignore_index=True).to_csv(sampled, index=False)
        logger.warning("--sample: wrote the sampled metadata to %s; use it "
                       "as --metadata against these embeddings", sampled)
    batch_size = args.batch_size or cfg.train.embed_batch_size_per_device
    if args.quant:
        if not splits:
            raise SystemExit("no non-empty split to calibrate --quant on")
        first = next(iter(splits.values()))
        with contextlib.closing(iter_batches(
                first, min(EMBED_CALIB_SAMPLES, len(first)))) as batches:
            pixels = torch.from_numpy(next(batches)["inputs"])
        if pixels.dim() == 5:                # panorama: fold the views
            pixels = pixels.reshape(-1, *pixels.shape[2:])
        model = quantize_model(model, normalize_images(pixels),
                               EVAL_CALIB_MARGIN, device,
                               f"{pixels.shape[0]} real images")
        batch_size = args.batch_size or default_batch(True)
    model = shard_model(model.to(device), mesh, device)
    embed_splits_to_disk(model, splits, out, batch_size, device, mesh)
    logger.warning("wrote embeddings for %s to %s (batch %d)",
                   sorted(splits), out, batch_size)
    return 0


def pretrain_batches(ds, tokenizer, batch_size: int, max_tokens: int,
                     device):
    """``epoch -> batches``: `PretrainDataset.batches` shuffled by the
    epoch's seed, as tensors on ``device`` (pixels f32, ids int64)."""

    def batches(epoch):
        for batch in ds.batches(tokenizer, batch_size, shuffle=True,
                                seed=epoch, max_tokens=max_tokens):
            yield {"pixel_values": torch.from_numpy(
                       batch["pixel_values"]).to(device),
                   "input_ids": torch.from_numpy(
                       batch["input_ids"]).long().to(device)}

    return batches


def cmd_pretrain(args) -> int:
    """Contrastive CLIP pretraining (`pigeon_tpu/cli/run.py::
    cmd_pretrain`): a `CLIPModel` (vision tower on :func:`attn_impl`'s
    route under :func:`remat_policy`) trained on ``--metadata``'s
    captioned images (`data/pretrain.py`; ``--yfcc`` or ``--landmarks``
    the YFCC captions, ``-a`` the auxiliary sentences) by
    `train.modes.pretrain_optimizer` (``--batch-size`` a micro-batch,
    default the preset's 32, 8 of them an update), checkpoints to
    ``--checkpoint-dir/NAME_pretrained``; the in-batch retrieval
    accuracy is logged before and after. A tokenizer vocabulary larger
    than the text config's stops the command."""
    import pandas as pd

    from pigeon_tpu_torch.data.pretrain import PretrainDataset
    from pigeon_tpu_torch.data.tokenizer import load_tokenizer
    from pigeon_tpu_torch.train.mesh import batch_slice
    from pigeon_tpu_torch.train.modes import (
        make_pretrain_step,
        make_retrieval_probe,
        pretrain,
        pretrain_optimizer,
        retrieval_accuracy,
    )

    if args.metadata is None:
        raise SystemExit("--metadata CSV is required for this command")
    device, mesh = run_mesh(args)
    cfg = make_config(args)
    # The hash fallback is sized to the text vocabulary; a real CLIP
    # vocabulary must fit it (a wrapped id would wrap the EOS too).
    tokenizer = load_tokenizer(fallback_vocab_size=cfg.text.vocab_size)
    if tokenizer.vocab_size > cfg.text.vocab_size:
        raise SystemExit(f"tokenizer vocab ({tokenizer.vocab_size}) exceeds "
                         f"the configured text vocab ({cfg.text.vocab_size});"
                         " use a matching config or vocab assets")
    model = build_clip_model(cfg, tokenizer, device, remat=remat_policy())
    ds = PretrainDataset(pd.read_csv(args.metadata), args.images,
                         variant=("yfcc" if (args.yfcc or args.landmarks)
                                  else "streetview"),
                         auxiliary=args.auxiliary,
                         image_size=cfg.vision.image_size)
    batch_size = global_batch(args, cfg.train.pretrain_batch_size_per_device,
                              mesh)
    steps_per_epoch = max(len(ds) // batch_size, 1)
    epochs = args.epochs or cfg.train.pretrain_num_epochs
    state = parallel_state(
        model, lambda params: pretrain_optimizer(
            params, cfg, steps_per_epoch * epochs), mesh, device, args.fsdp)
    global_batches = pretrain_batches(
        ds, tokenizer, batch_size,
        min(cfg.text.max_position_embeddings, 77), device)

    def batches(epoch):
        # Each rank its rows of the global batch (the negatives are the
        # global batch's again in the loss, `train.modes`).
        for b in global_batches(epoch):
            rows = batch_slice(len(b["input_ids"]), mesh)
            yield {k: v[rows] for k, v in b.items()}

    probe = make_retrieval_probe(state.model)

    def probe_batches(limit=4):
        for b in itertools.islice(batches(0), limit):
            yield b["pixel_values"], b["input_ids"]

    acc_before = retrieval_accuracy(probe, probe_batches())
    ckpt = os.path.join(args.checkpoint_dir, f"{args.name}_pretrained")
    logger.warning("pretraining on %d items: %d micro-batches of %d an "
                   "epoch, %d epochs, %d micro-batches an update", len(ds),
                   steps_per_epoch, batch_size, epochs,
                   cfg.train.pretrain_grad_accum_steps)
    state = pretrain(state, make_pretrain_step(), batches, epochs,
                     checkpoint_dir=ckpt,
                     save_steps=cfg.train.pretrain_save_steps)
    acc_after = retrieval_accuracy(probe, probe_batches())
    logger.warning("pretraining done at step %d: retrieval accuracy %.3f -> "
                   "%.3f", state.step, acc_before, acc_after)
    return 0


COMMANDS = {"serve": cmd_serve, "finetune": cmd_finetune,
            "evaluate": cmd_evaluate, "predict": cmd_predict,
            "embed": cmd_embed, "augment": cmd_augment,
            "export": cmd_export, "pretrain": cmd_pretrain,
            "geocells": cmd_geocells, "prototypes": cmd_prototypes}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.model == DINOV2 and args.function != "embed":
        raise SystemExit(f"--model {DINOV2} is an embedder: embed only")
    if args.function in MESH_COMMANDS:
        run_mesh(args)
    elif args.tp > 1 or args.fsdp:
        raise SystemExit(f"{args.function} runs on one card, as in the JAX "
                         f"CLI: it takes no --tp {args.tp}"
                         f"{' or --fsdp' if args.fsdp else ''}")
    return COMMANDS[args.function](args)


if __name__ == "__main__":
    sys.exit(main())
