"""CLI of the port: the ``serve`` and ``finetune`` subcommands.

Counterpart of `pigeon_tpu/cli/run.py::cmd_serve` and `cmd_finetune` (on
pixels), with their flags for these paths. Models are built in bf16 with
f32 parameters, on the attention route that ``PIGEON_ATTN_IMPL`` names in
the JAX package's words (:func:`attn_impl`; ``PIGEON_QUANT_ATTN_IMPL``
for ``serve --quant``, :func:`quant_attn_impl`): by default
``flash_fused``, kernel K1 (and K2 in the backward); ``PIGEON_FLASH_FWD``
picks the body of K3 where it runs (:func:`flash_fwd`).
``serve`` answers with a seeded initialisation (restoring a trained
checkpoint into it is not ported yet); ``serve --quant`` first makes its
tower int8: the weights quantized per output channel, the activation
scales calibrated by one dynamic forward (attention through kernel K3)
over ``--calib-images`` or a seeded synthetic batch; requests then run
every layer's attention through kernel K8. ``finetune`` trains from a seeded
initialisation, evaluates each epoch, keeps the best checkpoint under
``--checkpoint-dir/NAME`` and continues from it with ``--resume``.
Geocell, prototype and serving metadata CSVs are read with the stdlib
``csv`` module, training metadata with pandas, embeddings with numpy.

Usage:
    python -m pigeon_tpu_torch.cli.run serve pigeon --panorama -m \
        --heading --geocells data/geocells.csv [--prototypes P.csv \
        --embeddings DIR --metadata META.csv [--hedge]] \
        [--quant [--calib-images DIR]]
    python -m pigeon_tpu_torch.cli.run finetune myrun --metadata M.csv \
        --images DIR --geocells C.csv --panorama -m --heading \
        [--batch-size N] [--epochs N] [--resume]
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import functools
import glob
import logging
import os
import sys
from http.server import ThreadingHTTPServer
from typing import NamedTuple

import numpy as np
import torch

from pigeon_tpu_torch.config import (
    VisionConfig,
    pigeon_config,
    pigeotto_config,
)

logger = logging.getLogger("pigeon_tpu_torch.cli")

#: Seed of the initial weights (the JAX CLI initialises from PRNGKey(0)).
INIT_SEED = 0
#: Seed of the synthetic calibration batch of ``serve --quant`` without
#: ``--calib-images`` (the JAX CLI draws it from PRNGKey(3)).
CALIB_SEED = 3
#: At most this many ``--calib-images`` are read (`run.py:1408-1442`).
MAX_CALIB_IMAGES = 32

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pigeon_tpu_torch",
        description="PIGEON geolocation in PyTorch on an NVIDIA GPU.")
    p.add_argument("function", choices=["serve", "finetune"],
                   help="operation to run")
    p.add_argument("name", nargs="?", default="pigeon", help="run name")
    p.add_argument("--geocells", default=None, help="geocell CSV path")
    p.add_argument("--prototypes", default=None, help="prototype CSV path")
    p.add_argument("--embeddings", default=None,
                   help="embedding directory (train.npy, "
                        "train_indices.npy)")
    p.add_argument("--metadata", default=None, help="metadata CSV path")
    p.add_argument("--images", default="", help="image directory")
    p.add_argument("--checkpoint-dir", default="saved_models")
    p.add_argument("--batch-size", type=int, default=None,
                   help="finetune: batch (default: the preset's)")
    p.add_argument("--epochs", type=int, default=None,
                   help="finetune: epochs (default: the preset's)")
    p.add_argument("-r", "--resume", action="store_true",
                   help="finetune: continue from the latest checkpoint")
    p.add_argument("--hedge", action="store_true",
                   help="hedge refined guesses for competitive play")
    p.add_argument("--quant", action="store_true",
                   help="serve: int8 W8A8 vision tower (activation "
                        "scales calibrated at startup)")
    p.add_argument("--calib-images", default=None,
                   help="serve --quant: calibrate on up to 32 images of "
                        "this directory (default: a synthetic batch)")
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
    """The preset, with the head's flags as given (as the JAX CLI)."""
    cfg = pigeotto_config() if args.yfcc else pigeon_config()
    head = dataclasses.replace(cfg.head, multi_task=args.multitask,
                               heading=args.heading,
                               panorama=args.panorama)
    cfg = cfg.replace(head=head)
    if args.tiny:
        cfg = cfg.replace(
            vision=VisionConfig(image_size=64, patch_size=16,
                                hidden_size=64, intermediate_size=128,
                                num_layers=2, num_heads=4,
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


def load_embeddings(emb_dir: str, split: str) -> np.ndarray:
    """An embedding shard, reordered by its saved indices
    (`pigeon_tpu/train/embed.py::load_embeddings`)."""
    emb = np.load(os.path.join(emb_dir, f"{split}.npy"))
    idx = np.load(os.path.join(emb_dir, f"{split}_indices.npy")).flatten()
    return emb[np.argsort(idx)]


def load_refine_assets(args):
    """``(proto_rows, bank_emb, bank_lla)`` from ``--prototypes``,
    ``--embeddings`` and ``--metadata``, or None without them."""
    if not (args.prototypes and args.embeddings and args.metadata):
        return None
    meta = _read_csv(args.metadata)
    if meta and "selection" in meta[0]:
        meta = [r for r in meta if r["selection"] == "train"]
    lla = np.array([(float(r["lng"]), float(r["lat"])) for r in meta],
                   np.float32).reshape(-1, 2)
    emb = load_embeddings(args.embeddings, "train")
    if emb.ndim == 3:
        emb = emb.mean(1)
    if len(emb) != len(lla):
        # Prototype member indices address both by the same row number.
        raise SystemExit(f"{args.embeddings}: {len(emb)} embeddings vs "
                         f"{len(lla)} metadata train rows in "
                         f"{args.metadata}")
    rows = [{"geocell_idx": int(float(r["geocell_idx"])),
             "lng": float(r["lng"]), "lat": float(r["lat"]),
             "count": int(float(r["count"])), "indices": r["indices"]}
            for r in _read_csv(args.prototypes)]
    return rows, emb, lla


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


def quantize_for_inference(args, cfg, model, device):
    """``model`` with an int8 tower calibrated on ``--calib-images``
    (margin 1.1) or on a seeded N(0, 1) batch of 2 inputs (margin 1.25:
    synthetic activations lack real tails), on ``device``
    (`pigeon_tpu/cli/run.py::cmd_serve`, `_quantize_for_inference`)."""
    from pigeon_tpu_torch.models.quant import quantize_and_calibrate

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
    model = quantize_and_calibrate(model.to(device), calib.to(device),
                                   tower_key="vision", margin=margin)
    logger.warning("int8 W8A8 tower enabled (activation scales calibrated "
                   "on %s, margin %s)", source, margin)
    return model


def start_server(args, block: bool = True) -> ThreadingHTTPServer:
    """Build the model (int8 with ``--quant``), serving forward and
    refiner on ``--device``, warm them up, and start the HTTP server."""
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr, init_weights
    from pigeon_tpu_torch.serve import PredictionService, serve
    from pigeon_tpu_torch.serve.server import make_serving_fn
    from pigeon_tpu_torch.train.evaluate import build_refiner, refiner_preset

    device = _device(args)
    route = quant_attn_impl() if args.quant else attn_impl()
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
    logger.warning("weights: seeded initialisation (seed %d); checkpoint "
                   "restore is not ported yet", INIT_SEED)
    if args.quant:
        model = quantize_for_inference(args, cfg, model, device)
    serve_fn = make_serving_fn(model, cfg.head, cells, device)

    refine_fn = None
    assets = load_refine_assets(args)
    if assets is not None:
        preset = dataclasses.replace(refiner_preset("geoguessr"),
                                     hedge=args.hedge)
        refine_fn = build_refiner(*assets, num_cells=len(cells), cfg=preset,
                                  device=device)
        logger.warning("refinement enabled (topk=%d, hedge=%s)",
                       preset.topk, args.hedge)
    elif args.hedge:
        raise SystemExit("--hedge requires --prototypes/--embeddings/"
                         "--metadata (hedging applies to refined guesses)")

    # Warm up (kernel and decoder builds, first launches) before
    # accepting traffic.
    from PIL import Image

    from pigeon_tpu_torch.data import native_decode

    logger.warning("image decode: %s", "native libjpeg, then PIL"
                   if native_decode.available() else "PIL")
    views = (4,) if cfg.head.panorama else ()
    size = cfg.vision.image_size

    # PIL decodes what the native decoder cannot; loading its plugin
    # registry here keeps that cost out of the first request.
    Image.init()
    out = serve_fn(np.zeros((1, *views, size, size, 3), np.uint8))
    if refine_fn is not None:
        refine_fn(out["embedding"], out["pred_lla"], out["topk_cells"],
                  out["topk_probs"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    logger.warning("warmup done")
    service = PredictionService(serve_fn, image_size=size,
                                panorama=cfg.head.panorama,
                                refine_fn=refine_fn,
                                game_log=os.path.join("runs", "games.jsonl"))
    return serve(service, host=args.host, port=args.port, block=block)


def cmd_serve(args) -> int:
    start_server(args, block=True)
    return 0


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    return device


class Finetune(NamedTuple):
    """What `build_finetune` sets up for a finetuning run."""

    cfg: object            # PigeonConfig, head sized to the geocells
    device: torch.device
    geocells: torch.Tensor  # (C, 2) on the device
    state: object          # TrainState, restored with --resume
    train: object          # TabularImageDataset of the train split
    val: object            # ... and of the val split
    batch_size: int
    checkpoint_dir: str


def _split_frames(args, multitask: bool):
    """Train and val frames of ``--metadata`` (by its ``selection``
    column; without one both are the whole frame)."""
    import pandas as pd

    from pigeon_tpu_torch.data.pipeline import MT_COLUMNS

    if args.metadata is None:
        raise SystemExit("--metadata CSV is required for this command")
    df = pd.read_csv(args.metadata)
    if multitask:
        missing = [c for c in (*MT_COLUMNS, "climate_zone_idx")
                   if c not in df.columns]
        if missing:
            # -m without the label columns would crash inside the loss.
            raise SystemExit(
                f"--multitask needs columns {missing} that "
                f"{args.metadata} lacks and augmentation could not supply "
                "(the port has no GeoAugmentor yet: add them with "
                "`python -m pigeon_tpu.cli.run augment`), or drop -m")
    if "selection" not in df.columns:
        return df, df
    return (df[df["selection"] == "train"].reset_index(drop=True),
            df[df["selection"] == "val"].reset_index(drop=True))


def build_finetune(args) -> Finetune:
    """The model, optimizer, datasets and checkpoint directory of a
    ``finetune`` run on pixels: the preset at full width (``--tiny``:
    the smoke-test config), a seeded initialisation, every encoder layer
    but the last frozen, the tower on the route of :func:`attn_impl` and
    remat'd under ``attn_kernel``."""
    from pigeon_tpu_torch.data.pipeline import TabularImageDataset
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.checkpoints import (
        latest_step,
        restore_checkpoint,
    )
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import TrainState, adamw

    if args.embeddings:
        raise SystemExit("finetune --embeddings (training the head on "
                         "precomputed embeddings) is not ported yet")
    device = _device(args)
    route = attn_impl()
    forward_body = flash_fwd()
    cells = load_geocells(args)
    cfg = make_config(args)
    cfg = cfg.replace(head=dataclasses.replace(cfg.head,
                                               num_cells=len(cells)))
    train_df, val_df = _split_frames(args, cfg.head.multi_task)
    tcfg = cfg.train
    model = init_weights(build_finetune_model(cfg, attn_impl=route),
                         tcfg.seed).to(device)
    logger.warning("attention route: %s (PIGEON_FLASH_FWD=%s)", route,
                   forward_body)
    state = TrainState(model, adamw(model.parameters(), tcfg.learning_rate))
    ckpt_dir = os.path.join(args.checkpoint_dir, args.name)
    if args.resume and latest_step(ckpt_dir) is not None:
        restore_checkpoint(ckpt_dir, state)
        logger.warning("resumed from step %d", state.step)
    kw = dict(image_dir=args.images, image_size=cfg.vision.image_size,
              panorama=cfg.head.panorama)
    return Finetune(cfg=cfg, device=device,
                    geocells=torch.as_tensor(cells, device=device),
                    state=state, train=TabularImageDataset(train_df, **kw),
                    val=TabularImageDataset(val_df, **kw),
                    batch_size=args.batch_size or tcfg.batch_size_per_device,
                    checkpoint_dir=ckpt_dir)


def train_finetune(run: Finetune, num_epochs: int, name: str) -> list:
    """Train ``run`` for ``num_epochs`` epochs, each with an eval pass;
    checkpoints go to ``run.checkpoint_dir`` and scalars to
    ``runs/NAME/metrics.jsonl``. Returns the per-epoch eval metrics."""
    from pigeon_tpu_torch.data.pipeline import iter_batches
    from pigeon_tpu_torch.train.loop import train_model
    from pigeon_tpu_torch.train.train_loop import (
        batch_to_device,
        make_eval_step,
        make_train_step,
    )

    head = run.cfg.head
    _, history = train_model(
        run.state, make_train_step(head, run.geocells),
        make_eval_step(head, run.geocells),
        lambda epoch: iter_batches(run.train, run.batch_size, shuffle=True,
                                   seed=epoch, drop_last=True),
        lambda: iter_batches(run.val, run.batch_size),
        num_epochs=num_epochs,
        batch_to_device=functools.partial(batch_to_device,
                                          device=run.device),
        checkpoint_dir=run.checkpoint_dir,
        log_dir=os.path.join("runs", name),
        early_stopping_patience=run.cfg.train.early_stopping_patience)
    return history


def cmd_finetune(args) -> int:
    run = build_finetune(args)
    history = train_finetune(run, args.epochs or run.cfg.train.num_epochs,
                             args.name)
    logger.warning("final metrics: %s", history[-1] if history else {})
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    return {"serve": cmd_serve,
            "finetune": cmd_finetune}[args.function](args)


if __name__ == "__main__":
    sys.exit(main())
