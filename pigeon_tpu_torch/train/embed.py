"""The embedding sweep and head-only training's batches.

Counterpart of `pigeon_tpu/train/embed.py:30-160` on one device: a
dataset's images go through an embedder (`models.embedder.ClipEmbedder`
or `models.vit_embedder.ViTEmbedder`) batch by batch, and each split's
embeddings land in ``{split}.npy`` (f32) beside ``{split}_indices.npy``,
the positions of their rows within the split's frame: the reference's
on-disk layout (`preprocessing/embed.py:41-43`), which the refiner's bank
and head-only training (``finetune --embeddings``) read back with
`load_embeddings`. `embedding_batches` gives head-only training its
batches from such a bank.

Unlike the JAX package, which pads the last batch to its compiled shape,
the port runs it ragged. Over several ranks (`train/mesh.py`) each data
rank embeds its contiguous `host_slice` of a split at ``batch_size`` a
batch (the ranks of one model group the same rows, on their heads), the
slices are gathered in rank order, which is the split's order, and rank
0 writes the banks (`pigeon_tpu/train/embed.py:55-147`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import pandas as pd
import torch

from pigeon_tpu_torch.data.image_ops import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from pigeon_tpu_torch.data.pipeline import (
    TabularImageDataset,
    holdout,
    iter_batches,
)
from pigeon_tpu_torch.train import profiling
from pigeon_tpu_torch.train.multihost import (
    gather_objects,
    host_slice,
    is_primary,
    sync_hosts,
)
from pigeon_tpu_torch.train.train_loop import batch_to_device


def make_embed_step(model: torch.nn.Module, device):
    """``step(pixels) -> embeddings`` on ``device``: uint8 pixels are
    normalised there by the model's ``pixel_mean`` and ``pixel_std`` (a
    `ViTEmbedder`'s, from its `config.ViTVariant`), CLIP's where it has
    none; a panorama ``(B, V, S, S, 3)`` is folded to ``(B*V, S, S, 3)``
    for one tower batch and its embeddings unfolded to ``(B, V, D)``.
    While a torch profiler runs, each call records the span
    ``embed.h2d``: the copy to ``device`` and the normalisation, with the
    card's time (`train.profiling`)."""
    mean = getattr(model, "pixel_mean", CLIP_IMAGE_MEAN)
    std = getattr(model, "pixel_std", CLIP_IMAGE_STD)

    @torch.inference_mode()
    def step(pixels) -> torch.Tensor:
        with profiling.span("embed.h2d", device=True):
            x = batch_to_device({"inputs": pixels}, device, mean,
                                std)["inputs"]
        if x.dim() == 5:
            b, v = x.shape[:2]
            return model(x.reshape(b * v, *x.shape[2:])).reshape(b, v, -1)
        return model(x)

    return step


def embed_dataset(model: torch.nn.Module, dataset: TabularImageDataset,
                  batch_size: int, device, mesh=None
                  ) -> Dict[str, np.ndarray]:
    """Every image of ``dataset`` through ``model`` (in eval mode):
    ``embeddings`` ``(N, D)`` (``(N, V, D)`` for panoramas) and
    ``indices`` ``(N,)``, the rows' positions in the dataset. Over
    ``mesh``'s data axis each rank embeds its slice and every rank gets
    the whole, in order.

    Each batch's copy to the host starts as soon as its forward is
    enqueued and is read on the next iteration, after the next batch's
    forward is enqueued, so the transfer overlaps that forward and at
    most two batches of embeddings are held on the device."""
    model.eval()
    step = make_embed_step(model, device)
    chunks, index_chunks = [], []
    ranks = 1 if mesh is None else mesh.dp
    own = host_slice(len(dataset), 0 if mesh is None else mesh.data_rank,
                     ranks)
    if ranks > 1:
        dataset = holdout(dataset, own)
    seen = own.start
    pending = None          # (host tensor, event that completes its copy)

    def finish(host, copied) -> np.ndarray:
        if copied is not None:
            copied.synchronize()
        return host.numpy()

    for batch in iter_batches(dataset, batch_size):
        emb = step(batch["inputs"])
        host = emb.to("cpu", non_blocking=True)
        copied = None
        if host.device != emb.device:
            copied = torch.cuda.Event()
            copied.record()
        if pending is not None:
            chunks.append(finish(*pending))
        pending = (host, copied)
        n = len(batch["inputs"])
        index_chunks.append(np.arange(seen, seen + n))
        seen += n
    if pending is not None:
        chunks.append(finish(*pending))
    out = {"embeddings": (np.concatenate(chunks) if chunks
                          else np.zeros((0,), np.float32)),
           "indices": (np.concatenate(index_chunks) if index_chunks
                       else np.zeros((0,), np.int64))}
    if ranks > 1:
        parts = [p for p in gather_objects(out, mesh.data_group)
                 if len(p["indices"])]
        out = {k: np.concatenate([p[k] for p in parts]) for k in out}
    return out


def embed_splits_to_disk(model: torch.nn.Module,
                         datasets: Dict[str, TabularImageDataset],
                         out_dir: str, batch_size: int, device,
                         mesh=None) -> None:
    """Embed each named split and write ``{split}.npy`` and
    ``{split}_indices.npy`` under ``out_dir``: rank 0 writes, and the
    ranks meet at a barrier after each split (`embed.py:75-79`)."""
    if is_primary():
        os.makedirs(out_dir, exist_ok=True)
    for split, ds in datasets.items():
        out = embed_dataset(model, ds, batch_size, device, mesh)
        if is_primary():
            np.save(os.path.join(out_dir, f"{split}.npy"),
                    out["embeddings"])
            np.save(os.path.join(out_dir, f"{split}_indices.npy"),
                    out["indices"])
        sync_hosts()


def load_embeddings(emb_dir: str, split: str) -> np.ndarray:
    """An embedding shard, reordered by its saved indices."""
    emb = np.load(os.path.join(emb_dir, f"{split}.npy"))
    idx = np.load(os.path.join(emb_dir, f"{split}_indices.npy")).flatten()
    return emb[np.argsort(idx)]


def embedding_batches(embeddings: np.ndarray, rows: pd.DataFrame,
                      batch_size: int, shuffle_seed: Optional[int] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Head-only training's batches (`pigeon_tpu/cli/run.py:616-632`):
    ``inputs`` (the embeddings), ``labels`` (lng, lat) and, where ``rows``
    has the column, ``labels_clf`` (``geocell_idx``), and nothing else.
    Every batch is full: the tail that does not fill one is dropped, in
    training and in evaluation alike. With ``shuffle_seed`` the order is
    ``np.random.default_rng(shuffle_seed)``'s permutation."""
    order = np.arange(len(embeddings))
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    for start in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[start:start + batch_size]
        batch = {"inputs": embeddings[idx],
                 "labels": rows.iloc[idx][["lng", "lat"]]
                 .to_numpy(np.float32)}
        if "geocell_idx" in rows.columns:
            batch["labels_clf"] = rows.iloc[idx]["geocell_idx"] \
                .to_numpy(np.int32)
        yield batch
