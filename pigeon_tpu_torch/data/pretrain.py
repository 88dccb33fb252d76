"""Contrastive-pretraining dataset: multi-source (image, caption) pairs.

Counterpart of `pigeon_tpu/data/pretrain.py` (`PretrainIndexer`,
`PretrainDataset`): the metadata's ``source`` column sets each row's
items --

  * ``o*`` (StreetView panorama rows): 4 images a row, one item a view,
    heading offset ``view * 90`` degrees;
  * ``v*`` (single-frame rows): 1 image a row;
  * ``l*`` (landmark strip rows): one wide image cut into 5 vertical
    strips, one item a strip, heading offset ``strip * 72`` degrees.

Items are (PIL image, caption) with captions from `data.captions`; a
random square crop of 0.8-1.0 of the short side augments at load. One
RNG is shared across a batch, as in the JAX package, so seeded batches
hold the same pixels and ids in both.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import pandas as pd

from pigeon_tpu_torch.data.captions import streetview_caption, yfcc_caption
from pigeon_tpu_torch.data.image_ops import clip_preprocess_pil

STREETVIEW_VIEWS = 4
LANDMARK_STRIPS = 5


class PretrainIndexer:
    """Global item index -> (row, view, heading_offset_degrees).

    Panorama rows give 4 items, single rows 1, landmark rows 5, in
    source-grouped order (the reference's cutoff arithmetic).
    """

    def __init__(self, sources: pd.Series):
        s = sources.astype(str)
        self.pano_rows = np.where(s.str.startswith("o"))[0]
        self.single_rows = np.where(s.str.startswith("v"))[0]
        self.strip_rows = np.where(s.str.startswith("l"))[0]
        self.cut1 = len(self.pano_rows) * STREETVIEW_VIEWS
        self.cut2 = self.cut1 + len(self.single_rows)
        self.cut3 = self.cut2 + len(self.strip_rows) * LANDMARK_STRIPS

    def __len__(self) -> int:
        return self.cut3

    def lookup(self, index: int) -> Tuple[int, int, float]:
        """-> (dataframe row, view index, heading offset degrees)."""
        if index < 0 or index >= self.cut3:
            raise IndexError(index)
        if index < self.cut1:
            row = self.pano_rows[index // STREETVIEW_VIEWS]
            view = index % STREETVIEW_VIEWS
            return int(row), view, 90.0 * view
        if index < self.cut2:
            return int(self.single_rows[index - self.cut1]), 0, 0.0
        rel = index - self.cut2
        row = self.strip_rows[rel // LANDMARK_STRIPS]
        view = rel % LANDMARK_STRIPS
        return int(row), view, 72.0 * view


class PretrainDataset:
    """(image, caption) pairs for contrastive CLIP pretraining."""

    def __init__(self, df: pd.DataFrame, image_dir: str = "",
                 variant: str = "streetview", auxiliary: bool = True,
                 image_size: int = 336, augment: bool = True,
                 strip_width: int = 512, seed: int = 0):
        """Args:
            df: metadata with ``source``, image path column(s)
                (``image``/``image_2..4``), and caption metadata columns.
            variant: 'streetview' | 'yfcc' caption style.
            augment: random 0.8-1.0 square crop at load.
        """
        if "selection" in df.columns:
            df = df[df["selection"] == "train"]
        self.df = df.reset_index(drop=True)
        if "source" not in self.df.columns:
            self.df = self.df.assign(source="v")
        self.indexer = PretrainIndexer(self.df["source"])
        self.image_dir = image_dir
        self.variant = variant
        self.auxiliary = auxiliary
        self.image_size = image_size
        self.augment = augment
        self.strip_width = strip_width
        self.seed = seed

    def __len__(self) -> int:
        return len(self.indexer)

    def _load_image(self, row: pd.Series, view: int):
        from PIL import Image

        source = str(row["source"])
        if source.startswith("o"):
            cols = [c for c in self.df.columns if c.startswith("image")]
            path = os.path.join(self.image_dir, str(row[cols[view]]))
            return Image.open(path).convert("RGB")
        path = os.path.join(self.image_dir, str(row["image"]))
        img = Image.open(path).convert("RGB")
        if source.startswith("l"):
            # The strip width from the image itself where the
            # configured one does not fit 5 strips.
            width = img.size[0]
            strip = self.strip_width
            if strip * LANDMARK_STRIPS > width:
                strip = max(width // LANDMARK_STRIPS, 1)
            left = view * strip
            right = min((view + 1) * strip, width)
            img = img.crop((left, 0, right, img.size[1]))
        return img

    def _augment(self, img, rng: np.random.Generator):
        if not self.augment:
            return img
        w, h = img.size
        side = min(w, h)
        crop = rng.uniform(0.8, 1.0) * side
        left = rng.uniform(0, w - crop)
        top = rng.uniform(0, h - crop)
        return img.crop((int(left), int(top),
                         int(left + crop), int(top + crop)))

    def item(self, index: int, rng: Optional[np.random.Generator] = None):
        """-> (PIL image, caption string)."""
        rng = rng or np.random.default_rng((self.seed, index))
        row_idx, view, offset = self.indexer.lookup(index)
        row = self.df.iloc[row_idx]
        img = self._augment(self._load_image(row, view), rng)
        meta = row.to_dict()
        if "country_name" not in meta or pd.isna(meta.get("country_name")):
            caption = "A photo."
        elif self.variant == "yfcc":
            caption = yfcc_caption(meta, rng=rng, auxiliary=self.auxiliary)
        else:
            caption = streetview_caption(meta, heading_offset=offset,
                                         rng=rng, auxiliary=self.auxiliary)
        return img, caption

    def batches(self, tokenizer, batch_size: int, shuffle: bool = True,
                seed: int = 0, max_tokens: int = 77, drop_last: bool = True
                ) -> Iterator[dict]:
        """Yield ``{pixel_values, input_ids}`` numpy batches."""
        order = np.arange(len(self))
        rng = np.random.default_rng(seed)
        if shuffle:
            rng.shuffle(order)
        end = len(order) - batch_size + 1 if drop_last else len(order)
        for start in range(0, max(end, 0), batch_size):
            idx = order[start:start + batch_size]
            pixels, captions = [], []
            for i in idx:
                img, caption = self.item(int(i), rng)
                pixels.append(clip_preprocess_pil(img, self.image_size))
                captions.append(caption)
            yield {
                "pixel_values": np.stack(pixels),
                "input_ids": tokenizer(captions)[:, :max_tokens],
            }
