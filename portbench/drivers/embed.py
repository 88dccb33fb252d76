"""The embedding sweep of ``embed``: `train.embed.make_embed_step` over
a `models.embedder.ClipEmbedder`, batch after batch.

The traffic's ``pool`` of uint8 batches (``embed_batch_size_per_device``
images each) is made on the card from the seed and kept on the host, as
the sweep's input pipeline hands its batches over; each batch crosses to
the card in the step, and its embeddings are copied back as soon as its
forward is enqueued and read after the next batch's forward is enqueued,
as `train.embed.embed_dataset` does.

The check: a uniform sample, drawn from the seed, of ``checked_rows``
of all the answers of the window; after the window the reference embeds
those rows' images in float32. ``control`` runs the
program's own int8 path (`models.quant.quantize_and_calibrate`, static
scales calibrated on the first batch's first images) in its place.

Faults (for the correctness tooling): ``half_batch``, the step sees the
first half of each batch and its answers stand for the second half too;
``altered``, each batch's answers are shifted by one row.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.yardstick import flops


class Driver:
    def __init__(self, config, traffic, seed, device, fault=None,
                 control=False):
        if fault not in (None, "half_batch", "altered"):
            raise ValueError(f"embed driver: no fault {fault!r}")
        self.cfg, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.fault, self.control = fault, control
        self.batch = config["embed_batch_size_per_device"]
        self.k = 0
        # The checked sample: the rows of the window's answers with the
        # smallest seeded keys (a uniform sample of all of them).
        self.rng = np.random.default_rng(inputs.sub_seed(seed, "embed.sample"))
        self.keys = np.zeros(0)
        self.where = np.zeros((0, 2), np.int64)     # (pool index, row)
        self.answers = None

    def _pixels(self, j):
        s = self.cfg["image_size"]
        return inputs.pixels(self.seed, f"embed.pixels.{j}",
                             (self.batch, s, s, 3), self.device)

    def setup(self):
        from pigeon_tpu_torch.models.embedder import ClipEmbedder
        from pigeon_tpu_torch.train.embed import make_embed_step

        cfg = self.cfg
        pcfg = program.pigeon_config(cfg)
        model = program.build(lambda: ClipEmbedder(
            pcfg.vision, dtype=program.dtype(cfg),
            attn_impl=program.route(cfg)), self.device)
        program.load(model, inputs.make_weights(cfg, None, self.seed,
                                                self.device))
        model.eval()
        self.pool = [self._pixels(j).cpu().numpy()
                     for j in range(self.traffic["pool"])]
        if self.control:
            from pigeon_tpu_torch.data.image_ops import normalize_images
            from pigeon_tpu_torch.models.quant import quantize_and_calibrate

            calib = normalize_images(torch.from_numpy(
                self.pool[0][:self.traffic["calibration_images"]])
                .to(self.device))
            model = quantize_and_calibrate(
                model, calib, tower_key="vision",
                margin=self.traffic["calibration_margin"])
        self.model = model
        self.step = make_embed_step(model, self.device)
        # Warm-up: every batch of the pool once (its shape is the only
        # one the window runs), the last read back.
        self._run(0.0, min_batches=len(self.pool), keep=False)

    def _answer(self, pixels):
        if self.fault == "half_batch":
            half = self.step(pixels[:len(pixels) // 2])
            return torch.cat([half, half])
        emb = self.step(pixels)
        if self.fault == "altered":
            emb = emb.roll(1, 0)
        return emb

    def _keep(self, index, host):
        """The batch's rows into the sample: each row a seeded key, and
        the ``checked_rows`` smallest keys of the window kept."""
        size = self.traffic["checked_rows"]
        keys = self.rng.random(len(host))
        new = np.flatnonzero(keys < self.keys.max()) \
            if len(self.keys) >= size else np.arange(len(host))
        if not len(new):
            return
        where = np.stack([np.full(len(new), index % len(self.pool)), new], 1)
        answers = host[new] if self.answers is None else np.concatenate(
            [self.answers, host[new]])
        keys = np.concatenate([self.keys, keys[new]])
        where = np.concatenate([self.where, where])
        keep = np.argsort(keys, kind="stable")[:size]
        self.keys, self.where, self.answers = \
            keys[keep], where[keep], answers[keep]

    def _run(self, seconds: float, min_batches: int = 1, keep: bool = True):
        """Batches until ``seconds`` have passed; returns (batches,
        non-finite batches, seconds)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        pending, batches, bad = None, 0, 0

        def finish(index, host, copied):
            nonlocal bad
            if copied is not None:
                copied.synchronize()
            host = host.numpy()
            if not np.isfinite(host).all():
                bad += 1
            if keep:
                self._keep(index, host)

        while True:
            index = self.k
            pixels = self.pool[index % len(self.pool)]
            self.k += 1
            emb = self._answer(pixels)
            host = emb.to("cpu", non_blocking=True)
            copied = None
            if host.device != emb.device:
                copied = torch.cuda.Event()
                copied.record()
            if pending is not None:
                finish(*pending)
            pending = (index, host, copied)
            batches += 1
            if batches >= min_batches and time.perf_counter() - t >= seconds:
                break
        finish(*pending)
        return batches, bad, time.perf_counter() - t

    def window(self, seconds: float) -> dict:
        batches, bad, elapsed = self._run(seconds)
        images = batches * self.batch
        return {"attempted": batches, "failed": bad, "items": images,
                "seconds": elapsed,
                "flops_per_item": flops.tower_forward_flops(self.cfg)}

    def slice(self) -> dict:
        before = program.launches()
        self._run(self.traffic["trace_seconds"], keep=False)
        after = program.launches()
        s = (self.cfg["image_size"] // self.cfg["patch_size"]) ** 2 + 1
        shape = (self.batch, s, self.cfg["hidden_size"],
                 self.cfg["num_attention_heads"])
        return {k: [(shape, after[k] - before[k])] for k in after
                if after[k] > before[k]}

    def release(self):
        for name in ("model", "step"):
            self.__dict__.pop(name, None)

    def check(self) -> dict:
        from portbench.reference import model as ref

        ref.highest_precision()
        w = inputs.make_weights(self.cfg, None, self.seed, self.device)
        worst = 0.0
        block = self.traffic["reference_block"]
        for i in range(0, len(self.keys), block):
            where = self.where[i:i + block]
            px = torch.stack([torch.from_numpy(self.pool[j][r])
                              for j, r in where]).to(self.device)
            want = ref.embed(w, self.cfg, px, block=block)
            got = torch.from_numpy(self.answers[i:i + block]) \
                .to(want.device).float()
            err = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
            worst = max(worst, err if math.isfinite(err) else math.inf)
        return {"embedding_error": worst}
