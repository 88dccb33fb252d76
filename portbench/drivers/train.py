"""The train step of ``finetune``, back to back.

The program: `train.modes.build_finetune_model` (every encoder layer but
the last frozen, the configuration's route and remat policy), `AdamW`
from `train.train_loop.adamw` and `make_train_step`'s step. Each step
takes a batch of the traffic's ``pool`` of batches, cycled: uint8
panoramas on the card, CLIP-normalised there by the program's
`normalize_images`, with their labels. A step's loss is read back after
the next step is enqueued.

Set-up drives the same state through the first three steps, on batches
0-2 of the pool (rows that all differ), and keeps what the check
compares: each step's loss, the first gradient as AdamW holds it
(``exp_avg / (1 - b1)`` after one step) and each trained leaf's change
after three. The window then continues from that state. The reference
follows the same three steps in float32.

Faults (the correctness tooling plants them; benchmark runs take none):
``unchanged``, AdamW's step does nothing; ``half_batch``, every step
sees the first half of its batch. ``control`` puts the reference in fp8
(`reference.model`) in the program's place.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from portbench import inputs, program
from portbench.yardstick import flops

#: Steps that set-up takes and the check compares.
CHECK_STEPS = 3
#: A leaf whose first reference gradient is under this share of the
#: median leaf's moves by round-off alone: its change is not compared.
STILL_LEAF = 1e-3


class Driver:
    def __init__(self, config, traffic, seed, device, fault=None,
                 control=False):
        if fault not in (None, "unchanged", "half_batch"):
            raise ValueError(f"train driver: no fault {fault!r}")
        self.cfg, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.fault, self.control = fault, control
        self.batch = config["batch_size_per_device"]
        self.views = 4 if config["panorama"] else 1
        self.readings = None
        self.trained = trained_names(config)
        self.k = 0

    # -- inputs, made from the seed on the device
    def _pixels(self, j):
        s = self.cfg["image_size"]
        return inputs.pixels(self.seed, f"train.pixels.{j}",
                             (self.batch, self.views, s, s, 3), self.device)

    def _labels(self, j):
        return inputs.train_labels(self.seed, f"train.labels.{j}",
                                   self.batch, self.cfg, self.device)

    def _cells(self):
        return inputs.points(self.seed, "cells", self.cfg["num_cells"],
                             self.device)

    # -- the program
    def setup(self):
        if self.control:
            self.readings = self._reference_readings(fp8=True)
            return
        from pigeon_tpu_torch.data.image_ops import normalize_images
        from pigeon_tpu_torch.train.modes import build_finetune_model
        from pigeon_tpu_torch.train.train_loop import (
            TrainState,
            adamw,
            make_train_step,
        )

        cfg = self.cfg
        pcfg = program.pigeon_config(cfg)
        model = program.build(lambda: build_finetune_model(
            pcfg, dtype=program.dtype(cfg), attn_impl=program.route(cfg),
            remat=cfg["remat"]), self.device)
        program.load(model, inputs.make_weights(cfg, cfg, self.seed,
                                                self.device))
        opt = adamw(model.parameters(), cfg["learning_rate"],
                    b1=cfg["adam_b1"], b2=cfg["adam_b2"],
                    eps=cfg["adam_eps"], weight_decay=cfg["weight_decay"])
        if self.fault == "unchanged":
            opt.step = lambda *args, **kwargs: None
        self.state = TrainState(model, opt)
        self.step_fn = make_train_step(pcfg.head, self._cells())
        self.normalize = normalize_images
        pool = self.traffic["pool"]
        self.pool = [(self._pixels(j), self._labels(j)) for j in range(pool)]
        params = dict(model.named_parameters())
        trains = sorted(n for n, p in params.items() if p.requires_grad)
        if trains != sorted(self.trained):
            raise RuntimeError("the program trains other leaves than the "
                               f"configuration states: {trains[:4]}...")
        start = {n: params[n].detach().clone() for n in self.trained}
        losses, first = [], None
        for j in range(CHECK_STEPS):
            losses.append(self._step()["loss"].item())
            if j == 0:
                first = {n: self._first_grad(opt, params[n])
                         for n in self.trained}
        change = {n: (params[n].detach() - start[n]).norm().item()
                  for n in self.trained}
        self.readings = (losses, first, change)

    def _first_grad(self, opt, p) -> float:
        state = opt.state.get(p, {})
        if "exp_avg" not in state:
            return 0.0
        return state["exp_avg"].norm().item() / (1 - self.cfg["adam_b1"])

    def _batch(self):
        pixels, labels = self.pool[self.k % len(self.pool)]
        self.k += 1
        batch = dict(labels, inputs=self.normalize(pixels))
        if self.fault == "half_batch":
            batch = {key: v[:self.batch // 2] for key, v in batch.items()}
        return batch

    def _step(self):
        return self.step_fn(self.state, self._batch())

    def _run(self, seconds: float, min_steps: int = 1):
        """Steps until ``seconds`` have passed, each loss read after the
        next step is enqueued; returns (steps, losses, seconds)."""
        sync(self.device)
        t = time.perf_counter()
        losses, pending, steps = [], None, 0
        while True:
            metrics = self._step()
            steps += 1
            if pending is not None:
                losses.append(pending.item())
            pending = metrics["loss"]
            if steps >= min_steps and time.perf_counter() - t >= seconds:
                break
        losses.append(pending.item())
        return steps, losses, time.perf_counter() - t

    def window(self, seconds: float) -> dict:
        if self.control:
            return {"attempted": 0, "failed": 0}
        steps, losses, elapsed = self._run(seconds)
        images = steps * self.batch * self.views
        failed = sum(1 for x in losses if not math.isfinite(x))
        cfg = self.cfg
        per_view = flops.train_flops_per_view(
            cfg, cfg, self.views, cfg["trained_encoder_layers"])
        return {"attempted": steps, "failed": failed, "items": images,
                "seconds": elapsed, "flops_per_item": per_view}

    def slice(self) -> dict:
        before = program.launches()
        self._run(0.0, min_steps=self.traffic["trace_steps"])
        after = program.launches()
        s = (self.cfg["image_size"] // self.cfg["patch_size"]) ** 2 + 1
        shape = (self.batch * self.views, s, self.cfg["hidden_size"],
                 self.cfg["num_attention_heads"])
        return {k: [(shape, after[k] - before[k])] for k in after}

    def release(self):
        for name in ("state", "step_fn", "pool"):
            self.__dict__.pop(name, None)

    # -- the reference
    def _reference_readings(self, fp8: bool = False):
        from portbench.reference import model as ref

        ref.highest_precision()
        cfg = self.cfg
        w = inputs.make_weights(cfg, cfg, self.seed, self.device)
        trained = self.trained
        start = {k: w[k].clone() for k in trained}
        opt = ref.AdamW(cfg["learning_rate"], cfg["adam_b1"],
                        cfg["adam_b2"], cfg["adam_eps"], cfg["weight_decay"])
        cells = self._cells()
        losses, first = [], None
        self.rounded_logit_losses = []
        for j in range(CHECK_STEPS):
            loss, grads, rounded = ref.loss_and_grads(
                w, trained, cfg, cfg, self._pixels(j), self._labels(j),
                cells, block=self.traffic["reference_block"], fp8=fp8)
            losses.append(loss)
            self.rounded_logit_losses.append(rounded)
            if j == 0:
                first = {k: g.norm().item() for k, g in grads.items()}
            opt.step(w, grads)
        change = {k: (w[k] - start[k]).norm().item() for k in trained}
        return losses, first, change

    def check(self) -> dict:
        want = self._reference_readings()
        checks, self.details = compare(self.readings, want)
        self.details["bf16_logit_loss_gaps"] = [
            abs(r - w) / abs(w)
            for r, w in zip(self.rounded_logit_losses, want[0])]
        return checks


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trained_names(cfg: dict) -> list:
    """The leaves ``finetune`` trains: all but the encoder layers before
    the last ``trained_encoder_layers``, and the post-LayerNorm, which
    the embedding does not read."""
    first_trained = cfg["num_hidden_layers"] - cfg["trained_encoder_layers"]
    out = []
    for name, _, _, _ in inputs.weight_specs(cfg, cfg):
        if ".encoder.layers." in name:
            if int(name.split(".encoder.layers.")[1].split(".")[0]) \
                    < first_trained:
                continue
        out.append(name)
    return out


def _worst(got: dict, want: dict, leaves) -> tuple:
    """The worst leaf's gap between two norms, over the reference's norm
    of that leaf or of the median leaf, whichever is larger, and the
    leaf."""
    floor = statistics.median([want[k] for k in leaves])
    return max((abs(got.get(k, 0.0) - want[k]) / max(want[k], floor), k)
               for k in leaves)


def compare(got, want) -> tuple:
    """The three numbers the check holds to their limits, and what the
    look at them reads: each step's loss gap, the worst leaves and the
    leaves left out of the change."""
    (g_loss, g_first, g_change), (w_loss, w_first, w_change) = got, want
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(g_loss, w_loss)]
    leaves = sorted(w_first)
    median = statistics.median([w_first[k] for k in leaves])
    moving = [k for k in leaves if w_first[k] >= STILL_LEAF * median]
    grad, update = _worst(g_first, w_first, leaves), \
        _worst(g_change, w_change, moving)
    checks = {"loss_gap": max(loss_gaps), "grad_gap": grad[0],
              "update_gap": update[0]}
    details = {"loss_gaps": loss_gaps, "losses": w_loss,
               "grad_worst": grad, "update_worst": update,
               "still_leaves": sorted(set(leaves) - set(moving))}
    return checks, details
