"""Batched serving under open-loop arrivals: `serve.batching.MicroBatcher`
over `serve.server.make_serving_fn` and the refiner of
`train.evaluate.build_refiner` (the ``geoguessr`` preset, no hedging),
as ``serve --serve-batch`` runs them without HTTP and decoding.

Set-up builds the `SuperGuessr`, the refiner's bank (the traffic's
``bank_rows`` seeded embeddings and each cell's 1-3 seeded clusters),
the batcher (its ``max_batch``, ``buckets`` and ``max_wait_ms``, each
bucket warmed) and a pool of ``pool`` seeded uint8 panoramas on the
host. The window submits one panorama a request at the due times of
`inputs.arrival_times` (the traffic's ``arrivals``) whether or not
earlier ones are done, and times each from its due time to the moment
its result is set. Every request sent is waited for, up to a minute
after the window.

The check: ``checked_requests`` requests drawn from the seed. The
reference embeds their views in float32 and judges the served
embeddings (``embedding_error``). It runs the panorama head in float32
on the served embedding and judges the served top-k candidates
(``head_gap``, in nats: the worst, over the candidates, of the gap
between a candidate's served log-probability and the reference's, and
of the gap by which the candidate's reference log-probability lies
below the reference's best at its rank), so that only the head's bf16
rounding counts. The refiner is followed from the served embedding and
the served candidates, which the two numbers above judge:
`reference.refiner.refine` on them must give the served cell and
location exactly (``refine_mismatch`` counts the requests where it does
not). ``control`` serves the program's own int8 tower (static scales
calibrated on two pool panoramas) in the bf16 one's place.

Faults (for the correctness tooling): ``half_batch``, the forward sees
the first half of each bucket's rows and its answers stand for the rest;
``altered``, each batch's refined answers are shifted by one request;
``head_rolled``, each batch's candidates are shifted by one row, padding
rows included; ``view_dropped``, the head aggregates the last three
views alone.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.yardstick import flops

#: Seconds a request may take past the window's end before it counts as
#: never answered.
WAIT_S = 60.0
#: The faults the driver can plant.
FAULTS = (None, "half_batch", "altered", "head_rolled", "view_dropped")


class Driver:
    def __init__(self, config, traffic, seed, device, fault=None,
                 control=False):
        if fault not in FAULTS:
            raise ValueError(f"serve driver: no fault {fault!r}")
        self.cfg, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.fault, self.control = fault, control
        self.lock = threading.Lock()
        self.batch_starts = []        # (host time, bucket) of each forward

    def setup(self):
        from pigeon_tpu_torch.config import RefinerConfig
        from pigeon_tpu_torch.data.image_ops import normalize_images
        from pigeon_tpu_torch.models.super_guessr import SuperGuessr
        from pigeon_tpu_torch.serve.batching import MicroBatcher
        from pigeon_tpu_torch.serve.server import make_serving_fn
        from pigeon_tpu_torch.train.evaluate import build_refiner

        cfg, tr = self.cfg, self.traffic
        pcfg = program.pigeon_config(cfg)
        model = program.build(lambda: SuperGuessr(
            pcfg.vision, pcfg.head, dtype=program.dtype(cfg),
            attn_impl=program.route(cfg)), self.device)
        program.load(model, inputs.make_weights(cfg, cfg, self.seed,
                                                self.device))
        s = cfg["image_size"]
        self.pool = inputs.pixels(self.seed, "serve.pixels",
                                  (tr["pool"], 4, s, s, 3),
                                  self.device).cpu().numpy()
        if self.control:
            from pigeon_tpu_torch.models.quant import quantize_and_calibrate

            calib = normalize_images(torch.from_numpy(
                self.pool[:tr["calibration_panoramas"]]).to(self.device))
            model = quantize_and_calibrate(
                model, calib, tower_key="vision",
                margin=tr["calibration_margin"])
        self.cells = inputs.points(self.seed, "cells", cfg["num_cells"],
                                   self.device)
        serve_fn = make_serving_fn(model, pcfg.head,
                                   self.cells.cpu().numpy(), self.device)
        self.num_candidates = pcfg.head.num_candidates
        emb, lla, clusters = inputs.bank(self.seed, cfg, tr["bank_rows"],
                                         self.device)
        rows = [{"geocell_idx": c, "lng": lng, "lat": lat,
                 "count": len(idx), "indices": idx}
                for c, lng, lat, idx in clusters]
        preset = RefinerConfig(
            topk=cfg["refiner_topk"],
            max_refinement_km=cfg["max_refinement_km"],
            temperature=cfg["refiner_temperature"], hedge=False,
            max_protos_per_cell=cfg["max_protos_per_cell"],
            max_members_per_cluster=cfg["max_members_per_cluster"])
        refine_fn = build_refiner(rows, emb.cpu().numpy(), lla,
                                  num_cells=cfg["num_cells"], cfg=preset,
                                  device=self.device)
        del emb, rows
        self.batcher = MicroBatcher(
            self._timed(serve_fn), refine_fn=self._faulty(refine_fn),
            max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"],
            buckets=tuple(tr["buckets"]))
        self.batcher.warm((4, s, s, 3), torch.uint8)
        self.results = {}

    def _timed(self, serve_fn):
        """``serve_fn`` recording each call's start and bucket, with the
        fault planted, if any."""
        def timed(pixels):
            with self.lock:
                self.batch_starts.append((time.perf_counter(),
                                          pixels.shape[0]))
            if self.fault == "half_batch" and pixels.shape[0] > 1:
                half = serve_fn(pixels[:pixels.shape[0] // 2])
                return {k: None if v is None else torch.cat([v, v])
                        for k, v in half.items()}
            out = serve_fn(pixels)
            if self.fault == "head_rolled":
                return dict(out, topk_cells=out["topk_cells"].roll(1, 0),
                            topk_probs=out["topk_probs"].roll(1, 0))
            if self.fault == "view_dropped":
                from pigeon_tpu_torch.models.geocell_head import (
                    geocell_predictions,
                )

                with torch.inference_mode():
                    logits = serve_fn.model.head(
                        out["embedding"][:, 1:]).logits
                preds = geocell_predictions(logits, self.cells,
                                            self.num_candidates)
                return dict(out, pred_lla=preds["pred_lla"],
                            topk_cells=preds["topk_cells"],
                            topk_probs=preds["topk_probs"])
            return out

        timed.device = serve_fn.device
        timed.model = serve_fn.model
        return timed

    def _faulty(self, refine_fn):
        if self.fault != "altered":
            return refine_fn

        def altered(*args):
            out = refine_fn(*args)
            return dict(out, pred_lla=out["pred_lla"].roll(1, 0),
                        pred_cell=out["pred_cell"].roll(1, 0))
        return altered

    def _open_loop(self, seconds: float, keep=()):
        """Submit the schedule of ``seconds``; wait for every answer.
        Returns each request's due time and latency (s from the window's
        start; inf for none), the failures and the sender's lateness, and
        the window's start (host clock)."""
        due = inputs.arrival_times(self.traffic["arrivals"], seconds)
        done = [math.inf] * len(due)
        keep = set(keep)
        futures = []
        start = time.perf_counter() + 0.01
        late = []

        def on_done(i):
            def record(fut):
                done[i] = time.perf_counter()
            return record

        n_pool = len(self.pool)
        for i, t in enumerate(due):
            wait = start + t - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(max(0.0, time.perf_counter() - start - t))
            fut = self.batcher.submit(self.pool[i % n_pool])
            fut.add_done_callback(on_done(i))
            futures.append(fut)
        deadline = time.perf_counter() + WAIT_S
        failed = 0
        for i, fut in enumerate(futures):
            try:
                row = fut.result(timeout=max(0.0,
                                             deadline - time.perf_counter()))
                if i in keep:
                    self.results[i] = row
            except Exception:  # noqa: BLE001 — a failed or missing answer
                failed += 1
                done[i] = math.inf
        latency = [d - (start + t) for d, t in zip(done, due)]
        return due, latency, failed, late, start

    def window(self, seconds: float) -> dict:
        n = len(inputs.arrival_times(self.traffic["arrivals"], seconds))
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "checked"))
        k = min(n, self.traffic["checked_requests"])
        self.checked = sorted(rng.choice(n, k, replace=False).tolist())
        fills_before = len(self.batcher.fills)
        starts_before = len(self.batch_starts)
        due, latency, failed, late, start = self._open_loop(seconds,
                                                            self.checked)
        fills = self.batcher.fills[fills_before:]
        starts = self.batch_starts[starts_before:]
        # Each batch, in order, answered its fill of the requests in the
        # order they were sent: its end is its last request's answer.
        ends, first = [], 0
        answered = [start + t + x for t, x in zip(due, latency)]
        for fill, _ in fills:
            ends.append(max(answered[first:first + fill]))
            first += fill
        busy = sum(e - s for (s, _), e in zip(starts, ends)
                   if math.isfinite(e))
        per_request = 4 * flops.tower_forward_flops(self.cfg) \
            + flops.head_forward_flops(self.cfg, self.cfg["hidden_size"])
        return {"attempted": len(latency), "failed": failed,
                "items": sum(f for f, _ in fills), "seconds": busy,
                "flops_per_item": per_request,
                "counters": {"fills": fills,
                             "latency_ms": [x * 1e3 for x in latency],
                             "send_late_p95_ms": float(
                                 np.percentile(late, 95)) * 1e3}}

    def slice(self) -> dict:
        before = len(self.batch_starts)
        launched = program.launches()["K1"]
        self._open_loop(self.traffic["trace_seconds"])
        layers = self.cfg["num_hidden_layers"]
        s = (self.cfg["image_size"] // self.cfg["patch_size"]) ** 2 + 1
        buckets = {}
        for _, bucket in self.batch_starts[before:]:
            buckets[bucket] = buckets.get(bucket, 0) + layers
        calls = [((4 * b, s, self.cfg["hidden_size"],
                   self.cfg["num_attention_heads"]), n)
                 for b, n in sorted(buckets.items())]
        if sum(n for _, n in calls) != program.launches()["K1"] - launched:
            return {}
        return {"K1": calls}

    def release(self):
        batcher = self.__dict__.pop("batcher", None)
        if batcher is not None:
            batcher.close()

    def check(self) -> dict:
        from portbench.reference import model as ref
        from portbench.reference.refiner import Bank, refine

        ref.highest_precision()
        cfg = self.cfg
        w = inputs.make_weights(cfg, cfg, self.seed, self.device)
        emb, lla, clusters = inputs.bank(self.seed, cfg,
                                         self.traffic["bank_rows"],
                                         self.device)
        bank = Bank(clusters, emb, lla, cfg)
        cells = self.cells.cpu().numpy()
        out = {"embedding_error": 0.0, "head_gap": 0.0, "refine_mismatch": 0}
        n_pool = len(self.pool)
        for i in self.checked:
            row = self.results.get(i)
            if row is None:
                return {k: math.inf for k in out}
            px = torch.from_numpy(self.pool[i % n_pool]).to(self.device)
            views = ref.embed(w, cfg, px, block=4)
            got = torch.as_tensor(row["embedding"], device=views.device)
            out["embedding_error"] = max(out["embedding_error"], (
                (got - views).norm(dim=-1) / views.norm(dim=-1)).max().item())
            out["head_gap"] = max(out["head_gap"], head_gap(
                ref.head(w, cfg, got[None])["logits"][0],
                row["topk_cells"], row["topk_probs"]))
            # The refiner is followed from the served embedding, which the
            # number above judges, and the served candidates.
            cell, guess = refine(
                bank, got.mean(0), row["topk_cells"], row["topk_probs"],
                cells[int(row["topk_cells"][0])])
            if cell != int(row["pred_cell"]) or not np.array_equal(
                    np.float32(guess), np.float32(row["pred_lla"])):
                out["refine_mismatch"] += 1
        return out


def head_gap(ref_logits: torch.Tensor, cells, probs) -> float:
    """The served candidates against the reference head's logits: the
    worst, over the candidates in rank order, of the gap between the
    served and the reference log-probability, and of the gap by which
    the candidate's reference log-probability lies below the reference's
    best at that rank."""
    logp = torch.log_softmax(ref_logits.double(), -1)
    cells = torch.as_tensor(np.asarray(cells), device=logp.device).long()
    served = torch.as_tensor(np.asarray(probs, np.float64),
                             device=logp.device).log()
    best = logp.topk(len(cells)).values
    gap = torch.maximum((served - logp[cells]).abs(), best - logp[cells])
    return gap.max().item()
