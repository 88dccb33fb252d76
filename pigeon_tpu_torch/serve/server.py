"""HTTP model server speaking the Chrome-extension bot protocol.

Counterpart of `pigeon_tpu/serve/server.py`, with the same contract:

* ``POST /api/v1/predict`` with JSON ``{gameID, roundID, image, image_2,
  image_3, image_4}`` (base64 screenshots; single-image mode reads only
  ``image``) -> ``{"results": {"lat": .., "lng": ..}, "gameID", "roundID"}``;
  a missing field or undecodable image bytes is a 400, not a 500;
* ``POST /api/v1/game`` appends the round result to a JSONL log.

The compute path is `make_serving_fn` (uint8 pixels normalised on the
device, the model forward, top-k geocells) plus the optional refiner.
Requests are served by threads; device work is serialised by a lock, or,
with a `serve.batching.MicroBatcher` (``serve --serve-batch N``),
concurrent requests share one forward and take no lock.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from pigeon_tpu_torch.data import native_decode
from pigeon_tpu_torch.data.image_ops import normalize_images, resize_crop_pil
from pigeon_tpu_torch.models.geocell_head import geocell_predictions

logger = logging.getLogger("pigeon_tpu_torch.serve")


class PredictionService:
    """Decoding, the serving forward and refinement for one request."""

    def __init__(self, serve_fn: Callable, image_size: int = 336,
                 panorama: bool = True,
                 refine_fn: Optional[Callable] = None,
                 game_log: Optional[str] = None, batcher=None):
        """``serve_fn``: uint8 ``(1, 4, S, S, 3)`` (panorama) or
        ``(1, S, S, 3)`` pixels -> dict with ``pred_lla``, ``topk_cells``,
        ``topk_probs`` and ``embedding`` tensors. ``refine_fn``: the
        batched refiner (`models/refiner.make_refine_fn`). ``batcher``: a
        `serve.batching.MicroBatcher` that runs the forward (and its own
        refiner) for concurrent requests together."""
        self.serve_fn = serve_fn
        self.image_size = image_size
        self.panorama = panorama
        self.refine_fn = refine_fn
        self.game_log = game_log
        self.batcher = batcher
        self._lock = threading.Lock()

    def decode(self, payload: dict) -> np.ndarray:
        """The request's views as one uint8 batch of one."""
        keys = (["image", "image_2", "image_3", "image_4"]
                if self.panorama else ["image"])
        raws = []
        for key in keys:
            if key not in payload:
                raise ValueError(f"missing field {key!r}")
            raws.append(base64.b64decode(re.sub(
                r"^data:image/[a-zA-Z+]+;base64,", "", payload[key])))
        # Native JPEG decode for the whole request first; PIL for each
        # image it could not decode (e.g. PNG screenshots).
        decoded = (native_decode.decode_resize_crop_batch(
            raws, self.image_size,
            nthreads=min(len(raws), os.cpu_count() or 1))
            or [None] * len(raws))
        views = []
        for raw, nat in zip(raws, decoded):
            if nat is not None:
                views.append(nat)
                continue
            from PIL import Image

            try:
                with Image.open(io.BytesIO(raw)) as im:
                    views.append(resize_crop_pil(im, self.image_size))
            except Exception as e:  # noqa: BLE001 — client error, not 500
                # PIL raises UnidentifiedImageError (an OSError) for bytes
                # that are no image: the client's fault, so a 400.
                raise ValueError(f"undecodable image bytes: {e}") from e
        return np.stack(views)[None] if self.panorama else views[0][None]

    def predict(self, payload: dict) -> dict:
        pixels = self.decode(payload)
        if self.batcher is not None:
            # Concurrent requests share one forward: no lock.
            lng, lat = self.batcher.predict_one(pixels[0])["pred_lla"] \
                .tolist()
            return {"results": {"lat": lat, "lng": lng},
                    "gameID": payload.get("gameID"),
                    "roundID": payload.get("roundID")}
        with self._lock:                    # one device forward at a time
            out = self.serve_fn(pixels)
            pred = out["pred_lla"]
            if self.refine_fn is not None:
                pred = self.refine_fn(out["embedding"], out["pred_lla"],
                                      out["topk_cells"],
                                      out["topk_probs"])["pred_lla"]
            lng, lat = pred[0].tolist()
        return {"results": {"lat": lat, "lng": lng},
                "gameID": payload.get("gameID"),
                "roundID": payload.get("roundID")}

    def record_game(self, payload: dict) -> None:
        if not self.game_log:
            return
        os.makedirs(os.path.dirname(self.game_log) or ".", exist_ok=True)
        with open(self.game_log, "a") as f:
            f.write(json.dumps(payload) + "\n")


def make_serving_fn(model: torch.nn.Module, head_cfg, geocells,
                    device) -> Callable:
    """The serving forward of a `SuperGuessr` on ``device``.

    Returns ``serve_fn(pixels)``: uint8 (or already normalised float)
    NHWC pixels -> ``{"pred_lla", "topk_cells", "topk_probs",
    "embedding", "preds_mt"}`` as tensors on ``device``; the model it
    runs is ``serve_fn.model`` and its device ``serve_fn.device``.
    """
    device = torch.device(device)
    cells = torch.as_tensor(np.asarray(geocells, np.float32), device=device)
    model = model.to(device).eval()

    @torch.inference_mode()
    def serve_fn(pixels):
        if not isinstance(pixels, torch.Tensor):
            pixels = torch.tensor(pixels)   # a copy: views may be read-only
        pixels = pixels.to(device)
        if pixels.dtype == torch.uint8:
            pixels = normalize_images(pixels)
        out = model(pixels)
        preds = geocell_predictions(out.logits, cells,
                                    head_cfg.num_candidates)
        return {"pred_lla": preds["pred_lla"],
                "topk_cells": preds["topk_cells"],
                "topk_probs": preds["topk_probs"],
                "embedding": out.embedding, "preds_mt": out.preds_mt}

    serve_fn.model = model
    serve_fn.device = device
    return serve_fn


class _Handler(BaseHTTPRequestHandler):
    service: PredictionService = None  # bound by serve()

    def _reply(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_OPTIONS(self):  # CORS preflight from the extension
        self.send_response(204)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "POST, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "Content-Type")
        self.end_headers()

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except ValueError:          # JSONDecodeError is a ValueError
            self._reply(400, {"error": "invalid JSON"})
            return
        if self.path == "/api/v1/predict":
            try:
                self._reply(200, self.service.predict(payload))
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serving must not die
                logger.exception("prediction failed")
                self._reply(500, {"error": str(e)})
        elif self.path == "/api/v1/game":
            self.service.record_game(payload)
            self._reply(200, {"status": "ok"})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def log_message(self, fmt, *args):
        logger.info("%s " + fmt, self.client_address[0], *args)


class _Server(ThreadingHTTPServer):
    #: The listen backlog. socketserver's default of 5 drops the SYNs of
    #: more concurrent connects than that while the accept loop waits for
    #: the GIL, and a client retries a dropped SYN after ~1 s.
    request_queue_size = 128


def serve(service: PredictionService, host: str = "127.0.0.1",
          port: int = 5000, block: bool = True) -> ThreadingHTTPServer:
    """Start the threaded HTTP server; with ``block=False`` it runs on a
    daemon thread and the caller owns ``shutdown()``."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    httpd = _Server((host, port), handler)
    logger.info("serving on http://%s:%d", host, httpd.server_address[1])
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
