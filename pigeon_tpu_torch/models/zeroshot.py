"""Zero-shot geocell classification through CLIP text prompts.

Counterpart of `pigeon_tpu/models/zeroshot.py`: one prompt a geocell
(`geocell_prompts`), its text-tower embedding (`embed_prompts`), and a
cosine classifier of images against those embeddings
(`make_zero_shot_classifier`, and `make_zero_shot_eval_step` with the
eval-step contract of `train.train_loop.make_eval_step`, which
``evaluate --zeroshot`` runs through the metric suite). The projections
run in f32 on the towers' pooled outputs, as the JAX package's
``pooled @ kernel`` promotes them.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def geocell_prompts(records: Sequence[dict],
                    template: str = "A photo located in {place}.") -> List[str]:
    """One text prompt a geocell record: ``admin_1, country`` (or the
    country alone) where the record names them, else the centroid's
    latitude and longitude."""
    prompts = []
    for r in records:
        admin_1 = str(r.get("admin_1", "") or "")
        country = str(r.get("country", "") or "")
        if country and country.lower() not in ("nan", "none", ""):
            place = f"{admin_1}, {country}" if admin_1 and \
                admin_1.lower() not in ("nan", "none", "") else country
        else:
            place = (f"latitude {float(r['lat']):.1f}, "
                     f"longitude {float(r['lng']):.1f}")
        prompts.append(template.format(place=place))
    return prompts


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@torch.inference_mode()
def embed_prompts(clip_model, token_ids) -> torch.Tensor:
    """Tokenized prompts ``(C, S)`` -> L2-normalised f32 text embeddings
    ``(C, projection_dim)`` on the model's device."""
    device = clip_model.logit_scale.device
    ids = torch.as_tensor(np.asarray(token_ids), device=device)
    _, pooled = clip_model.text(ids)
    return _unit(pooled.float() @ clip_model.text_projection.weight.T)


def _image_logits(clip_model, pixels, text_embeds) -> torch.Tensor:
    """``(B, C)`` f32 logits: the vision tower's pooled output projected
    in f32, normalised, against ``text_embeds``, times the logit scale."""
    _, pooled = clip_model.vision(pixels)
    img = _unit(pooled.float() @ clip_model.visual_projection.weight.T)
    return clip_model.logit_scale.exp() * img @ text_embeds.T, img


def make_zero_shot_classifier(clip_model, text_embeds) -> Callable:
    """``pixels -> (probs, logits)`` over the geocell prompts: one
    vision-tower forward and a ``(B, D) x (D, C)`` product an image."""

    @torch.inference_mode()
    def classify(pixel_values):
        clip_model.eval()
        logits, _ = _image_logits(clip_model, pixel_values, text_embeds)
        return torch.softmax(logits, dim=-1), logits

    return classify


def make_zero_shot_eval_step(clip_model, text_embeds, geocells,
                             num_candidates: int = 5) -> Callable:
    """``eval_step(model, batch) -> (parts, predictions)`` with the
    contract of `train.train_loop.make_eval_step` (the model argument is
    ignored: ``clip_model`` is bound), so ``evaluate --zeroshot`` runs
    through `train.loop.evaluate_model`. ``parts["loss"]`` is the cross
    entropy against ``labels_clf`` where the batch has them, else 0; the
    embedding is the normalised image projection; there are no
    multi-task outputs. The vision tower runs on the route it was built
    with. A batch with ``row_index`` (a rank's padded rows) takes its
    loss over the rows that are not padding, counted in
    ``parts["rows"]``."""
    from pigeon_tpu_torch.models.geocell_head import geocell_predictions

    device = clip_model.logit_scale.device
    cells = torch.as_tensor(np.asarray(geocells, np.float32), device=device)

    @torch.inference_mode()
    def eval_step(_model, batch):
        clip_model.eval()
        logits, img = _image_logits(clip_model, batch["inputs"], text_embeds)
        preds = geocell_predictions(logits, cells, num_candidates)
        keep = (batch["row_index"] >= 0 if "row_index" in batch
                else slice(None))
        loss = torch.zeros((), device=logits.device)
        if "labels_clf" in batch:
            loss = F.cross_entropy(logits[keep],
                                   batch["labels_clf"][keep].long())
        preds.update(embedding=img, preds_mt=None, preds_climate=None,
                     preds_month=None)
        parts = {"loss": loss}
        if "row_index" in batch:
            parts["rows"] = keep.sum()
        return parts, preds

    return eval_step
