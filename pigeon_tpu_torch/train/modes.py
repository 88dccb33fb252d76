"""Training modes: contrastive pretraining and the finetuning models.

Counterpart of `pigeon_tpu/train/modes.py`:

* `linear_warmup_schedule` and `pretrain_optimizer` — AdamW with betas
  (0.9, 0.98), eps 1e-6, weight decay 1e-3, clipping at 1.0 and 8-step
  gradient accumulation, its learning rate warmed up linearly, then
  decayed linearly to 0 (the preset's ``pretrain_*`` fields);
* `make_pretrain_step` — one contrastive micro-step of a `CLIPModel`
  (forward, symmetric InfoNCE, backward, the optimizer's accumulation or
  update), with ``loss``, ``in_batch_accuracy`` and ``logit_scale``;
* `make_retrieval_probe` and `retrieval_accuracy` — the in-batch
  image-to-text retrieval probe read before and after pretraining;
* `pretrain` — the loop: async periodic saves through one
  `CheckpointSession`, a final synchronous save, and a SIGTERM that
  saves and returns (`PreemptionGuard`);
* `build_finetune_model` and `build_embedding_model`.

Over a mesh (`train/mesh.py`) the in-batch negatives are the global
batch's, as the JAX package's GSPMD step computes them
(`pigeon_tpu/train/modes.py:146-160`): each rank all-gathers the image
and text embeddings with autograd (`global_contrastive_loss`) before the
loss, and DDP's average of the ranks' gradients is then the one-card
step's gradient.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from pigeon_tpu_torch.config import PigeonConfig
from pigeon_tpu_torch.models.geocell_head import GeocellHead
from pigeon_tpu_torch.models.super_guessr import (
    SuperGuessr,
    freeze_all_but_last_layer,
)

logger = logging.getLogger("pigeon_tpu_torch.train")


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax's ``linear_schedule(init, end, steps)`` at ``count``."""
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def linear_warmup_schedule(peak_lr: float, total_steps: int,
                           warmup_ratio: float) -> Callable[[int], float]:
    """``count -> lr``: linear warmup from 0 to ``peak_lr`` over
    ``max(int(total_steps * warmup_ratio), 1)`` counts, then linear decay
    to 0 over the rest (at least one), as `optax.join_schedules` of two
    linear schedules (the reference's HF ``linear`` schedule)."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay = max(total_steps - warmup, 1)

    def schedule(count: int) -> float:
        if count < warmup:
            return _linear(0.0, peak_lr, warmup, count)
        return _linear(peak_lr, 0.0, decay, count - warmup)

    return schedule


def pretrain_optimizer(params: Iterable[torch.nn.Parameter],
                       cfg: PigeonConfig, total_steps: int):
    """The pretraining AdamW over ``params`` (`train_loop.adamw`): the
    preset's betas, eps, weight decay, clipping and accumulation, with
    `linear_warmup_schedule` read by update. ``total_steps`` is counted
    in micro-batches, as the CLI passes it, while the schedule advances
    once an update, as optax's inside ``MultiSteps`` does."""
    from pigeon_tpu_torch.train.train_loop import adamw

    t = cfg.train
    schedule = linear_warmup_schedule(
        t.pretrain_learning_rate, total_steps, t.pretrain_warmup_ratio)
    return adamw(params, schedule(0), b1=t.pretrain_adam_b1,
                 b2=t.pretrain_adam_b2, eps=t.pretrain_adam_eps,
                 weight_decay=t.pretrain_weight_decay,
                 max_grad_norm=t.pretrain_max_grad_norm,
                 accum_steps=t.pretrain_grad_accum_steps, schedule=schedule)


def in_batch_accuracy(logits_per_image: torch.Tensor) -> torch.Tensor:
    """The share of images whose best text is their own."""
    target = torch.arange(logits_per_image.shape[0],
                          device=logits_per_image.device)
    return (logits_per_image.argmax(-1) == target).float().mean()


def global_contrastive_loss(out: dict, mesh):
    """`models.clip.clip_contrastive_loss` over the GLOBAL batch: the
    ranks' unit image and text embeddings all-gathered over ``mesh``'s
    ``data`` axis with autograd, in rank order, so every rank computes
    the one-card loss. The all-gather's backward sums each rank's
    gradient of that loss into the rank's own rows, ``dp`` times the
    one-card value, which DDP's average over the ``dp`` ranks brings back.
    Returns ``(loss, logits_per_image of the global batch)``."""
    from pigeon_tpu_torch.models.clip import clip_contrastive_loss
    from pigeon_tpu_torch.train.mesh import all_gather_rows

    image, text = out["image_embeds"], out["text_embeds"]
    if mesh is not None and mesh.device_mesh is not None and mesh.dp > 1:
        image = all_gather_rows(image, mesh.data_group)
        text = all_gather_rows(text, mesh.data_group)
    scale = out["logit_scale"]
    return (clip_contrastive_loss(image, text, scale),
            scale * image @ text.T)


def make_pretrain_step() -> Callable:
    """``step(state, batch) -> metrics``: one contrastive micro-step of
    ``state.model`` (a `CLIPModel`) on a device batch ``{pixel_values,
    input_ids}``, then ``state.optimizer.step()`` (an accumulation, or
    the update every k-th call). The metrics are device scalars. Over a
    mesh (``state.mesh``) the batch is the rank's slice of the global
    batch and the negatives are the global batch's
    (`global_contrastive_loss`)."""

    def step(state, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = state.runner(batch["pixel_values"], batch["input_ids"])
        loss, logits = global_contrastive_loss(out, state.mesh)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(),
                "in_batch_accuracy": in_batch_accuracy(logits.detach()),
                "logit_scale": out["logit_scale"].detach()}

    return step


def make_retrieval_probe(clip_model) -> Callable:
    """``probe(pixel_values, input_ids) -> accuracy``: in-batch
    image-to-text retrieval accuracy of ``clip_model`` (a device
    scalar), without gradients."""

    @torch.inference_mode()
    def probe(pixel_values, input_ids):
        was_training = clip_model.training
        clip_model.eval()
        try:
            out = clip_model(pixel_values, input_ids)
        finally:
            clip_model.train(was_training)
        return in_batch_accuracy(out["logits_per_image"])

    return probe


def retrieval_accuracy(probe: Callable,
                       batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                       trials: Optional[int] = 30) -> float:
    """The mean of ``probe`` over at most ``trials`` batches (0.0 for
    none)."""
    accs = []
    for i, (pixels, token_ids) in enumerate(batches):
        if trials is not None and i >= trials:
            break
        accs.append(float(probe(pixels, token_ids)))
    return float(np.mean(accs)) if accs else 0.0


def pretrain(state, step_fn: Callable,
             batches_fn: Callable[[int], Iterable[dict]], num_epochs: int,
             checkpoint_dir: Optional[str] = None, save_steps: int = 50,
             batch_to_device: Optional[Callable] = None,
             log_fn: Optional[Callable] = None,
             preemption: bool = True, preempt_poll_steps: int = 10):
    """Contrastive pretraining: ``num_epochs`` passes over
    ``batches_fn(epoch)``, a checkpoint of ``state`` every ``save_steps``
    micro-steps written while training goes on, and a final one written
    before this returns. A SIGTERM (with ``preemption``) stops at the
    next micro-step boundary, saves and returns; over several ranks
    they agree by `coordinated_flag` every ``preempt_poll_steps``
    micro-steps, so every rank stops at the same one. Returns
    ``state``."""
    from pigeon_tpu_torch.train.checkpoints import CheckpointSession
    from pigeon_tpu_torch.train.multihost import (
        coordinated_flag,
        process_count,
    )
    from pigeon_tpu_torch.train.preemption import PreemptionGuard

    nproc = process_count()
    session = CheckpointSession(checkpoint_dir) if checkpoint_dir else None
    stack = contextlib.ExitStack()
    guard = stack.enter_context(PreemptionGuard()) if preemption else None
    preempted = False
    try:
        for epoch in range(num_epochs):
            for batch in batches_fn(epoch):
                if nproc == 1 and guard is not None and guard.requested:
                    preempted = True
                    break
                if batch_to_device is not None:
                    batch = batch_to_device(batch)
                metrics = step_fn(state, batch)
                if log_fn is not None:
                    log_fn(state.step, metrics)
                if session and state.step % save_steps == 0:
                    session.save(state)
                if (nproc > 1 and guard is not None
                        and state.step % preempt_poll_steps == 0
                        and coordinated_flag(guard.requested)):
                    preempted = True
                    break
            if preempted:
                break
        if session:
            session.save(state, wait=True)
            if preempted:
                logger.warning("pretrain preempted at step %d: checkpoint "
                               "saved", state.step)
    finally:
        if session:
            session.close()
        stack.close()
    return state


def build_finetune_model(cfg: PigeonConfig, dtype=torch.bfloat16,
                         attn_impl: str = "fused",
                         remat: str = "attn_kernel") -> SuperGuessr:
    """SuperGuessr for finetuning on pixels: f32 parameters, ``dtype``
    compute, the tower on route ``attn_impl`` (default ``"fused"``: K1
    forward, K2 backward; ``"block"``: K6 and K9 forward;
    `cli.run.attn_impl` reads ``PIGEON_ATTN_IMPL``)
    and remat'd under ``remat``, one of `models.clip.REMATS` (default
    ``attn_kernel``: the attention kernel's and the attention outputs
    kept, the rest recomputed; ``cli.run.remat_policy`` reads
    ``PIGEON_REMAT``), every encoder layer but
    the last frozen (reference `train_modes.py:67-107`). The weights are
    uninitialised: see `models.super_guessr.init_weights`."""
    model = SuperGuessr(cfg.vision, cfg.head, dtype=dtype,
                        attn_impl=attn_impl, remat=remat)
    return freeze_all_but_last_layer(model)


def build_embedding_model(cfg: PigeonConfig) -> GeocellHead:
    """The geocell head alone, in f32, for head-only training on
    precomputed embeddings (``finetune --embeddings``; reference
    `train_modes.py:110-133`). Uninitialised, as above."""
    return GeocellHead(cfg.head, dtype=torch.float32)
