#!/usr/bin/env python3
"""Convert a JAX finetuning run's Orbax checkpoint into the PyTorch port's.

    python scripts/convert_orbax_to_torch.py NAME --orbax-dir DIR \
        --geocells C.csv [--tiny] [--yfcc] [--panorama] [-m] [--heading] \
        [--embeddings DIM] [--step N] [--checkpoint-dir saved_models]

Runs where JAX, Flax, Optax and Orbax are installed (not on the GPU
machine): it is the one file of the repo that imports both `pigeon_tpu`
and `pigeon_tpu_torch`. Its steps:

1. the JAX `TrainState` target is rebuilt from the flags the JAX CLI's
   ``finetune`` takes: `build_finetune_model` (pixels), or
   `build_embedding_model` on embeddings of width ``--embeddings DIM``
   (head-only), then `create_train_state` with the CLI's `adamw`;
2. the run is restored into it by `pigeon_tpu.train.checkpoints.
   restore_checkpoint` (the newest step, or ``--step``);
3. the weights, through `pigeon_tpu_torch.models.jax_bridge`, and the Adam
   moments go into the port's model and `adamw`, written as
   ``--checkpoint-dir/NAME/step_N/`` (DCP) by the port's `save_checkpoint`:
   ``finetune --resume``, ``serve``, ``evaluate`` and ``predict`` of the
   port read it.

The moments map exactly: optax's ``ScaleByAdamState(count, mu, nu)``
updates by ``lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)`` and
torch's AdamW by ``lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) +
eps)``, the same formula with ``t = count``. ``mu`` and ``nu`` take the
weights' name mapping; the port's optimizer holds the trainable
parameters only, each with ``{"step": count, "exp_avg": mu, "exp_avg_sq":
nu}``. The script refuses, naming the reason, a run whose optimizer
chain holds gradient clipping or ``MultiSteps`` accumulation (those
belong to pretraining; the chain is read from the checkpoint's own tree
metadata before anything is restored), and a run in which a parameter
the port freezes has non-zero moments.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("name", help="run name: the output is "
                                "CHECKPOINT_DIR/NAME/step_N/")
    p.add_argument("--orbax-dir", required=True,
                   help="the JAX run's Orbax checkpoint directory")
    p.add_argument("--checkpoint-dir", default="saved_models",
                   help="the port's checkpoint root")
    p.add_argument("--step", type=int, default=None,
                   help="the step to convert (default: the newest)")
    p.add_argument("--geocells", required=True, help="geocell CSV path")
    p.add_argument("--embeddings", type=int, default=None, metavar="DIM",
                   help="a head-only run (finetune --embeddings) on "
                        "embeddings of this width")
    p.add_argument("--panorama", action="store_true")
    p.add_argument("-m", "--multitask", action="store_true")
    p.add_argument("--heading", action="store_true")
    p.add_argument("--yfcc", action="store_true")
    p.add_argument("--tiny", action="store_true")
    return p


def flag_namespace(args) -> argparse.Namespace:
    """The flags both CLIs' ``make_config`` read."""
    return argparse.Namespace(
        tiny=args.tiny, yfcc=args.yfcc, panorama=args.panorama,
        multitask=args.multitask, heading=args.heading, landmarks=False,
        model=None, geocells=args.geocells)


def jax_target(args):
    """``(target, optimizer, learning_rate)``: the JAX `TrainState` a
    ``finetune`` run of these flags starts from (the restore target), and
    the run's optimizer."""
    import jax
    import jax.numpy as jnp

    from pigeon_tpu.cli import run as jax_cli
    from pigeon_tpu.train.modes import (
        build_embedding_model,
        build_finetune_model,
    )
    from pigeon_tpu.train.train_loop import adamw, create_train_state

    ns = flag_namespace(args)
    cells, _ = jax_cli.load_geocells(ns)
    cfg = jax_cli.config_with_cells(ns, cells)
    views = (4,) if cfg.head.panorama else ()
    if args.embeddings:
        model = build_embedding_model(cfg)
        example = jnp.zeros((2, *views, args.embeddings))
    else:
        model, _ = build_finetune_model(cfg, attn_impl="xla")
        size = cfg.vision.image_size
        example = jnp.zeros((2, *views, size, size, 3))
    lr = cfg.train.learning_rate
    opt = adamw(lr)
    target = create_train_state(jax.random.PRNGKey(cfg.train.seed), model,
                                opt, (example,))
    return target, opt, lr


def checked_step(directory: str, step: int | None) -> int:
    """The step to convert (the newest unless ``step``); raises
    SystemExit, naming the reason, unless the checkpoint's optimizer state
    is the finetune AdamW's (`pigeon_tpu.train.train_loop.adamw` without
    clipping or accumulation). The chain is read from the checkpoint's
    tree metadata, so a run is refused whatever flags were given."""
    import orbax.checkpoint as ocp

    from pigeon_tpu.train.checkpoints import latest_step

    step = step if step is not None else latest_step(directory)
    if step is None:
        raise SystemExit(f"no checkpoint found in {directory}")
    path = os.path.join(os.path.abspath(directory), str(step), "default")
    chain = ocp.StandardCheckpointer().metadata(path) \
        .item_metadata.tree["opt_state"]
    if isinstance(chain, dict) and "inner_opt_state" in chain:
        why = "optax.MultiSteps gradient accumulation"
    elif isinstance(chain, list) and len(chain) > 1:
        why = "a transform before AdamW (gradient clipping)"
    elif not (isinstance(chain, list) and chain
              and isinstance(chain[0], list) and chain[0]
              and isinstance(chain[0][0], dict)
              and {"count", "mu", "nu"} <= set(chain[0][0])):
        why = "an optimizer other than the finetune AdamW"
    else:
        return step
    raise SystemExit(f"the run's optimizer holds {why}: the port's finetune "
                     "AdamW has no such state (pretraining's chain is not "
                     "converted)")


def port_config(args):
    """The port's config for these flags, as its ``finetune`` sizes it:
    the head to the geocells and, head-only, to the embeddings' width."""
    from pigeon_tpu_torch.cli import run as port_cli

    ns = flag_namespace(args)
    cfg = port_cli.make_config(ns)
    head = dict(num_cells=len(port_cli.load_geocells(ns)))
    if args.embeddings:
        head["embed_dim"] = args.embeddings
    return cfg.replace(head=dataclasses.replace(cfg.head, **head))


def port_model(args, jax_params):
    """``(model, bridge)``: the port's model for these flags (the
    parameters the port freezes frozen), holding the weights ``bridge``
    maps from ``jax_params``."""
    from pigeon_tpu_torch.models.jax_bridge import (
        head_state_dict_from_jax,
        state_dict_from_jax,
    )
    from pigeon_tpu_torch.train.modes import (
        build_embedding_model,
        build_finetune_model,
    )

    cfg = port_config(args)
    if args.embeddings:
        model, bridge = build_embedding_model(cfg), head_state_dict_from_jax
    else:
        model = build_finetune_model(cfg, attn_impl="plain", remat="none")
        bridge = state_dict_from_jax
    model.load_state_dict(bridge(jax_params), strict=True)
    return model, bridge


def convert(args, restored, learning_rate: float):
    """The port's `TrainState` of the restored JAX state: the weights, and
    the Adam moments of the trainable parameters in the port's AdamW."""
    import jax
    import torch

    from pigeon_tpu_torch.train.train_loop import TrainState, adamw

    host = jax.tree_util.tree_map(np.asarray, jax.device_get(restored))
    (adam, *_), = host.opt_state
    model, bridge = port_model(args, host.params)
    mu, nu = bridge(adam.mu), bridge(adam.nu)
    for name, p in model.named_parameters():
        if not p.requires_grad and (mu[name].any() or nu[name].any()):
            raise SystemExit(f"{name} is frozen in the port's finetune "
                             "model, but the run's Adam moments for it are "
                             "not zero: it trained there")
    optimizer = adamw(model.parameters(), learning_rate)
    names = {id(p): n for n, p in model.named_parameters()}
    count = float(np.asarray(adam.count))
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            optimizer.state[p] = {"step": torch.tensor(count),
                                  "exp_avg": mu[name].clone(),
                                  "exp_avg_sq": nu[name].clone()}
    return TrainState(model, optimizer, int(np.asarray(host.step)))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sys.path.insert(0, ROOT)
    from pigeon_tpu.train.checkpoints import restore_checkpoint
    from pigeon_tpu_torch.train.checkpoints import save_checkpoint

    orbax_step = checked_step(args.orbax_dir, args.step)
    target, _, lr = jax_target(args)
    restored = restore_checkpoint(args.orbax_dir, target, step=orbax_step)
    state = convert(args, restored, lr)
    out = os.path.join(args.checkpoint_dir, args.name)
    step = save_checkpoint(out, state)
    trained = sum(len(g["params"]) for g in state.optimizer.param_groups)
    print(f"wrote {out}/step_{step}/: {len(state.model.state_dict())} "
          f"tensors, Adam moments of {trained} trainable parameters")
    return 0


if __name__ == "__main__":
    sys.exit(main())
