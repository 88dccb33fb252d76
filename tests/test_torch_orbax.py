"""`scripts/convert_orbax_to_torch.py` on the CPU: a JAX finetuning run at
``--tiny`` size (a pixel `SuperGuessr`, and a head-only `GeocellHead`)
takes two train steps and is saved by Orbax; the converter writes the
port's checkpoint, which must hold the same weights, Adam moments and
step bit for bit; one more step on each side must leave the parameters
within 1e-4 and move them alike. The converter refuses an optimizer
chain with clipping or ``MultiSteps`` and moments on a frozen
parameter."""

import importlib.util
import os

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CELLS, BATCH, DIM = 23, 3, 64


def load_converter():
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_to_torch",
        os.path.join(ROOT, "scripts", "convert_orbax_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CONVERT = load_converter()
#: Each run's flags (the JAX CLI's ``finetune``'s, and the converter's).
RUNS = {"pixels": ("--panorama", "-m", "--heading"),
        "head_only": ("--panorama", "--embeddings", str(DIM))}


def write_cells(root) -> np.ndarray:
    rng = np.random.default_rng(0)
    cells = np.stack([rng.uniform(-180, 180, NUM_CELLS),
                      rng.uniform(-60, 70, NUM_CELLS)], -1) \
        .astype(np.float32)
    pd.DataFrame({"name": [f"c{i}" for i in range(NUM_CELLS)],
                  "lng": cells[:, 0], "lat": cells[:, 1]}).to_csv(
        root / "cells.csv", index=False)
    return cells


def batches(run: str, n: int, seed=3) -> list:
    """Seeded batches of panoramas (every label the multi-task loss
    reads) or of embeddings (the head-only batch: labels and cells)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"labels": np.stack([rng.uniform(-180, 180, BATCH),
                                     rng.uniform(-60, 70, BATCH)], -1)
                 .astype(np.float32),
                 "labels_clf": rng.integers(0, NUM_CELLS, BATCH)
                 .astype(np.int32)}
        if run == "head_only":
            batch["inputs"] = rng.normal(size=(BATCH, 4, DIM)) \
                .astype(np.float32)
        else:
            heading = rng.uniform(0, 2 * np.pi, (BATCH, 4))
            batch.update(
                inputs=rng.integers(0, 256, (BATCH, 4, 64, 64, 3),
                                    dtype=np.uint8),
                labels_multi_task=rng.normal(size=(BATCH, 6))
                .astype(np.float32),
                labels_climate=rng.integers(0, 28, BATCH).astype(np.int32),
                labels_month=rng.integers(0, 12, BATCH).astype(np.int32),
                heading=np.stack([np.sin(heading), np.cos(heading)], -1)
                .astype(np.float32))
        out.append(batch)
    return out


def converter_argv(root, run: str, *extra):
    return ["torchrun", "--orbax-dir", str(root / "orbax"),
            "--checkpoint-dir", str(root / "port"), "--tiny",
            "--geocells", str(root / "cells.csv"), *RUNS[run], *extra]


def jax_step(args, cells):
    """``(state, step)``: the JAX ``finetune`` run's initial state and its
    train step in f32 on the xla route, with the CLI's gradient mask for
    a pixel run."""
    from pigeon_tpu.cli import run as jax_cli
    from pigeon_tpu.models.geocell_head import GeocellHead
    from pigeon_tpu.train.modes import build_finetune_model
    from pigeon_tpu.train.train_loop import make_train_step

    cfg = jax_cli.config_with_cells(CONVERT.flag_namespace(args), cells)
    target, opt, _ = CONVERT.jax_target(args)
    mask = None
    if args.embeddings:
        model = GeocellHead(cfg.head)
    else:
        model, mask_builder = build_finetune_model(
            cfg, dtype=jnp.float32, attn_impl="xla", remat="none")
        mask = mask_builder(target.params)
    return target, make_train_step(model, opt, cfg.head, cells,
                                   grad_mask=mask, donate=False)


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_state(args):
    """The port's model and AdamW for ``args``' run, f32, plain route."""
    from pigeon_tpu_torch.train.modes import (
        build_embedding_model,
        build_finetune_model,
    )
    from pigeon_tpu_torch.train.train_loop import TrainState, adamw

    cfg = CONVERT.port_config(args)
    model = build_embedding_model(cfg) if args.embeddings else \
        build_finetune_model(cfg, dtype=torch.float32, attn_impl="plain",
                             remat="none")
    return cfg, TrainState(model, adamw(model.parameters(),
                                        cfg.train.learning_rate))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_converted_run_matches_jax(tmp_path, run):
    """Two JAX steps, Orbax, the converter: weights and moments bit for
    bit, the step count equal; a third step on each side within 1e-4,
    each parameter moved alike."""
    from pigeon_tpu.train.checkpoints import save_checkpoint
    from pigeon_tpu_torch.models.jax_bridge import (
        head_state_dict_from_jax,
        state_dict_from_jax,
    )
    from pigeon_tpu_torch.train.checkpoints import restore_checkpoint
    from pigeon_tpu_torch.train.train_loop import (
        batch_to_device,
        make_train_step,
    )

    cells = write_cells(tmp_path)
    argv = converter_argv(tmp_path, run)
    args = CONVERT.build_parser().parse_args(argv)
    jstate, step = jax_step(args, cells)
    data = batches(run, 3)
    for batch in data[:2]:
        jstate, _ = step(jstate, jax_batch(batch), jax.random.PRNGKey(0))
    save_checkpoint(str(tmp_path / "orbax"), jstate)
    assert CONVERT.main(argv) == 0

    cfg, state = port_state(args)
    restore_checkpoint(str(tmp_path / "port" / "torchrun"), state)
    assert state.step == 2
    bridge = head_state_dict_from_jax if args.embeddings \
        else state_dict_from_jax
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
    (adam, *_), = host.opt_state
    weights, mu, nu = (bridge(t) for t in (host.params, adam.mu, adam.nu))
    model = state.model
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), weights[name]), name
    trainable = [p for g in state.optimizer.param_groups
                 for p in g["params"]]
    names = {id(p): n for n, p in model.named_parameters()}
    assert len(trainable) == sum(p.requires_grad
                                 for p in model.parameters())
    assert len(trainable) < len(names) or args.embeddings
    for p in trainable:
        saved = state.optimizer.state[p]
        assert saved["step"].item() == int(adam.count) == 2
        assert torch.equal(saved["exp_avg"], mu[names[id(p)]])
        assert torch.equal(saved["exp_avg_sq"], nu[names[id(p)]])

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    jstate, _ = step(jstate, jax_batch(data[2]), jax.random.PRNGKey(0))
    make_train_step(cfg.head, torch.from_numpy(cells))(
        state, batch_to_device(data[2], "cpu"))
    after = bridge(jax.tree_util.tree_map(np.asarray,
                                          jax.device_get(jstate.params)))
    moved = {"port": set(), "jax": set()}
    for name, p in model.named_parameters():
        got, want = p.detach(), after[name]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4, msg=name)
        for side, value in (("port", got), ("jax", want)):
            if not torch.equal(value, before[name]):
                moved[side].add(name)
        if name.endswith("k_proj.bias"):
            # Its gradient is 0 in exact arithmetic (the softmax ignores a
            # shift shared by all keys): its updates follow rounding noise.
            continue
        # Both updates are lr * m / (sqrt(v) + eps) from the same moments
        # (the lr is 2e-5): they agree to the rounding of the parameter
        # they land on, two ulps of a LayerNorm scale near 1.
        torch.testing.assert_close(got - before[name], want - before[name],
                                   rtol=0, atol=2 * 2.0 ** -23, msg=name)
    # Every trainable parameter moves but the post-LN's: it feeds the
    # pooled CLS output, which the head does not read.
    assert moved["port"] == moved["jax"] == {
        names[id(p)] for p in trainable} - {"vision.post_ln.weight",
                                             "vision.post_ln.bias"}


@pytest.mark.parametrize("chain,why", [
    (dict(accum_steps=2), "MultiSteps"),
    (dict(max_grad_norm=1.0), "gradient clipping"),
    (dict(max_grad_norm=1.0, accum_steps=2), "MultiSteps")])
def test_converter_refuses_a_pretraining_chain(tmp_path, chain, why):
    """A run saved with pretraining's optimizer chain is refused from the
    checkpoint alone: the converter gets a finetune run's flags."""
    from pigeon_tpu.train.checkpoints import save_checkpoint
    from pigeon_tpu.train.train_loop import adamw

    write_cells(tmp_path)
    argv = converter_argv(tmp_path, "head_only")
    target, _, lr = CONVERT.jax_target(
        CONVERT.build_parser().parse_args(argv))
    opt_state = adamw(lr, **chain).init(target.params)
    save_checkpoint(str(tmp_path / "orbax"),
                    target.replace(opt_state=opt_state))
    with pytest.raises(SystemExit, match=why):
        CONVERT.main(argv)
    assert not (tmp_path / "port").exists()


def test_converter_refuses_moments_on_a_frozen_parameter(tmp_path):
    from pigeon_tpu.train.checkpoints import save_checkpoint

    write_cells(tmp_path)
    argv = converter_argv(tmp_path, "pixels")
    target, _, _ = CONVERT.jax_target(
        CONVERT.build_parser().parse_args(argv))
    (adam, *_), = target.opt_state
    layers = adam.mu["vision"]["encoder"]["layers"]
    layers["fc1"]["bias"] = layers["fc1"]["bias"].at[0, 0].set(1.0)
    save_checkpoint(str(tmp_path / "orbax"), target)
    with pytest.raises(SystemExit, match="layers.0.fc1.bias is frozen"):
        CONVERT.main(argv)
