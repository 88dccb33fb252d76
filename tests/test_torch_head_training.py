"""Head-only training of the PyTorch port against the JAX package, on the
CPU: both CLIs' ``finetune --embeddings`` for 2 epochs on the same bank
and metadata, the port's head started from the JAX initialisation
(bridged), must see the same batches in the same order, end with head
parameters within 1e-4 (each update alike), and report the same eval
metrics each epoch (accuracies equal, the rest within the ``evaluate``
tests' 1e-4 relative); the port's smoothing is K10's plain version. Also
the flags the port refuses there, and the head-only batches."""

import os

import numpy as np
import pandas as pd
import pytest
import jax
import torch

from pigeon_tpu_torch.cli import run as cli
from pigeon_tpu_torch.models.jax_bridge import head_state_dict_from_jax
from tests.test_torch_evaluate import assert_metrics_match

NUM_CELLS, DIM, BATCH, EPOCHS = 13, 64, 8, 2
TRAIN_ROWS, VAL_ROWS = 26, 11
#: Each run's head flags; every bank is (N, 4, D) panoramas, which a
#: single-image head averages over the views.
CASES = {"panorama": ("--panorama",), "single": (),
         "single_heading": ("--heading",)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Geocells, a metadata CSV (train and val rows, labels near a cell
    that the embeddings encode, a geocell column) and a bank of (N, 4, D)
    embeddings written out of order with their indices."""
    root = tmp_path_factory.mktemp("head_world")
    rng = np.random.default_rng(0)
    cells = np.stack([rng.uniform(-180, 180, NUM_CELLS),
                      rng.uniform(-60, 70, NUM_CELLS)], -1)
    pd.DataFrame({"name": [f"c{i}" for i in range(NUM_CELLS)],
                  "lng": cells[:, 0], "lat": cells[:, 1]}).to_csv(
        root / "cells.csv", index=False)
    n = TRAIN_ROWS + VAL_ROWS
    cell = rng.integers(0, NUM_CELLS, n)
    lla = cells[cell] + rng.normal(0, 2, (n, 2))
    selection = np.array(["train"] * TRAIN_ROWS + ["val"] * VAL_ROWS)
    rng.shuffle(selection)
    pd.DataFrame({"image": [f"{i}.png" for i in range(n)],
                  "lng": lla[:, 0], "lat": lla[:, 1], "selection": selection,
                  "geocell_idx": cell}).to_csv(root / "meta.csv",
                                               index=False)
    codes = rng.normal(size=(NUM_CELLS, DIM))
    (root / "emb").mkdir()
    for split in ("train", "val"):
        rows = cell[selection == split]
        emb = codes[rows][:, None] + rng.normal(0, 1, (len(rows), 4, DIM))
        order = rng.permutation(len(rows))
        np.save(root / "emb" / f"{split}.npy", emb[order].astype(np.float32))
        np.save(root / "emb" / f"{split}_indices.npy", order)
    return root


def finetune_argv(root, ckpt, *extra):
    return ["finetune", "headrun", "--tiny", "--metadata",
            str(root / "meta.csv"), "--geocells", str(root / "cells.csv"),
            "--embeddings", str(root / "emb"), "--batch-size", str(BATCH),
            "--epochs", str(EPOCHS), "--checkpoint-dir", str(ckpt), *extra]


def spy_train_model(monkeypatch, module, into: dict):
    """Wrap ``module.train_model``: record the initial parameters (as a
    numpy tree or state dict), the labels of every batch in order, and
    the final state and history."""
    real = module.train_model

    def spy(state, step, eval_step, train_fn, eval_fn, **kw):
        def record(kind, batches):
            for batch in batches:
                into["batches"].append((kind, np.array(batch["labels"])))
                yield batch

        into["batches"] = []
        into["initial"] = (jax.tree_util.tree_map(np.array, state.params)
                           if hasattr(state, "params") else
                           {k: v.detach().clone() for k, v in
                            state.model.state_dict().items()})
        out = real(state, step, eval_step,
                   lambda epoch: record(("train", epoch), train_fn(epoch)),
                   lambda: record("eval", eval_fn()), **kw)
        into["state"], into["history"] = out
        return out

    monkeypatch.setattr(module, "train_model", spy)


@pytest.mark.parametrize("case", sorted(CASES))
def test_head_training_matches_jax(world, tmp_path, monkeypatch, case):
    """The JAX CLI's run, then the port's from its initial head: the same
    batches, final parameters and each epoch's metrics."""
    from pigeon_tpu.cli import run as jax_cli
    from pigeon_tpu.train import loop as jax_loop
    from pigeon_tpu.train.checkpoints import latest_step as jax_latest
    from pigeon_tpu_torch.models import super_guessr
    from pigeon_tpu_torch.train import loop as port_loop
    from pigeon_tpu_torch.train.checkpoints import latest_step

    monkeypatch.chdir(tmp_path)
    seen = {"jax": {}, "port": {}}
    spy_train_model(monkeypatch, jax_loop, seen["jax"])
    spy_train_model(monkeypatch, port_loop, seen["port"])
    assert jax_cli.main(finetune_argv(world, tmp_path / "jax",
                                      *CASES[case])) == 0
    start = head_state_dict_from_jax(seen["jax"]["initial"])

    def jax_init(model, seed):
        model.load_state_dict(start, strict=True)
        return model

    monkeypatch.setattr(super_guessr, "init_weights", jax_init)
    assert cli.main(finetune_argv(world, tmp_path / "port", *CASES[case],
                                  "--device", "cpu")) == 0

    steps = EPOCHS * (TRAIN_ROWS // BATCH)
    got, want = seen["port"], seen["jax"]
    assert len(got["batches"]) == len(want["batches"]) == (
        steps + EPOCHS * (VAL_ROWS // BATCH))
    for (kind, labels), (jkind, jlabels) in zip(got["batches"],
                                                want["batches"]):
        assert kind == jkind
        np.testing.assert_array_equal(labels, jlabels)
    assert got["state"].step == int(want["state"].step) == steps
    assert latest_step(str(tmp_path / "port" / "headrun")) == jax_latest(
        str(tmp_path / "jax" / "headrun"))

    final = head_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(want["state"].params)))
    for name, value in got["state"].model.state_dict().items():
        torch.testing.assert_close(value, final[name], rtol=0, atol=1e-4,
                                   msg=name)
        # Adam moves each entry by ~lr (2e-5) a step: the updates agree
        # to the rounding of the parameters they land on.
        torch.testing.assert_close(value - start[name],
                                   final[name] - start[name], rtol=0,
                                   atol=2 * 2.0 ** -23, msg=name)
        assert not torch.equal(value, start[name]), name
    assert len(got["history"]) == len(want["history"]) == EPOCHS
    for metrics, jmetrics in zip(got["history"], want["history"]):
        assert_metrics_match(metrics, {k: float(v)
                                       for k, v in jmetrics.items()})


@pytest.mark.parametrize("flag", [("--base", "b.pt"), ("--resume",),
                                  ("--multitask",), ("--sample", "4")])
def test_head_training_refuses_what_jax_ignores(world, tmp_path, flag):
    """``--base`` and ``--resume`` (the JAX CLI ignores them here), ``-m``
    (its loss fails: the batches carry no multi-task labels) and
    ``--sample`` (the JAX CLI ignores it) stop the command by name."""
    with pytest.raises(SystemExit, match=f"does not take {flag[0]}"):
        cli.main(finetune_argv(world, tmp_path, *flag, "--device", "cpu"))


def test_embedding_batches_drop_tails_and_carry_only_labels(world):
    """Full batches only, in training and evaluation; the epoch's seed
    shuffles; ``inputs``, ``labels`` and ``labels_clf`` and nothing
    else."""
    from pigeon_tpu_torch.train.embed import embedding_batches

    rows = pd.read_csv(world / "meta.csv").iloc[:11]
    emb = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
    plain = list(embedding_batches(emb, rows, 4))
    assert [len(b["inputs"]) for b in plain] == [4, 4]
    assert set(plain[0]) == {"inputs", "labels", "labels_clf"}
    np.testing.assert_array_equal(plain[1]["inputs"], emb[4:8])
    order = np.arange(11)
    np.random.default_rng(1).shuffle(order)
    shuffled = list(embedding_batches(emb, rows, 4, shuffle_seed=1))
    np.testing.assert_array_equal(shuffled[0]["inputs"], emb[order[:4]])
    np.testing.assert_array_equal(
        shuffled[0]["labels_clf"], rows["geocell_idx"].to_numpy()[order[:4]])
    assert "labels_clf" not in next(embedding_batches(
        emb, rows.drop(columns=["geocell_idx"]), 4))


def test_head_only_run_is_a_geocell_head_of_the_bank_width(world, tmp_path):
    """`build_finetune` with ``--embeddings``: an f32 `GeocellHead` sized
    to the geocells and the bank's width, every parameter in AdamW."""
    from pigeon_tpu_torch.models.geocell_head import GeocellHead

    run = cli.build_finetune(cli.build_parser().parse_args(finetune_argv(
        world, tmp_path, "--panorama", "--device", "cpu")))
    model = run.state.model
    assert isinstance(model, GeocellHead) and model.dtype == torch.float32
    assert model.cell_layer.weight.shape == (NUM_CELLS, DIM)
    assert sum(len(g["params"]) for g in run.state.optimizer.param_groups) \
        == len(list(model.parameters()))
    shapes = [b["inputs"].shape for b in run.train_batches(0)]
    assert shapes == [(BATCH, 4, DIM)] * (TRAIN_ROWS // BATCH)
    assert os.path.basename(run.checkpoint_dir) == "headrun"
