"""The port's multi-process primitives and commands on gloo CPU ranks
(`pigeon_tpu_torch/train/multihost.py`, the CLI under a process group),
against the JAX package's `train/multihost.py` and the port's own
one-process runs.

The ranks (`tests/torch_ranks.py`) start once for this module and run
the CLI's `main` in their process group, as `torchrun` ranks would:
`host_slice`, `iter_host_batches` and `coordinated_flag`; a SIGTERM to
one rank, after which both save and stop at the same step; ``embed``'s
banks, ``evaluate``'s metrics and ``predict``'s rows equal to one
process; DCP checkpoints written at 2 ranks and restored at 1, and back;
head-only training at 2 ranks; and `dryrun_multichip(4)`.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import torch_ranks
from pigeon_tpu_torch.cli.run import main
from pigeon_tpu_torch.train import multihost as mh


@pytest.fixture(scope="module")
def pool2():
    pool = torch_ranks.RankPool(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def pool4():
    pool = torch_ranks.RankPool(4)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """PNG panoramas, a metadata CSV with every label column (months
    everywhere) and 6 geocells; 10 train, 4 val and 5 test rows."""
    tmp = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(12)
    (tmp / "imgs").mkdir()
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (30 + 5 * i, 40, 3),
                                     dtype=np.uint8)).save(
            tmp / "imgs" / f"{i}.png")
    rows = []
    for i in range(19):
        v = rng.integers(0, 6, 4)
        rows.append(dict(
            image=f"{v[0]}.png", image_2=f"{v[1]}.png",
            image_3=f"{v[2]}.png", image_4=f"{v[3]}.png",
            lng=rng.uniform(-180, 180), lat=rng.uniform(-60, 70),
            selection="train" if i < 10 else "val" if i < 14 else "test",
            **dict(zip(("elevation", "population", "temp_avg", "temp_diff",
                        "prec_avg", "prec_diff"), rng.normal(size=6))),
            climate_zone_idx=rng.integers(0, 28),
            month=rng.integers(0, 12), heading=rng.uniform(0, 360),
            geocell_idx=rng.integers(0, 6)))
    pd.DataFrame(rows).to_csv(tmp / "meta.csv", index=False)
    cells = np.stack([np.linspace(-150, 150, 6), np.linspace(-50, 60, 6)],
                     -1)
    pd.DataFrame({"name": list("abcdef"), "lng": cells[:, 0],
                  "lat": cells[:, 1]}).to_csv(tmp / "cells.csv", index=False)
    return tmp


def common(world, *extra):
    return ["--tiny", "--device", "cpu", "--panorama", "-m", "--heading",
            "--metadata", str(world / "meta.csv"),
            "--images", str(world / "imgs"),
            "--geocells", str(world / "cells.csv"), *extra]


def run_here(argv, cwd):
    """`main(argv)` in this process (no process group), from ``cwd``."""
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(list(argv))
    finally:
        os.chdir(old)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, nproc", [(10, 2), (11, 2), (7, 4), (3, 4),
                                      (1, 3)])
def test_host_slice_matches_jax(n, nproc):
    from pigeon_tpu.train.multihost import host_slice as jax_slice

    for pid in range(nproc):
        assert mh.host_slice(n, pid, nproc) == jax_slice(n, pid, nproc)
    covered = np.concatenate([np.arange(n)[mh.host_slice(n, p, nproc)]
                              for p in range(nproc)])
    np.testing.assert_array_equal(covered, np.arange(n))


def test_primitives_on_two_ranks(pool2):
    r0, r1 = pool2.run("primitives", 11)
    assert (r0["slice"], r1["slice"]) == (slice(0, 6), slice(6, 11))
    assert (r0["rank"], r1["rank"], r0["count"]) == (0, 1, 2)
    assert r0["primary"] and not r1["primary"]
    for r in (r0, r1):
        np.testing.assert_array_equal(r["gathered"], [[0, 0], [1, 10]])
        assert r["one"] is True and r["none"] is False


def test_one_process_primitives_are_the_identity():
    assert not mh.distributed()
    assert (mh.process_index(), mh.process_count()) == (0, 1)
    assert mh.coordinated_flag(True) and not mh.coordinated_flag(False)
    np.testing.assert_array_equal(mh.allgather_hosts(np.arange(3)),
                                  [[0, 1, 2]])


def test_global_batch_the_data_axis_does_not_divide_stops():
    from pigeon_tpu_torch.train.mesh import Mesh

    assert mh.check_global_batch(8, Mesh(dp=2)) == 4
    with pytest.raises(ValueError, match="global batch 7 must divide"):
        mh.check_global_batch(7, Mesh(dp=2))


@pytest.mark.parametrize("tp", [1, 2])
def test_host_batches_are_the_one_process_batches(pool2, world, tp):
    """Each rank decodes its data rank's rows of every shuffled global
    batch; joined in rank order they are the one-process batches (under
    ``tp = 2`` both ranks load the whole batch)."""
    from pigeon_tpu_torch.data.pipeline import TabularImageDataset, \
        iter_batches

    ds = TabularImageDataset(pd.read_csv(world / "meta.csv"),
                             str(world / "imgs"), image_size=32,
                             panorama=True)
    want = [b["labels"][:, 1].tolist()
            for b in iter_batches(ds, 4, shuffle=True, seed=3,
                                  drop_last=True)]
    got = pool2.run("host_batches", str(world / "meta.csv"),
                    str(world / "imgs"), 4, tp, seed=3)
    for i, batch in enumerate(want):
        if tp == 1:
            joined = got[0][i][0] + got[1][i][0]
        else:
            joined = got[0][i][0]
            assert got[1][i][0] == joined
        np.testing.assert_allclose(joined, batch)
        assert got[0][i][1] == got[1][i][1]


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------

def test_sigterm_to_one_rank_stops_both_at_the_same_step(pool2, world,
                                                         tmp_path):
    """Rank 1 alone gets a SIGTERM as it takes step 2 of 5 (10 rows at a
    global batch of 2): both ranks agree at the epoch's boundary, stop
    at step 5 before its eval, and save step 5 together (DCP)."""
    argv = ["finetune", "pre", *common(world, "--batch-size", "2",
                                       "--epochs", "3")]
    got = pool2.run("preempted_finetune", argv, str(tmp_path), 2, 1)
    assert got[0] == got[1] == (5, 5, ["step_5"])
    assert os.path.isfile(tmp_path / "saved_models" / "pre" / "step_5"
                          / ".metadata")


def test_sigterm_to_one_rank_stops_pretrain_on_every_rank(pool2, tmp_path):
    """`pretrain`'s loop: rank 0 alone gets a SIGTERM at micro-step 2;
    the ranks agree at the next poll (every 3 micro-steps), stop at step
    3 and write its checkpoint together, where one process would have run
    on to step 12."""
    got = pool2.run("preempted_pretrain", str(tmp_path / "pre"), 2, 0, 3)
    assert got[0] == got[1] == (3, 3, ["step_3"])


# ---------------------------------------------------------------------------
# Commands at 2 ranks against one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--tp", "2"], ["--quant", "--tp",
                                                        "2"]])
def test_embed_banks_equal_one_process(pool2, world, tmp_path, extra):
    """Each data rank embeds its slice of a split, rank 0 writes the
    gathered banks in order: the one-process banks (K8 under ``--quant``
    at 2 heads a rank, its int32 sums all-reduced exactly)."""
    argv = ["embed", "e", *common(world, "--batch-size", "3", *extra)]
    assert pool2.run("cli", argv + ["--output", str(tmp_path / "two")],
                     str(tmp_path)) == [0, 0]
    one = [a for a in argv if a not in ("--tp", "2")]
    assert run_here(one + ["--output", str(tmp_path / "one")],
                    tmp_path) == 0
    for split in ("train", "val", "test"):
        for suffix in ("", "_indices"):
            got = np.load(tmp_path / "two" / f"{split}{suffix}.npy")
            want = np.load(tmp_path / "one" / f"{split}{suffix}.npy")
            # bf16 towers: a row's products may round otherwise in
            # another batch (rows and threads differ); the int8 and
            # index banks agree to the bit where the batch does.
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("ranks, extra", [
    (2, ["--batch-size", "3"]),
    (2, ["--batch-size", "3", "--quant", "--tp", "2"]),
    (4, ["--batch-size", "3", "--quant", "--tp", "2"])])
def test_evaluate_metrics_equal_one_process(request, world, tmp_path,
                                            ranks, extra):
    """``evaluate -t`` (5 test rows at a global batch of 3: a padded tail
    on the data axis) at 2 ranks, and at 4 on a (2, 2) mesh, rank 0
    writing the JSON: the metrics of one process, within float rounding
    (int8 under ``--tp 2``: its int32 sums all-reduce exactly)."""
    pool = request.getfixturevalue(f"pool{ranks}")
    argv = ["evaluate", "ev", *common(world, "-t", *extra)]
    assert pool.run("cli", argv + ["--output", str(tmp_path / "two.json")],
                    str(tmp_path)) == [0] * ranks
    one = [a for a in argv if a not in ("--tp", "2")]
    assert run_here(one + ["--output", str(tmp_path / "one.json")],
                    tmp_path) == 0
    got = json.loads((tmp_path / "two.json").read_text())["test"]
    want = json.loads((tmp_path / "one.json").read_text())["test"]
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("extra", [[], ["--quant", "--tp", "2"]])
def test_predict_rows_equal_one_process(pool2, world, tmp_path, extra):
    """``predict -l`` at 2 ranks and a global batch of 3: rank 0 writes
    every row, in order, as one process does (int8 on 2 heads a rank: its
    int32 sums all-reduce exactly)."""
    df = pd.read_csv(world / "meta.csv")
    df.to_csv(tmp_path / "pred.csv", index=False)
    argv = ["predict", "pr", "--tiny", "--device", "cpu", "--panorama",
            "-m", "--heading", "-l", str(tmp_path / "pred.csv"),
            "--images", str(world / "imgs"), "--geocells",
            str(world / "cells.csv"), "--batch-size", "3"]
    assert pool2.run("cli", argv + extra + ["--output",
                                            str(tmp_path / "two.csv")],
                     str(tmp_path)) == [0, 0]
    one = [a for a in extra if a not in ("--tp", "2")]
    assert run_here(argv + one + ["--output", str(tmp_path / "one.csv")],
                    tmp_path) == 0
    got = pd.read_csv(tmp_path / "two.csv")
    want = pd.read_csv(tmp_path / "one.csv")
    assert list(got["image"]) == list(want["image"]) == list(df["image"])
    pd.testing.assert_frame_equal(got, want, rtol=1e-6)


def test_dcp_written_at_two_ranks_restores_at_one_and_back(pool2, world,
                                                            tmp_path):
    """``finetune --tp 2`` at 2 ranks writes DCP directories; one process
    resumes from them (and `evaluate` reads them) and writes its own;
    2 ranks under ``--fsdp`` resume from that."""
    from pigeon_tpu_torch.train.checkpoints import latest_step

    ckpt = tmp_path / "saved_models" / "run"
    base = ["finetune", "run", *common(world, "--batch-size", "2")]
    assert pool2.run("cli", base + ["--epochs", "1", "--tp", "2"],
                     str(tmp_path)) == [0, 0]
    assert sorted(os.listdir(ckpt)) == ["step_5"]
    assert run_here(base + ["--epochs", "2", "--resume"], tmp_path) == 0
    one = latest_step(str(ckpt))
    assert one > 5 and os.path.isfile(ckpt / f"step_{one}" / ".metadata")
    assert pool2.run("cli", base + ["--epochs", "1", "--resume", "--fsdp"],
                     str(tmp_path)) == [0, 0]
    assert latest_step(str(ckpt)) == one + 5
    assert os.path.isfile(ckpt / f"step_{one + 5}" / ".metadata")
    records = [json.loads(line) for line in
               open(tmp_path / "runs" / "run" / "metrics.jsonl")]
    steps = [r["step"] for r in records if r["tag"] == "train/loss"]
    # Rank 0 alone writes: the last run's 5 steps once each, after the
    # step it resumed from.
    assert steps[-5:] == list(range(one + 1, one + 6))
    ev = ["evaluate", "run", *common(world, "-t", "--batch-size", "3",
                                     "--output", str(tmp_path / "e.json"))]
    assert run_here(ev, tmp_path) == 0
    # ``serve``'s weights (`init_and_restore`) from the DCP directory.
    from pigeon_tpu_torch.cli.run import build_model, build_parser
    from pigeon_tpu_torch.train.checkpoints import restore_model

    args = build_parser().parse_args(
        ["serve", "run", *common(world), "--checkpoint-dir",
         str(tmp_path / "saved_models")])
    _, _, served = build_model(args)
    _, _, again = build_model(args)
    assert restore_model(str(ckpt), again) == one + 5
    for (name, p), q in zip(served.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(p, q), name


def test_head_only_training_at_two_ranks_equals_one_process(pool2, world,
                                                            tmp_path):
    """``finetune --embeddings`` (the f32 head) at 2 ranks under DDP and
    FSDP2: rank 0's metrics are one process's."""
    rng = np.random.default_rng(2)
    df = pd.read_csv(world / "meta.csv")
    emb = tmp_path / "emb"
    emb.mkdir()
    for split in ("train", "val"):
        n = int((df["selection"] == split).sum())
        np.save(emb / f"{split}.npy",
                rng.normal(size=(n, 4, 32)).astype(np.float32))
        np.save(emb / f"{split}_indices.npy", np.arange(n))
    argv = ["finetune", "h", "--tiny", "--device", "cpu", "--panorama",
            "--metadata", str(world / "meta.csv"), "--geocells",
            str(world / "cells.csv"), "--embeddings", str(emb),
            "--batch-size", "2", "--epochs", "2"]

    def metrics(name):
        return [json.loads(line) for line in
                open(tmp_path / "runs" / name / "metrics.jsonl")]

    assert run_here(argv, tmp_path) == 0
    want = metrics("h")
    for name, extra in (("h2", []), ("h3", ["--fsdp"])):
        assert pool2.run("cli", [argv[0], name, *argv[2:], *extra],
                         str(tmp_path)) == [0, 0]
        got = metrics(name)
        assert [r["tag"] for r in got] == [r["tag"] for r in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["value"], w["value"], rtol=1e-5,
                                       atol=1e-5, err_msg=g["tag"])


def test_dryrun_multichip_prints_its_ok_lines(capfd):
    from pigeon_tpu_torch.train.dryrun import dryrun_multichip

    dryrun_multichip(4)
    out = capfd.readouterr().out
    lines = [line for line in out.splitlines() if line.endswith(" OK")]
    assert len(lines) == 3, out
    assert "mesh={'data': 2, 'model': 2} DDP" in lines[0]
    assert "FSDP2" in lines[1]
    assert "pp: mesh={'data': 2, 'stage': 2, 'model': 1}" in lines[2]
