"""The embedding sweep of the PyTorch port against the JAX package, on the
CPU at ``--tiny`` size: the port's ``embed --device cpu`` and the JAX
CLI's ``embed`` on the same ``--base`` file (an HF CLIP ``vision_model.*``
state dict, or an HF ViT one for ``--embedder vit``) over the sample20
images, both models in f32, write the same splits: every ``.npy`` within
1e-4 and the indices equal, single image and panorama, with ``--sample``
(the same ``metadata_sampled.csv``) and with ``--quant`` (the same int8
weights and scales, activation scales within 1e-4 relative, rows within
the repo's int8 bound); `load_embeddings` and ``-s``'s sample (also
``finetune``'s on pixels) against the JAX package's; and a bank the
port's ``embed`` wrote, read by its ``evaluate`` refinement."""

import json
import os

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu_torch.cli import run as cli
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax
from tests.test_torch_hf_import import VISION, hf_vision_state
from tests.test_torch_vit_embedder import seeded_hf_vit_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE20 = os.path.join(ROOT, "data", "benchmarks", "sample20", "images")
NUM_CELLS = 11
#: The int8 bound (tests/test_torch_quant.py): max error of an embedding.
INT8_MAX = 5e-2
#: (extra flags, base file) of each sweep both CLIs run.
CASES = {"single": ((), "clip.pt"),
         "panorama": (("--panorama",), "clip.pt"),
         "sample": (("--panorama", "-s", "5"), "clip.pt"),
         "quant": (("--panorama", "--quant"), "clip.pt"),
         "vit": (("--embedder", "vit"), "vit.pt")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A metadata CSV of 20 rows over the sample20 images (panorama views
    drawn from them; 12 train, 4 val, 4 test rows, interleaved), seeded
    HF CLIP and HF ViT ``--base`` files of the ``--tiny`` tower, and a
    geocell CSV."""
    root = tmp_path_factory.mktemp("embed_world")
    rng = np.random.default_rng(0)
    images = sorted(os.listdir(SAMPLE20))
    views = rng.choice(images, (len(images), 3))
    pd.DataFrame({"image": images, "image_2": views[:, 0],
                  "image_3": views[:, 1], "image_4": views[:, 2],
                  "lng": rng.uniform(-180, 180, len(images)),
                  "lat": rng.uniform(-60, 70, len(images)),
                  "selection": [("train", "train", "val", "train",
                                 "test")[i % 5] for i in range(len(images))],
                  "geocell_idx": rng.integers(0, NUM_CELLS, len(images))}
                 ).to_csv(root / "meta.csv", index=False)
    torch.save(hf_vision_state(rng, "vision_model."), root / "clip.pt")
    torch.save(seeded_hf_vit_state(rng, VISION), root / "vit.pt")
    cells = np.stack([rng.uniform(-180, 180, NUM_CELLS),
                      rng.uniform(-60, 70, NUM_CELLS)], -1)
    pd.DataFrame({"name": [f"c{i}" for i in range(NUM_CELLS)],
                  "lng": cells[:, 0], "lat": cells[:, 1]}).to_csv(
        root / "cells.csv", index=False)
    return root


@pytest.fixture
def f32_embedders(monkeypatch):
    """Both CLIs build their embedders in f32 instead of bf16, so that
    their banks can be held to each other by value."""
    from pigeon_tpu.models import embedder as je
    from pigeon_tpu.models import vit_embedder as jv
    from pigeon_tpu_torch.models import embedder as te
    from pigeon_tpu_torch.models import vit_embedder as tv

    for module, name in ((je, "ClipEmbedder"), (jv, "ViTEmbedder")):
        monkeypatch.setattr(module, name, lambda config, *,
                            _real=getattr(module, name), **kw: _real(
                                config, **{**kw, "dtype": jnp.float32}))
    # The port's are subclasses: `init_weights` tells modules by class.
    for module, name in ((te, "ClipEmbedder"), (tv, "ViTEmbedder")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, type(name, (real,), {
            "__init__": lambda self, config, _real=real, **kw:
                _real.__init__(self, config,
                               **{**kw, "dtype": torch.float32})}))


def embed_argv(root, out, *extra):
    return ["embed", "tinyemb", "--tiny", "--metadata", str(root / "meta.csv"),
            "--images", SAMPLE20, "--output", str(out), "--batch-size", "8",
            *extra]


def capture(monkeypatch, module, into: dict):
    """Record the model (and params) ``module.embed_splits_to_disk`` is
    called with, then call it."""
    real = module.embed_splits_to_disk

    def spy(model, *args, **kw):
        into["model"] = model
        into["args"] = args
        return real(model, *args, **kw)

    monkeypatch.setattr(module, "embed_splits_to_disk", spy)


@pytest.mark.parametrize("case", sorted(CASES))
def test_embed_command_matches_jax(world, tmp_path, monkeypatch,
                                   f32_embedders, case):
    """The same splits, each ``.npy`` within 1e-4 (int8: the repo's int8
    bound) and its indices equal; ``--sample``'s metadata equal; under
    ``--quant`` the same int8 tower."""
    from pigeon_tpu.cli import run as jax_cli
    from pigeon_tpu.train import embed as jax_embed
    from pigeon_tpu_torch.train import embed as port_embed

    extra, base = CASES[case]
    monkeypatch.chdir(tmp_path)
    seen = {"port": {}, "jax": {}}
    capture(monkeypatch, port_embed, seen["port"])
    capture(monkeypatch, jax_embed, seen["jax"])
    for name, main, device in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_cli.main, [])):
        assert main(embed_argv(world, tmp_path / name, *extra, "--base",
                               str(world / base), *device)) == 0
    got, want = (sorted(os.listdir(tmp_path / n)) for n in ("port", "jax"))
    assert got == want
    splits = ("test", "train", "val")
    assert [f for f in got if f.endswith(".npy")] == [
        f"{s}{x}.npy" for s in splits for x in ("", "_indices")]
    views = (4,) if "--panorama" in extra else ()
    for split in splits:
        rows = np.load(tmp_path / "port" / f"{split}.npy")
        ref = np.load(tmp_path / "jax" / f"{split}.npy")
        assert rows.dtype == np.float32
        assert rows.shape == ref.shape == (rows.shape[0], *views,
                                           VISION.hidden_size)
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / f"{split}_indices.npy"),
            np.load(tmp_path / "jax" / f"{split}_indices.npy"))
        if "--quant" in extra:
            assert np.abs(rows - ref).max() < INT8_MAX, split
        else:
            np.testing.assert_allclose(rows, ref, atol=1e-4, rtol=1e-4,
                                       err_msg=split)
    if "-s" in extra:
        sampled = [pd.read_csv(tmp_path / n / "metadata_sampled.csv")
                   for n in ("port", "jax")]
        pd.testing.assert_frame_equal(*sampled)
        assert len(sampled[0]) == 13        # 5 of 12 train rows, all others
    if "--quant" in extra:
        assert seen["port"]["args"][2] == 8       # the batch given
        got = seen["port"]["model"].state_dict()
        want = state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, seen["jax"]["args"][0]))
        assert got.keys() == want.keys()
        scales = [k for k in want if k.endswith("act_scale")]
        assert len(scales) == 1 + 6 * VISION.num_layers
        for name, value in want.items():
            if name in scales:
                np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                           rtol=1e-4, err_msg=name)
            elif value.dtype == torch.int8 or name.endswith(".scale"):
                assert torch.equal(got[name], value), name


def test_embed_quant_refuses_the_vit(world, tmp_path):
    with pytest.raises(SystemExit, match="CLIP embedder only"):
        cli.main(embed_argv(world, tmp_path, "--embedder", "vit", "--quant",
                            "--device", "cpu"))


@pytest.mark.parametrize("name,embedder,vit", [
    ("my_vit_run", "auto", True), ("pigeon", "auto", False),
    ("my_vit_run", "clip", False), ("pigeon", "vit", True)])
def test_embedder_routing_by_name(name, embedder, vit):
    args = cli.build_parser().parse_args(["embed", name, "--embedder",
                                          embedder])
    assert cli.use_vit_embedder(args) is vit


def test_load_embeddings_matches_jax(tmp_path):
    """A shard written out of order is put back in order by its indices,
    as the JAX package's `load_embeddings` does; the CLI's name is the
    same function."""
    from pigeon_tpu.train.embed import load_embeddings as jax_load
    from pigeon_tpu_torch.train.embed import load_embeddings

    rng = np.random.default_rng(2)
    np.save(tmp_path / "train.npy", rng.normal(size=(7, 4, 5))
            .astype(np.float32))
    np.save(tmp_path / "train_indices.npy", rng.permutation(7))
    got = load_embeddings(str(tmp_path), "train")
    np.testing.assert_array_equal(got, jax_load(str(tmp_path), "train"))
    assert cli.load_embeddings is load_embeddings


def test_embed_stops_without_a_gpu(world, tmp_path, monkeypatch):
    """No CUDA device: ``embed`` stops before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "build_embedder", lambda *a: pytest.fail(
        "an embedder was built"))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(embed_argv(world, tmp_path))


def test_port_bank_feeds_evaluate_refinement(world, tmp_path, monkeypatch):
    """A bank the port's ``embed`` wrote (the train rows of the
    metadata), with prototypes over its rows, refines the port's
    ``evaluate -t``: the run reads it and writes finite metrics."""
    monkeypatch.chdir(tmp_path)
    bank = tmp_path / "bank"
    assert cli.main(embed_argv(world, bank, "--base",
                               str(world / "clip.pt"), "--device",
                               "cpu")) == 0
    meta = pd.read_csv(world / "meta.csv")
    train = meta[meta["selection"] == "train"].reset_index(drop=True)
    assert np.load(bank / "train.npy").shape == (len(train), 64)
    pd.DataFrame({"geocell_idx": train["geocell_idx"],
                  "lng": train["lng"], "lat": train["lat"], "count": 1,
                  "indices": [json.dumps([i]) for i in range(len(train))]}
                 ).to_csv(tmp_path / "protos.csv", index=False)
    out = tmp_path / "metrics.json"
    argv = ["evaluate", "tinyemb", "--tiny", "--device", "cpu", "-t",
            "--metadata", str(world / "meta.csv"), "--images", SAMPLE20,
            "--geocells", str(world / "cells.csv"),
            "--base", str(world / "clip.pt"),
            "--prototypes", str(tmp_path / "protos.csv"),
            "--embeddings", str(bank), "--batch-size", "8",
            "--checkpoint-dir", str(tmp_path / "none"), "--output", str(out)]
    assets = cli.load_refine_assets(cli.build_parser().parse_args(argv))
    np.testing.assert_array_equal(assets[1], np.load(bank / "train.npy"))
    assert cli.main(argv) == 0
    metrics = json.loads(out.read_text())["test"]
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("n", [5, 12, None])
def test_sample_dataset_matches_jax(world, n):
    """``-s N``: the port's `sample_dataset` keeps the rows the JAX CLI's
    `_sample_dataset` keeps (seed 330, original order) of a split frame
    whose index is not reset, and ``finetune`` on pixels samples its
    train split so."""
    from pigeon_tpu.cli.run import _sample_dataset
    from pigeon_tpu.data import TabularImageDataset as JaxDataset
    from pigeon_tpu_torch.data.pipeline import TabularImageDataset

    df = pd.read_csv(world / "meta.csv")
    train = df[df["selection"] == "train"]
    want = _sample_dataset(JaxDataset(train, SAMPLE20), n).df
    got = cli.sample_dataset(TabularImageDataset(train, SAMPLE20), n).df
    pd.testing.assert_frame_equal(got, want.reset_index(drop=True))
    assert len(got) == min(n or len(train), len(train))
    run = cli.build_finetune(cli.build_parser().parse_args(
        ["finetune", "tinyrun", "--tiny", "--device", "cpu", "--metadata",
         str(world / "meta.csv"), "--images", SAMPLE20, "--geocells",
         str(world / "cells.csv"), "--batch-size", "1",
         *(["-s", str(n)] if n else [])]))
    # An epoch at batch 1 holds every sampled row once, shuffled.
    labels = np.concatenate([b["labels"] for b in run.train_batches(0)])
    want = got[["lng", "lat"]].to_numpy(np.float32)
    np.testing.assert_array_equal(labels[np.lexsort(labels.T)],
                                  want[np.lexsort(want.T)])
