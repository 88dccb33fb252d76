"""Contrastive pretraining of the PyTorch port against the JAX package, on
the CPU in f32 at the ``--tiny`` widths (2 layers, D = 64): the text
tower and `CLIPModel` (`models/clip.py`), the contrastive loss, the
warmup schedule, two accumulation cycles of the pretraining step on the
``fused`` route (the JAX side through its Pallas kernels in interpret
mode, ``remat='none'``), the retrieval probe, the captions, the
pretraining dataset (`data/pretrain.py`) and the ``pretrain`` command."""

import dataclasses
import json
import math
import os

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import PigeonConfig, TextConfig, TrainConfig, \
    VisionConfig
from pigeon_tpu_torch.cli import run as cli
from pigeon_tpu_torch.models import clip as tclip
from pigeon_tpu_torch.models.jax_bridge import clip_state_dict_from_jax

#: The --tiny towers of both CLIs.
VISION = VisionConfig(image_size=64, patch_size=16, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4,
                      projection_dim=32)
TEXT = TextConfig(vocab_size=1024, hidden_size=64, intermediate_size=128,
                  num_layers=2, num_heads=4, max_position_embeddings=32,
                  projection_dim=32)
#: The fused route's tower: 2 heads of 64, the width the JAX package's
#: fused kernels take in interpret mode (tests/test_torch_routes.py).
FUSED_VISION = VisionConfig(image_size=42, patch_size=14, hidden_size=128,
                            intermediate_size=256, num_layers=2,
                            num_heads=2, projection_dim=32)
EOS = TEXT.vocab_size - 1
SEQ = 16


def jax_clip(vision, text=TEXT, seed=0, **kw):
    """A JAX `CLIPModel` (f32) and its parameters as numpy."""
    from pigeon_tpu.models.clip import CLIPModel

    model = CLIPModel(vision, text, eos_token_id=EOS, **kw)
    size = vision.image_size
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, size, size, 3)),
                                 jnp.zeros((1, SEQ), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def port_clip(params, vision, text=TEXT, **kw):
    model = tclip.CLIPModel(vision, text, eos_token_id=EOS, **kw)
    model.load_state_dict(clip_state_dict_from_jax(params), strict=True)
    return model


def batch(n, vision, seed):
    """Pixels and ids; row 0 holds the EOS twice, row 1 none."""
    rng = np.random.default_rng(seed)
    size = vision.image_size
    px = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    ids = rng.integers(0, EOS - 1, (n, SEQ)).astype(np.int32)
    for i in range(n):
        ids[i, rng.integers(3, SEQ):] = EOS
    ids[0, 2] = EOS                      # the first EOS is the pooled one
    ids[1, :] = rng.integers(0, EOS - 1, SEQ)
    return px, ids


@pytest.fixture(scope="module")
def tiny():
    return jax_clip(VISION)


def test_text_tower_and_clip_model_match_jax(tiny):
    from pigeon_tpu.models.clip import CLIPTextTower

    jmodel, params = tiny
    model = port_clip(params, VISION, attn_impl="plain")
    px, ids = batch(4, VISION, seed=1)
    want_hidden, want_pooled = jax.jit(CLIPTextTower(
        TEXT, eos_token_id=EOS).apply)({"params": params["text"]},
                                       jnp.asarray(ids))
    with torch.no_grad():
        hidden, pooled = model.text(torch.from_numpy(ids).long())
        out = model(torch.from_numpy(px), torch.from_numpy(ids).long(),
                    return_loss=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden),
                               atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               atol=1e-4)
    np.testing.assert_allclose(pooled[0].numpy(), hidden[0, 2].numpy())
    np.testing.assert_allclose(pooled[1].numpy(), hidden[1, 0].numpy())
    want = jax.jit(jmodel.apply, static_argnames="return_loss")(
        {"params": params}, jnp.asarray(px), jnp.asarray(ids),
        return_loss=True)
    for key in ("image_embeds", "text_embeds", "logits_per_image", "loss",
                "logit_scale"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    assert out["logit_scale"].item() == pytest.approx(1 / 0.07, rel=1e-6)


def test_the_causal_mask_holds_on_every_route(tiny):
    """Each route of the text tower takes the plain path under the mask:
    the same outputs, and a later token leaves an earlier row alone."""
    _, params = tiny
    _, ids = batch(2, VISION, seed=2)
    ids = torch.from_numpy(ids).long()
    outs = {}
    for route in tclip.ATTN_IMPLS:
        model = port_clip(params, VISION, attn_impl=route)
        with torch.no_grad():
            outs[route] = model.text(ids)[0]
    for route, hidden in outs.items():
        torch.testing.assert_close(hidden, outs["plain"], rtol=0, atol=0,
                                   msg=route)
    changed = ids.clone()
    changed[:, -1] = 7
    with torch.no_grad():
        after = port_clip(params, VISION, attn_impl="plain").text(changed)[0]
    torch.testing.assert_close(after[:, :-1], outs["plain"][:, :-1])
    assert tclip.causal_mask(3).tolist() == [[[[0, -1e9, -1e9],
                                               [0, 0, -1e9], [0, 0, 0]]]]


def test_contrastive_loss_matches_jax():
    from pigeon_tpu.models.clip import clip_contrastive_loss

    rng = np.random.default_rng(5)
    img = rng.normal(size=(6, 32)).astype(np.float32)
    txt = rng.normal(size=(6, 32)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    want = clip_contrastive_loss(jnp.asarray(img), jnp.asarray(txt), 14.3)
    got = tclip.clip_contrastive_loss(torch.from_numpy(img),
                                      torch.from_numpy(txt),
                                      torch.tensor(14.3))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)


@pytest.mark.parametrize("peak, total, ratio", [
    (1e-6, 20, 0.2), (5e-7, 37, 0.02), (1e-3, 4, 0.2), (2e-5, 1, 0.5)])
def test_warmup_schedule_matches_optax_at_every_step(peak, total, ratio):
    from pigeon_tpu.train.modes import linear_warmup_schedule as jsched
    from pigeon_tpu_torch.train.modes import linear_warmup_schedule

    got, want = linear_warmup_schedule(peak, total, ratio), \
        jsched(peak, total, ratio)
    for count in range(total + 3):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6,
                                           abs=1e-12), count


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX package's kernels as its own tests run them on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    monkeypatch.setenv("PIGEON_FUSED_BWD", "kernel")
    monkeypatch.setenv("PIGEON_FUSED_BWD_GROUPS", "2")
    with pltpu.force_tpu_interpret_mode():
        yield


#: Two updates of 2 micro-batches; the schedule over 4 micro-batches
#: warms up for one count, so the first update runs at lr 0 and the
#: second at the peak (a schedule that advanced by micro-batch would
#: run the second at a third of it).
PRETRAIN = PigeonConfig(vision=FUSED_VISION, text=TEXT, train=TrainConfig(
    pretrain_grad_accum_steps=2, pretrain_learning_rate=1e-3))
MICRO_STEPS = 4


def port_grads(model, px, ids):
    model.zero_grad(set_to_none=True)
    model(px, ids, return_loss=True)["loss"].backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_two_accumulation_cycles_match_jax_on_the_fused_route(
        interpret_mode):
    from pigeon_tpu.train.modes import make_pretrain_step as jstep
    from pigeon_tpu.train.modes import pretrain_optimizer as jopt
    from pigeon_tpu.train.train_loop import TrainState as JState
    from pigeon_tpu_torch.train.modes import (
        make_pretrain_step,
        pretrain_optimizer,
    )
    from pigeon_tpu_torch.train.train_loop import TrainState

    jmodel, params = jax_clip(FUSED_VISION, seed=3, attn_impl="flash_fused")
    opt = jopt(PRETRAIN, MICRO_STEPS)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params,
                    opt_state=opt.init(params))
    step = jstep(jmodel, opt)
    model = port_clip(params, FUSED_VISION, attn_impl="fused",
                      remat="attn_kernel")
    state = TrainState(model, pretrain_optimizer(model.parameters(),
                                                 PRETRAIN, MICRO_STEPS))
    tstep = make_pretrain_step()

    for i in range(MICRO_STEPS):
        px, ids = batch(4, FUSED_VISION, seed=10 + i)
        jb = {"pixel_values": jnp.asarray(px), "input_ids": jnp.asarray(ids)}
        tb = {"pixel_values": torch.from_numpy(px),
              "input_ids": torch.from_numpy(ids).long()}
        got_grads = port_grads(model, tb["pixel_values"], tb["input_ids"])
        jstate, want = step(jstate, jb)
        if i % 2 == 0:
            # The first micro-batch of a cycle: optax's running mean is
            # its gradients alone.
            want_grads = clip_state_dict_from_jax(jax.device_get(
                jstate.opt_state.acc_grads))
            for name, g in got_grads.items():
                # 5e-4: the repo's bound for the fused QKV gradients.
                np.testing.assert_allclose(
                    g.numpy(), want_grads[name].numpy(), atol=5e-4,
                    err_msg=name)
        got = tstep(state, tb)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key].item(), float(want[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
    assert state.step == int(jstate.step) == MICRO_STEPS
    assert state.optimizer.updates == 2
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)
    want_params = clip_state_dict_from_jax(jax.device_get(jstate.params))
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_params[name].numpy(), atol=1e-4,
                                   err_msg=name)
        moved = max(moved, (p.detach() - clip_state_dict_from_jax(
            params)[name]).abs().max().item())
    assert moved > 5e-4                  # the second update moved them


def test_retrieval_accuracy_matches_jax(tiny):
    from pigeon_tpu.train.modes import make_retrieval_probe as jprobe
    from pigeon_tpu.train.modes import retrieval_accuracy as jacc
    from pigeon_tpu_torch.train.modes import (
        make_retrieval_probe,
        retrieval_accuracy,
    )

    jmodel, params = tiny
    model = port_clip(params, VISION, attn_impl="plain")
    batches = [batch(6, VISION, seed=20 + i) for i in range(3)]
    want = jacc(jprobe(jmodel), params, batches)
    got = retrieval_accuracy(make_retrieval_probe(model), [
        (torch.from_numpy(px), torch.from_numpy(ids).long())
        for px, ids in batches])
    assert got == pytest.approx(want, abs=1e-7)
    assert retrieval_accuracy(make_retrieval_probe(model), []) == 0.0
    assert retrieval_accuracy(make_retrieval_probe(model), [
        (torch.from_numpy(px), torch.from_numpy(ids).long())
        for px, ids in batches], trials=1) == pytest.approx(
        jacc(jprobe(jmodel), params, batches, trials=1), abs=1e-7)


# ---------------------------------------------------------------------------
# Captions and the pretraining dataset
# ---------------------------------------------------------------------------

COUNTRIES = ("France", "United States Of America", "Philippines",
             "United States Minor Outlying Isl", "Japan", "Netherlands")


def meta_row(rng):
    """A metadata row with each optional field present, NaN or absent."""
    def maybe(value):
        r = rng.random()
        return value if r < 0.5 else (float("nan") if r < 0.75 else None)

    row = {"country_name": COUNTRIES[rng.integers(len(COUNTRIES))],
           "geo_area": maybe("Normandy"), "town": maybe("Bayeux"),
           "climate_zone": maybe("Temperate Oceanic"),
           "driving_right": maybe(bool(rng.integers(2))),
           "heading": maybe(float(rng.uniform(0, 360))),
           "month": maybe(int(rng.integers(12)))}
    return {k: v for k, v in row.items() if v is not None}


def test_captions_equal_the_jax_packages_string_for_string():
    from pigeon_tpu.data import captions as jcap
    from pigeon_tpu_torch.data import captions as tcap

    rng = np.random.default_rng(8)
    driving = {"Japan": "left", "France": "right"}
    for i in range(300):
        meta = meta_row(rng)
        offset = float(rng.choice([0, 90, 180, 270]))
        for aux in (True, False):
            assert tcap.streetview_caption(
                meta, offset, np.random.default_rng(i), aux) == \
                jcap.streetview_caption(meta, offset,
                                        np.random.default_rng(i), aux)
            assert tcap.yfcc_caption(
                meta, np.random.default_rng(i), aux, driving) == \
                jcap.yfcc_caption(meta, np.random.default_rng(i), aux,
                                  driving)
    for heading in (0, 45, 46, 135, 136, 225, 226, 315, 316, -10, 720):
        assert tcap.compass_direction(heading) == \
            jcap.compass_direction(heading)


def test_indexer_lookups_equal_the_jax_packages():
    from pigeon_tpu.data.pretrain import PretrainIndexer as JIndexer
    from pigeon_tpu_torch.data.pretrain import PretrainIndexer

    sources = pd.Series(["o1", "v2", "l3", "o4", "v5", "v6", "l7", "x8",
                         "o9"])
    got, want = PretrainIndexer(sources), JIndexer(sources)
    assert len(got) == len(want) == 3 * 4 + 3 + 2 * 5
    for i in range(len(want)):
        assert got.lookup(i) == want.lookup(i)
    for bad in (-1, len(want)):
        with pytest.raises(IndexError):
            got.lookup(bad)


@pytest.fixture(scope="module")
def pretrain_world(tmp_path_factory):
    """Images and a metadata CSV of ``o``, ``v`` and ``l`` rows with
    captions' fields, some missing."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pretrain")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(6)

    def save(name, w, h):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(images / name)
        return name

    rows = []
    for r in range(3):
        views = [save(f"pano{r}_{v}.png", 90 + 7 * v, 70) for v in range(4)]
        rows.append({"source": "o", "image": views[0], "image_2": views[1],
                     "image_3": views[2], "image_4": views[3]})
    for r in range(4):
        rows.append({"source": "v", "image": save(f"single{r}.png",
                                                  80 + 9 * r, 64)})
    for r in range(2):
        rows.append({"source": "l", "image": save(f"strip{r}.png", 400, 72)})
    for row in rows:
        row.update({k: v for k, v in meta_row(rng).items()})
        row["selection"] = "train"
    rows[1]["country_name"] = float("nan")    # "A photo."
    rows.append({"source": "v", "image": rows[3]["image"],
                 "selection": "val", "country_name": "Japan"})
    df = pd.DataFrame(rows)
    df.to_csv(root / "meta.csv", index=False)
    return root, df


@pytest.mark.parametrize("variant, auxiliary", [("streetview", True),
                                                ("yfcc", False)])
def test_dataset_batches_equal_the_jax_packages(pretrain_world, variant,
                                                auxiliary):
    from pigeon_tpu.data.pretrain import PretrainDataset as JDataset
    from pigeon_tpu.data.tokenizer import HashTokenizer as JHash
    from pigeon_tpu_torch.data.pretrain import PretrainDataset
    from pigeon_tpu_torch.data.tokenizer import HashTokenizer

    root, df = pretrain_world
    kw = dict(variant=variant, auxiliary=auxiliary, image_size=32,
              strip_width=100)
    got_ds = PretrainDataset(df, str(root / "images"), **kw)
    want_ds = JDataset(df, str(root / "images"), **kw)
    assert len(got_ds) == len(want_ds) == 3 * 4 + 4 + 2 * 5
    for seed in (0, 3):
        got = list(got_ds.batches(HashTokenizer(1024, 77), 5, seed=seed,
                                  max_tokens=24))
        want = list(want_ds.batches(JHash(1024, 77), 5, seed=seed,
                                    max_tokens=24))
        assert len(got) == len(want) == 5          # drop_last
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["pixel_values"], w["pixel_values"],
                                       atol=1e-6)
            np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
    tail = list(got_ds.batches(HashTokenizer(1024), 5, shuffle=False,
                               drop_last=False))
    assert [len(b["input_ids"]) for b in tail] == [5, 5, 5, 5, 5, 1]


# ---------------------------------------------------------------------------
# The pretrain command
# ---------------------------------------------------------------------------

def test_pretrain_command_trains_and_checkpoints(pretrain_world, tmp_path,
                                                 monkeypatch):
    from torch.distributed.checkpoint import FileSystemReader

    from pigeon_tpu_torch.train.checkpoints import latest_step, read_counters

    root, _ = pretrain_world
    monkeypatch.chdir(tmp_path)
    argv = ["pretrain", "tinyclip", "--tiny", "--device", "cpu",
            "--metadata", str(root / "meta.csv"), "--images",
            str(root / "images"), "--batch-size", "4", "--epochs", "2",
            "-a", "--checkpoint-dir", str(tmp_path / "ck")]
    assert cli.main(argv) == 0
    ckpt = tmp_path / "ck" / "tinyclip_pretrained"
    # 26 items -> 6 micro-batches an epoch, 12 in all.
    assert latest_step(str(ckpt)) == 12
    assert read_counters(str(ckpt))["updates"] == 12 // 8
    saved = FileSystemReader(str(ckpt / "step_12")).read_metadata() \
        .state_dict_metadata
    assert tuple(saved["model.text.token_embed.weight"].size) == (1024, 64)


def test_pretrain_stops_on_a_vocabulary_larger_than_the_text_config(
        pretrain_world, tmp_path, monkeypatch):
    from pigeon_tpu_torch.data.tokenizer import _bytes_to_unicode

    root, _ = pretrain_world
    vocab_dir = tmp_path / "data" / "clip_vocab"
    vocab_dir.mkdir(parents=True)
    vocab = {c: i for i, c in enumerate(_bytes_to_unicode().values())}
    for i in range(1100):
        vocab[f"w{i}</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (vocab_dir / "vocab.json").write_text(json.dumps(vocab))
    (vocab_dir / "merges.txt").write_text("#version: 0.2\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="exceeds the configured text"):
        cli.main(["pretrain", "x", "--tiny", "--device", "cpu",
                  "--metadata", str(root / "meta.csv")])


def test_pretrain_builds_the_vision_tower_on_the_route_and_remat_named(
        monkeypatch):
    from pigeon_tpu_torch.data.tokenizer import HashTokenizer

    cfg = cli.make_config(cli.build_parser().parse_args(
        ["pretrain", "--tiny"]))
    monkeypatch.setenv("PIGEON_ATTN_IMPL", "flash_fused_block")
    model = cli.build_clip_model(cfg, HashTokenizer(1024), "cpu",
                                 remat="attn_slim")
    assert tclip.routes_of(model.vision) == {"block"}
    assert model.vision.encoder.remat == "attn_slim"
    assert model.text.encoder.remat == "none"
    assert model.eos_token_id == 1023
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.dtype == torch.bfloat16
    assert math.isclose(model.logit_scale.item(), math.log(1 / 0.07),
                        rel_tol=1e-6)
    assert dataclasses.asdict(cfg.text)["vocab_size"] == 1024


def test_the_schedule_count_resumes_from_a_checkpoint(tmp_path):
    """The optimizer's count of updates is in its state dict with a
    schedule, so a restored run reads the schedule where it stopped."""
    from pigeon_tpu_torch.train.modes import pretrain_optimizer

    cfg = PigeonConfig(train=TrainConfig(pretrain_grad_accum_steps=2,
                                         pretrain_learning_rate=1e-3))
    p = torch.nn.Parameter(torch.ones(3))
    opt = pretrain_optimizer([p], cfg, 20)
    for _ in range(6):
        p.grad = torch.ones(3)
        opt.step()
    state = opt.state_dict()
    assert state["updates"] == 3 and state["accumulation"]["mini_step"] == 0
    q = torch.nn.Parameter(p.detach().clone())
    other = pretrain_optimizer([q], cfg, 20)
    other.load_state_dict(state)
    assert other.updates == 3
    for o in (opt, other):
        for prm in o.param_groups[0]["params"]:
            prm.grad = torch.ones(3)
        o.step()
        for prm in o.param_groups[0]["params"]:
            prm.grad = torch.ones(3)
        o.step()
    # The fourth update: count 3 of the 4 warmup counts (20 * 0.2).
    assert other.param_groups[0]["lr"] == opt.param_groups[0]["lr"] == \
        pytest.approx(1e-3 * 3 / 4)
    assert torch.equal(p, q)


def test_pretrain_saves_and_returns_on_sigterm(tmp_path):
    """A SIGTERM stops `pretrain` at the next micro-step boundary with a
    checkpoint of that step; periodic saves land every ``save_steps``."""
    import signal

    from pigeon_tpu_torch.train.checkpoints import latest_step
    from pigeon_tpu_torch.train.modes import pretrain
    from pigeon_tpu_torch.train.train_loop import TrainState

    model = torch.nn.Linear(2, 2)
    state = TrainState(model, torch.optim.SGD(model.parameters(), 0.1))
    seen = []

    def batches(epoch):
        for i in range(10):
            if epoch == 1 and i == 2:
                signal.raise_signal(signal.SIGTERM)
            yield i

    def step(st, batch):
        seen.append(batch)
        st.step += 1
        return {}

    out = pretrain(state, step, batches, num_epochs=3,
                   checkpoint_dir=str(tmp_path), save_steps=4)
    assert out.step == 12 and len(seen) == 12
    assert latest_step(str(tmp_path)) == 12
    assert sorted(int(f[5:]) for f in os.listdir(tmp_path)) == [4, 8, 12]
