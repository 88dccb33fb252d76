"""The finetuning slice of the PyTorch port against the JAX package, on
the CPU in f32: the loss in every branch, two train steps of the whole
model (the JAX side through its Pallas kernels in interpret mode), the
remat policy, the input pipeline and its native decoder's switch, the
metric suite, checkpoints and the ``finetune`` command."""

import dataclasses
import math

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from pigeon_tpu.config import HeadConfig, PigeonConfig, VisionConfig
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax

VISION = VisionConfig(image_size=42, patch_size=14, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4)
HEAD = HeadConfig(num_cells=37, embed_dim=64, panorama=True,
                  multi_task=True, heading=True)
CFG = PigeonConfig(vision=VISION, head=HEAD)
RNG = np.random.default_rng(12)
CELLS = np.stack([RNG.uniform(-180, 180, HEAD.num_cells),
                  RNG.uniform(-60, 70, HEAD.num_cells)], -1) \
    .astype(np.float32)
LR = 1e-3


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX package's fused forward and backward kernels as its tests
    run them on the CPU: interpret mode, two head groups."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    monkeypatch.setenv("PIGEON_FUSED_BWD", "kernel")
    monkeypatch.setenv("PIGEON_FUSED_BWD_GROUPS", "2")
    with pltpu.force_tpu_interpret_mode():
        yield


def labels(rng, b):
    """Every label the multi-task panorama loss reads, as numpy."""
    return {
        "labels": np.stack([rng.uniform(-180, 180, b),
                            rng.uniform(-60, 70, b)], -1).astype(np.float32),
        "labels_clf": rng.integers(0, HEAD.num_cells, b).astype(np.int32),
        "labels_multi_task": rng.normal(size=(b, 6)).astype(np.float32),
        "labels_climate": rng.integers(0, 28, b).astype(np.int32),
        "labels_month": rng.integers(0, 12, b).astype(np.int32),
    }


def loss_kwargs(lab, conv):
    """Label arrays as `geocell_loss`'s keyword arguments."""
    return {("labels_lla" if k == "labels" else k): conv(lab[k])
            for k in ("labels", "labels_clf", "labels_multi_task",
                      "labels_climate", "labels_month")}


def batches(n, b=3, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = labels(rng, b)
        batch["inputs"] = rng.integers(0, 256, (b, 4, 42, 42, 3),
                                       dtype=np.uint8)
        heading = rng.uniform(0, 2 * np.pi, (b, 4))
        batch["heading"] = np.stack([np.sin(heading), np.cos(heading)],
                                    -1).astype(np.float32)
        out.append(batch)
    return out


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "smoothed": dict(multi_task=False),
    "int_clf": dict(multi_task=False, smooth_labels=False),
    "multi_task": dict(),
    "climate_soft_month_smoothed": dict(month_smoothing=0.3),
    "no_month_head": dict(predict_month=False),
    "pigeotto_tau": dict(label_smoothing_km=65.0, month_smoothing=0.3),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_geocell_loss_matches_jax(case):
    from pigeon_tpu.models.geocell_head import GeocellOutput, geocell_loss
    from pigeon_tpu_torch.models import geocell_head as th

    cfg = dataclasses.replace(HEAD, **LOSS_CASES[case])
    rng = np.random.default_rng(len(case))
    b = 5
    outs = {"logits": rng.normal(size=(b, cfg.num_cells)),
            "preds_mt": rng.normal(size=(b, 6)),
            "preds_climate": rng.normal(size=(b, 28)),
            "preds_month": rng.normal(size=(b, 12))}
    outs = {k: (v * 3).astype(np.float32) for k, v in outs.items()}
    lab = labels(rng, b)
    if case == "climate_soft_month_smoothed":
        lab["labels_climate"] = rng.dirichlet(np.ones(28), b) \
            .astype(np.float32)

    def output(mod, conv):
        return mod(aggregated=None, embedding=None,
                   **{k: conv(v) for k, v in outs.items()})

    want_total, want = geocell_loss(output(GeocellOutput, jnp.asarray),
                                    jnp.asarray(CELLS), cfg,
                                    **loss_kwargs(lab, jnp.asarray))
    got_total, got = th.geocell_loss(output(th.GeocellOutput,
                                            torch.from_numpy),
                                     torch.from_numpy(CELLS), cfg,
                                     **loss_kwargs(lab, torch.from_numpy))
    assert sorted(got) == sorted(want)
    for key in want:
        # 1e-5: f32 log-softmax over 37 cells and sums of 5 rows.
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert got_total.item() == got["loss"].item()


def test_scoring_matches_jax():
    from pigeon_tpu.core.geodesy import haversine_matrix_np, haversine_np
    from pigeon_tpu.core.scoring import geoguessr_score_np, \
        smooth_month_labels
    from pigeon_tpu_torch.core import geodesy, scoring

    months = np.arange(12, dtype=np.int32)
    np.testing.assert_allclose(
        scoring.smooth_month_labels(torch.from_numpy(months), 12,
                                    0.3).numpy(),
        np.asarray(smooth_month_labels(jnp.asarray(months), 12, 0.3)),
        rtol=1e-6)
    x, y = CELLS[:7], CELLS[7:11]
    np.testing.assert_array_equal(geodesy.haversine_matrix_np(x, y),
                                  haversine_matrix_np(x, y))
    np.testing.assert_array_equal(geodesy.haversine_np(x[:4], y),
                                  haversine_np(x[:4], y))
    d = np.array([0.0, 12.5, 1492.7, 20000.0])
    assert scoring.geoguessr_score_np(d) == geoguessr_score_np(d)
    assert scoring.geoguessr_score_np([1492.7]) == 1839.0


# ---------------------------------------------------------------------------
# The slice: two train steps against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    from pigeon_tpu.models.super_guessr import SuperGuessr

    params = SuperGuessr(VISION, HEAD).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 4, 42, 42, 3)))["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def port_state(params, remat="attn_kernel"):
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import TrainState, adamw

    cfg = CFG.replace(vision=VISION)
    model = build_finetune_model(cfg, dtype=torch.float32, remat=remat)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return TrainState(model, adamw(model.parameters(), LR))


def torch_batch(batch):
    from pigeon_tpu_torch.train.train_loop import batch_to_device

    return batch_to_device(batch, "cpu")


def test_two_train_steps_match_jax(jax_params, interpret_mode):
    from pigeon_tpu.data.image_ops import normalize_images
    from pigeon_tpu.models.geocell_head import geocell_loss
    from pigeon_tpu.models.super_guessr import trainable_last_layer_mask
    from pigeon_tpu.train.modes import build_finetune_model
    from pigeon_tpu.train.train_loop import (
        TrainState,
        adamw,
        make_train_step,
    )
    from pigeon_tpu_torch.train.train_loop import make_train_step as tstep

    # Interpret-mode Pallas cannot run under jax.checkpoint, so the JAX
    # side runs remat='none'; the port runs its default, attn_kernel.
    model, _ = build_finetune_model(CFG, dtype=jnp.float32,
                                    attn_impl="flash_fused", remat="none")
    opt = adamw(LR)
    mask = trainable_last_layer_mask(jax_params, VISION.num_layers)
    step = make_train_step(model, opt, HEAD, CELLS, grad_mask=mask,
                           donate=False)

    def loss(params, batch):
        out = model.apply({"params": params},
                          normalize_images(jnp.asarray(batch["inputs"])),
                          heading=jnp.asarray(batch["heading"]))
        return geocell_loss(out, jnp.asarray(CELLS), HEAD,
                            **loss_kwargs(batch, jnp.asarray))[0]

    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=jax_params,
                        opt_state=opt.init(jax_params))
    state = port_state(jax_params)
    initial = {n: p.detach().clone()
               for n, p in state.model.named_parameters()}
    train_step = tstep(HEAD, torch.from_numpy(CELLS))
    grad_fn = jax.jit(jax.grad(loss))
    for batch in batches(2):
        jgrads = grad_fn(jstate.params, batch)
        jgrads = jax.tree_util.tree_map(lambda g, m: g * m, jgrads, mask)
        jstate, want = step(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                            jax.random.PRNGKey(0))
        got = train_step(state, torch_batch(batch))
        assert sorted(got) == sorted(want)
        for key in want:
            # 1e-4: the tower and slice bound (LayerNorm variance and
            # summation order differ); grad_norm sums the same squares.
            np.testing.assert_allclose(got[key].item(), float(want[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
        want_grads = state_dict_from_jax(jax.device_get(jgrads))
        for name, p in state.model.named_parameters():
            if p.requires_grad:
                want_g = want_grads[name].numpy()
                got_g = (np.zeros_like(want_g) if p.grad is None
                         else p.grad.numpy())
                # 5e-4: the repo's bound for the fused QKV gradients.
                np.testing.assert_allclose(got_g, want_g, atol=5e-4,
                                           err_msg=name)
    assert state.step == int(jstate.step) == 2

    want_params = state_dict_from_jax(jax.device_get(jstate.params))
    frozen = 0
    for name, p in state.model.named_parameters():
        if not p.requires_grad:
            frozen += 1
            assert torch.equal(p, initial[name]), name
            assert torch.equal(want_params[name], initial[name]), name
            continue
        # AdamW's first step moves each entry by ~LR * sign(g); where a
        # gradient is near 0 (within the 5e-4 gradient bound) the two
        # signs may differ, so two steps may part by up to 2 * LR each.
        # Everywhere else the two updates agree to rounding. The key bias
        # has a gradient of 0 in exact arithmetic (the softmax ignores a
        # shift shared by all keys): its updates follow rounding noise.
        diff = (p.detach() - want_params[name]).abs()
        assert diff.max().item() <= 2 * 2 * LR, name
        if not name.endswith("k_proj.bias"):
            assert (diff > 1e-6).float().mean().item() <= 0.05, name
    assert frozen == 16   # the first of two layers: 6 Linears + 2 LNs


def test_remat_attn_kernel_gives_the_gradients_of_none(jax_params,
                                                       monkeypatch):
    """Bit for bit on the CPU, with K1 (here its plain version) run once
    per layer: the recompute pass replays its saved output."""
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.train.train_loop import batch_loss

    calls = []
    reference = k1.fused_qkv_attention_reference
    monkeypatch.setattr(k1, "fused_qkv_attention_reference",
                        lambda *a: calls.append(1) or reference(*a))
    batch = torch_batch(batches(1)[0])
    grads = {}
    for remat in ("none", "attn_kernel"):
        state = port_state(jax_params, remat)
        calls.clear()
        _, total, _ = batch_loss(state.model, batch,
                                 torch.from_numpy(CELLS), HEAD)
        total.backward()
        assert len(calls) == VISION.num_layers, remat
        grads[remat] = {n: p.grad for n, p in
                        state.model.named_parameters() if p.requires_grad}
    for name, g in grads["none"].items():
        other = grads["attn_kernel"][name]
        assert (g is None and other is None) or torch.equal(g, other), name


def test_eval_step_predictions(jax_params):
    from pigeon_tpu_torch.train.train_loop import make_eval_step

    state = port_state(jax_params)
    parts, preds = make_eval_step(HEAD, torch.from_numpy(CELLS))(
        state.model, torch_batch(batches(1)[0]))
    assert math.isfinite(parts["loss"].item())
    assert preds["topk_cells"].shape == (3, HEAD.num_candidates)
    np.testing.assert_array_equal(preds["pred_lla"].numpy(),
                                  CELLS[preds["pred_cell"].numpy()])
    assert preds["embedding"].shape == (3, 4, 64)


# ---------------------------------------------------------------------------
# Data, metrics, checkpoints
# ---------------------------------------------------------------------------

def write_world(tmp_path, n=14):
    """PNG panoramas and a metadata CSV with every label column (some
    headings and months missing)."""
    rng = np.random.default_rng(5)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (30 + 7 * i, 50, 3),
                                     dtype=np.uint8)).save(img_dir / f"{i}.png")
    rows = []
    for i in range(n):
        v = rng.integers(0, 6, 4)
        rows.append(dict(
            image=f"{v[0]}.png", image_2=f"{v[1]}.png",
            image_3=f"{v[2]}.png", image_4=f"{v[3]}.png",
            lng=rng.uniform(-180, 180), lat=rng.uniform(-60, 70),
            selection="train" if i < n - 4 else "val",
            **dict(zip(("elevation", "population", "temp_avg", "temp_diff",
                        "prec_avg", "prec_diff"), rng.normal(size=6))),
            climate_zone_idx=rng.integers(0, 28),
            month=rng.integers(0, 12) if i % 5 else np.nan,
            heading=rng.uniform(0, 360),
            geocell_idx=rng.integers(0, 5)))
    pd.DataFrame(rows).to_csv(tmp_path / "meta.csv", index=False)
    cells = np.stack([np.linspace(-150, 150, 5), np.linspace(-50, 60, 5)], -1)
    pd.DataFrame({"name": list("abcde"), "lng": cells[:, 0],
                  "lat": cells[:, 1]}).to_csv(tmp_path / "cells.csv",
                                              index=False)
    return tmp_path


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_jax_pipeline(tmp_path, shuffle):
    from pigeon_tpu.data import TabularImageDataset, iter_batches
    from pigeon_tpu_torch.data import pipeline

    write_world(tmp_path)
    df = pd.read_csv(tmp_path / "meta.csv")
    want = list(iter_batches(
        TabularImageDataset(df, image_dir=str(tmp_path / "imgs"),
                            image_size=28, panorama=True, normalize=False),
        4, shuffle=shuffle, seed=3, drop_last=shuffle))
    got = list(pipeline.iter_batches(
        pipeline.TabularImageDataset(df, image_dir=str(tmp_path / "imgs"),
                                     image_size=28, panorama=True),
        4, shuffle=shuffle, seed=3, drop_last=shuffle))
    assert len(got) == len(want) == (3 if shuffle else 4)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert got[0]["inputs"].shape == (4, 4, 28, 28, 3)


def test_producer_exception_reraises_in_consumer(tmp_path):
    from pigeon_tpu_torch.data import pipeline

    write_world(tmp_path)
    df = pd.read_csv(tmp_path / "meta.csv")
    df.loc[9, "image_3"] = "missing.png"
    ds = pipeline.TabularImageDataset(df, image_dir=str(tmp_path / "imgs"),
                                      image_size=28, panorama=True)
    seen = []
    with pytest.raises(FileNotFoundError, match="missing.png"):
        for batch in pipeline.iter_batches(ds, 4):
            seen.append(batch)
    assert len(seen) == 2


def test_native_decode_zero_forces_pil(monkeypatch):
    """``PIGEON_NATIVE_DECODE=0`` makes the loader return no library, as
    the JAX package's does (`pigeon_tpu/data/native_decode.py::load`):
    nothing is built and the caller decodes with PIL."""
    from pigeon_tpu_torch import native
    from pigeon_tpu_torch.data import native_decode

    def no_build(*a, **kw):
        raise AssertionError("built under PIGEON_NATIVE_DECODE=0")

    monkeypatch.setattr(native, "build_shared", no_build)
    monkeypatch.setenv("PIGEON_NATIVE_DECODE", "0")
    native_decode.load.cache_clear()
    try:
        assert native_decode.available() is False
        assert native_decode.decode_resize_crop_batch([b"\xff\xd8"], 8) is None
    finally:
        native_decode.load.cache_clear()


def test_metrics_match_jax():
    from pigeon_tpu.train.metrics import compute_geoguessr_metrics as want
    from pigeon_tpu_torch.train.metrics import compute_geoguessr_metrics

    rng = np.random.default_rng(6)
    n = 40
    truth = labels(rng, n)["labels"]
    arrays = dict(
        predictions=truth + rng.normal(0, 6, (n, 2)).astype(np.float32),
        labels=truth,
        cell_preds=rng.integers(0, 5, n), cell_labels=rng.integers(0, 5, n),
        topk_cells=rng.integers(0, 5, (n, 5)),
        preds_climate=rng.normal(size=(n, 28)),
        labels_climate=rng.integers(0, 28, n),
        preds_month=rng.normal(size=(n, 12)),
        labels_month=rng.integers(0, 12, n))
    expected = want(**arrays)
    assert compute_geoguessr_metrics(**arrays) == expected
    assert 0 < expected["Under_750_km"] < 1


def test_checkpoint_round_trip_keeps_the_newest(tmp_path, jax_params):
    from pigeon_tpu_torch.train import checkpoints

    state = port_state(jax_params)
    d = str(tmp_path / "ckpt")
    assert checkpoints.latest_step(d) is None
    for step in (1, 2, 3, 4):
        state.step = step
        checkpoints.save_checkpoint(d, state)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["step_2", "step_3", "step_4"]
    other = port_state(jax_params)
    with torch.no_grad():
        other.model.head.cell_layer.bias.fill_(3.0)
    checkpoints.restore_checkpoint(d, other)
    assert other.step == 4
    for a, b in zip(other.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        checkpoints.restore_checkpoint(str(tmp_path / "none"), other)


# ---------------------------------------------------------------------------
# The finetune command
# ---------------------------------------------------------------------------

def finetune_argv(tmp_path, *extra):
    return ["finetune", "tinyrun", "--tiny", "--device", "cpu",
            "--panorama", "-m", "--heading",
            "--metadata", str(tmp_path / "meta.csv"),
            "--images", str(tmp_path / "imgs"),
            "--geocells", str(tmp_path / "cells.csv"),
            "--batch-size", "4", *extra]


def test_finetune_on_pixels_with_resume(tmp_path, monkeypatch):
    import json

    from pigeon_tpu_torch.cli.run import main
    from pigeon_tpu_torch.train.checkpoints import latest_step

    write_world(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(finetune_argv(tmp_path, "--epochs", "1")) == 0
    ckpt = str(tmp_path / "saved_models" / "tinyrun")
    assert latest_step(ckpt) == 2          # 10 train rows, batch 4
    assert main(finetune_argv(tmp_path, "--epochs", "2", "--resume")) == 0
    assert latest_step(ckpt) > 2
    records = [json.loads(line) for line in
               open(tmp_path / "runs" / "tinyrun" / "metrics.jsonl")]
    steps = [r["step"] for r in records if r["tag"] == "train/loss"]
    assert steps == [1, 2, 3, 4, 5, 6]     # the resumed run goes on at 3
    assert all(math.isfinite(r["value"]) for r in records)
    assert any(r["tag"] == "eval/Geocell_accuracy" for r in records)


def test_finetune_profile_writes_a_trace_of_the_step_spans(tmp_path,
                                                           monkeypatch):
    """``--profile DIR``: the loop's profiler window opens after the
    fifth step and closes at the run's end, so the sixth and last step
    lands in it, its spans as the trace's annotations."""
    import json

    from pigeon_tpu_torch.cli.run import main

    write_world(tmp_path)
    monkeypatch.chdir(tmp_path)
    trace_dir = tmp_path / "trace"
    assert main(finetune_argv(tmp_path, "--epochs", "3",
                              "--profile", str(trace_dir))) == 0
    (path,) = trace_dir.glob("*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert {"train.step", "train.forward", "train.backward",
            "train.optimizer"} <= set(names)
    assert names.count("train.step") == 1


def test_finetune_refuses_what_it_cannot_do(tmp_path):
    from pigeon_tpu_torch.cli.run import main

    write_world(tmp_path)
    df = pd.read_csv(tmp_path / "meta.csv").drop(columns=["temp_avg"])
    df.to_csv(tmp_path / "meta.csv", index=False)
    with pytest.raises(SystemExit, match=r"--multitask needs columns "
                                         r"\['temp_avg'\]"):
        main(finetune_argv(tmp_path))
    with pytest.raises(SystemExit, match="--embeddings does not take "
                                         "--multitask"):
        main(finetune_argv(tmp_path, "--embeddings", str(tmp_path)))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            main([a if a != "cpu" else "cuda"
                  for a in finetune_argv(tmp_path)])
