"""Product evaluation of the PyTorch port against the JAX package, on the
CPU: the geodesy's LLA <-> ECEF conversions, the metric suite with its
regression scaler and country index, `evaluate_benchmark` with a refiner,
the benchmark dataset and holdout, the refiner's npz cache, and the
``evaluate`` and ``predict`` commands at ``--tiny`` size with the same
``--base`` file (their JSON keys, CSV rows and columns, loaded weights
and ``--quant`` activation scales), the restore policy, and the stop
without a GPU."""

import dataclasses
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
from tests.test_torch_hf_import import seeded_reference_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTRY = os.path.join(ROOT, "data", "benchmarks", "benchmarks.json")
SAMPLE20 = os.path.join(ROOT, "data", "benchmarks", "sample20", "images")
NUM_CELLS, BANK_ROWS = 60, 200
#: Distance-like metrics (f32 forwards of two packages): relative bound.
DISTANCE_RTOL = 1e-4
#: The bank's embeddings lie this many of the images' per-dimension
#: spreads around their mean.
BANK_SPREAD = 30


# ---------------------------------------------------------------------------
# Geodesy and the metric suite
# ---------------------------------------------------------------------------

def lla_points(rng, n=64):
    return np.stack([rng.uniform(-180, 180, n),
                     rng.uniform(-89, 89, n)], -1)


def test_lla_ecef_conversions_match_jax():
    """`lla2ecef` and `ecef2lla` in f32 torch against jnp within 1e-5
    relative; the float64 numpy twins against the JAX package's within
    1e-9 relative, and through a round trip."""
    from pigeon_tpu.core import geodesy as jg
    from pigeon_tpu_torch.core import geodesy as tg

    lla = lla_points(np.random.default_rng(0))
    ecef = jg.lla2ecef_np(lla)
    np.testing.assert_allclose(tg.lla2ecef_np(lla), ecef, rtol=1e-9)
    np.testing.assert_allclose(tg.ecef2lla_np(ecef), jg.ecef2lla_np(ecef),
                               rtol=1e-9)
    np.testing.assert_allclose(tg.ecef2lla_np(tg.lla2ecef_np(lla)), lla,
                               rtol=1e-9, atol=1e-9)
    f32 = lla.astype(np.float32)
    got = tg.lla2ecef(torch.from_numpy(f32)).numpy()
    want = np.asarray(jg.lla2ecef(jnp.asarray(f32)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 6.4e6)
    e32 = ecef.astype(np.float32)
    np.testing.assert_allclose(tg.ecef2lla(torch.from_numpy(e32)).numpy(),
                               np.asarray(jg.ecef2lla(jnp.asarray(e32))),
                               rtol=1e-5, atol=1e-5 * 180)


def test_regression_scaler_matches_jax(tmp_path):
    """Fit, transform and inverse against the JAX scaler within 1e-9
    relative; each package loads the other's JSON."""
    from pigeon_tpu.train.metrics import RegressionScaler as JaxScaler
    from pigeon_tpu_torch.train.metrics import RegressionScaler

    rng = np.random.default_rng(1)
    raw = np.abs(rng.normal(500, 100, size=(40, 6)))
    raw[:, 2] -= 480                       # temp_avg: not logged, signed
    got, want = RegressionScaler.fit(raw), JaxScaler.fit(raw)
    scaled = want.transform(raw)
    np.testing.assert_allclose(got.transform(raw), scaled, rtol=1e-9)
    noisy = scaled + rng.normal(0, 0.1, scaled.shape)
    np.testing.assert_allclose(got.inverse(noisy), want.inverse(noisy),
                               rtol=1e-9)
    got.save(str(tmp_path / "port.json"))
    want.save(str(tmp_path / "jax.json"))
    for path in ("port.json", "jax.json"):
        a = RegressionScaler.load(str(tmp_path / path))
        b = JaxScaler.load(str(tmp_path / path))
        np.testing.assert_allclose(a.inverse(noisy), b.inverse(noisy),
                                   rtol=1e-9)


def write_countries(tmp_path) -> str:
    """Three countries: a square, a concave L (one Polygon each) and a
    MultiPolygon of two squares."""
    def ring(points):
        return [list(map(float, p)) for p in (*points, points[0])]

    features = [
        ("Square", "Polygon",
         [ring([(-20, -10), (0, -10), (0, 10), (-20, 10)])]),
        ("Ell", "Polygon",
         [ring([(0, 0), (30, 0), (30, 15), (15, 15), (15, 30), (0, 30)])]),
        ("Isles", "MultiPolygon",
         [[ring([(40, -20), (60, -20), (60, 0), (40, 0)])],
          [ring([(-60, 40), (-40, 40), (-40, 60), (-60, 60)])]]),
    ]
    fc = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {"name": name},
         "geometry": {"type": kind, "coordinates": coords}}
        for name, kind, coords in features]}
    path = tmp_path / "countries.geojson"
    path.write_text(json.dumps(fc))
    return str(path)


def test_polygons_and_countries_match_jax(tmp_path):
    """`points_in_polygon`, `CountryIndex.country_of` (with its nearest
    fallback) and `country_accuracy` give the JAX package's answers."""
    from pigeon_tpu.train import metrics as jm
    from pigeon_tpu_torch.train import metrics as tm

    path = write_countries(tmp_path)
    rng = np.random.default_rng(2)
    points = np.stack([rng.uniform(-70, 70, 300),
                       rng.uniform(-30, 70, 300)], -1)
    got, want = tm.CountryIndex(path), jm.CountryIndex(path)
    for ring in [r for rings in want.rings for r in rings]:
        np.testing.assert_array_equal(tm.points_in_polygon(points, ring),
                                      jm.points_in_polygon(points, ring))
    np.testing.assert_array_equal(got.country_of(points),
                                  want.country_of(points))
    assert got.names == want.names == ["Square", "Ell", "Isles"]
    preds = points + rng.normal(0, 8, points.shape)
    assert tm.country_accuracy(preds, points, got) == \
        jm.country_accuracy(preds, points, want)


def suite_inputs(rng, n, tmp_path):
    labels = np.stack([rng.uniform(-60, 60, n), rng.uniform(-30, 60, n)], -1)
    preds = labels + rng.normal(0, 5, labels.shape)
    preds[: n // 3] = labels[: n // 3]
    cells = rng.integers(0, 50, n)
    raw = np.abs(rng.normal(500, 100, size=(n, 6)))
    return dict(
        predictions=preds, labels=labels,
        cell_preds=np.where(rng.random(n) < 0.5, cells, 0),
        cell_labels=cells, topk_cells=rng.integers(0, 50, (n, 50)),
        preds_mt=rng.normal(size=(n, 6)), labels_mt=rng.normal(size=(n, 6)),
        preds_climate=rng.normal(size=(n, 28)),
        labels_climate=rng.integers(0, 28, n),
        preds_month=rng.normal(size=(n, 12)),
        labels_month=rng.integers(0, 12, n),
        scaler=("fit", raw), country_index=write_countries(tmp_path))


SUITE_CASES = {
    "distances": ("predictions", "labels"),
    "cells_one_hot": ("predictions", "labels", "cell_preds", "cell_labels",
                      "topk_cells"),
    "mt_without_scaler": ("predictions", "labels", "preds_mt", "labels_mt",
                          "preds_climate", "labels_climate"),
    "full": None,
}


@pytest.mark.parametrize("case", sorted(SUITE_CASES))
def test_metric_suite_matches_jax(tmp_path, case):
    """`compute_geoguessr_metrics` on the same inputs: the same keys in
    the same order, values within 1e-9 relative (top-5 over all 50
    candidates, as the JAX suite takes it)."""
    from pigeon_tpu.train import metrics as jm
    from pigeon_tpu_torch.train import metrics as tm

    inputs = suite_inputs(np.random.default_rng(3), 101, tmp_path)
    names = SUITE_CASES[case] or tuple(inputs)
    kw = {k: inputs[k] for k in names}
    if case == "cells_one_hot":
        kw["cell_labels"] = np.eye(50)[kw["cell_labels"]]

    def build(module):
        out = dict(kw)
        if "scaler" in out:
            out["scaler"] = module.RegressionScaler.fit(out["scaler"][1])
        if "country_index" in out:
            out["country_index"] = module.CountryIndex(out["country_index"])
        return out

    got = tm.compute_geoguessr_metrics(**build(tm))
    want = jm.compute_geoguessr_metrics(**build(jm))
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-9)
    if case == "full":
        assert {"Country_accuracy", "Mean_temperature_error",
                "Month_accuracy", "Geocell_top5_accuracy"} <= set(got)


# ---------------------------------------------------------------------------
# evaluate_benchmark, the refiner cache and the datasets
# ---------------------------------------------------------------------------

def sample20_embeddings(state: dict) -> np.ndarray:
    """The f32 embeddings of the sample20 images (64 px) under the
    ``--tiny`` single-image model holding the reference-layout
    ``state``."""
    from pigeon_tpu_torch.config import HeadConfig
    from pigeon_tpu_torch.data.image_ops import normalize_images
    from pigeon_tpu_torch.data.pipeline import BenchmarkDataset, iter_batches
    from pigeon_tpu_torch.models.hf_import import import_state
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr
    from tests.test_torch_hf_import import VISION

    model = SuperGuessr(VISION, HeadConfig(num_cells=NUM_CELLS,
                                           embed_dim=64))
    model.load_state_dict(import_state(state, VISION.num_layers))
    pixels = next(iter_batches(BenchmarkDataset(
        "sample20", REGISTRY, image_size=64), 20))["inputs"]
    with torch.no_grad():
        return model(normalize_images(torch.from_numpy(pixels))) \
            .embedding.numpy()


def write_world(root, seed=0) -> dict:
    """Geocells, a refinement bank (metadata, embeddings, prototypes over
    every cell), a ``--base`` file of the ``--tiny`` single-image model,
    a holdout metadata CSV over the sample20 images, countries and a
    scaler. Returns paths and the bank's locations.

    The seeded tower's embeddings of the sample20 images differ little
    from one image to the next, so the ``--base`` file's cell layer reads
    their offsets from the mean, scaled to logits of about unit spread,
    and the bank lies around that mean: each image then has a cell of its
    own, and refinement moves some guesses to another candidate cell."""
    from pigeon_tpu_torch.config import HeadConfig

    rng = np.random.default_rng(seed)
    cells = lla_points(rng, NUM_CELLS) * [1, 0.75]
    pd.DataFrame({"name": [f"c{i}" for i in range(NUM_CELLS)],
                  "lng": cells[:, 0], "lat": cells[:, 1]}).to_csv(
        root / "cells.csv", index=False)
    state = seeded_reference_state(
        rng, HeadConfig(num_cells=NUM_CELLS, embed_dim=64))
    emb = sample20_embeddings(state)
    mean, spread = emb.mean(0), emb.std(0)
    weight = rng.normal(size=(NUM_CELLS, 64)) / (8 * spread)
    state["cell_layer.weight"] = torch.tensor(weight, dtype=torch.float32)
    state["cell_layer.bias"] = torch.tensor(-weight @ mean,
                                            dtype=torch.float32)
    torch.save(state, root / "base.pt")
    bank = lla_points(rng, BANK_ROWS).astype(np.float32)
    pd.DataFrame({"lng": bank[:, 0], "lat": bank[:, 1],
                  "selection": "train"}).to_csv(root / "meta.csv",
                                                index=False)
    (root / "emb").mkdir()
    np.save(root / "emb" / "train.npy", (mean + BANK_SPREAD * spread
                                         * rng.normal(size=(BANK_ROWS, 64)))
            .astype(np.float32))
    np.save(root / "emb" / "train_indices.npy", np.arange(BANK_ROWS))
    rows, pool = [], [tuple(p) for p in bank.tolist()]
    for cell in range(NUM_CELLS):
        for _ in range(rng.integers(1, 3)):
            idx = rng.choice(BANK_ROWS, int(rng.integers(1, 6)),
                             replace=False).tolist()
            lng, lat = bank[idx].mean(0).tolist()
            pool.append((lng, lat))
            rows.append({"geocell_idx": cell, "lng": lng, "lat": lat,
                         "count": len(idx), "indices": json.dumps(idx)})
    pd.DataFrame(rows).to_csv(root / "protos.csv", index=False)
    images = sorted(os.listdir(SAMPLE20))
    pd.DataFrame({"image": images,
                  "lng": rng.uniform(-180, 180, len(images)),
                  "lat": rng.uniform(-60, 70, len(images)),
                  "selection": ["test" if i % 3 else "train"
                                for i in range(len(images))],
                  "geocell_idx": rng.integers(0, NUM_CELLS, len(images))}
                 ).to_csv(root / "holdout.csv", index=False)
    write_countries(root)
    return {"root": root, "pool": np.array(pool, np.float32), "state": state}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_world(tmp_path_factory.mktemp("world"))


def refine_assets(root):
    return ["--prototypes", str(root / "protos.csv"),
            "--embeddings", str(root / "emb"),
            "--metadata", str(root / "meta.csv")]


def assert_metrics_match(got: dict, want: dict) -> None:
    """The same keys in the same order; accuracies equal, every other
    metric within `DISTANCE_RTOL` relative."""
    assert list(got) == list(want)
    for key, value in want.items():
        if "accuracy" in key or key.startswith("Under_"):
            assert got[key] == value, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=DISTANCE_RTOL,
                                       err_msg=key)


def test_evaluate_benchmark_with_refiner_matches_jax(world):
    """A multi-task f32 model on bridged weights through each package's
    eval step (50 candidates), refiner (the ``im2gps3k`` preset), scaler
    and country index: distance metrics and the multi-task errors within
    1e-4 relative, accuracies equal."""
    from pigeon_tpu.cli.run import _load_refine_assets
    from pigeon_tpu.config import HeadConfig, VisionConfig
    from pigeon_tpu.models.super_guessr import SuperGuessr as JaxModel
    from pigeon_tpu.train import evaluate as je
    from pigeon_tpu.train import metrics as jm
    from pigeon_tpu.train.train_loop import make_eval_step as jax_eval_step
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr
    from pigeon_tpu_torch.train import evaluate as te
    from pigeon_tpu_torch.train import metrics as tm
    from pigeon_tpu_torch.train.train_loop import (
        batch_to_device,
        make_eval_step,
    )

    root = world["root"]
    vision = VisionConfig(image_size=64, patch_size=16, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4,
                          projection_dim=32)
    head = HeadConfig(num_cells=NUM_CELLS, embed_dim=64, multi_task=True)
    cells = pd.read_csv(root / "cells.csv")[["lng", "lat"]] \
        .to_numpy(np.float32)
    rng = np.random.default_rng(4)
    batches = []
    for b in (5, 5):
        raw = np.abs(rng.normal(500, 100, size=(b, 6)))
        batches.append({
            "inputs": rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8),
            "labels": lla_points(rng, b).astype(np.float32),
            "labels_clf": rng.integers(0, NUM_CELLS, b).astype(np.int32),
            "labels_multi_task": raw.astype(np.float32),
            "labels_climate": rng.integers(0, 28, b).astype(np.int32)})
    raw_mt = np.concatenate([b["labels_multi_task"] for b in batches])
    model = JaxModel(vision, head)
    params = model.init(jax.random.PRNGKey(7),
                        jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    args = cli.build_parser().parse_args(["evaluate", *refine_assets(root)])
    assets = _load_refine_assets(args)
    preset = je.refiner_preset("im2gps3k")
    want = je.evaluate_benchmark(
        jax_eval_step(model, head, cells, num_candidates=50), params,
        iter(batches), refine_fn=je.build_refiner(
            *assets, num_cells=NUM_CELLS, cfg=preset),
        scaler=jm.RegressionScaler.fit(raw_mt),
        country_index=jm.CountryIndex(str(root / "countries.geojson")))

    tmodel = SuperGuessr(vision, head)
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    eval_step = make_eval_step(head, torch.from_numpy(cells),
                               num_candidates=te.EVAL_NUM_CANDIDATES)
    assert eval_step(tmodel, batch_to_device(batches[0], "cpu"))[1][
        "topk_cells"].shape == (5, 50)
    got = te.evaluate_benchmark(
        eval_step, tmodel, iter(batches),
        lambda b: batch_to_device(b, "cpu"),
        refine_fn=te.build_refiner(*cli.load_refine_assets(args),
                                   num_cells=NUM_CELLS, cfg=preset),
        scaler=tm.RegressionScaler.fit(raw_mt),
        country_index=tm.CountryIndex(str(root / "countries.geojson")))
    assert "Country_accuracy" in got and "Mean_elevation_error" in got
    assert_metrics_match(got, want)


def test_refiner_npz_cache_is_the_jax_packages(world, tmp_path,
                                               monkeypatch):
    """The port reads a bank the JAX package cached (the same tensors as
    the bank it packs itself) and caches the same arrays in turn."""
    from pigeon_tpu.cli.run import _load_refine_assets
    from pigeon_tpu.train import evaluate as je
    from pigeon_tpu_torch.models import refiner
    from pigeon_tpu_torch.train import evaluate as te

    root = world["root"]
    args = cli.build_parser().parse_args(["evaluate", *refine_assets(root)])
    preset = te.refiner_preset("im2gps3k")
    je.build_refiner(*_load_refine_assets(args), num_cells=NUM_CELLS,
                     cfg=preset, cache_path=str(tmp_path / "jax.npz"))
    captured = []
    real = refiner.make_refine_fn
    monkeypatch.setattr(te, "make_refine_fn", lambda bank, cfg: captured
                        .append(bank) or real(bank, cfg))
    assets = cli.load_refine_assets(args)
    te.build_refiner(*assets, num_cells=NUM_CELLS, cfg=preset,
                     cache_path=str(tmp_path / "jax.npz"))
    te.build_refiner(*assets, num_cells=NUM_CELLS, cfg=preset,
                     cache_path=str(tmp_path / "port.npz"))
    from_cache, packed = captured
    for field in dataclasses.fields(packed):
        a, b = (getattr(x, field.name) for x in (from_cache, packed))
        assert a.dtype == b.dtype and torch.equal(a, b), field.name
    with np.load(tmp_path / "jax.npz") as j, \
            np.load(tmp_path / "port.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for name in j.files:
            assert j[name].dtype == p[name].dtype, name
            np.testing.assert_array_equal(j[name], p[name], err_msg=name)


def test_benchmark_dataset_and_holdout_match_jax():
    """`BenchmarkDataset` from the registry and a `holdout` slice of it
    give the JAX package's rows and batches (uint8 pixels)."""
    from pigeon_tpu.data import pipeline as jp
    from pigeon_tpu_torch.data import pipeline as tp

    want = jp.BenchmarkDataset("sample20", REGISTRY, image_size=64,
                               normalize=False)
    got = tp.BenchmarkDataset("sample20", REGISTRY, image_size=64)
    assert got.name == "sample20" and got.image_dir == want.image_dir
    pd.testing.assert_frame_equal(got.df, want.df)
    for g, w in ((got, want),
                 (tp.holdout(got, slice(3, 11)),
                  jp.holdout(want, slice(3, 11)))):
        w.normalize = False
        pd.testing.assert_frame_equal(g.df, w.df)
        for gb, wb in zip(tp.iter_batches(g, 6), jp.iter_batches(w, 6)):
            assert gb.keys() == wb.keys()
            for key in gb:
                np.testing.assert_array_equal(gb[key], wb[key], err_msg=key)
    with pytest.raises(KeyError, match="not registered"):
        tp.BenchmarkDataset("nope", REGISTRY)


def test_closing_iter_batches_early_stops_its_producer():
    """A calibration batch taken from `iter_batches` and the generator
    closed: the producer thread ends instead of blocking on a full
    queue."""
    import threading

    from pigeon_tpu_torch.data import pipeline as tp

    def producers():
        return [t for t in threading.enumerate()
                if t.name.endswith("(producer)")]

    ds = tp.BenchmarkDataset("sample20", REGISTRY, image_size=32)
    batches = tp.iter_batches(ds, 2)
    assert next(batches)["inputs"].shape == (2, 32, 32, 3)
    assert len(producers()) == 1          # 9 batches left, 2 queued
    batches.close()
    assert producers() == []


# ---------------------------------------------------------------------------
# The commands
# ---------------------------------------------------------------------------

def evaluate_argv(root, *extra):
    return ["evaluate", "tinyeval", "--tiny", "--geocells",
            str(root / "cells.csv"), "--base", str(root / "base.pt"),
            "--checkpoint-dir", str(root / "no_checkpoints"),
            "--batch-size", "8", *extra]


EVAL_CASES = {
    "sample20": ("-l", "sample20", "--benchmarks", REGISTRY,
                 "--countries", "countries.geojson", "refine"),
    "holdout": ("-t", "--metadata", "holdout.csv", "--images", SAMPLE20),
}


@pytest.fixture
def f32_models(monkeypatch):
    """Both CLIs build their `SuperGuessr`s in f32 instead of bf16, so
    that their outputs can be held to each other by value: the bf16
    forwards of two packages may round an activation one ulp apart."""
    from pigeon_tpu.models import super_guessr as jsg
    from pigeon_tpu_torch.models import super_guessr as tsg

    jax_model, port_model = jsg.SuperGuessr, tsg.SuperGuessr
    monkeypatch.setattr(jsg, "SuperGuessr", lambda vision, head,
                        dtype=None, **kw: jax_model(vision, head,
                                                    dtype=jnp.float32, **kw))
    monkeypatch.setattr(tsg, "SuperGuessr", lambda vision, head,
                        dtype=None, **kw: port_model(
                            vision, head, dtype=torch.float32, **kw))


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_command_matches_jax(world, tmp_path, monkeypatch,
                                      f32_models, case):
    """The port's ``evaluate --device cpu`` and the JAX CLI's on the same
    ``--base`` file, both in f32: the same benchmarks in the JSON, each
    with the same metrics (accuracies equal, the rest within 1e-4
    relative), and the weights each loads equal bit for bit."""
    from pigeon_tpu.cli import run as jax_cli
    from pigeon_tpu_torch.models.hf_import import import_state

    root = world["root"]
    monkeypatch.chdir(root)
    extra = [str(root / a) if a.endswith((".geojson", ".csv")) else a
             for a in EVAL_CASES[case] if a != "refine"]
    if "refine" in EVAL_CASES[case]:
        extra += refine_assets(root)
    outputs = {}
    for name, main, device in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_cli.main, [])):
        out = tmp_path / f"{name}.json"
        assert main(evaluate_argv(root, *extra, *device, "--output",
                                  str(out))) == 0
        outputs[name] = json.loads(out.read_text())
    assert list(outputs["port"]) == list(outputs["jax"]) == [
        "sample20" if case == "sample20" else "test"]
    for name, metrics in outputs["port"].items():
        assert all(np.isfinite(v) for v in metrics.values())
        assert_metrics_match(metrics, outputs["jax"][name])
    assert ("Country_accuracy" in metrics) == (case == "sample20")

    args = cli.build_parser().parse_args(evaluate_argv(root, *extra))
    _, cfg, model = cli.build_model(args)
    jargs = jax_cli.build_parser().parse_args(evaluate_argv(root, *extra))
    jcells, _ = jax_cli.load_geocells(jargs)
    jcfg = jax_cli.config_with_cells(jargs, jcells)
    from pigeon_tpu.models.super_guessr import SuperGuessr

    params = jax_cli._init_and_restore(
        jargs, jcfg, SuperGuessr(jcfg.vision, jcfg.head),
        jnp.zeros((1, 64, 64, 3)))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    loaded = import_state(world["state"], cfg.vision.num_layers)
    assert set(loaded) == set(want)           # the file covers the model
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_quant_calibration_matches_jax(world, f32_models):
    """``evaluate --quant``'s calibration: the first sample20 batch (at
    most 8 images, CLIP-normalised, margin 1.0) through the port's
    `quantize_on_batch` and the JAX CLI's `_quantize_for_inference` on the
    weights each CLI restores from the same ``--base`` file: activation
    scales within 1e-4 relative (the repo's calibration bound), int8
    weights and their scales equal. Both compute in f32 here: the CLIs'
    bf16 forwards may round an activation near a maximum one bf16 ulp
    (2^-8) apart."""
    from pigeon_tpu.cli import run as jax_cli
    from pigeon_tpu.data.image_ops import normalize_images
    from pigeon_tpu.models.super_guessr import SuperGuessr
    from pigeon_tpu_torch.data.pipeline import BenchmarkDataset, iter_batches

    root = world["root"]
    args = cli.build_parser().parse_args(evaluate_argv(
        root, "-l", "sample20", "--benchmarks", REGISTRY))
    _, cfg, model = cli.build_model(args, quant=True)
    ds = BenchmarkDataset("sample20", REGISTRY, image_size=64)
    batch = next(iter_batches(ds, 10))
    got = cli.quantize_on_batch(model, batch, torch.device("cpu"),
                                "sample20").state_dict()

    jargs = jax_cli.build_parser().parse_args(evaluate_argv(root))
    jcells, _ = jax_cli.load_geocells(jargs)
    jcfg = jax_cli.config_with_cells(jargs, jcells)
    params = jax_cli._init_and_restore(
        jargs, jcfg, SuperGuessr(jcfg.vision, jcfg.head),
        jnp.zeros((1, 64, 64, 3)))
    _, qparams = jax_cli._quantize_for_inference(
        jcfg, params, normalize_images(jnp.asarray(batch["inputs"][:8])))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    scales = [k for k in want if k.endswith("act_scale")]
    assert len(scales) == 1 + 6 * cfg.vision.num_layers
    assert got.keys() == want.keys()
    for name, value in want.items():
        if name in scales:
            np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                       rtol=1e-4, err_msg=name)
        elif value.dtype == torch.int8 or name.endswith(".scale"):
            assert torch.equal(got[name], value), name


PREDICT_CASES = {
    "directory": ("--images", SAMPLE20),
    "csv_refined_quant": ("-l", "holdout.csv", "--images", SAMPLE20,
                          "--quant", "refine"),
}


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_command_matches_jax(world, tmp_path, monkeypatch,
                                     f32_models, case):
    """``predict`` in both packages on the same ``--base`` file, both in
    f32: the same columns and images, row for row the same cell, and
    coordinates and top-1 probability within 1e-4 relative; refined
    locations on the bank's or a prototype's."""
    from pigeon_tpu.cli import run as jax_cli

    root = world["root"]
    monkeypatch.chdir(root)
    extra = [str(root / a) if a.endswith(".csv") else a
             for a in PREDICT_CASES[case] if a != "refine"]
    if "refine" in PREDICT_CASES[case]:
        extra += refine_assets(root)
    frames = {}
    for name, main, device in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_cli.main, [])):
        out = tmp_path / f"{name}.csv"
        argv = ["predict", *evaluate_argv(root, *extra, *device)[1:],
                "--output", str(out)]
        assert main(argv) == 0
        frames[name] = pd.read_csv(out)
    got, want = frames["port"], frames["jax"]
    assert list(got.columns) == list(want.columns) == list(
        cli.PREDICT_COLUMNS)
    assert got["image"].tolist() == want["image"].tolist()
    assert len(got) == 20
    assert got["geocell_idx"].tolist() == want["geocell_idx"].tolist()
    for column in ("lat", "lng", "top1_prob"):
        np.testing.assert_allclose(got[column], want[column],
                                   rtol=DISTANCE_RTOL, err_msg=column)
    assert got["lat"].between(-90, 90).all()
    assert got["lng"].between(-180, 180).all()
    assert got["geocell_idx"].between(0, NUM_CELLS - 1).all()
    assert got["top1_prob"].between(0, 1).all()
    if "--prototypes" in extra:
        for frame in (got, want):
            lla = frame[["lng", "lat"]].to_numpy(np.float32)
            assert np.isclose(world["pool"][None], lla[:, None],
                              atol=1e-4).all(-1).any(-1).all()


def save_checkpoint_of(root, argv, seed: int) -> dict:
    """A ``finetune``-format checkpoint of the model ``argv`` describes,
    with weights of ``seed``, under the run's directory; returns them."""
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr, init_weights
    from pigeon_tpu_torch.train.checkpoints import save_checkpoint
    from pigeon_tpu_torch.train.train_loop import TrainState, adamw

    args = cli.build_parser().parse_args(argv)
    cfg = cli.make_config(args)
    cfg = cfg.replace(head=dataclasses.replace(cfg.head,
                                               num_cells=NUM_CELLS))
    model = init_weights(SuperGuessr(cfg.vision, cfg.head), seed)
    save_checkpoint(os.path.join(args.checkpoint_dir, args.name),
                    TrainState(model, adamw(model.parameters(), 1e-3), 3))
    return model.state_dict()


def test_a_checkpoint_beats_base_in_serve_and_evaluate(world, tmp_path,
                                                       monkeypatch):
    """With a checkpoint under ``--checkpoint-dir/NAME`` and ``--base``,
    ``serve`` and ``evaluate`` run the checkpoint's weights
    (`pigeon_tpu/cli/run.py::_init_and_restore`); without one,
    ``--base``'s."""
    from pigeon_tpu_torch.train import evaluate as te

    root = world["root"]
    monkeypatch.chdir(tmp_path)
    common = ["--tiny", "--device", "cpu", "--geocells",
              str(root / "cells.csv"), "--base", str(root / "base.pt"),
              "--checkpoint-dir", str(tmp_path / "ckpt")]
    serve = ["serve", "tinyrun", "--port", "0", *common]
    saved = save_checkpoint_of(root, serve, seed=9)
    httpd = cli.start_server(cli.build_parser().parse_args(serve),
                             block=False)
    httpd.shutdown()
    httpd.server_close()
    served = httpd.RequestHandlerClass.service.serve_fn.model.state_dict()

    seen = []
    real = te.evaluate_benchmark
    monkeypatch.setattr(te, "evaluate_benchmark", lambda step, model, *a,
                        **kw: seen.append(model.state_dict()) or real(
                            step, model, *a, **kw))
    for name in ("tinyrun", "nocheckpoint"):
        assert cli.main(["evaluate", name, "-l", "sample20", "--benchmarks",
                         REGISTRY, "--batch-size", "10", *common]) == 0
    with_ckpt, base_only = seen
    _, _, model = cli.build_model(cli.build_parser().parse_args(
        ["evaluate", "nocheckpoint", *common]))
    for name, value in saved.items():
        assert torch.equal(served[name], value), name
        assert torch.equal(with_ckpt[name], value), name
        assert torch.equal(base_only[name], model.state_dict()[name]), name
    assert not torch.equal(base_only["head.cell_layer.weight"],
                           saved["head.cell_layer.weight"])
    torch.testing.assert_close(base_only["head.cell_layer.weight"],
                               world["state"]["cell_layer.weight"],
                               rtol=0, atol=0)


def test_finetune_overlays_base_before_resume(world, tmp_path):
    """``finetune --base``: the seeded model takes the file's tensors in
    its own parameters (the ones AdamW holds); with ``--resume`` and a
    checkpoint, the checkpoint's come after and win."""
    from pigeon_tpu_torch.train.checkpoints import save_checkpoint
    from tests.test_torch_train import write_world as write_pixels

    root = world["root"]
    write_pixels(tmp_path)
    argv = ["finetune", "tinyrun", "--tiny", "--device", "cpu",
            "--metadata", str(tmp_path / "meta.csv"),
            "--images", str(tmp_path / "imgs"),
            "--geocells", str(root / "cells.csv"),
            "--base", str(root / "base.pt"),
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    run = cli.build_finetune(cli.build_parser().parse_args(argv))
    model = run.state.model
    assert torch.equal(model.head.cell_layer.weight.detach(),
                       world["state"]["cell_layer.weight"].float())
    held = {id(p) for group in run.state.optimizer.param_groups
            for p in group["params"]}
    assert id(model.head.cell_layer.weight) in held
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    run.state.step = 3
    save_checkpoint(run.checkpoint_dir, run.state)
    resumed = cli.build_finetune(cli.build_parser().parse_args(
        argv + ["--resume"]))
    assert resumed.state.step == 3
    for name, value in model.state_dict().items():
        assert torch.equal(resumed.state.model.state_dict()[name], value)


@pytest.mark.parametrize("command", ["evaluate", "predict"])
def test_evaluate_and_predict_stop_without_a_gpu(world, monkeypatch,
                                                 command):
    """No fallback: without ``--device cpu`` the commands ask for a CUDA
    device and stop when there is none, before building anything."""
    root = world["root"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "build_model", lambda *a, **kw: pytest.fail(
        "a model was built"))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main([command, "x", "--tiny", "--geocells",
                  str(root / "cells.csv"), "--images", SAMPLE20])
