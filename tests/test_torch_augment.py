"""The training data of the port's ``finetune`` against the JAX package's:
the GeoAugmentor (`geocell/augmentor.py`) and its boundary lookup
(`geocell/boundaries.py`) on seeded GeoTIFFs and GeoJSON, the
``augment`` command, ``finetune -m`` on a frame without the multi-task
columns, a comma-separated ``--metadata``, and JPEG batches through the
native decoder."""

import json
import os

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from tests.test_torch_train import finetune_argv, write_world

SOURCES = ("adm0", "adm1", "koppen", "elevation", "population", "tavg",
           "prec", "driving")


def write_geotiff(path, data, origin=(-180.0, 90.0), scale=(10.0, 10.0)):
    """A GeoTIFF with ModelPixelScale and ModelTiepoint tags
    (`tests/test_augmentor.py::write_geotiff`)."""
    from PIL import TiffImagePlugin

    ifd = TiffImagePlugin.ImageFileDirectory_v2()
    ifd[33550] = (float(scale[0]), float(scale[1]), 0.0)
    ifd[33922] = (0.0, 0.0, 0.0, float(origin[0]), float(origin[1]), 0.0)
    Image.fromarray(data).save(path, tiffinfo=ifd)


def rect(x0, y0, x1, y1):
    """A closed ring, as GeoJSON writes them."""
    return [[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]]


def write_aux(root, sources=SOURCES, seed=0):
    """An auxiliary-data directory in `build_augmentor`'s layout with the
    ``sources`` named, seeded."""
    rng = np.random.default_rng(seed)
    aux = root / "aux"
    for sub in ("boundaries", "koppen_geiger", "elevation", "pop_density",
                "worldclim/tavg", "worldclim/prec"):
        (aux / sub).mkdir(parents=True, exist_ok=True)
    countries = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {"shapeName": "Westland"},
         "geometry": {"type": "Polygon",
                      "coordinates": [rect(-120, -40, -10, 50)]}},
        {"type": "Feature", "properties": {"name": "Eastland"},
         "geometry": {"type": "MultiPolygon", "coordinates": [
             [rect(10, -50, 80, 20)], [rect(90, 0, 150, 60)]]}},
        {"type": "Feature", "properties": {},
         "geometry": {"type": "Polygon",
                      "coordinates": [rect(-170, 55, -60, 80)]}}]}
    areas = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {"NAME_1": f"area{i}"},
         "geometry": {"type": "Polygon", "coordinates": [
             rect(-180 + 45 * i, -60, -140 + 45 * i, 60)]}}
        for i in range(8)]}
    if "adm0" in sources:
        (aux / "boundaries" / "geoBoundariesCGAZ_ADM0.geojson").write_text(
            json.dumps(countries))
    if "adm1" in sources:
        (aux / "boundaries" / "geoBoundariesCGAZ_ADM1.geojson").write_text(
            json.dumps(areas))
    if "koppen" in sources:
        write_geotiff(aux / "koppen_geiger" / "koppen.tif",
                      rng.integers(0, 32, (18, 36)).astype(np.uint8))
    if "elevation" in sources:
        write_geotiff(aux / "elevation" / "srtm.tif",
                      rng.normal(500, 300, (18, 36)).astype(np.float32))
    if "population" in sources:
        write_geotiff(aux / "pop_density" / "ghsl.tif",
                      rng.gamma(2, 50, (18, 36)).astype(np.float32),
                      origin=(-18040095.0, 9020047.0), scale=(1e6, 1e6))
    for name, key in (("tavg", "tavg"), ("prec", "prec")):
        if key in sources:
            for month in range(1, 13):
                write_geotiff(aux / "worldclim" / name / f"{name}_{month:02d}.tif",
                              rng.normal(15, 8, (18, 36)).astype(np.float32))
    if "driving" in sources:
        (aux / "driving_side.json").write_text(
            json.dumps({"Westland": "right", "Eastland": "left"}))
    return str(aux)


def points(n=40, seed=1):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"lng": rng.uniform(-180, 180, n),
                         "lat": rng.uniform(-85, 85, n),
                         "selection": np.where(np.arange(n) % 4, "train",
                                               "val")})


def test_boundaries_match_both_jax_lookups(tmp_path):
    """`BoundarySet` as the JAX `BoundarySet` (rings without their closing
    vertex) and as the JAX `CountryIndex` (rings as written), on points
    inside, between and outside the polygons."""
    from pigeon_tpu.geocell.augmentor import load_boundaries_with_names
    from pigeon_tpu.train.metrics import CountryIndex as JaxIndex
    from pigeon_tpu_torch.geocell import augmentor
    from pigeon_tpu_torch.train.metrics import CountryIndex

    path = os.path.join(write_aux(tmp_path), "boundaries",
                        "geoBoundariesCGAZ_ADM0.geojson")
    pts = points(200)[["lng", "lat"]].to_numpy()
    want, want_names = load_boundaries_with_names(path)
    got, got_names = augmentor.load_boundaries_with_names(path)
    assert got_names == want_names == ["Westland", "Eastland", "2"]
    np.testing.assert_array_equal(got.assign(pts), want.assign(pts))
    np.testing.assert_array_equal(got.assign_with_nearest_fill(pts),
                                  want.assign_with_nearest_fill(pts))
    np.testing.assert_array_equal(got.centroids, want.centroids)
    index, jindex = CountryIndex(path), JaxIndex(path)
    assert index.names == jindex.names == ["0", "Eastland", "2"]
    np.testing.assert_array_equal(index.country_of(pts),
                                  jindex.country_of(pts))
    np.testing.assert_array_equal(index.centroids, jindex.centroids)
    assert (got.assign(pts) < 0).any()      # the nearest fill is exercised


@pytest.mark.parametrize("sources", ["all", "rasters_only", "countries",
                                     "none"])
def test_augmentor_matches_jax(tmp_path, sources):
    from pigeon_tpu.geocell.augmentor import build_augmentor as jax_build
    from pigeon_tpu_torch.geocell.augmentor import build_augmentor

    chosen = {"all": SOURCES,
              "rasters_only": ("koppen", "elevation", "population", "tavg"),
              "countries": ("adm0", "driving"),
              "none": ()}[sources]
    aux = write_aux(tmp_path, chosen)
    got, want = build_augmentor(aux), jax_build(aux)
    if not chosen:
        assert got is None and want is None
        return
    df = points()
    pd.testing.assert_frame_equal(got.augment(df), want.augment(df))
    assert set(got.augment(df).columns) > set(df.columns)


def test_augment_command_writes_the_jax_csv(tmp_path):
    from pigeon_tpu.cli import run as jax_cli
    from pigeon_tpu_torch.cli import run as cli

    aux = write_aux(tmp_path)
    meta = tmp_path / "meta.csv"
    points().to_csv(meta, index=False)
    assert cli.main(["augment", "--metadata", str(meta), "--aux-dir", aux]) \
        == 0
    assert jax_cli.main(["augment", "--metadata", str(meta), "--aux-dir",
                         aux, "--output", str(tmp_path / "jax.csv")]) == 0
    got = (tmp_path / "meta_augmented.csv").read_text()
    assert got == (tmp_path / "jax.csv").read_text()
    assert "climate_zone_idx" in got.splitlines()[0]
    with pytest.raises(SystemExit, match="needs lng/lat"):
        pd.DataFrame({"x": [1]}).to_csv(tmp_path / "bad.csv", index=False)
        cli.main(["augment", "--metadata", str(tmp_path / "bad.csv")])


def test_finetune_multitask_augments_a_frame_without_the_columns(
        tmp_path, monkeypatch):
    """``finetune -m`` on metadata that lacks every multi-task column
    trains on the CPU on what the GeoAugmentor of ``--aux-dir`` adds."""
    from pigeon_tpu_torch.cli import run as cli
    from pigeon_tpu_torch.data.pipeline import MT_COLUMNS

    write_world(tmp_path)
    df = pd.read_csv(tmp_path / "meta.csv") \
        .drop(columns=[*MT_COLUMNS, "climate_zone_idx"])
    df.to_csv(tmp_path / "meta.csv", index=False)
    aux = write_aux(tmp_path)
    seen = []
    real = cli._augment_frame
    monkeypatch.setattr(cli, "_augment_frame",
                        lambda frame, args, source: seen.append(source)
                        or real(frame, args, source))
    monkeypatch.chdir(tmp_path)
    assert cli.main(finetune_argv(tmp_path, "--epochs", "1", "--aux-dir",
                                  aux)) == 0
    assert seen == [str(tmp_path / "meta.csv")]
    records = [json.loads(line) for line in
               open(tmp_path / "runs" / "tinyrun" / "metrics.jsonl")]
    assert all(np.isfinite(r["value"]) for r in records)
    assert any(r["tag"] == "eval/Climate_accuracy" for r in records)
    # Sources that cannot supply a column stop the command with the fix.
    partial = write_aux(tmp_path / "partial", ("koppen", "elevation"))
    with pytest.raises(SystemExit, match="population.*augment"):
        cli.main(finetune_argv(tmp_path, "--aux-dir", partial))


def recorded_frames(monkeypatch, module):
    """The frames of every `TabularImageDataset` ``module`` builds, as they
    are when training starts (after ``--sample``)."""
    made = []

    class Recording(module.TabularImageDataset):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(module, "TabularImageDataset", Recording)
    return made


def test_two_metadata_files_give_the_jax_frames(tmp_path, monkeypatch):
    """Train rows of both files concatenated, then ``--sample``; val from
    the first file; each file augmented on its own under ``-m``."""
    import pigeon_tpu.data as jax_data
    from pigeon_tpu.cli import run as jax_cli
    from pigeon_tpu.train import loop as jax_loop
    from pigeon_tpu_torch.cli import run as cli
    from pigeon_tpu_torch.data import pipeline

    write_world(tmp_path)
    first = pd.read_csv(tmp_path / "meta.csv")
    second = first.copy()
    second["lng"] = -second["lng"]
    second = second.drop(columns=["temp_avg", "prec_diff"])  # augmented
    second.to_csv(tmp_path / "second.csv", index=False)
    aux = write_aux(tmp_path)
    argv = [a if a != str(tmp_path / "meta.csv")
            else f"{tmp_path / 'meta.csv'},{tmp_path / 'second.csv'}"
            for a in finetune_argv(tmp_path, "--aux-dir", aux, "-s", "15")]

    port = recorded_frames(monkeypatch, pipeline)
    cli.build_finetune(cli.build_parser().parse_args(argv))
    jax = recorded_frames(monkeypatch, jax_data)
    monkeypatch.setattr(jax_loop, "train_model",
                        lambda state, *a, **kw: (state, []))
    jax_cli.main([a for a in argv if a not in ("--device", "cpu")])
    assert len(port) == len(jax) == 2
    n_train = int((first["selection"] == "train").sum()
                  + (second["selection"] == "train").sum())
    assert n_train > 15
    for got, want in zip(port, jax):
        pd.testing.assert_frame_equal(got.df, want.df)
    assert len(port[0].df) == 15
    assert len(port[1].df) == int((first["selection"] == "val").sum())
    # Without -s every train row of both files is there.
    port.clear()
    cli.build_finetune(cli.build_parser().parse_args(argv[:-2]))
    assert len(port[0].df) == n_train


def test_jpeg_batches_match_the_jax_pipeline(tmp_path):
    """JPEG panoramas through both pipelines' uint8 paths: the native
    decoder where it builds (both packages take it then), PIL where it
    does not."""
    from pigeon_tpu.data import TabularImageDataset, iter_batches
    from pigeon_tpu_torch.data import native_decode, pipeline

    rng = np.random.default_rng(7)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40 + 9 * i, 61, 3),
                                     dtype=np.uint8)).save(
            img_dir / f"{i}.jpg", quality=90)
    df = pd.DataFrame({
        **{col: [f"{(i + k) % 5}.jpg" for i in range(6)]
           for k, col in enumerate(("image", "image_2", "image_3",
                                    "image_4"))},
        "lng": rng.uniform(-180, 180, 6), "lat": rng.uniform(-60, 60, 6)})
    want = list(iter_batches(TabularImageDataset(
        df, image_dir=str(img_dir), image_size=24, panorama=True,
        normalize=False), 3))
    got = list(pipeline.iter_batches(pipeline.TabularImageDataset(
        df, image_dir=str(img_dir), image_size=24, panorama=True), 3))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    df.assign(selection=["train"] * 4 + ["val"] * 2).to_csv(
        tmp_path / "m.csv", index=False)
    val = pipeline.TabularImageDataset.from_csv(
        str(tmp_path / "m.csv"), "val", str(img_dir), 24, panorama=True)
    assert len(val) == 2
    np.testing.assert_array_equal(val.labels_lla(),
                                  df[["lng", "lat"]].to_numpy(np.float32)[4:])
    if native_decode.available():
        # The native path is what ran: its output differs from PIL's.
        row = df.iloc[0]
        pil = Image.open(img_dir / row["image"])
        pil.draft("RGB", (24, 24))
        from pigeon_tpu_torch.data.image_ops import resize_crop_pil

        assert not np.array_equal(resize_crop_pil(pil, 24), got[0]["inputs"][0, 0])
