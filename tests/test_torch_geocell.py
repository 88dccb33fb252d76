"""The port's offline geocell tooling (`pigeon_tpu_torch/geocell/`) against
the JAX package's (`pigeon_tpu/geocell/`) on the same seeded inputs: the
geometry engine, Voronoi cells, the split and fuse of `cells.py`, the
creator, naive cells, the assigner and the prototype builder give the
same cells (points exactly, polygons within 1e-9) and the same prototype
rows; the ``geocells`` -> ``prototypes`` CLI run of the port, with JAX
blocked, writes the same CSVs as the JAX CLI's."""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from pigeon_tpu.geocell import assignment as j_assignment
from pigeon_tpu.geocell import cells as j_cells
from pigeon_tpu.geocell import creation as j_creation
from pigeon_tpu.geocell import geometry as j_geom
from pigeon_tpu.geocell import naive as j_naive
from pigeon_tpu.geocell import prototypes as j_prototypes
from pigeon_tpu.geocell import voronoi as j_voronoi
from pigeon_tpu_torch.geocell import assignment as t_assignment
from pigeon_tpu_torch.geocell import boundaries as t_boundaries
from pigeon_tpu_torch.geocell import cells as t_cells
from pigeon_tpu_torch.geocell import creation as t_creation
from pigeon_tpu_torch.geocell import geometry as t_geom
from pigeon_tpu_torch.geocell import naive as t_naive
from pigeon_tpu_torch.geocell import prototypes as t_prototypes
from pigeon_tpu_torch.geocell import voronoi as t_voronoi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The polygons' bound, port against JAX.
POLY_TOL = 1e-9
BLOCKED = ("jax", "jaxlib", "flax", "optax", "pigeon_tpu")


def square(x0, y0, s):
    return np.array([[x0, y0], [x0 + s, y0], [x0 + s, y0 + s], [x0, y0 + s]],
                    float)


def star(rng, cx, cy, n=8, r=(0.5, 3.0)):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(*r, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1)


def write_world(root, seed: int, train: int = 1024, held: int = 128,
                countries: int = 3, per_side: int = 2, sites: int = 8,
                ids: bool = False):
    """A seeded metadata CSV (``lng``, ``lat``, ``selection``; with
    ``ids`` also ``country_id``, ``admin_1_id``, ``admin_2_id``) of rows
    clustered around ``sites`` sites a country, three streets a site, in
    ``countries`` grids of 4-degree admin-2 squares, and their GeoJSON."""
    rng = np.random.default_rng(seed)
    feats, site_list = [], []
    for ci in range(countries):
        x0, y0 = -100.0 + 90.0 * ci, -20.0 + 25.0 * ci
        for gy in range(per_side):
            for gx in range(per_side):
                a, b = x0 + 4.0 * gx, y0 + 4.0 * gy
                feats.append({
                    "type": "Feature",
                    "properties": {"shapeName": f"c{ci}_{gx}_{gy}"},
                    "geometry": {"type": "Polygon", "coordinates": [[
                        [a, b], [a + 4, b], [a + 4, b + 4], [a, b + 4],
                        [a, b]]]}})
        span = 4.0 * per_side
        site_list.append(np.stack([
            rng.uniform(x0 + 0.3, x0 + span - 0.3, sites),
            rng.uniform(y0 + 0.3, y0 + span - 0.3, sites)], -1))
    centers = np.concatenate(site_list)
    streets = (centers[:, None] + rng.normal(0, 0.4, (len(centers), 3, 2))
               ).reshape(-1, 2)
    n = train + held
    pick = rng.integers(0, len(streets), n)
    pts = streets[pick] + rng.normal(0, 0.04, (n, 2))
    sel = np.array(["train"] * train + ["test"] * held)
    rng.shuffle(sel)
    df = pd.DataFrame({"image": [f"{i}.png" for i in range(n)],
                       "lng": pts[:, 0], "lat": pts[:, 1],
                       "selection": sel})
    gj = os.path.join(root, "admin2.geojson")
    with open(gj, "w") as f:
        json.dump({"type": "FeatureCollection", "features": feats}, f)
    if ids:
        admin2 = t_boundaries.BoundarySet.from_geojson(gj)
        a2 = admin2.assign_with_nearest_fill(pts)
        df["admin_2_id"] = a2
        df["admin_1_id"] = a2 // 2
        df["country_id"] = a2 // (per_side * per_side)
    meta = os.path.join(root, "meta.csv")
    df.to_csv(meta, index=False)
    return meta, gj


def assert_rings_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=POLY_TOL)


def assert_cells_equal(got_cells, want_cells):
    got = {c.cell_id: c for c in got_cells}
    want = {c.cell_id: c for c in want_cells}
    assert sorted(got) == sorted(want)
    for cid, w in want.items():
        g = got[cid]
        assert (g.admin_1, g.country) == (w.admin_1, w.country)
        np.testing.assert_array_equal(g.points, w.points)
        assert_rings_close(g.polygons, w.polygons)


def assert_frames_equal(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        if want[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], want[col], rtol=0,
                                       atol=POLY_TOL)
        else:
            assert got[col].tolist() == want[col].tolist(), col


# ---------------------------------------------------------------------------
# Geometry and Voronoi
# ---------------------------------------------------------------------------

def _geometry(geom, case: str, seed: int):
    rng = np.random.default_rng(seed)
    rings = [star(rng, *rng.uniform(-50, 50, 2)) for _ in range(6)]
    pts = rng.uniform(-55, 55, (400, 2))
    if case == "area_centroid_bbox":
        return [(geom.polygon_area(r), geom.polygon_centroid(r),
                 geom.bbox(r)) for r in rings]
    if case == "clip":
        hull = geom.convex_hull(rings[1])
        return [geom.clip_to_convex(r, hull) for r in rings]
    if case == "intersect":
        return [geom.polygons_intersect(a, b) for a in rings for b in rings]
    if case == "pip":
        big = [star(rng, 0, 0, 64, (20, 50))]
        many = np.repeat(pts, 20, axis=0) + rng.normal(0, 1, (8000, 2))
        return (geom.points_in_ring(pts, rings[0]),
                geom.points_in_multipolygon(pts, rings),
                geom.points_in_multipolygon(many, big * 3))
    if case == "scale_hull":
        return [(geom.scale_about_centroid(r, 1.01), geom.convex_hull(r))
                for r in rings]
    if case == "dissolve_wkt":
        tiles = t_voronoi.voronoi_regions_for_points(rng.uniform(1, 9, (5,
                                                                       2)))
        pieces = [geom.clip_to_convex(square(0, 0, 10), t) for t in tiles]
        comps = geom.dissolve(pieces)
        return ([s for s, _ in comps], [h for _, hs in comps for h in hs],
                geom.dissolve_to_wkt(pieces), geom.to_wkt(pieces),
                geom.from_wkt(geom.to_wkt(pieces)))
    if case == "proximity":
        return [geom.boundary_proximity_count(r, rings, tol=0.5)
                for r in rings]
    raise ValueError(case)


def _flatten(x):
    if isinstance(x, (list, tuple)):
        return [y for item in x for y in _flatten(item)]
    return [x]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["area_centroid_bbox", "clip", "intersect",
                                  "pip", "scale_hull", "dissolve_wkt",
                                  "proximity"])
def test_geometry_matches_jax(case, seed):
    got = _flatten(_geometry(t_geom, case, seed))
    want = _flatten(_geometry(j_geom, case, seed))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
        else:
            np.testing.assert_allclose(np.asarray(g, float),
                                       np.asarray(w, float), rtol=0,
                                       atol=POLY_TOL)


@pytest.mark.parametrize("k,scale", [(2, 1.0), (3, 1.0), (7, 1.0),
                                     (4, 1e-5), (30, 1.0)])
def test_voronoi_matches_jax(k, scale):
    rng = np.random.default_rng(k)
    sites = 5.0 + scale * rng.uniform(-4, 4, (k, 2))
    assert_rings_close(t_voronoi.voronoi_regions_for_points(sites),
                       j_voronoi.voronoi_regions_for_points(sites))


# ---------------------------------------------------------------------------
# Cells: split, fuse, balance
# ---------------------------------------------------------------------------

def _split_points(case: str):
    rng = np.random.default_rng(3)
    if case == "two":
        return np.concatenate([rng.normal([2, 2], 0.2, (80, 2)),
                               rng.normal([7, 7], 0.2, (80, 2))])
    if case == "three":
        return np.concatenate([rng.normal(c, 0.3, (70, 2))
                               for c in ([2, 2], [7, 2], [4.5, 7])])
    if case == "doughnut":
        ang = rng.uniform(0, 2 * np.pi, 50)
        ring = np.stack([5 + 4 * np.cos(ang), 5 + 4 * np.sin(ang)], -1)
        return np.concatenate([rng.normal([5, 5], 0.1, (70, 2)), ring])
    return rng.uniform(0, 10, (150, 2))          # uniform: no split


@pytest.mark.parametrize("case", ["two", "three", "doughnut", "uniform"])
def test_cell_split_matches_jax(case):
    pts = _split_points(case)
    cells = []
    for mod in (t_cells, j_cells):
        cell = mod.Cell("root", "a1", "c", pts.copy(), [square(0, 0, 10)])
        new = cell.split((8, 0.05), 20, 60)
        cells.append([cell] + new)
    assert_cells_equal(*cells)
    for got, want in zip(*cells):
        assert got.to_row() == want.to_row()


def _fuse_cells(mod, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        for j in range(4):
            n = int(rng.integers(3, 30))
            out.append(mod.Cell(f"{i}_{j}", f"a{i // 2}", f"c{j // 2}",
                                rng.normal([i * 4 + 2, j * 4 + 2], 0.5,
                                           (n, 2)),
                                [square(i * 4, j * 4, 4)]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 330])
def test_fuse_matches_jax(seed):
    colls = [mod.CellCollection(_fuse_cells(mod, seed))
             for mod in (t_cells, j_cells)]
    for coll in colls:
        for country in coll.countries[::-1]:
            coll._fuse_country(country, 25, seed)
        coll.clean()
    assert_cells_equal(*colls)


@pytest.mark.parametrize("workers", [0, 2])
def test_balance_matches_jax(workers):
    """The fuse, then the split ladder, serial and on a spawned process
    pool (the port's workers import torch, the JAX package's jax)."""
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.normal(c, 0.3, (70, 2))
                          for c in ([0, 0], [6, 0], [0, 6])])
    side = rng.normal([10, 3], 0.3, (5, 2))
    colls = []
    for mod in (t_cells, j_cells):
        coll = mod.CellCollection([
            mod.Cell("root", "a1", "c", pts.copy(), [square(-2, -2, 10)]),
            mod.Cell("side", "a1", "c", side.copy(), [square(8, -2, 4)])])
        coll.balance(20, 60, optics_params=((15, 0.05),),
                     num_workers=workers)
        colls.append(coll)
    assert_cells_equal(*colls)
    assert colls[0].to_records() == colls[1].to_records()


# ---------------------------------------------------------------------------
# Creator, naive cells, assigner, prototypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boundaries", ["admin2", "none", "ids"])
def test_creator_matches_jax(tmp_path, boundaries):
    meta, gj = write_world(str(tmp_path), 1, train=768, held=64,
                           ids=boundaries == "ids")
    df = pd.read_csv(meta)
    out = {}
    for name, mod, bset in (
            ("torch", t_creation, t_boundaries.BoundarySet),
            ("jax", j_creation, j_creation.BoundarySet)):
        admin2 = bset.from_geojson(gj) if boundaries != "none" else None
        creator = mod.GeocellCreator(df, admin_2=admin2)
        csv = str(tmp_path / f"{name}.csv")
        out[name] = (creator.generate(30, 60, optics_params=(
            j_cells.OPTICS_PARAMS_STREETVIEW), output_csv=csv), csv)
    assert_cells_equal(out["torch"][0], out["jax"][0])
    assert_frames_equal(pd.read_csv(out["torch"][1]),
                        pd.read_csv(out["jax"][1]))


@pytest.mark.parametrize("max_size,min_size", [(40, 1), (100, 10)])
def test_naive_matches_jax(max_size, min_size):
    pts = np.random.default_rng(4).normal([10, 20], [40, 20], (1500, 2))
    got = t_naive.NaiveCell.build(pts, max_size, min_size)
    want = j_naive.NaiveCell.build(pts, max_size, min_size)
    assert [c.bounds for c in got] == [c.bounds for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.points, w.points)
        np.testing.assert_array_equal(g.centroid, w.centroid)
        np.testing.assert_array_equal(g.contains(pts), w.contains(pts))


@pytest.mark.parametrize("source", ["csv", "collection"])
def test_assigner_matches_jax(tmp_path, source):
    meta, gj = write_world(str(tmp_path), 2, train=512, held=64)
    df = pd.read_csv(meta)
    pts = df[["lng", "lat"]].to_numpy()
    far = np.random.default_rng(5).uniform(-180, 180, (64, 2))
    probes = np.concatenate([pts, far])
    labels = []
    for mod, cmod, bset in ((t_assignment, t_creation,
                             t_boundaries.BoundarySet),
                            (j_assignment, j_creation,
                             j_creation.BoundarySet)):
        csv = str(tmp_path / f"{mod.__name__}.csv")
        cells = cmod.GeocellCreator(df, admin_2=bset.from_geojson(
            gj)).generate(30, 60, j_cells.OPTICS_PARAMS_STREETVIEW,
                          output_csv=csv)
        assigner = (mod.CellAssigner.from_csv(csv) if source == "csv"
                    else mod.CellAssigner.from_collection(cells))
        labels.append((assigner.assign(probes), assigner.one_hot(pts)))
    np.testing.assert_array_equal(labels[0][0], labels[1][0])
    np.testing.assert_array_equal(labels[0][1], labels[1][1])


@pytest.mark.parametrize("cluster_args", [(5, 0.05), (8, 0.02)])
def test_prototypes_match_jax(cluster_args):
    """The same rows exactly, a cell above 512 points included (its
    haversine matrix in the C++ kernels on both sides)."""
    rng = np.random.default_rng(6)
    parts = [rng.normal(c, s, (n, 2)) for c, s, n in (
        ([0, 0], 0.05, 20), ([5, 5], 0.05, 20), ([50, 20], 0.05, 15),
        ([10, 40], 0.3, 600), ([11, 41], 0.02, 3))]
    pts = np.concatenate(parts)
    cell = np.concatenate([[0] * 40, [1] * 15, [2] * 600, [3] * 3])
    df = pd.DataFrame({"lng": pts[:, 0], "lat": pts[:, 1],
                       "geocell_idx": cell,
                       "selection": np.where(rng.random(len(pts)) < 0.9,
                                             "train", "val")})
    got = t_prototypes.build_prototypes(df, cluster_args, num_workers=0)
    want = j_prototypes.build_prototypes(df, cluster_args, num_workers=0)
    assert len(got) > 4
    assert got.to_dict("records") == want.to_dict("records")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def port_cli(argv, cwd):
    """The port's CLI in a process where JAX and the JAX package are
    blocked."""
    code = ("import sys\n"
            f"for name in {BLOCKED!r}:\n    sys.modules[name] = None\n"
            "from pigeon_tpu_torch.cli.run import main\n"
            f"sys.exit(main({list(argv)!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_cli_ladder_matches_jax(tmp_path):
    """``geocells --load`` then ``prototypes --geocells`` (labels from the
    cells CSV, a process pool over the cells): the port with JAX blocked
    and the JAX CLI write the same CSVs."""
    from pigeon_tpu.cli.run import main as jax_main

    meta, gj = write_world(str(tmp_path), 0)
    for who in ("torch", "jax"):
        cells = str(tmp_path / f"cells_{who}.csv")
        protos = str(tmp_path / f"protos_{who}.csv")
        argvs = (["geocells", "lad", "--metadata", meta, "--load", gj,
                  "--output", cells],
                 ["prototypes", "lad", "--metadata", meta, "--geocells",
                  cells, "--output", protos])
        for argv in argvs:
            if who == "torch":
                port_cli(argv, str(tmp_path))
            else:
                assert jax_main(argv) == 0
    got = pd.read_csv(tmp_path / "cells_torch.csv")
    assert len(got) >= 10 and got["size"].sum() == 1024
    for name in ("cells", "protos"):
        with open(tmp_path / f"{name}_torch.csv") as f:
            mine = f.read()
        with open(tmp_path / f"{name}_jax.csv") as f:
            assert mine == f.read(), name


def test_prototypes_cli_comma_pairs(tmp_path):
    """``--metadata A,B --output PA,PB``: one table a file, its member
    indices its own train rows; a list of another length stops."""
    from pigeon_tpu_torch.cli.run import main

    meta, gj = write_world(str(tmp_path), 3, train=256, held=32, ids=True)
    df = pd.read_csv(meta)
    cells = str(tmp_path / "cells.csv")
    assert main(["geocells", "--metadata", meta, "--load", gj,
                 "--output", cells]) == 0
    halves = [str(tmp_path / f"m{i}.csv") for i in range(2)]
    df.iloc[:140].to_csv(halves[0], index=False)
    df.iloc[140:].to_csv(halves[1], index=False)
    outs = [str(tmp_path / f"p{i}.csv") for i in range(2)]
    assert main(["prototypes", "--metadata", ",".join(halves),
                 "--geocells", cells, "--output", ",".join(outs)]) == 0
    for half, out in zip(halves, outs):
        train = pd.read_csv(half).query("selection == 'train'")
        table = pd.read_csv(out)
        members = [i for ix in table["indices"] for i in json.loads(ix)]
        assert max(members) < len(train)
        assert table["count"].sum() == len(members)
    with pytest.raises(SystemExit, match="one CSV per"):
        main(["prototypes", "--metadata", ",".join(halves),
              "--geocells", cells, "--output", outs[0]])
    with pytest.raises(SystemExit, match="geocell_idx"):
        main(["prototypes", "--metadata", halves[0], "--output", outs[0]])
