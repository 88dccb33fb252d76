"""The port's host geo kernels (`csrc/geokernels.cpp`, loaded by
`pigeon_tpu_torch/geocell/geokernels.py`) and its OPTICS
(`geocell/optics.py`): every C++ entry point against its plain numpy
version and against the JAX package's own library, the C++ reachability
graph against the numpy graph bit for bit, the port's xi extraction
against scikit-learn's `cluster_optics_xi` and `OPTICS` exactly (random
graphs and the graphs of geocell fixtures), and the numpy fallback where
the library does not build."""

import logging

import numpy as np
import pytest
from sklearn.cluster import OPTICS, cluster_optics_xi

from pigeon_tpu import native as j_native
from pigeon_tpu.core.geodesy import haversine_matrix_np as j_haversine_np
from pigeon_tpu_torch.core.geodesy import haversine_matrix_np
from pigeon_tpu_torch.geocell import boundaries, geokernels, optics
from pigeon_tpu_torch.geocell import geometry as geom

#: A fixed seeded OPTICS case and its xi labels, computed on the CPU by
#: scikit-learn (`OPTICS(min_samples=8, xi=0.05).fit_predict`). The smoke
#: (`chip_smoke.py`'s ``[geocell_ladder]``) reads them from this file and
#: holds the port's labels on the card's machine to them.
XI_CASE = {"seed": 3, "n": 120, "min_samples": 8, "xi": 0.05}
XI_EXPECTED = [
    -1, 4, -1, 3, -1, -1, 4, -1, 3, -1, -1, 4, 2, 3, -1, 0, 4, -1, 3,
    -1, -1, 4, 2, 3, 3, -1, 4, 2, 3, -1, -1, 4, 1, 3, -1, -1, 4, 1, 3,
    1, -1, 4, -1, 3, 3, 0, 4, -1, 3, -1, -1, 4, 2, 3, -1, 0, 4, 1, 3, 3,
    0, 4, -1, 3, -1, -1, 4, 1, 3, -1, 0, 4, 2, 3, -1, 0, 4, 1, 3, -1, 0,
    4, 2, 3, -1, -1, 4, -1, 3, -1, 0, 4, 2, 3, -1, -1, 4, 1, 3, 4, -1,
    4, -1, 3, -1, -1, 4, 2, 3, 4, 0, 4, 1, 3, -1, 0, 4, -1, 3, 4]


@pytest.fixture(autouse=True)
def library():
    """Each test needs the library built (g++ and OpenMP here)."""
    if not geokernels.available():
        pytest.skip("the C++ geo kernels do not build here")


def xi_case_points(seed: int, n: int, **_) -> np.ndarray:
    """`XI_CASE`'s points: four seeded blobs of different spreads and a
    fifth of the points uniform noise around them."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, (4, 2))
    spread = np.array([0.4, 0.8, 1.5, 0.3])
    k = np.arange(n) % 5
    noise = rng.uniform(-10, 10, (n, 2))
    blob = centers[k % 4] + rng.normal(0, 1, (n, 2)) * spread[k % 4, None]
    return np.where((k == 4)[:, None], noise, blob)


def blobs(n, k, spread, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-50, 50, (k, 2))
    return centers[rng.integers(0, k, n)] + rng.normal(0, spread, (n, 2))


def rings(seed, count=6, n=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(0.5, 4.0, n)
        c = rng.uniform(-6, 6, 2)
        out.append(np.stack([c[0] + rad * np.cos(ang),
                             c[1] + rad * np.sin(ang)], -1))
    return out


# ---------------------------------------------------------------------------
# The library's entry points
# ---------------------------------------------------------------------------

def _entry_point(mod, case: str, seed: int, plain: bool = False):
    """Each entry point on seeded inputs (``plain``: its numpy version
    in the port)."""
    rng = np.random.default_rng(seed)
    rs = rings(seed)
    pts = rng.uniform(-9, 9, (3000, 2))
    if case == "pip_batch":
        return (geom.points_in_ring(pts, rs[0]) if plain
                else mod.pip_batch(pts, geom.as_ring(rs[0])))
    if case == "pip_multi":
        return (np.any([geom.points_in_ring(pts, r) for r in rs], 0)
                if plain else mod.pip_multi(pts, rs))
    if case == "assign_features":
        feats = [rs[:2], rs[2:3], rs[3:]]
        bset = boundaries.BoundarySet(feats, ["a", "b", "c"])
        return (bset.assign(pts) if plain
                else mod.assign_features(pts, feats, bset.bboxes))
    if case == "multipoly_intersect_batch":
        cands = [rings(seed + 10 + i, count=int(rng.integers(0, 3)))
                 for i in range(12)]
        return (np.array([geom.polygons_intersect(rs[:2], c) for c in cands])
                if plain else mod.multipoly_intersect_batch(rs[:2], cands))
    if case == "haversine_matrix":
        x = np.stack([rng.uniform(-180, 180, 300),
                      rng.uniform(-70, 70, 300)], -1)
        return (haversine_matrix_np(x, x[:200]) if plain
                else mod.haversine_matrix(x, x[:200]))
    raise ValueError(case)


ENTRY_POINTS = ["pip_batch", "pip_multi", "assign_features",
                "multipoly_intersect_batch", "haversine_matrix"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ENTRY_POINTS)
def test_entry_point_matches_numpy_and_jax_library(case, seed):
    got = _entry_point(geokernels, case, seed)
    want = _entry_point(None, case, seed, plain=True)
    if case == "haversine_matrix":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)
    if j_native.available():
        np.testing.assert_array_equal(got, _entry_point(j_native, case,
                                                        seed))


def test_haversine_numpy_matches_jax():
    rng = np.random.default_rng(2)
    x = np.stack([rng.uniform(-180, 180, 200), rng.uniform(-89, 89, 200)],
                 -1)
    np.testing.assert_array_equal(haversine_matrix_np(x, x),
                                  j_haversine_np(x, x))


# ---------------------------------------------------------------------------
# The OPTICS graph
# ---------------------------------------------------------------------------

def _graph_input(kind: str, n: int, seed: int):
    if kind == "euclidean":
        return blobs(n, 6, 1.2, seed), False
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(40, 50, n)], -1)
    d = haversine_matrix_np(pts, pts)
    return np.where(d == 0, 1e-5, d), True


@pytest.mark.parametrize("kind,n,min_samples", [
    ("euclidean", 400, 8), ("euclidean", 500, 15), ("euclidean", 600, 300),
    ("euclidean", 9000, 300), ("precomputed", 350, 5),
    ("precomputed", 40, 40), ("euclidean", 3, 2)])
def test_cpp_graph_equals_numpy_graph(kind, n, min_samples):
    """Bit for bit, the 9000-point case on the OpenMP path (>= 8192
    unprocessed points a step)."""
    x, pre = _graph_input(kind, n, n)
    got = geokernels.optics_graph(x, min_samples, precomputed=pre)
    want = optics.optics_graph_np(x, min_samples, precomputed=pre)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if kind == "euclidean" and n == 400:
        ref = OPTICS(min_samples=min_samples, xi=0.05).fit(x)
        for g, w in zip(want, (ref.ordering_, ref.core_distances_,
                               ref.reachability_, ref.predecessor_)):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The xi extraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_xi_extraction_equals_sklearn_on_random_graphs(seed):
    """Random reachability plots (inf plateaus, ties, any predecessors)
    at random min_samples and xi, with and without the predecessor
    correction: the same labels and clusters."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(2, 300))
        min_samples = int(rng.integers(2, min(n, 25) + 1))
        reach = np.round(rng.exponential(1.0, n), int(rng.integers(1, 4)))
        reach[rng.random(n) < 0.05] = np.inf
        kwargs = dict(reachability=reach,
                      predecessor=rng.integers(-1, n, n),
                      ordering=rng.permutation(n), min_samples=min_samples,
                      xi=float(rng.uniform(0.001, 0.4)),
                      predecessor_correction=bool(rng.random() < 0.8))
        want = cluster_optics_xi(**kwargs)
        got = optics.cluster_optics_xi(**kwargs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1].reshape(-1, 2),
                                      want[1].reshape(-1, 2))


@pytest.mark.parametrize("case", ["streetview", "planet", "prototypes",
                                  "fixture_cells"])
def test_xi_labels_equal_sklearn_optics(case, tmp_path):
    """`optics_xi_labels` against ``OPTICS(...).fit_predict`` on the
    geocell fixtures: the split ladders' settings, a prototype cell's
    precomputed haversine graph, and the cells of a seeded world (every
    cell's points at the StreetView ladder's first setting)."""
    if case == "streetview":
        sets = [(blobs(500, 6, 1.2, 5), 8, 0.05, False),
                (blobs(400, 4, 2.0, 6), 15, 0.015, False)]
    elif case == "planet":
        sets = [(blobs(700, 6, 1.2, 7), 300, 0.05, False)]
    elif case == "prototypes":
        x, _ = _graph_input("precomputed", 350, 9)
        sets = [(x, 5, 0.05, True)]
    else:
        # A seeded world's admin-2 cells (4-degree squares): sites, three
        # streets a site, the rows around the streets.
        rng = np.random.default_rng(4)
        sites = rng.uniform(0, 12, (10, 2))
        streets = (sites[:, None] + rng.normal(0, 0.4, (10, 3, 2))
                   ).reshape(-1, 2)
        pts = streets[rng.integers(0, 30, 900)] + rng.normal(0, 0.04,
                                                            (900, 2))
        square = (pts // 4.0) @ [1, 10]
        sets = [(pts[square == q], 8, 0.05, False)
                for q in np.unique(square) if (square == q).sum() > 8]
    for x, min_samples, xi, pre in sets:
        kwargs = {"metric": "precomputed"} if pre else {}
        want = OPTICS(min_samples=min_samples, xi=xi,
                      **kwargs).fit_predict(x)
        got = optics.optics_xi_labels(x, min_samples, xi, precomputed=pre)
        np.testing.assert_array_equal(got, want)


def test_stored_xi_case():
    """`XI_EXPECTED` is scikit-learn's answer for `XI_CASE`, and the
    port's, on the C++ graph and on the numpy one."""
    pts = xi_case_points(**XI_CASE)
    ms, xi = XI_CASE["min_samples"], XI_CASE["xi"]
    want = OPTICS(min_samples=ms, xi=xi).fit_predict(pts)
    assert want.tolist() == XI_EXPECTED
    assert optics.optics_xi_labels(pts, ms, xi).tolist() == XI_EXPECTED
    ordering, _, reach, pred = optics.optics_graph_np(pts, ms)
    labels, _ = optics.cluster_optics_xi(reachability=reach,
                                         predecessor=pred,
                                         ordering=ordering, min_samples=ms,
                                         xi=xi)
    assert labels.tolist() == XI_EXPECTED


def test_xi_rejects_sizes_out_of_range():
    kwargs = dict(reachability=np.ones(5), predecessor=np.zeros(5, int),
                  ordering=np.arange(5))
    for ms in (1, 6):
        with pytest.raises(ValueError, match="min_samples"):
            optics.cluster_optics_xi(min_samples=ms, **kwargs)


# ---------------------------------------------------------------------------
# Where the library does not build
# ---------------------------------------------------------------------------

def test_failed_build_falls_back_to_numpy(monkeypatch, caplog):
    """A build that fails makes `load` None with one warning; the split,
    the prototypes and the OPTICS labels then run in numpy, with the same
    answers."""
    import pandas as pd

    from pigeon_tpu_torch.geocell import cells, prototypes

    pts = np.concatenate([np.random.default_rng(1).normal(c, 0.3, (70, 2))
                          for c in ([0, 0], [6, 0], [0, 6])])
    rng = np.random.default_rng(2)
    big = rng.normal([10, 40], 0.3, (600, 2))
    df = pd.DataFrame({"lng": np.r_[pts[:, 0], big[:, 0]],
                       "lat": np.r_[pts[:, 1], big[:, 1]],
                       "geocell_idx": [0] * 210 + [1] * 600})

    def run():
        cell = cells.Cell("root", "a", "c", pts.copy(),
                          [np.array([[-2, -2], [9, -2], [9, 9], [-2, 9]],
                                    float)])
        new = cell.split((15, 0.05), 20, 60)
        return ([(c.cell_id, c.points, c.polygons) for c in [cell] + new],
                prototypes.build_prototypes(df, num_workers=0),
                optics.optics_xi_labels(blobs(300, 4, 1.0, 3), 8, 0.05))

    with_cpp = run()

    def broken(*a, **kw):
        raise RuntimeError("building geokernels.cpp failed (exit 1):\n"
                           "g++: not found")

    monkeypatch.setattr(geokernels.native, "build_shared", broken)
    geokernels.load.cache_clear()
    optics._log_numpy_graph.cache_clear()
    try:
        with caplog.at_level(logging.WARNING):
            assert geokernels.load() is None and not geokernels.available()
            plain = run()
        messages = [r.getMessage() for r in caplog.records]
        assert sum("geo kernels unavailable" in m for m in messages) == 1
        assert sum("OPTICS graph in numpy" in m for m in messages) == 1
    finally:
        geokernels.load.cache_clear()
        optics._log_numpy_graph.cache_clear()
    for (i1, p1, g1), (i2, p2, g2) in zip(with_cpp[0], plain[0]):
        assert i1 == i2
        np.testing.assert_array_equal(p1, p2)
        for a, b in zip(g1, g2):
            np.testing.assert_array_equal(a, b)
    pd.testing.assert_frame_equal(with_cpp[1].drop(columns="lng"),
                                  plain[1].drop(columns="lng"))
    np.testing.assert_allclose(with_cpp[1]["lng"], plain[1]["lng"],
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(with_cpp[2], plain[2])
