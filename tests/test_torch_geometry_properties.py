"""Property tests (hypothesis) of the port's geometry engine
(`pigeon_tpu_torch/geocell/geometry.py`), against the JAX package's where
both hold: clipping, point-in-polygon on numpy and on the C++ kernels,
Voronoi partitions, areas and WKT; and ADVICE's translated falsifier of
the noise-edge threshold, which the port scales with the coordinates'
magnitude (the JAX package's, with the clip's extent alone, lets a 1-ulp
repeated vertex of a small cell far from the origin clip it away)."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from pigeon_tpu.geocell import geometry as j_geom
from pigeon_tpu_torch.geocell import geokernels
from pigeon_tpu_torch.geocell import geometry as geom
from pigeon_tpu_torch.geocell.voronoi import voronoi_regions_for_points

EXAMPLES = settings(max_examples=40, deadline=None, derandomize=True)


@st.composite
def convex_polygon(draw, max_radius=50.0, span=180.0):
    """A convex ring: sorted angles around a center anywhere on the
    (lon, lat) plane, one radius."""
    n = draw(st.integers(3, 10))
    cx = draw(st.floats(-span, span))
    cy = draw(st.floats(-span / 2, span / 2))
    angles = np.sort(np.asarray(draw(st.lists(
        st.floats(0, 2 * np.pi - 1e-3), min_size=n, max_size=n,
        unique=True))))
    radius = draw(st.floats(1e-3, max_radius))
    return np.stack([cx + radius * np.cos(angles),
                     cy + radius * np.sin(angles)], -1)


@st.composite
def simple_polygon(draw):
    """A star-shaped (simple, possibly concave) ring, every angular gap
    below pi (`tests/test_geometry_properties.py::simple_polygon`)."""
    n = draw(st.integers(3, 12))
    cx = draw(st.floats(-100, 100))
    cy = draw(st.floats(-50, 50))
    rot = draw(st.floats(0, 2 * np.pi))
    gaps = np.asarray(draw(st.lists(st.floats(0.01, 1.0), min_size=n,
                                    max_size=n)))
    f = gaps / gaps.sum()
    if f.max() > 0.45:
        lam = (0.45 - 1.0 / n) / (f.max() - 1.0 / n)
        f = lam * f + (1 - lam) / n
    angles = rot + 2 * np.pi * np.cumsum(f)
    radii = np.asarray(draw(st.lists(st.floats(0.5, 40.0), min_size=n,
                                     max_size=n)))
    return np.stack([cx + radii * np.cos(angles),
                     cy + radii * np.sin(angles)], -1)


def with_repeated_vertex(ring: np.ndarray, at: int = 1) -> np.ndarray:
    """``ring`` with vertex ``at`` repeated one ulp away."""
    return np.insert(ring, at, np.nextafter(ring[at], np.inf), axis=0)


@pytest.mark.parametrize("origin,side", [
    ((170.0, -55.0), 1e-3), ((-179.5, 89.0), 1e-3), ((120.0, 30.0), 1e-4),
    ((0.0, 0.0), 1e-3), ((45.0, -10.0), 1.0)])
def test_noise_edge_keeps_the_area(origin, side):
    """ADVICE's falsifier and its translations: a square of ``side``
    degrees at ``origin`` with one vertex repeated to 1 ulp keeps its
    area through ``clip_to_convex(clip, clip)``."""
    x0, y0 = origin
    sq = np.array([[x0, y0], [x0 + side, y0], [x0 + side, y0 + side],
                   [x0, y0 + side]])
    clip = with_repeated_vertex(sq)
    out = geom.clip_to_convex(clip, clip)
    assert abs(geom.polygon_area(out)) == pytest.approx(
        abs(geom.polygon_area(sq)), rel=1e-9)


def test_pinned_noise_edge_case():
    """The JAX package's pinned falsifier (edge ~9e-16 at the origin)
    holds in the port too."""
    clip = np.array([
        [1.000000000000000e+00, 0.000000000000000e+00],
        [5.403023058681398e-01, 8.414709848078965e-01],
        [9.999995000000417e-01, -9.999998333348088e-04],
        [9.999995000000417e-01, -9.999998333339206e-04]])
    out = geom.clip_to_convex(clip, clip)
    assert abs(geom.polygon_area(out)) == pytest.approx(
        abs(geom.polygon_area(clip)), rel=1e-9, abs=1e-12)


@EXAMPLES
@given(clip=convex_polygon(), at=st.integers(0, 2))
def test_clip_self_keeps_area_anywhere(clip, at):
    """A convex ring clipped to itself keeps its area at any position and
    size, with or without a 1-ulp repeated vertex."""
    want = abs(geom.polygon_area(clip))
    for ring in (clip, with_repeated_vertex(clip, at)):
        out = geom.clip_to_convex(ring, ring)
        assert abs(geom.polygon_area(out)) == pytest.approx(
            want, rel=1e-9, abs=1e-12)


@EXAMPLES
@given(subject=simple_polygon(), clip=convex_polygon(span=100.0))
def test_clip_matches_jax_and_is_bounded(subject, clip):
    """Where no clip edge is below the noise threshold, the port clips as
    the JAX package does (within 1e-9); the area never exceeds the
    subject's or the clip's."""
    edges = np.hypot(*(np.roll(clip, -1, 0) - clip).T)
    if edges.min() <= 1e-9 * max(np.ptp(clip), np.abs(clip).max()):
        return      # a noise-length edge: the deviation's own ground
    out = geom.clip_to_convex(subject, clip)
    np.testing.assert_allclose(out, j_geom.clip_to_convex(subject, clip),
                               rtol=0, atol=1e-9)
    if len(out) >= 3:
        a_out = abs(geom.polygon_area(out))
        bound = min(abs(geom.polygon_area(subject)),
                    abs(geom.polygon_area(clip)))
        assert a_out <= bound * (1 + 1e-9) + 1e-9


@EXAMPLES
@given(poly=convex_polygon(), seed=st.integers(0, 2**31 - 1))
def test_pip_numpy_cpp_and_jax_agree(poly, seed):
    rng = np.random.default_rng(seed)
    bb = geom.bbox(poly)
    pts = np.stack([rng.uniform(bb[0] - 5, bb[2] + 5, 300),
                    rng.uniform(bb[1] - 5, bb[3] + 5, 300)], -1)
    got = geom.points_in_ring(pts, poly)
    np.testing.assert_array_equal(got, j_geom.points_in_ring(pts, poly))
    if geokernels.available():
        np.testing.assert_array_equal(
            got, geokernels.pip_batch(pts, geom.as_ring(poly)))


@EXAMPLES
@given(seed=st.integers(0, 2**31 - 1), k=st.integers(2, 8),
       scale=st.sampled_from([1.0, 1e-2, 1e-4]))
def test_voronoi_partition_dissolves_to_parent(seed, k, scale):
    """A square carved into k Voronoi territories and dissolved recovers
    its area (one component where the sites are not near-coincident)."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform(2, 8, (1, 2)) + rng.uniform(-3 * scale, 3 * scale,
                                                    (k, 2))
    if len(np.unique(sites, axis=0)) < k:
        return
    parent = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], float)
    pieces = [p for p in (geom.clip_to_convex(parent, r)
                          for r in voronoi_regions_for_points(sites))
              if len(p) >= 3]
    out = geom.dissolve(pieces)
    total = sum(abs(geom.polygon_area(s)) for s, _ in out) \
        - sum(abs(geom.polygon_area(h)) for _, hs in out for h in hs)
    assert total == pytest.approx(100.0, rel=1e-6)
    if scale >= 1e-2:
        assert len(out) == 1


@EXAMPLES
@given(poly=convex_polygon(), factor=st.floats(0.1, 3.0))
def test_area_scales_and_survives_wkt(poly, factor):
    scaled = geom.scale_about_centroid(poly, factor)
    assert abs(geom.polygon_area(scaled)) == pytest.approx(
        abs(geom.polygon_area(poly)) * factor**2, rel=1e-9)
    assert geom.to_wkt(poly) == j_geom.to_wkt(poly)
    parsed = geom.from_wkt(geom.to_wkt(poly))
    if parsed and abs(geom.polygon_area(poly)) > 1e-3:
        assert abs(geom.polygon_area(parsed[0])) == pytest.approx(
            abs(geom.polygon_area(poly)), rel=1e-3, abs=1e-4)
