"""Geocell data structures + the fuse/split balancing algorithm.

Counterpart of `pigeon_tpu/geocell/cells.py`, the same cells for the
same inputs and seed: OPTICS runs the port's own graph and xi
extraction (`geocell/optics.py`), the adjacency predicate the port's
C++ geo kernels where they build (`geocell/geokernels.py`).

Rebuilds the behavioral contract of the reference's `Cell` /
`CellCollection` (`dataset_creation/geocell/cell.py`,
`cell_collection.py`) on the numpy geometry engine:

  * a Cell owns a point set and a list of polygon pieces (rings);
  * FUSE: cells below `min_cell_size` absorb their largest adjacent
    neighbor, preferring (1) small same-admin-1 neighbors, (2) any
    same-admin-1 neighbor, (3) small neighbors anywhere, (4) any neighbor,
    (5) a 2x-enlarged search — the reference's priority ladder
    (`cell_collection.py:184-244`), with adjacency = intersection of
    1.01x-scaled shapes;
  * SPLIT: cells above `max_cell_size` are OPTICS-clustered on their
    points with escalating parameter ladders; sub-`min` clusters dissolve
    into noise; noise points join the nearest large-cluster centroid;
    territories are carved by clipping the parent's polygons to the finite
    Voronoi regions of the cluster centroids (`cell.py:299-418`).

Termination/limits (shared with the reference): a cell only splits when
OPTICS finds >= 2 clusters of at least `min_cell_size` — dense unimodal
blobs (single cities) can stay oversize; the planet-scale ladder's
aggressive final settings (min_samples 1000, xi 1e-4) exist to force
splits of such blobs. The split loop terminates when no oversize cell
yields a split.

Representation difference vs the reference (by design): shapes are kept as
lists of convex-clipped pieces rather than dissolved shapely unions — every
operation the pipeline needs (point assignment, adjacency, WKT export,
area) works on piece lists, and it removes the need for a GEOS-style
boolean-union engine. The 2-cluster split uses the perpendicular-bisector
half-plane directly (scipy Voronoi needs >= 3 sites).
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pigeon_tpu_torch.geocell import geokernels
from pigeon_tpu_torch.geocell import geometry as geom
from pigeon_tpu_torch.geocell.optics import optics_xi_labels
from pigeon_tpu_torch.geocell.voronoi import voronoi_regions_for_points

#: OPTICS (min_samples, xi) escalation ladders (reference
#: `cell_collection.py:12-13`).
OPTICS_PARAMS_STREETVIEW = ((8, 0.05), (10, 0.025), (15, 0.015))
OPTICS_PARAMS_PLANET = ((300, 0.05), (400, 0.005), (1000, 0.0001))

GEOCELL_COLUMNS = ("name", "admin_1", "country", "size", "num_polygons",
                   "geometry", "lng", "lat")


class Cell:
    """A geocell: named point set + polygon pieces within an admin context."""

    def __init__(self, cell_id: str, admin_1: str, country: str,
                 points: np.ndarray, polygons: Sequence[np.ndarray]):
        self.cell_id = str(cell_id)
        self.admin_1 = str(admin_1)
        self.country = str(country)
        self.points = np.asarray(points, np.float64).reshape(-1, 2)
        self.polygons: List[np.ndarray] = [
            geom.as_ring(p) for p in polygons if len(geom.as_ring(p)) >= 3]

    @property
    def size(self) -> int:
        return len(self.points)

    @property
    def empty(self) -> bool:
        return self.size == 0

    @property
    def centroid(self) -> np.ndarray:
        """Mean of POINTS (not shape) — the coordinate the model predicts
        for this cell (reference `cell.py:107-115`)."""
        return self.points.mean(axis=0)

    @property
    def area(self) -> float:
        return sum(abs(geom.polygon_area(p)) for p in self.polygons)

    def scaled_polygons(self, factor: float) -> List[np.ndarray]:
        """Pieces scaled about the cell's overall shape centroid."""
        if not self.polygons:
            return []
        weights = np.array([abs(geom.polygon_area(p)) + 1e-12
                            for p in self.polygons])
        centers = np.array([geom.polygon_centroid(p)
                            for p in self.polygons])
        origin = (centers * weights[:, None]).sum(0) / weights.sum()
        return [geom.scale_about_centroid(p, factor, origin)
                for p in self.polygons]

    def combine(self, others: Iterable["Cell"]) -> None:
        """Absorb other cells' points + pieces; empty them
        (reference `cell.py:154-168`)."""
        for other in others:
            if other is self:
                continue
            if other.size:
                self.points = np.vstack([self.points, other.points])
            self.polygons.extend(other.polygons)
            other.points = np.zeros((0, 2))
            other.polygons = []

    def contains(self, points: np.ndarray) -> np.ndarray:
        return geom.points_in_multipolygon(points, self.polygons)

    def to_row(self) -> dict:
        c = self.centroid if self.size else np.array([np.nan, np.nan])
        # Export dissolves the piece list into unioned polygons (holes
        # included) so the WKT artifact is interchangeable with the
        # reference's shapely-union geometry column (`cell.py:51-59`).
        comps = geom.dissolve(self.polygons)
        return {
            "name": self.cell_id,
            "admin_1": self.admin_1,
            "country": self.country,
            "size": self.size,
            "num_polygons": max(len(comps), 1) if self.polygons
            else 0,
            "geometry": geom.components_to_wkt(comps),
            "lng": c[0],
            "lat": c[1],
        }

    def __repr__(self):
        return (f"Cell(id={self.cell_id}, admin_1={self.admin_1}, "
                f"country={self.country}, size={self.size}, "
                f"pieces={len(self.polygons)})")

    def __hash__(self):
        return hash(self.cell_id)

    def __eq__(self, other):
        return isinstance(other, Cell) and self.cell_id == other.cell_id

    # ------------------------------------------------------------------
    # Splitting
    # ------------------------------------------------------------------

    def split(self, params: Tuple[int, float], min_cell_size: int,
              max_cell_size: int,
              rng: Optional[random.Random] = None) -> List["Cell"]:
        """OPTICS-split this cell; returns the NEW cells (self keeps the
        first cluster's territory). Empty list = no usable split.

        Mirrors `cell.py:336-418`: sub-min clusters -> noise; noise points
        assigned to nearest large-cluster centroid; need >= 2 large
        clusters; the doughnut case (1 real cluster + bounded noise) is
        split cluster-vs-noise.
        """
        if self.size <= max_cell_size:
            return []
        min_samples, xi = params
        min_samples = min(min_samples, max(2, self.size - 1))
        # The critical path of planet-scale balancing is OPTICS on the
        # largest cell, which no amount of per-cell fan-out can hide —
        # optics_xi_labels runs the O(n²) graph in native C++/OpenMP.
        labels = optics_xi_labels(self.points, min_samples, xi)

        # Dissolve small clusters into noise.
        ids, counts = np.unique(labels[labels >= 0], return_counts=True)
        small = ids[counts < min_cell_size]
        labels = np.where(np.isin(labels, small), -1, labels)
        ids, counts = np.unique(labels[labels >= 0], return_counts=True)
        large = ids[counts >= min_cell_size]

        noise_count = int((labels == -1).sum())
        if len(large) == 0:
            return []
        if len(large) == 1:
            # Doughnut: one cluster + noise; only split when the remaining
            # noise stays bounded (`cell.py:381-384`).
            if noise_count < min_cell_size or noise_count > max_cell_size:
                return []
            labels = np.where(labels == large[0], 0, 1)
            centroids = np.stack([self.points[labels == 0].mean(0),
                                  self.points[labels == 1].mean(0)])
        else:
            # Noise joins the nearest large-cluster centroid
            # (`cell.py:309-317`).
            centroids = np.stack([self.points[labels == c].mean(0)
                                  for c in large])
            relabel = np.full_like(labels, -1)
            for i, c in enumerate(large):
                relabel[labels == c] = i
            noise_idx = np.where(relabel == -1)[0]
            if len(noise_idx):
                d = np.linalg.norm(
                    self.points[noise_idx, None, :] - centroids[None],
                    axis=-1)
                relabel[noise_idx] = d.argmin(1)
            labels = relabel
            centroids = np.stack([self.points[labels == i].mean(0)
                                  for i in range(len(large))])

        territories = self._carve_territories(centroids)

        # First cluster stays in self; the rest become new cells.
        new_cells = []
        keep_mask = labels == 0
        for i in range(1, len(centroids)):
            mask = labels == i
            name = f"{self.cell_id}_s{i}_{self.size}"
            new_cells.append(Cell(name, self.admin_1, self.country,
                                  self.points[mask], territories[i]))
        self.points = self.points[keep_mask]
        self.polygons = territories[0]
        # Repair fragmentation before returning (`cell.py:400-408` calls
        # __clean_dirty_splits on the split outputs + self).
        clean_dirty_splits([self] + new_cells)
        return new_cells

    def _carve_territories(self, centroids: np.ndarray
                           ) -> List[List[np.ndarray]]:
        """Clip this cell's pieces to each centroid's Voronoi region."""
        k = len(centroids)
        if not self.polygons:
            return [[] for _ in range(k)]
        if k == 2:
            regions = _bisector_half_planes(centroids[0], centroids[1],
                                            self.polygons)
        else:
            regions = voronoi_regions_for_points(centroids)
        territories: List[List[np.ndarray]] = []
        for region in regions:
            pieces = []
            for ring in self.polygons:
                # as_ring normalizes near-duplicate closing vertices that
                # Sutherland-Hodgman can emit, keeping every piece in the
                # canonical form both the numpy and native adjacency
                # predicates assume.
                clipped = geom.as_ring(geom.clip_to_convex(ring, region))
                if len(clipped) >= 3 and \
                        abs(geom.polygon_area(clipped)) > 1e-12:
                    pieces.append(clipped)
            territories.append(pieces)
        return territories


def _split_worker(task):
    """Process-pool task: split one cell (must be module-level to pickle).
    Returns the (mutated) cell and its new children."""
    cell, params, min_size, max_size = task
    new_cells = cell.split(params, min_size, max_size)
    return cell, new_cells


def clean_dirty_splits(cells: List[Cell], buffer_deg: float = 0.01) -> None:
    """Repair fragmented splits: non-largest disconnected fragments of a
    cell's territory move (shape AND points) to the adjacent cell with the
    largest shared border.

    Rebuilds the reference's `__clean_dirty_splits` (`cell.py:420-481`):
    it keeps each MultiPolygon's largest sub-polygon and reassigns every
    smaller one to the neighbor with the largest buffer(0.01)-intersection
    area — for touching polygons that area is proportional to shared
    border length, which `boundary_proximity_count` scores directly.
    Fragments touching no neighbor (true islands) stay, as in the
    reference (`cell.py:460-461`).
    """
    for cell in cells:
        if len(cell.polygons) <= 1:
            continue
        comps = geom.dissolve(cell.polygons)
        if len(comps) <= 1:
            continue
        areas = [abs(geom.polygon_area(s)) for s, _ in comps]
        largest = int(np.argmax(areas))

        # Group original pieces by dissolved component (smallest
        # containing shell of the piece centroid).
        piece_comp = []
        for piece in cell.polygons:
            rep = geom.polygon_centroid(piece)
            inside = [i for i, (s, _) in enumerate(comps)
                      if geom.points_in_ring(rep[None], s)[0]]
            piece_comp.append(min(inside, key=lambda i: areas[i])
                              if inside else largest)

        others = [c for c in cells if c is not cell]
        keep_pieces = [p for p, ci in zip(cell.polygons, piece_comp)
                       if ci == largest]
        for ci, (shell, _holes) in enumerate(comps):
            if ci == largest:
                continue
            frag_pieces = [p for p, pc in zip(cell.polygons, piece_comp)
                           if pc == ci]
            scores = [geom.boundary_proximity_count(
                shell, c.polygons, tol=buffer_deg) for c in others]
            if not scores or max(scores) == 0:
                keep_pieces.extend(frag_pieces)   # island: stays
                continue
            target = others[int(np.argmax(scores))]
            target.polygons.extend(frag_pieces)
            if cell.size:
                mask = geom.points_in_multipolygon(cell.points, frag_pieces)
                if mask.any():
                    target.points = np.vstack([target.points,
                                               cell.points[mask]])
                    cell.points = cell.points[~mask]
        cell.polygons = keep_pieces


def _adjacent_mask(subject: List[np.ndarray],
                   candidates: List[Cell]) -> np.ndarray:
    """Per-candidate `polygons_intersect(subject, c.polygons)` — one
    OpenMP pass through the native kernel when available (the fuse
    phase's hot predicate at admin-2 seeding scale), numpy otherwise."""
    if subject and len(candidates) >= 8 and geokernels.available():
        return geokernels.multipoly_intersect_batch(
            subject, [c.polygons for c in candidates])
    return np.array([geom.polygons_intersect(subject, c.polygons)
                     for c in candidates], bool)


def _bisector_half_planes(a: np.ndarray, b: np.ndarray,
                          pieces: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Two large convex quads covering each side of the perpendicular
    bisector of a-b (the k=2 Voronoi diagram)."""
    all_pts = np.vstack(pieces)
    span = max(np.ptp(all_pts[:, 0]), np.ptp(all_pts[:, 1]), 1.0) * 100
    mid = (a + b) / 2.0
    d = b - a
    d = d / (np.linalg.norm(d) + 1e-30)
    n = np.array([-d[1], d[0]])
    quad_a = np.array([mid + n * span, mid - n * span,
                       mid - n * span - d * span, mid + n * span - d * span])
    quad_b = np.array([mid - n * span, mid + n * span,
                       mid + n * span + d * span, mid - n * span + d * span])
    return [quad_a, quad_b]


class CellCollection:
    """A mutable set of cells + the balancing algorithm."""

    def __init__(self, cells: Iterable[Cell]):
        self.cells: Dict[str, Cell] = {
            c.cell_id: c for c in cells if not c.empty}

    def __len__(self):
        return len(self.cells)

    def __iter__(self):
        return iter(self.cells.values())

    def find(self, cell_id: str) -> Cell:
        return self.cells[str(cell_id)]

    @property
    def countries(self) -> List[str]:
        return sorted({c.country for c in self})

    def add(self, cell: Cell) -> None:
        self.cells[cell.cell_id] = cell

    def remove(self, cell: Cell) -> None:
        self.cells.pop(cell.cell_id, None)

    def clean(self) -> None:
        for cid in [c.cell_id for c in self if c.empty]:
            self.cells.pop(cid)

    # ------------------------------------------------------------------

    def balance(self, min_cell_size: int, max_cell_size: int,
                optics_params: Sequence[Tuple[int, float]]
                = OPTICS_PARAMS_PLANET, seed: int = 330,
                num_workers: int = 0) -> None:
        """Fuse small cells per country, then split large cells
        (reference `cell_collection.py:121-133`).

        ``num_workers`` > 0 parallelizes the split phase over a process
        pool (planet-scale runs are OPTICS-bound)."""
        for country in self.countries[::-1]:
            self._fuse_country(country, min_cell_size, seed)
        self.clean()
        self._split_all(min_cell_size, max_cell_size, optics_params,
                        num_workers=num_workers)
        self.clean()

    def _fuse_country(self, country: str, min_cell_size: int,
                      seed: int) -> None:
        rng = random.Random(seed)
        excluded: set = set()
        while True:
            cells = [c for c in self
                     if c.country == country and not c.empty]
            small = [c for c in cells
                     if c.size < min_cell_size
                     and c.cell_id not in excluded]
            if not small:
                break
            center = rng.choice(sorted(small, key=lambda c: c.cell_id))
            scaled = center.scaled_polygons(1.01)

            neighbor = self._find_neighbor(center, scaled, cells,
                                           min_cell_size)
            if neighbor is None:
                scaled2 = center.scaled_polygons(2.02)
                neighbor = self._find_neighbor(center, scaled2, cells,
                                               min_cell_size,
                                               any_tier_only=True)
            if neighbor is None:
                excluded.add(center.cell_id)
                continue
            center.combine([neighbor])
            self.remove(neighbor)

    def _find_neighbor(self, center: Cell, scaled: List[np.ndarray],
                       cells: List[Cell], min_cell_size: int,
                       any_tier_only: bool = False) -> Optional[Cell]:
        """Adjacency ladder (reference `cell_collection.py:205-237`):
        small+same-admin-1 -> same-admin-1 -> small -> any; within a tier
        pick the LARGEST intersecting neighbor.

        The intersection predicate is evaluated ONCE per candidate (one
        batched native pass when available) and the tiers filter the hit
        set — equivalent to testing per tier, since a tier's hits are
        tier ∩ all-hits."""
        others = [c for c in cells if c.cell_id != center.cell_id]
        hits = _adjacent_mask(scaled, others)
        adj = [c for c, h in zip(others, hits) if h]
        if not adj:
            return None
        if any_tier_only:
            return max(adj, key=lambda c: c.size)
        small = [c for c in adj if c.size < min_cell_size]
        same_a1 = [c for c in adj if c.admin_1 == center.admin_1]
        small_a1 = [c for c in small if c.admin_1 == center.admin_1]
        for tier in (small_a1, same_a1, small, adj):
            if tier:
                return max(tier, key=lambda c: c.size)
        return None

    def _split_all(self, min_cell_size: int, max_cell_size: int,
                   optics_params: Sequence[Tuple[int, float]],
                   num_workers: int = 0) -> None:
        """Escalating OPTICS ladders; iterate until no cell splits
        (reference `cell_collection.py:145-182`).

        Splits within a round are independent, so with ``num_workers`` > 0
        they fan out over a process pool (the reference's
        ThreadPoolExecutor split parallelism, `cell_collection.py:165` —
        a process pool here because the numpy OPTICS fallback holds the
        GIL for its O(n²) core, which dominates planet-scale runs).
        """
        # ONE pool for all rounds/ladders: spawn-context workers (fork +
        # the parent's torch threads can deadlock; the reference forces
        # spawn globally, run.py:192) pay a full interpreter + import
        # startup each, so recreating the pool per round would cost
        # workers x seconds x rounds. Workers spawn lazily on first use.
        pool = None
        if num_workers:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            pool = ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=multiprocessing.get_context("spawn"))
        try:
            self._split_ladders(pool, min_cell_size, max_cell_size,
                                optics_params)
        finally:
            if pool is not None:
                pool.shutdown()

    def _split_ladders(self, pool, min_cell_size: int, max_cell_size: int,
                       optics_params: Sequence[Tuple[int, float]]) -> None:
        for params in optics_params:
            pending = sorted((c for c in self if c.size > max_cell_size),
                             key=lambda c: c.cell_id)
            while pending:
                results: List[Tuple[Cell, List[Cell]]] = []
                jobs = [(c, params, min_cell_size, max_cell_size)
                        for c in pending]
                if pool is not None and len(pending) > 1:
                    results = list(pool.map(_split_worker, jobs))
                else:
                    results = [_split_worker(job) for job in jobs]

                next_round: List[Cell] = []
                for cell, new_cells in results:
                    # Worker results are pickled copies: re-register the
                    # (possibly mutated) parent under its id.
                    self.add(cell)
                    for nc in new_cells:
                        self.add(nc)
                        if nc.size > max_cell_size:
                            next_round.append(nc)
                    if new_cells and cell.size > max_cell_size:
                        next_round.append(cell)
                pending = sorted(next_round, key=lambda c: c.cell_id)

    # ------------------------------------------------------------------

    def to_records(self) -> List[dict]:
        return [c.to_row() for c in sorted(self, key=lambda c: c.cell_id)
                if not c.empty]

    def to_csv(self, path: str) -> None:
        """Geocell CSV with the reference schema + centroid columns
        (consumed by `GeocellHead` via the lng/lat columns, reference
        `models/super_guessr.py:162-174`)."""
        import pandas as pd

        pd.DataFrame(self.to_records()).to_csv(path, index=False)
