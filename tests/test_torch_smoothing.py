"""K10's cluster design (`csrc/smooth_labels.cu`) on the CPU: a model of
its partition and reduction against the plain version, the launch plan's
coverage of every (row, cell), and the wrapper's cached table check. The
kernel itself runs only on a card (`tests/test_torch_kernels.py`, ``-m
gpu``)."""

import numpy as np
import pytest
import torch

from pigeon_tpu_torch.core.geodesy import haversine_matrix
from pigeon_tpu_torch.kernels import geodesy as k10


def points(rng, n):
    return torch.from_numpy(np.stack(
        [rng.uniform(-180, 180, n), rng.uniform(-65, 70, n)],
        -1).astype(np.float32))


def cta_cells(plan, num_cells, rank):
    """The cells of CTA ``rank`` by chunk, one a thread as the kernel
    indexes them (cell = base + thread), the ones past the slice's end
    dropped."""
    begin = min(rank * plan.slice, num_cells)
    end = min(begin + plan.slice, num_cells)
    return [c[c < end] for c in (np.arange(base, base + plan.threads)
                                 for base in range(begin, end,
                                                   plan.threads))]


def cluster_model(labels, cells, tau_km, plan):
    """The kernel's computation in its order: per tile and CTA, d by
    chunk, each CTA's minimum over its chunks, the cluster's minimum over
    its CTAs' partials (+inf from an empty slice), then the exp."""
    batch, num_cells = labels.shape[0], cells.shape[0]
    out = torch.full((batch, num_cells), float("nan"))
    for tile in range(plan.tiles):
        rows = labels[tile * plan.rows:(tile + 1) * plan.rows]
        partials, chunks = [], []
        for rank in range(k10.CLUSTER):
            m = torch.full((rows.shape[0],), float("inf"))
            for idx in cta_cells(plan, num_cells, rank):
                d = haversine_matrix(rows, cells[idx])
                m = torch.minimum(m, d.amin(-1))
                chunks.append((idx, d))
            partials.append(m)
        dmin = torch.stack(partials).amin(0)
        for idx, d in chunks:
            out[tile * plan.rows:tile * plan.rows + rows.shape[0], idx] = (
                torch.exp(-(d - dmin[:, None]) / tau_km))
    return out


@pytest.mark.parametrize("b, c", [(1, 1), (3, 5), (8, 2203), (37, 200),
                                  (300, 2203)])
def test_cluster_model_matches_plain_version_exactly(b, c):
    rng = np.random.default_rng(b * 10000 + c)
    labels, cells = points(rng, b), points(rng, c)
    plan = k10.launch_plan(b, c)
    got = cluster_model(labels, cells, 75.0, plan)
    want = k10.smooth_labels_reference(labels, cells, 75.0)
    # The minimum is exact in any order, and d and the exp are the same
    # arithmetic per element, so the partition changes no bit.
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got.max(-1).values == 1.0).all())


def test_cluster_model_matches_with_chunks_and_small_blocks():
    """Plans the launcher picks only for long slices or never, but which
    the kernel takes: several chunks a CTA, ragged row tiles."""
    rng = np.random.default_rng(7)
    labels, cells = points(rng, 13), points(rng, 3000)
    want = k10.smooth_labels_reference(labels, cells, 65.0)
    for rows, threads in ((8, 64), (4, 64), (2, 96)):
        plan = k10.LaunchPlan(rows, threads, -(-13 // rows),
                              -(-3000 // k10.CLUSTER))
        assert len(cta_cells(plan, 3000, 0)) > 1
        got = cluster_model(labels, cells, 65.0, plan)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def coverage(plan, batch, num_cells):
    """How many times the kernel stores each (row, cell) under ``plan``."""
    count = np.zeros((batch, num_cells), np.int64)
    for tile in range(plan.tiles):
        rows = np.arange(tile * plan.rows, (tile + 1) * plan.rows)
        rows = rows[rows < batch]
        for rank in range(k10.CLUSTER):
            for idx in cta_cells(plan, num_cells, rank):
                np.add.at(count, (rows[:, None], idx[None, :]), 1)
    return count


def sampled_shapes():
    rng = np.random.default_rng(0)
    shapes = {(1, 1), (1, 2203), (300, 1), (300, 2203), (8, 2203),
              (256, 2203), (3, 5), (17, 7), (16, 8), (64, 9)}
    shapes |= {(int(b), int(c)) for b, c in zip(rng.integers(1, 301, 24),
                                                 rng.integers(1, 2204, 24))}
    return sorted(shapes)


@pytest.mark.parametrize("b, c", sampled_shapes())
def test_launch_plan_covers_every_row_and_cell_once(b, c):
    plan = k10.launch_plan(b, c)
    assert plan.rows in k10.ROWS
    # Whole warps, within the launch bound, and enough threads for the
    # cluster's reduction (one thread a row and CTA).
    assert plan.threads % 32 == 0
    assert plan.rows * k10.CLUSTER <= plan.threads <= k10.MAX_THREADS
    assert plan.tiles == -(-b // plan.rows)
    assert (coverage(plan, b, c) == 1).all()


def test_launch_plan_takes_the_fewest_rows_whose_grid_the_card_holds():
    # The main path's batch: one row a cluster, 64 CTAs.
    assert k10.launch_plan(8, 2203) == k10.LaunchPlan(1, 288, 8, 276)
    # The check shape: 4 rows a cluster, 512 CTAs.
    assert k10.launch_plan(256, 2203) == k10.LaunchPlan(4, 288, 64, 276)
    for b in range(1, 1001):
        plan = k10.launch_plan(b, 2203)
        resident = k10.H100_SMS * (k10.SM_THREADS // plan.threads)
        assert plan.tiles * k10.CLUSTER <= resident or plan.rows == 8
        if plan.rows > 1:
            assert -(-b // (plan.rows // 2)) * k10.CLUSTER > resident
    # A slice longer than a 512-thread chunk loops over chunks.
    assert k10.launch_plan(8, 4096).threads == 512
    plan = k10.launch_plan(8, 100000)
    assert plan.threads == 512 and len(cta_cells(plan, 100000, 0)) == 25


def test_table_check_is_cached_per_tensor_and_rechecks_any_other():
    labels, table = torch.zeros(3, 2), torch.zeros(5, 2)
    k10._check_operands(labels, table, 75.0)
    k10._check_operands(labels, table, 75.0)
    wrong = [(torch.zeros(5, 2, dtype=torch.float64), TypeError),
             (torch.zeros(5, 3), ValueError),
             (torch.zeros(2, 5).t(), ValueError),
             (torch.zeros(5, 2, device="meta"), ValueError),
             (torch.zeros(0, 2), ValueError)]
    for bad, error in wrong:
        with pytest.raises(error):
            k10._check_operands(labels, bad, 75.0)
        # The valid table passes again, and the wrong one still raises.
        k10._check_operands(labels, table, 75.0)
        with pytest.raises(error):
            k10._check_operands(labels, bad, 75.0)
    # A valid table is checked again against labels on another device.
    with pytest.raises(ValueError, match="labels on meta"):
        k10._check_operands(labels.to("meta"), table, 75.0)
    # The same tensor restrided in place is another table.
    table.as_strided_((5, 2), (1, 5))
    with pytest.raises(ValueError, match="contiguous"):
        k10._check_operands(labels, table, 75.0)
    # The labels are checked every call, whatever the table.
    with pytest.raises(TypeError):
        k10._check_operands(labels.double(), torch.zeros(5, 2), 75.0)
    with pytest.raises(ValueError):
        k10._check_operands(labels, torch.zeros(5, 2), 0.0)
