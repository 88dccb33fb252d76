"""The open-loop schedule: the same for every run, Poisson gaps at the
rate asked for in a fixed shuffled order; and the seeded inputs repeat
bit for bit."""

import numpy as np
import pytest
import torch

from portbench import inputs

POISSON = {"process": "poisson", "rate": 160.0}


def test_schedule_is_the_same_in_every_run():
    a = inputs.arrival_times(POISSON, 10.0)
    assert a == inputs.arrival_times(POISSON, 10.0)
    assert np.all(np.diff(a) > 0)


def test_schedule_has_poisson_gaps_at_the_rate():
    gaps = np.diff([0.0] + inputs.arrival_times(POISSON, 10.0))
    assert len(gaps) == 1600 and gaps.sum() == pytest.approx(10.0)
    assert gaps.min() > 0 and gaps.mean() == pytest.approx(1 / 160.0)
    # Exponential: the median gap is ln 2 of the mean, and the order is
    # shuffled, not sorted.
    assert np.median(gaps) == pytest.approx(np.log(2) / 160.0, rel=0.02)
    assert not np.all(np.diff(gaps) >= 0)


def test_no_other_arrival_process():
    with pytest.raises(ValueError):
        inputs.arrival_times({"process": "burst", "rate": 1.0}, 1.0)


def test_seeded_inputs_repeat():
    a = inputs.make_weights({"image_size": 32, "patch_size": 16,
                             "hidden_size": 128, "intermediate_size": 256,
                             "num_hidden_layers": 1}, None, 9, "cpu")
    b = inputs.make_weights({"image_size": 32, "patch_size": 16,
                             "hidden_size": 128, "intermediate_size": 256,
                             "num_hidden_layers": 1}, None, 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(inputs.pixels(9, "x", (2, 4), "cpu"),
                       inputs.pixels(9, "x", (2, 4), "cpu"))
