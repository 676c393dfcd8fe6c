"""Percentiles are taken over all requests, rates over all the work and
all the time."""

import math

import numpy as np
import pytest

import stats


def test_percentile_is_numpys_linear_over_every_value():
    rng = np.random.default_rng(0)
    v = rng.lognormal(3, 1, 1001)
    for q in (50, 95, 99):
        assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q), rel=1e-12)


def test_a_failed_request_counts_as_missing_in_the_tail():
    v = [10.0] * 95 + [math.inf] * 5
    assert stats.percentile(v, 50) == 10.0
    assert math.isinf(stats.percentile(v + [math.inf], 95))


def test_tail_is_of_all_requests_not_a_median_of_chunks():
    v = [1.0] * 90 + [100.0] * 10  # every slow request in one chunk
    chunks = [stats.percentile(v[i:i + 10], 95) for i in range(0, 100, 10)]
    assert np.median(chunks) == 1.0
    assert stats.percentile(v, 95) == 100.0


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(905 * 7, 3.5) == 905 * 2
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
