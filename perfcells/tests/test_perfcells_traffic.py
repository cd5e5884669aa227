"""The traffic generator: deterministic in the seed, the asked rate, the
same work for every seed in another order."""

import numpy as np
import pytest

from perfcells import harness, traffic


def test_poisson_schedule_has_the_asked_mean_and_is_seeded():
    spec = {"kind": "poisson", "rate_per_s": 400.0}
    a = traffic.arrivals(spec, 10.0, 7, 2**31 + 5)
    b = traffic.arrivals(spec, 10.0, 7, 2**31 + 5)
    c = traffic.arrivals(spec, 10.0, 7, 2**31 + 6)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == len(c) == 4000
    assert np.all(np.diff(a) >= 0) and 0 < a[0] and a[-1] <= 10.0
    gaps = np.diff(np.concatenate([[0.0], a]))
    assert np.mean(gaps) == pytest.approx(1 / 400.0, rel=1e-9)
    assert np.std(gaps) == pytest.approx(1 / 400.0, rel=0.1)  # exponential: std = mean
    assert np.allclose(np.sort(gaps), np.sort(np.diff(np.concatenate([[0.0], c]))))


def test_arrivals_kind_is_found_by_its_file():
    assert traffic.arrivals_kind("poisson").pieces({"rate_per_s": 5.0}, 2.0) == [(0.0, 2.0, 5.0)]
    with pytest.raises(ValueError, match="unknown arrivals kind"):
        traffic.arrivals({"kind": "no_such_shape", "rate_per_s": 1.0}, 1.0, 0, 0)


def test_lane_batches_are_seeded_and_never_repeat_a_window_in_a_batch():
    a = traffic.lane_batches(100, 5, 32, 2**33)
    b = traffic.lane_batches(100, 5, 32, 2**33)
    for _ in range(7):
        x, y = next(a), next(b)
        assert np.array_equal(x, y) and x.shape == (5, 32)
        for row in x:
            assert len(set(row.tolist())) == 32
    assert not np.array_equal(next(traffic.lane_batches(100, 5, 32, 1)), x)


def test_requests_are_a_seeded_permutation_of_the_pool():
    pool = [np.zeros((3, 8, 2))] * 10
    r = traffic.requests(pool, 25, 4)
    assert np.array_equal(r, traffic.requests(pool, 25, 4))
    assert sorted(r[:10].tolist()) == list(range(10))


def test_request_pool_and_lines():
    spec = harness.load_cell("c4-serve-poisson")
    pool, (mean, std) = traffic.request_pool(spec["traffic"], 8, 12, 64)
    assert len(pool) > 2000 and 30 < max(w.shape[0] for w in pool) <= 64
    assert mean.shape == std.shape == (2,) and np.all(std > 0)
    line = traffic.request_line(pool[0], 3, "b64-npy")
    assert '"seed": 3' in line and "xy_b64_npy" in line

