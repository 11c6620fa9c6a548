import types

import pytest

from tests import tiny
from pb import stats


def test_percentile_interpolates_between_closest_ranks():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile([10], 95) == 10
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)


def test_rate_and_tail_show_a_stall():
    # 99 requests of 10 ms back to back, then one that stalls for 2 s
    recs, t = [], 0.0
    for _ in range(99):
        recs.append((t, t + 0.010, 8))
        t += 0.010
    recs.append((t, t + 2.0, 8))
    t_end = t + 2.0
    rate = stats.window_rate(recs, 0.0, t_end)
    assert rate == pytest.approx(800 / 2.99)          # all the clips over all the time
    assert rate < 0.5 * 800 / 1.0                      # far below the stall-free rate
    lat = stats.latencies_ms(recs)
    assert stats.percentile(lat, 95) == pytest.approx(10.0)
    assert stats.percentile(lat, 100) == pytest.approx(2000.0)
    # with six stalls the 95th percentile is a stall
    recs6 = recs[:94] + [(0, 2.0, 8)] * 6
    assert stats.percentile(stats.latencies_ms(recs6), 95) == pytest.approx(2000.0)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([9.0, 10.0, 10.0, 11.0]) == pytest.approx(0.15)


def test_empty_window_raises():
    with pytest.raises(ValueError):
        stats.window_rate([], 1.0, 1.0)
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_the_per_layer_tail_reads_as_the_end_to_end_one():
    recs = [(0.0, 0.001 * (i + 1), 8) for i in range(100)]
    run = types.SimpleNamespace(window={"records": recs})
    e2e = tiny.run.load("metrics", "request_ms_p95").read(run)
    assert tiny.run.load("metrics", "service.request_p95_ms").read(run) == e2e
    assert e2e == pytest.approx(95.05)
    run.window["records"] = []
    assert tiny.run.load("metrics", "service.request_p95_ms").read(run) is None
