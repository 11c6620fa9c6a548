import pytest

from tests import tiny  # noqa: F401
from pb import trace


def test_union_counts_overlap_once():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_length([(0, 10), (2, 3)]) == 10
    assert trace.union_length([]) == 0


def test_idle_share_from_the_union_not_the_sum():
    ev = [(trace.HOST, "request", 0.0, 10.0),
          (trace.DEVICE, "a", 1.0, 3.0), (trace.DEVICE, "b", 2.0, 4.0),   # overlapping
          (trace.DEVICE, "c", 6.0, 7.0),
          (trace.HOST, "sort", 4.5, 6.0)]
    r = trace.reduce(ev, 10.0)
    assert r["busy_s"] == 4.0                      # a sum of kernel times would say 5
    assert r["idle_pct"] == pytest.approx(60.0)
    assert r["device_ops"][0] == ["a", 2.0]
    names = dict(r["idle_gaps"])
    # gaps 0-1 and 7-10 lie in "request" alone; 4-6 is named by "sort",
    # the innermost range around its middle
    assert names == {"sort": pytest.approx(2.0), "request": pytest.approx(4.0)}


def test_a_range_shadow_on_the_device_is_no_operation():
    ev = [(trace.HOST, "explain_lower", 0.0, 4.0), (trace.DEVICE, "explain_lower", 0.0, 4.0),
          (trace.DEVICE, "kernel", 1.0, 2.0)]
    r = trace.reduce(ev, 4.0)
    assert r["busy_s"] == 1.0
    assert [n for n, _ in r["device_ops"]] == ["kernel"]


def test_no_device_operation_raises():
    with pytest.raises(ValueError):
        trace.reduce([(trace.HOST, "x", 0.0, 1.0)], 1.0)
